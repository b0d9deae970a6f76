"""The one-thread fixture the port's smoke-sized CPU tests share.

Under the suite's parallel workers, torch's default of a thread per core
oversubscribes the machine and small ops wait on each other: the 30-step
training test took 132 s that way and 3 s alone, the phase-8 rehearsal
122 s and 6 s.  Test modules import ``one_torch_thread`` from here.
"""
import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """torch on one thread for the test, its count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_torch_thread_runs_torch_on_one_thread(one_torch_thread):
    assert torch.get_num_threads() == 1
