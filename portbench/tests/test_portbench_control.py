"""The control: the reference computed in float8 in the program's place
comes out not correct under each cell's limits, where the program comes
out correct.  On the card at the cell's own size (``gpu``); on the CPU
at smoke widths, where the float8 control must still read above the
program."""
import pytest
import torch

import control
from harness import manifest
from smallcfg import small_mix, small_model

SERVE_CELLS = ("olmo-1b.longgen", "granite-moe-3b-a800m.batch")


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v["limit"] for k, v in limits.items()
               if k in readings)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", SERVE_CELLS + ("olmo-1b.train",))
def test_control_fails_the_cell_on_the_card(cell, cuda):
    limits = manifest.limits_file(cell)
    mix = manifest.traffic_file(manifest.workload(manifest.load(),
                                                  cell)["traffic"])
    if mix["kind"] == "serve":
        rec = control.serve_seed(cell, 2**31 + 77, 10.0, cuda)
    else:
        rec = control.train_seed(cell, 2**31 + 77, cuda)
    assert not _fails(rec["program"], limits), rec
    assert _fails(rec["control"], limits), rec
    for fault in ("half_batch", "unmasked"):
        if fault in rec:
            assert _fails(rec[fault], limits), (fault, rec)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_control_reads_above_the_program_on_the_cpu(cell):
    w = manifest.workload(manifest.load(), cell)
    rec = control.serve_seed(cell, 2**31 + 9, 1.0, torch.device("cpu"),
                             model=small_model(w["config"]),
                             mix=small_mix(manifest.traffic_file(
                                 w["traffic"])))
    for k in rec["program"]:
        if k != "max_logit_gap":
            assert rec["control"][k] > 2 * rec["program"][k], rec


def test_training_control_and_faults_read_above_the_program_on_the_cpu():
    w = manifest.workload(manifest.load(), "olmo-1b.train")
    rec = control.train_seed("olmo-1b.train", 2**31 + 9,
                             torch.device("cpu"),
                             model=small_model(w["config"]),
                             mix=small_mix(manifest.traffic_file("train")))
    prog = rec["program"]
    assert rec["control"]["loss_gap"] > 10 * prog["loss_gap"], rec
    assert (rec["half_batch"]["grad_norm_gap"]
            > 10 * prog["grad_norm_gap"]), rec
    assert rec["unmasked"]["zeros_gap"] > 1000, rec
