"""``harness/spans.py`` on a made-up event list (device ms under a range,
gaps put down to the engine phase the host was in), its readers on
traced CPU runs (nothing to read, nothing raised), and on the card a
traced granite run at smoke widths (``gpu``)."""
import types

import pytest
import torch
from torch.autograd import DeviceType

import run
from harness import manifest, spans
from smallcfg import small_mix, small_model

NEW = ("attn_ms.batch", "moe_ms.batch", "idle_decode_ms.batch",
       "idle_host_ms.batch", "update_dev_ms.train")


def _event(name, start, end, device, eid=0, annotation=False):
    return types.SimpleNamespace(
        name=name, id=eid, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def _events():
    """Two steps (µs): step 1 [0, 100] with schedule, decode (attention,
    then a MoE layer with a grouped product inside), host_sync and
    sample; step 2 [120, 220] with decode alone; a last host event at
    300.  Each device operation has a launch with its correlation id:
    the gaps between them fall 4 µs inside step 1's decode, 6 inside its
    sample, 20 between the steps and 101 after the last operation."""
    hosts = [("serve.step", 0, 100), ("serve.schedule", 0, 10),
             ("serve.decode", 10, 60), ("attn.decode", 11, 20),
             ("aten::copy_", 12, 14), ("moe", 22, 45),
             ("kernel.bitmap_spmm_grouped", 32, 40),
             ("serve.host_sync", 60, 80), ("serve.sample", 80, 95),
             ("serve.step", 120, 220), ("serve.decode", 121, 200),
             ("aten::mm", 300, 301)]        # not a range of the program
    # (start, end, launched at): attention's copy, the grouped product,
    # the router inside the MoE layer, then the sampler, step 2's decode
    ops = [(0, 12, 1), (16, 40, 12), (40, 70, 33), (70, 84, 25),
           (90, 105, 85), (125, 200, 130)]
    out = [_event(n, s, e, False) for n, s, e in hosts]
    for i, (s, e, t) in enumerate(ops):
        out.append(_event("cudaLaunchKernel", t, t + 1, False, eid=i + 1))
        out.append(_event(f"kernel_{i}", s, e, True, eid=i + 1))
    # the ranges' device-side twins: no device operation
    out += [_event("attn.decode", 16, 40, True, eid=2, annotation=True),
            _event("kernel.bitmap_spmm_grouped", 40, 70, True, eid=3,
                   annotation=True),
            _event("serve.step", 0, 105, True, annotation=True)]
    return out


def test_gaps_land_in_the_phase_the_host_was_in():
    idle = spans.Spans(_events()).idle_ms()
    assert idle == pytest.approx({"serve.decode": 4e-3,
                                  "serve.sample": 6e-3,
                                  spans.OUTSIDE: 121e-3})


def test_device_ms_is_what_the_range_launched_not_its_twin():
    sp = spans.Spans(_events())
    assert sp.count("serve.step") == 2
    assert sp.busy_us == pytest.approx(12 + 68 + 15 + 75)
    assert sp.device_ms("attn.decode") == pytest.approx(24e-3)
    assert sp.device_ms("kernel.bitmap_spmm_grouped") == pytest.approx(30e-3)
    assert sp.device_ms("moe") == pytest.approx(44e-3)
    assert sp.device_ms("moe", skip=("kernel.bitmap_spmm_grouped",)) == \
        pytest.approx(14e-3)
    assert sp.device_ms("serve.decode") == pytest.approx((24 + 44 + 75) * 1e-3)
    assert sp.device_ms("train.update") is None


class _Profiled:
    """What a driver's ``profile`` holds: the profiler, as ``_prof``."""

    def __init__(self, events):
        self._prof = types.SimpleNamespace(events=lambda: events)


def _run_of(events):
    return types.SimpleNamespace(
        driver=types.SimpleNamespace(profile=_Profiled(events)))


def test_readers_divide_by_the_steps_of_the_span():
    r = _run_of(_events())
    read = {n: manifest.reader(n)(r) for n in NEW}
    assert read["attn_ms.batch"] == pytest.approx(24e-3 / 2)
    assert read["moe_ms.batch"] == pytest.approx(14e-3 / 2)
    assert read["idle_decode_ms.batch"] == pytest.approx(4e-3 / 2)
    assert read["idle_host_ms.batch"] == pytest.approx(127e-3 / 2)
    assert read["update_dev_ms.train"] is None


def test_readers_read_nothing_without_device_time_or_ranges():
    hosts_only = [e for e in _events() if e.device_type == DeviceType.CPU]
    for events in (hosts_only, [_event("a", 0, 1, True)], []):
        r = _run_of(events)
        assert all(manifest.reader(n)(r) is None for n in NEW)
    untraced = types.SimpleNamespace(
        driver=types.SimpleNamespace(profile=None))
    assert all(manifest.reader(n)(untraced) is None for n in NEW)


def _traced(cell, device, seed=2**31 + 11, seconds=1.0):
    bench = manifest.load()
    w = manifest.workload(bench, cell)
    return run.execute(cell, seed, seconds, True, device,
                       model=small_model(w["config"]),
                       mix=small_mix(manifest.traffic_file(w["traffic"])))


@pytest.mark.parametrize("cell", ["granite-moe-3b-a800m.batch",
                                  "olmo-1b.train"])
def test_traced_cpu_runs_read_none_and_raise_nothing(cell):
    out = _traced(cell, torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert not set(NEW) & set(out["metrics"])


@pytest.mark.gpu
def test_traced_granite_run_reads_attention_and_moe_on_the_card(cuda):
    out = _traced("granite-moe-3b-a800m.batch", cuda, seconds=3.0)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["attn_ms.batch"]["value"] > 0
    assert m["moe_ms.batch"]["value"] > 0
    assert m["idle_decode_ms.batch"]["value"] >= 0
    assert m["idle_host_ms.batch"]["value"] >= 0
