"""The port's profiler ranges (``repro_torch.counting.span``): none opened
with no profiler running, telemetry on or off and in a train step;
under the CPU profiler every range named in ``SPANS``, nested where the
layers nest (kernels and attention inside the engine's decode or
prefill phase), one ``attn.decode`` per attention layer and one ``moe``
per MoE layer in a decode step, as many ``kernel.bitmap_spmm`` ranges as
the op counter counts products, ``train.grads`` then ``train.update``;
and the same tokens and losses with the profiler on as off.
"""
import contextlib
import re
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import counting
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.launch.counters import OpCounter
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as M
from repro_torch.serve import ServeEngine
from repro_torch.serve.telemetry import PHASES
from repro_torch.sparse.pruning import global_l1_prune, tree_map
from repro_torch.train import optimizer as opt_lib
from test_torch_threads import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("olmo-1b", "granite-moe-3b-a800m")
# the program's record names, as opposed to ATen's ("aten::mm") and
# autograd's ("MmBackward0")
PROGRAM = re.compile(r"^(kernel|attn|serve|train)\.|^moe$")


def _engine(arch, telemetry, tmp_path, slots=2):
    kw = {"metrics_out": str(tmp_path / "m.json")} if telemetry else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # a smoke head served dense
        eng = ServeEngine(get_smoke_config(arch), num_slots=slots,
                          max_len=32, sparsity=0.5, seed=0, device="cpu",
                          **kw)
    for i in range(slots):
        eng.submit([1 + i, 2, 3], 6)
    eng.warmup()
    eng.step()                 # every slot admitted and decoding
    return eng


def _train(steps=1):
    cfg = get_smoke_config("olmo-1b")
    params = global_l1_prune(
        M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"),
        0.5)
    masks = tree_map(lambda _, t: t != 0, params)
    step = build_train_step(cfg, opt_lib.OptConfig(lr=1e-2),
                            prune_masks=masks)
    opt = opt_lib.init(params)
    losses = []
    for i in range(steps):
        batch = pipeline.synth_batch(cfg, pipeline.DataConfig(2, 16), i)
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return losses


def _profiled(fn):
    """``fn()`` under the CPU profiler: (its result, the program's
    ranges as (name, start, end), by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events() if PROGRAM.match(e.name)),
                    key=lambda r: (r[1], -r[2]))
    return out, ranges


def _inside(r, outer):
    return any(o[1] <= r[1] and r[2] <= o[2] for o in outer)


def test_span_is_one_shared_noop_without_a_profiler():
    assert counting.span("attn.decode") is counting.span("moe")
    with profile(activities=[ProfilerActivity.CPU]):
        on = counting.span("moe")
    assert on is not counting.span("moe")
    assert {f"serve.{p}" for p in PHASES} <= counting.SPANS
    assert {f"kernel.{k}" for k in counting.KERNELS} <= counting.SPANS


class _CountingRange(contextlib.nullcontext):
    opened = 0

    def __init__(self, name):
        super().__init__()
        _CountingRange.opened += 1


@pytest.mark.parametrize("case", ["serve_off", "serve_on", "train"])
def test_no_range_is_opened_without_a_profiler(case, tmp_path,
                                               monkeypatch):
    if case == "train":
        run = _train
    else:
        eng = _engine("granite-moe-3b-a800m", case == "serve_on", tmp_path)
        assert (eng.spans is not None) == (case == "serve_on")
        run = eng.step
    _CountingRange.opened = 0
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        _CountingRange)
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _CountingRange)
    run()
    assert _CountingRange.opened == 0
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    assert _CountingRange.opened > 0          # the count sees records


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_ranges_nest_and_count_the_layers(arch, tmp_path):
    eng = _engine(arch, True, tmp_path)
    cfg = eng.cfg
    _, ranges = _profiled(eng.step)
    names = [r[0] for r in ranges]
    assert set(names) <= counting.SPANS
    assert names.count("serve.step") == 1
    decode = [r for r in ranges if r[0] == "serve.decode"]
    assert len(decode) == 1
    phases = [r for r in ranges if r[0] in ("serve.decode", "serve.prefill")]
    for r in ranges:
        if r[0] == "attn.decode" or r[0].startswith("kernel."):
            assert _inside(r, phases), r
        if r[0].startswith("serve.") and r[0] != "serve.step":
            assert _inside(r, [x for x in ranges if x[0] == "serve.step"])
    assert names.count("attn.decode") == cfg.num_layers
    moe_layers = cfg.num_layers if cfg.num_experts else 0
    assert names.count("moe") == moe_layers
    for r in ranges:
        if r[0] == "kernel.bitmap_spmm_grouped":
            assert _inside(r, [x for x in ranges if x[0] == "moe"])
    assert names.count("kernel.bitmap_spmm_grouped") == 3 * moe_layers
    # the same decode call under the op counter: one op per product
    with OpCounter() as c:
        eng._decode()
    counted = [n for n, _, _ in c.ops if n == "bitmap_spmm"]
    assert names.count("kernel.bitmap_spmm") == len(counted) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_attention_kernel_range_nests_in_attn_decode(arch, tmp_path):
    """``kernel.decode_attention`` is a program range, opened once per
    attention layer in a decode step, inside that layer's
    ``attn.decode``."""
    assert "kernel.decode_attention" in counting.SPANS
    eng = _engine(arch, False, tmp_path)
    _, ranges = _profiled(eng.step)
    kernel = [r for r in ranges if r[0] == "kernel.decode_attention"]
    attn = [r for r in ranges if r[0] == "attn.decode"]
    assert len(kernel) == len(attn) == eng.cfg.num_layers
    assert all(_inside(r, attn) for r in kernel)


def test_train_step_holds_grads_then_update_once_each():
    _, ranges = _profiled(_train)
    top = [r[0] for r in ranges if r[0].startswith("train.")]
    assert top == ["train.grads", "train.update"]
    grads, update = (r for r in ranges if r[0].startswith("train."))
    assert grads[2] <= update[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_profiler_changes_no_served_token(arch, tmp_path):
    served = []
    for profiled in (False, True):
        eng = _engine(arch, True, tmp_path)

        def drain(eng=eng):
            while eng.scheduler.has_work:
                eng.step()
        if profiled:
            _profiled(drain)
        else:
            drain()
        served.append([list(r.tokens) for r in eng.requests])
    assert served[0] == served[1] and all(served[0])


def test_profiler_changes_no_train_loss():
    plain = _train(steps=2)
    traced, _ = _profiled(lambda: _train(steps=2))
    assert traced == plain
