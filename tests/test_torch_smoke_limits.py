"""``chip_smoke.py``'s phase-5 limit (``scaled_compare``) on the CPU.

The limit must pass what the kernels legitimately differ by (attention's
p rounded to bf16 before the PV product, a float32 sum taken in another
order) and fail a zero output, an attention output missing one KV tile,
and a product missing one K block.  Inputs are made from a seed.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from test_torch_threads import one_torch_thread  # noqa: F401  (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _attention(q, k, v, dropped=None):
    """Causal attention as the kernel rounds it: p = exp(s - max) cast to
    v's type before the PV product, sums in float32; ``dropped`` (lo, hi,
    from_row) masks keys lo..hi-1 for rows from ``from_row`` on."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    rows = torch.arange(q.shape[2])[:, None]
    cols = torch.arange(k.shape[2])[None, :]
    live = rows >= cols
    if dropped is not None:
        lo, hi, from_row = dropped
        live &= ~((rows >= from_row) & (cols >= lo) & (cols < hi))
    s = s.masked_fill(~live, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return ((p.to(v.dtype).float() @ v.float())
            / p.sum(-1, keepdim=True)).to(q.dtype)


def _attn_inputs(dtype, s=512, d=64):
    r = np.random.default_rng(0)
    return [torch.from_numpy(r.standard_normal((1, 4, s, d)).astype(
        np.float32)).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("case", ["rounded", "zero", "one_tile_missing"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_attention_limit(smoke, case, dname):
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dname]
    q, k, v = _attn_inputs(dtype)
    plain = ref.attention_ref(q, k, v)
    rms = plain.float().square().mean(-1, keepdim=True).sqrt()
    fixed = smoke.ATTN_ATOL[dtype]
    if case == "rounded":
        _, used, zero = smoke.scaled_compare("K2", _attention(q, k, v),
                                             plain, fixed, rms)
        assert used <= 1.0 and zero > 0.9
    else:
        out = (torch.zeros_like(plain) if case == "zero"
               else _attention(q, k, v, dropped=(64, 128, 448)))
        with pytest.raises(AssertionError, match="differs from plain"):
            smoke.scaled_compare("K2", out, plain, fixed, rms)


@pytest.mark.parametrize("case", ["reordered", "zero", "one_block_missing"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_matmul_limit(smoke, case, dname):
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dname]
    r = np.random.default_rng(1)
    k = 2048
    x = torch.from_numpy(r.standard_normal((130, k)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(0.02 * r.standard_normal((k, 512)).astype(
        np.float32)).to(dtype).float()
    plain = (x.float() @ w).to(dtype)
    rms = plain.float().square().mean().sqrt()
    fixed = smoke.ATOL[dtype] * k ** 0.5
    h = k // 2
    if case == "reordered":
        out = (x[:, h:].float() @ w[h:] + x[:, :h].float() @ w[:h]).to(dtype)
        _, used, zero = smoke.scaled_compare("K3", out, plain, fixed, rms)
        assert used <= 1.0 and zero > 0.9
    else:
        out = (torch.zeros_like(plain) if case == "zero" else
               (x.float() @ w - x[:, :64].float() @ w[:64, :]).to(dtype))
        with pytest.raises(AssertionError, match="differs from plain"):
            smoke.scaled_compare("K3", out, plain, fixed, rms)


# Phase 1's check of the built variants (``check_variants``), rehearsed on
# made-up SASS counts: it passes when every tensor-core variant of K2
# (bf16, one per head dim) and of K3 / K4 (bf16 wide M) runs HMMA, and
# fails when one does not or one is missing; decode attention's variants
# are listed with no tensor-core requirement.
def _variants(k2_hmma=(8, 8, 8, 8)):
    names = [f"k1_bitmap_spmm_kernel_{i}" for i in range(8)]
    names += [f"k2_flash_attention_kernel_{i}" for i in range(8)]
    names += [f"k2_flash_attention_mma_{d}" for d in range(len(k2_hmma))]
    names += [f"block_sparse_mma_wide_{i}" for i in range(4)]
    names += [f"nm_spmm_mma_wide_{i}" for i in range(4)]
    names += [f"decode_attention_split_{i}" for i in range(10)]
    names += ["decode_attention_combine"]
    sass = {n: dict.fromkeys(("HMMA", "LDSM", "LDGSTS", "BAR"), 0)
            for n in names}
    for d, hmma in enumerate(k2_hmma):
        sass[f"k2_flash_attention_mma_{d}"]["HMMA"] = hmma
    for n in names:
        if "mma_wide" in n:
            sass[n]["HMMA"] = 48
    report = {n: (96, 0) for n in names}
    return report, sass, {n: n for n in names}


def test_phase1_check_passes_tensor_variants(smoke):
    seen = smoke.check_variants(*_variants())
    assert seen == {"K1 / K1g": (8, 0, 0), "K2": (12, 0, 4),
                    "K3 / K4": (8, 0, 8), "decode attention": (11, 0, 0)}


@pytest.mark.parametrize("k2_hmma", [(8, 8, 0, 8), (8, 8, 8)])
def test_phase1_check_fails_a_k2_variant_without_hmma(smoke, k2_hmma):
    with pytest.raises(AssertionError):
        smoke.check_variants(*_variants(k2_hmma))


def test_phase5_times_the_fma_body_beside_the_tensor_path(smoke,
                                                          monkeypatch):
    """``time_attention`` on the CPU with the timers and the kernel
    wrapper faked: it times the planned path through the kernel layer and
    the FMA body through the wrapper with ``path="fma"``, and reports
    both."""
    from repro_torch.kernels import flash_attention
    paths = []

    def fake(q, k, v, *, causal=True, window=None, path=None):
        paths.append(path)
        return ref.attention_ref(q, k, v, causal=causal, window=window)

    def once(fn, reps):
        fn()
        return 1.0

    monkeypatch.setattr(flash_attention, "flash_attention", fake)
    monkeypatch.setattr(smoke, "graph_ms", once)
    monkeypatch.setattr(smoke, "time_ms", once)
    monkeypatch.setattr(smoke, "_sdpa_backend", lambda *a: "MATH")
    # two input sets, not the ~950 that keep a card's replay past its L2
    monkeypatch.setattr(smoke, "_copies", lambda nbytes: 2)
    q, k, v = _attn_inputs(torch.bfloat16, s=64, d=32)
    res = smoke.time_attention("rehearsal", q, k, v, None)
    assert "fma" in paths and res["path"] == "tensor"
    assert res["fma_path_ms"] > 0 and res["ms"] > 0 and res["bound_ms"] > 0




def test_phase8_rehearsal_on_cpu(smoke, monkeypatch, capsys,
                                 one_torch_thread):
    """Phase 8 end to end on the CPU at smoke widths: the K1 / K1g / K2
    and decode-attention wrappers replaced by plain versions that count
    launches,
    ``ops.default_impl`` forced to "cuda", the timers, the profiler,
    memory stats and the no-dense-copy check stubbed.  Training, the
    parity and resume checks, K2 against ``scan_attention`` and serving
    the trained model all run, and 8d's K1 launches are its decode steps'
    (7 projections x 2 layers + the head)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import LAUNCHES, bitmap_spmm, flash_attention
    from repro_torch.kernels import decode_attention, ops

    def counting(name, plain):
        def fake(*args, **kw):
            kw.pop("path", None)
            LAUNCHES[name] += 1
            return plain(*args, **kw)
        return fake

    monkeypatch.setattr(bitmap_spmm, "bitmap_spmm",
                        counting("bitmap_spmm", ref.bitmap_spmm_ref))
    monkeypatch.setattr(bitmap_spmm, "bitmap_spmm_grouped",
                        counting("bitmap_spmm_grouped",
                                 ref.bitmap_spmm_grouped_ref))
    monkeypatch.setattr(flash_attention, "flash_attention",
                        counting("flash_attention", ref.attention_ref))
    monkeypatch.setattr(decode_attention, "decode_attention",
                        counting("decode_attention",
                                 decode_attention.decode_attention_ref))
    monkeypatch.setattr(ops, "default_impl", lambda x: "cuda")
    monkeypatch.setattr(smoke, "sync", lambda: None)
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "assert_no_dense_copy", lambda eng: None)
    monkeypatch.setattr(smoke, "profile_device",
                        lambda run, steps: [run() for _ in range(steps)]
                        and None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 0)
    cfg = get_smoke_config("olmo-1b")
    cpu = torch.device("cpu")
    out = smoke.training_phase(cfg, cpu, torch.Generator().manual_seed(0),
                               "rehearsal", batch=4, seq=32, long_seq=64)
    rec, path = out["train"], out["bitmap_spmm"]
    assert len(rec["losses"]) == 12 + 4 and rec["timed_steps"] == 8
    assert rec["idle_share"] is None and rec["sparsity_blocks"] >= 0.499
    assert rec["mfu"] > 0 and rec["tokens_per_s"] > 0
    long = rec["long_seq"]
    assert long["seq"] == 64 and long["timed_steps"] == 3
    assert long["tokens_per_s"] > 0 and long["mfu"] > 0
    for r in (rec, long):
        assert r["fwd_bwd_ms"] == 1.0 and 0 <= r["update_share"] < 1
    assert path["launches_per_step"] == 7 * cfg.num_layers + 1
    assert path["launches"] == path["launches_per_step"] * path[
        "decode_steps"] > 0
    k5 = out["decode_attention"]
    assert k5["launches_per_step"] == cfg.num_layers
    assert k5["launches"] == k5["launches_per_step"] * k5["decode_steps"] \
        + k5["launches_per_prefill_call"] * k5["prefill_calls"] > 0
    text = capsys.readouterr().out
    for arch in smoke.TRAIN_ARCHS:
        assert f"{arch}-smoke train step, card against CPU" in text
    assert "restored and resumed equal the uninterrupted run" in text
    assert text.count("max |K2 - scan_attention|") == 2


@pytest.mark.parametrize("broken", [False, True])
def test_phase2_sharded_cases_launch_once_per_shard(smoke, monkeypatch,
                                                    one_torch_thread,
                                                    broken):
    """Phase 2's sharded cases on the CPU, the K1 / K1g wrappers replaced
    by counting plain versions: each product launches once per shard and
    agrees with the unsharded weight's plain version; a kernel that
    loses the last shard's output fails the phase."""
    from repro_torch.kernels import LAUNCHES, bitmap_spmm

    def counting(name, plain):
        def fake(x, w, out_dtype=None):
            LAUNCHES[name] += 1
            out = plain(x, w, out_dtype=out_dtype)
            # the last column shard's slice, or the last row shard's
            # partial product, comes back zero
            lost = broken and LAUNCHES[name] % 2 == 0
            return out.zero_() if lost else out
        return fake

    monkeypatch.setattr(bitmap_spmm, "bitmap_spmm",
                        counting("bitmap_spmm", ref.bitmap_spmm_ref))
    monkeypatch.setattr(bitmap_spmm, "bitmap_spmm_grouped",
                        counting("bitmap_spmm_grouped",
                                 ref.bitmap_spmm_grouped_ref))
    monkeypatch.setattr(smoke, "sync", lambda: None)
    gen, cpu = torch.Generator().manual_seed(0), torch.device("cpu")
    cases = (("qkvo", 256, 256, "col"), ("down", 512, 256, "row"))
    groups = (("gate_up", 64, 32, "col"), ("down", 32, 64, "row"))
    if broken:
        with pytest.raises(AssertionError, match="max |kernel - plain|"):
            smoke.sharded_against_plain(cpu, gen, cases, (1, 4))
        return
    before = dict(LAUNCHES)
    err = smoke.sharded_against_plain(cpu, gen, cases, (1, 4))
    err_g = smoke.sharded_against_plain(cpu, gen, groups, (1, 4), groups=5)
    assert err < 1e-3 and err_g < 1e-3
    # 2 cases x 2 rows x 2 types, 2 shards each
    assert LAUNCHES["bitmap_spmm"] - before["bitmap_spmm"] == 16
    assert (LAUNCHES["bitmap_spmm_grouped"]
            - before["bitmap_spmm_grouped"]) == 16


def test_train_flops_counts_olmo_at_full_width(smoke):
    """6·N·T plus the attention term, and the remat recompute apart, for
    olmo-1b at batch 4 x seq 512 (1.18 B parameters)."""
    from repro_torch.configs import get_config
    cfg = get_config("olmo-1b")
    n, t = cfg.param_count(), 4 * 512
    assert 1.17e9 < n < 1.19e9
    f = smoke.train_flops(cfg, 4, 512)
    attn = 16 * 16 * 128 * 512 * t
    assert f["model"] == 6 * n * t + 12 * attn
    head = 2048 * 50304
    assert f["remat"] == 2 * (n - head) * t + 4 * attn + 2 * head * t


@pytest.mark.parametrize("broken", [False, True])
def test_phase5b_decode_attention_rehearsal_on_cpu(smoke, monkeypatch,
                                                   one_torch_thread, broken):
    """Phase 5b on the CPU at small shapes, the decode-attention wrapper
    replaced by a counting plain version, ``ops.default_impl`` forced to
    "cuda", timers and the SDPA backend stubbed: it checks, counts two
    launches per shape and times every shape (a ring with cold lines
    among them); a kernel that drops the newest line of every slot fails
    it."""
    from repro_torch.kernels import LAUNCHES, decode_attention
    plain = decode_attention.decode_attention_ref

    def fake(q, kc, vc, pos, *, window=None, ring=False):
        LAUNCHES["decode_attention"] += 1
        if broken:
            pos = pos - 1
        return plain(q, kc, vc, pos, window=window, ring=ring)

    def once(fn, reps):
        fn()
        return 1.0

    monkeypatch.setattr(decode_attention, "decode_attention", fake)
    for name in ("graph_ms", "time_ms"):
        monkeypatch.setattr(smoke, name, once)
    monkeypatch.setattr(smoke, "sync", lambda: None)
    monkeypatch.setattr(smoke, "_sdpa_backend", lambda *a: "MATH")
    monkeypatch.setattr(smoke, "_copies", lambda nbytes: 2)
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "default_impl", lambda x: "cuda")
    cases = [("olmo-like", 4, 40, 4, 4, 32, None, False, 0, 39),
             ("granite-like", 6, 24, 6, 2, 16, None, False, 3, 10),
             ("gemma-like", 4, 16, 4, 2, 64, 16, True, 0, 63)]
    gen, cpu = torch.Generator().manual_seed(0), torch.device("cpu")
    if broken:
        with pytest.raises(AssertionError, match="differs from plain"):
            smoke.decode_attention_phase(None, None, None, cpu, gen,
                                         cases=cases)
        return
    out = smoke.decode_attention_phase(None, None, None, cpu, gen,
                                       cases=cases)
    path, err, timings = out["decode_attention"]
    assert path["launches"] == path["calls"] == 2 * len(cases)
    assert err == 0.0 and [t["shape"] for t in timings] == [
        c[0] for c in cases]
    assert all(t["bound_ms"] > 0 and t["valid_lines"] > 0 for t in timings)
