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
# fails when one does not or one is missing.
def _variants(k2_hmma=(8, 8, 8, 8)):
    names = [f"k1_bitmap_spmm_kernel_{i}" for i in range(8)]
    names += [f"k2_flash_attention_kernel_{i}" for i in range(8)]
    names += [f"k2_flash_attention_mma_{d}" for d in range(len(k2_hmma))]
    names += [f"block_sparse_mma_wide_{i}" for i in range(4)]
    names += [f"nm_spmm_mma_wide_{i}" for i in range(4)]
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
                    "K3 / K4": (8, 0, 8)}


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
    q, k, v = _attn_inputs(torch.bfloat16, s=64, d=32)
    res = smoke.time_attention("rehearsal", q, k, v, None)
    assert "fma" in paths and res["path"] == "tensor"
    assert res["fma_path_ms"] > 0 and res["ms"] > 0 and res["bound_ms"] > 0
