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
