"""Port's flash_attention (its plain version, on the CPU) against the JAX
package's Pallas kernel (interpret mode) and oracle, on the reference's
sweep at B = 2.  Tolerances are the reference sweep's: atol 2e-3
(float32), 5e-2 (bfloat16)."""
import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.flash_attention import flash_attention as ref_kernel
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels.flash_attention import live_pairs

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATOL = {"float32": 2e-3, "bfloat16": 5e-2}


def _inputs(b, hq, hkv, sq, skv, d, dname, seed):
    r = np.random.default_rng(seed)
    arrays = [r.standard_normal(s).astype(np.float32)
              for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    jdt, tdt = DTYPES[dname]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(a, b, dname):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=ATOL[dname])


@pytest.mark.parametrize("hq,hkv,s,d,window", [
    (4, 4, 128, 64, None),
    (4, 2, 256, 64, None),
    (8, 1, 128, 128, None),
    (4, 2, 256, 64, 64),
    (2, 2, 128, 32, 16),
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_flash_attention_sweep(hq, hkv, s, d, window, dname):
    (rq, rk, rv), (q, k, v) = _inputs(2, hq, hkv, s, s, d, dname,
                                      seed=hash((hq, s, d, window or 0))
                                      % 2**32)
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert LAUNCHES["flash_attention"] == 0     # CPU: the plain version
    assert out.dtype == q.dtype and out.shape == q.shape
    got = out.float().numpy()
    _close(got, ref_kernel(rq, rk, rv, causal=True, window=window, bq=64,
                           bkv=64, interpret=True), dname)
    _close(got, ref_ref.attention_ref(rq, rk, rv, causal=True,
                                      window=window), dname)


@pytest.mark.parametrize("sq,skv,d,causal,window", [
    (100, 100, 64, True, None),      # ragged: no multiple of any tile
    (60, 90, 32, False, 16),         # Sq != Skv, window without causal
    (70, 50, 32, True, 8),           # rows with no live key at all
    (33, 33, 256, True, 5),          # gemma3's head dim
])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_flash_attention_any_length_matches_oracle(sq, skv, d, causal, window,
                                                   dname):
    """Lengths the Pallas kernel does not take (it asserts S % tile == 0)
    against the reference's oracle."""
    (rq, rk, rv), (q, k, v) = _inputs(1, 4, 2, sq, skv, d, dname, seed=sq)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    _close(out.float().numpy(), ref_ops.flash_attention(
        rq, rk, rv, impl="xla", causal=causal, window=window), dname)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (128, 128, True, None), (100, 100, True, 16), (60, 90, False, 16),
    (70, 50, True, 8), (64, 64, False, None)])
def test_live_pairs_counts_the_mask(sq, skv, causal, window):
    """The bound's operation count: the pairs the reference's mask keeps."""
    q = np.arange(sq)[:, None]
    kp = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= q >= kp
    if window is not None:
        mask &= (q - kp) < window
    assert live_pairs(sq, skv, causal, window) == int(mask.sum())


def test_flash_attention_rejects_unknown_impl():
    q = torch.zeros(1, 1, 4, 32)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, q, q, impl="pallas")
