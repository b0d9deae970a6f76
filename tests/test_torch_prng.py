"""Port's replay of JAX's default PRNG (``repro_torch.prng``) against
``jax.random`` itself: keys, ``fold_in`` and the 32-bit draws bit-equal,
normals within 4 float32 ulps (the replay computes XLA's ``erf_inv``
polynomial in torch, whose ``log1p`` and ``sqrt`` may round apart),
uniforms over any range bit-equal, Gumbels within 1e-6 (torch's and
XLA's ``log`` may round apart) and categorical draws equal, one key at a
time and batched over rows of keys as ``jax.vmap`` draws.

The seeds are the frames frontend's: ``PRNGKey(seed + 0x5eed)`` for
seed 0, 3 and the largest int32 seed, folded with the steps 0, 1, 17
and 10**6.
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference these tests hold the port against;
# the card's machine has no JAX, and runs tests/test_torch_cuda.py
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch import prng

SEEDS = (0, 3, 2**31 - 1 - 0x5eed)
STEPS = (0, 1, 17, 10**6)


def _ordinal(a: np.ndarray) -> np.ndarray:
    """float32 values as integers that count ulps across zero."""
    i = a.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_bits_bit_equal(seed):
    key = jax.random.PRNGKey(seed + 0x5eed)
    pkey = prng.prng_key(seed + 0x5eed)
    assert all(type(w) is int for w in pkey)
    np.testing.assert_array_equal(np.asarray(key, np.int64), pkey)
    for step in STEPS:
        k, pk = jax.random.fold_in(key, step), prng.fold_in(pkey, step)
        assert all(type(w) is int for w in pk)
        np.testing.assert_array_equal(np.asarray(k, np.int64), pk,
                                      err_msg=f"fold_in step {step}")
        bits = jax.random.bits(k, (1537,), jnp.uint32)
        np.testing.assert_array_equal(np.asarray(bits, np.int64),
                                      prng.random_bits(pk, 1537).numpy(),
                                      err_msg=f"bits step {step}")


@pytest.mark.parametrize("shape", [(4, 1, 1536), (2, 1, 64)])
@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_four_ulps(seed, shape):
    key = jax.random.PRNGKey(seed + 0x5eed)
    pkey = prng.prng_key(seed + 0x5eed)
    for step in STEPS:
        want = np.asarray(jax.random.normal(jax.random.fold_in(key, step),
                                            shape, jnp.float32))
        got = prng.normal(prng.fold_in(pkey, step), shape, device="cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        ulps = np.abs(_ordinal(got.numpy()) - _ordinal(want))
        assert ulps.max() <= 4, (step, int(ulps.max()))
        # most draws are exact: only the polynomial's last roundings part
        assert (ulps == 0).mean() > 0.8, (step, (ulps == 0).mean())


def test_uniform_edges_and_erfinv_poles():
    """The uniform's low end is nextafter(-1, 0), as ``jax.random``
    clamps it, and erfinv(±1) is ±inf."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = prng.uniform(prng.prng_key(7), (4096,), device="cpu", minval=lo)
    want = jax.random.uniform(jax.random.PRNGKey(7), (4096,), jnp.float32,
                              lo, 1.0)
    np.testing.assert_array_equal(u.numpy(), np.asarray(want))
    assert float(u.min()) >= lo and float(u.max()) < 1.0
    poles = prng._erfinv32(torch.tensor([-1.0, 1.0, 0.0]))
    assert poles.tolist() == [float("-inf"), float("inf"), 0.0]


TINY = float(np.finfo(np.float32).tiny)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (TINY, 1.0), (-3.5, 2.25),
                                   (1e-3, 7.0)])
def test_uniform_range_bit_equal(lo, hi):
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        pkey = prng.fold_in(prng.prng_key(seed), 5)
        want = jax.random.uniform(key, (3, 777), jnp.float32, lo, hi)
        got = prng.uniform(pkey, (3, 777), device="cpu", minval=lo,
                           maxval=hi)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


V_HEAD = 50304          # olmo-1b's vocabulary: the sampler's draw size


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_1e6(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = np.asarray(jax.random.gumbel(key, (V_HEAD,), jnp.float32))
    got = prng.gumbel(prng.fold_in(prng.prng_key(seed), 11), (V_HEAD,),
                      device="cpu").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # most are bit-equal: only log's last rounding parts them
    assert (got == want).mean() > 0.5


def test_categorical_equal_indices_one_and_batched():
    """64 seeded rows of logits: ``categorical`` per key, and
    ``categorical_rows`` with keys folded per row on the device, give
    ``jax.random.categorical``'s indices (vmapped as the serve step
    draws)."""
    rng = np.random.default_rng(0)
    rows, vocab = 64, 1000
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, rows)
    pos = rng.integers(0, 4096, rows).astype(np.int32)
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    folded = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(pos))
    want = np.asarray(jax.vmap(jax.random.categorical)(folded,
                                                       jnp.asarray(logits)))
    pkeys = torch.tensor([prng.prng_key(int(s)) for s in seeds])
    pfold = prng.fold_in_rows(pkeys, torch.from_numpy(pos))
    np.testing.assert_array_equal(pfold.numpy(),
                                  np.asarray(folded, np.int64))
    got = prng.categorical_rows(pfold, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    one = [int(prng.categorical(prng.fold_in(prng.prng_key(int(s)), int(p)),
                                torch.from_numpy(logits[i])))
           for i, (s, p) in enumerate(zip(seeds, pos))]
    np.testing.assert_array_equal(one, want)
    bits = prng.random_bits_rows(pfold[:3], 257)
    for b in range(3):
        k = (int(pfold[b, 0]), int(pfold[b, 1]))
        assert torch.equal(bits[b], prng.random_bits(k, 257))
