"""A replay of JAX's default pseudo-random stream, without JAX.

The JAX package draws the frames frontend's per-step embeddings from
``jax.random`` (``normal(fold_in(PRNGKey(seed + 0x5eed), step), (B, 1,
D))``).  This module computes the same keys and bits, and the same
normals to a few float32 ulps, so that the port serves the same tokens.

What it replays: JAX's default implementation, ``threefry2x32`` (the
Threefry-2x32 block cipher with 20 rounds) with
``jax_threefry_partitionable`` on, JAX 0.9.0's default:

* ``PRNGKey(s)`` is the pair (s >> 32, s & 0xFFFFFFFF);
* ``fold_in(k, d)`` is threefry(k, (0, d));
* ``random_bits(k, n)`` hashes the counters (0, i), i < n, and keeps
  out0 ^ out1;
* ``uniform(minval, maxval)``: the bits' top 23 become a float f in
  [1, 2), less 1, then ``max(minval, f·(maxval - minval) + minval)`` in
  float32;
* ``normal``: sqrt(2)·erfinv(u), u uniform in [nextafter(-1, 0), 1),
  erfinv by XLA's float32 polynomial (Giles, "Approximating the erfinv
  function");
* ``gumbel``: the default (low-range) form, ``-log(-log(u))`` with u
  uniform in [tiny, 1); ``categorical``: ``argmax(gumbel + logits)``.

A key is a pair of Python ints, so ``prng_key`` and ``fold_in`` hash
their two words on the host and launch nothing.  The bits and the
normals are computed on int64 tensors masked to 32 bits on the device
asked for, every constant a Python scalar, so a draw on the card makes
no round trip to the host.  The batched forms (``fold_in_rows``,
``categorical_rows``) take a (B, 2) int64 key tensor on the device, one
key per row, as ``jax.vmap`` over keys draws: the key words broadcast
against the counters, so B rows of V draws are one set of launches.
"""
from __future__ import annotations

import math
import struct
from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the normal's uniform low end, float32 nextafter(-1, 0), and the
# smallest normal float32, the Gumbel's uniform low end
_LO = -(1.0 - 2.0 ** -24)
_TINY = 2.0 ** -126

Key = Tuple[int, int]

# XLA's ErfInv32 coefficients, highest degree first: w < 5, then w >= 5
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under ``key``:
    the pair (out0, out1), each shaped as the counters (int64 tensors, or
    Python ints)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF)."""
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashed at (0, data)."""
    return threefry2x32(key, 0, data & _MASK)


def random_bits(key: Key, n: int,
                device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 in [0, 2**32) on
    ``device``: the counters (0, i) hashed, out0 ^ out1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    out0, out1 = threefry2x32(key, torch.zeros_like(i), i)
    return out0 ^ out1


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: w = -log1p(-x²), a degree-8 polynomial
    in w - 2.5 (w < 5) or sqrt(w) - 3, times x; ±inf at ±1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT[0], _ERFINV_GT[0])
    for lo, hi in zip(_ERFINV_LT[1:], _ERFINV_GT[1:]):
        p = torch.where(lt, lo, hi) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _f32(x: float) -> float:
    """``x`` rounded to the nearest float32."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _uniform_bits(bits: torch.Tensor, minval: float,
                  maxval: float) -> torch.Tensor:
    """``jax.random.uniform``'s float32 map of 32-bit draws: the top 23
    bits as f in [1, 2), less 1, then max(minval, f·(maxval - minval) +
    minval) with minval, maxval and their difference rounded to float32.
    XLA contracts the multiply-add into one rounding (a fused
    multiply-add), so it is computed here in float64, where the product
    of two float32 values is exact, and rounded to float32 once."""
    lo = _f32(minval)
    scale = _f32(_f32(maxval) - lo)
    # int64 -> int32 keeps the low 32 bits; then reinterpret as float32
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (f.double() * scale + lo).float().clamp_min(lo)


def uniform(key: Key, shape: Sequence[int],
            device: torch.device | str | None = None,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, math.prod(shape), device)
    return _uniform_bits(bits, minval, maxval).reshape(tuple(shape))


def normal(key: Key, shape: Sequence[int],
           device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` drawn on ``device``."""
    return math.sqrt(2.0) * _erfinv32(uniform(key, shape, device,
                                              minval=_LO))


def _gumbel_of(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def gumbel(key: Key, shape: Sequence[int],
           device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``, the default low-range
    form: -log(-log(u)), u uniform in [tiny, 1)."""
    return _gumbel_of(uniform(key, shape, device, minval=_TINY))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of
    float32 ``logits``: argmax(gumbel + logits), the first index of a
    tie."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return (g + logits).argmax(-1)


# --------------------------------------------------------------- batched ----


def fold_in_rows(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.fold_in)(keys, data)`` on the device: row b
    of the (B, 2) ``keys`` folded with ``data[b]``."""
    k0, k1 = keys[:, 0], keys[:, 1]
    out0, out1 = threefry2x32((k0, k1), torch.zeros_like(k0),
                              data.to(torch.int64) & _MASK)
    return torch.stack((out0, out1), dim=1)


def random_bits_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) draws, row b ``random_bits(keys[b], n)``, in one pass: the
    key words (B, 1) broadcast against the counters (1, n)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    out0, out1 = threefry2x32((keys[:, :1], keys[:, 1:]),
                              torch.zeros_like(i), i)
    return out0 ^ out1


def gumbel_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) float32 Gumbel draws, row b ``gumbel(keys[b], (n,))``."""
    return _gumbel_of(_uniform_bits(random_bits_rows(keys, n), _TINY, 1.0))


def categorical_rows(keys: torch.Tensor, logits: torch.Tensor
                     ) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)``: row b of the
    (B, V) float32 ``logits`` sampled under ``keys[b]``, on the device
    with no read back to the host."""
    return (gumbel_rows(keys, logits.shape[-1]) + logits).argmax(-1)
