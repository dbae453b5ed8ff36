"""JAX's threefry2x32 random bits in PyTorch, bit for bit.

The JAX engine samples a request's token number ``count`` with Gumbel
noise drawn as ``jax.random.gumbel(fold_in(key(seed), count), (V,))``
(``flexflow_tpu/generation/engine.py::derive_keys`` / ``_sample``). This
module reproduces each piece of that chain for ``jax_threefry_partitionable``
on (the default of the JAX versions the repository targets):

* :func:`key` — ``jax.random.key(seed)`` for a 32-bit seed: the key words
  are ``(seed >> 32, seed & 0xFFFFFFFF)``, i.e. ``(0, seed mod 2**32)``;
* :func:`fold_in` — ``threefry2x32(key, (0, data))``;
* :func:`random_bits` — 32-bit bits over the partitionable counter layout:
  element ``i`` hashes the 64-bit counter ``(hi, lo) = (0, i)`` and keeps
  ``bits1 ^ bits2``;
* :func:`uniform` — the mantissa construction: ``(bits >> 9) | 0x3F800000``
  bit-cast to float32, minus 1, scaled to ``[minval, maxval)`` with one
  rounding (as XLA's fused multiply-add rounds), clamped below by
  ``minval``;
* :func:`gumbel` — the default ("low") mode, ``-log(-log(u))`` with ``u``
  uniform on ``[tiny, 1)``.

Everything is integer arithmetic except the two logarithms, so keys, bits
and uniforms equal JAX's exactly; Gumbel values agree to the last ulp or
two of float32 ``log``. uint32 is emulated in int64 tensors (sums taken
mod 2**32, rotations and xors on the low 32 bits), so the functions run
on any device and batch over a leading axis of keys. On a CUDA device they
launch kernels only (constants go in as kernel arguments, never as host
copies), so a CUDA graph can capture them inside an engine step.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY32 = torch.finfo(torch.float32).tiny

Key = Tuple[torch.Tensor, torch.Tensor]  # (k1, k2), int64 tensors of uint32 values


def _u32(x) -> torch.Tensor:
    return x & MASK32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcast int64 tensors holding uint32 values; returns (y0, y1)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def key(seed: Union[int, torch.Tensor]) -> Key:
    """``jax.random.key(seed)`` for 32-bit seeds (batched over a tensor of
    seeds). Seeds fold as 32-bit values, as the engine folds them: a
    negative int32 seed keeps its bit pattern."""
    s = torch.as_tensor(seed, dtype=torch.int64)
    return torch.zeros_like(s), _u32(s)


def fold_in(k: Key, data: Union[int, torch.Tensor]) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashed at the counter
    ``(0, data mod 2**32)``."""
    k1, k2 = k
    if isinstance(data, int):
        d = torch.full_like(k1, data & MASK32)
    else:
        d = _u32(torch.as_tensor(data, dtype=torch.int64, device=k1.device))
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def random_bits(k: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` under the partitionable
    layout: int64 [*batch, *shape] of uint32 values, batched over the
    keys' own shape."""
    k1, k2 = k
    n = 1
    for s in shape:
        n *= int(s)
    if n >= 2**32:
        raise ValueError("random_bits over 2**32 or more elements needs 64-bit counters")
    lo = torch.arange(n, dtype=torch.int64, device=k1.device).reshape(tuple(shape))
    expand = (...,) + (None,) * len(shape)
    b1, b2 = threefry2x32(k1[expand], k2[expand], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(
    k: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(k, shape)
    one = (bits >> 9) | 0x3F800000  # random mantissa under exponent 0
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    # the float32 bounds and their float32 difference, as host scalars
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    # XLA fuses floats * (hi - lo) + lo into one rounding (an FMA); the
    # float32 product is exact in float64, so round once from there
    scaled = (floats.double() * span + float(lo)).float()
    return scaled.clamp_min(float(lo))


def gumbel(k: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, default mode."""
    return -torch.log(-torch.log(uniform(k, shape, minval=TINY32, maxval=1.0)))
