"""Threefry-2x32 counter-based random numbers in torch integer ops.

The draws of ``jax.random`` that the decode engine's sampler takes, bit
for bit, on any torch device: ``threefry2x32`` (Random123's 20-round
Threefry-2x32, as ``jax._src.prng._threefry2x32_lowering``),
:func:`prng_key` (``jax.random.PRNGKey`` of a 32-bit seed),
:func:`fold_in`, :func:`split` (``jax.random.split``: key ``i`` is
the hash of the counter pair ``(i >> 32, i & 0xFFFFFFFF)``, both output
words kept), :func:`random_bits` (32 bits per element, the
``jax_threefry_partitionable`` layout: element ``i`` of the flattened
shape hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and keeps the
xor of the two output words), :func:`uniform` (f32: the top 23 bits
become the mantissa of a float in [1, 2), minus 1), :func:`bernoulli`
(``uniform < p``) and :func:`gumbel` (``mode="low"``: ``-log(-log(u))``
over ``uniform(tiny, 1)``).

A key is an int64 tensor whose last axis holds the two 32-bit words; a
batch of keys is ``(..., 2)``. torch has no full uint32 arithmetic on
CUDA, so every word lives in an int64 and each add, rotate and xor is
masked back to 32 bits. The bits and the uniform floats are exact; the
Gumbel transform's two logarithms may differ from XLA's by an ulp.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
#: the Threefry key-schedule parity constant
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal number, ``jnp.finfo(jnp.float32).tiny``
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under key
    ``(k1, k2)``; int64 tensors holding 32-bit values, broadcast
    together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    y = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y = (y + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, y


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 32-bit seeds: ``(0, seed mod
    2**32)``, shape ``seed.shape + (2,)``."""
    s = torch.as_tensor(seed, device=device).to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(s), s], -1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed over the counter pair
    ``(0, data mod 2**32)``; ``key`` (..., 2), ``data`` broadcast to the
    batch shape."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key of a batch ``(..., 2)``: the
    ``num`` new keys ``(..., num, 2)``."""
    idx = torch.arange(int(num), dtype=torch.int64, device=key.device)
    k1 = key[..., 0].unsqueeze(-1)
    k2 = key[..., 1].unsqueeze(-1)
    o0, o1 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return torch.stack([o0, o1], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key of a batch
    ``(..., 2)``: an int64 tensor ``key.shape[:-1] + shape`` of values
    below 2**32."""
    shape = tuple(int(n) for n in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(*batch, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*batch, *([1] * len(shape)))
    b1, b2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & MASK).reshape(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 over [minval, maxval): the top 23
    bits as the mantissa of [1, 2), minus 1, then ``floats * (maxval -
    minval) + minval`` floored at ``minval``. XLA contracts that multiply
    and add into one fused rounding; here the product of two f32 values
    is exact in f64 and the sum is rounded from there."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    span = (hi - lo).double()
    scaled = (floats.double() * span + lo.double()).float()
    return torch.maximum(lo, scaled)


def bernoulli(key: torch.Tensor, p: torch.Tensor,
              shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli`` with an f32 ``p``: a bool tensor
    ``key.shape[:-1] + shape``, ``uniform(key, shape) < p``; ``p`` (0-d,
    or one per key of the batch) broadcasts over ``shape``."""
    u = uniform(key, shape)
    p = p.float().reshape(p.shape + (1,) * len(tuple(shape)))
    return u < p


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(mode="low")`` in f32."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row:
    the first index of the largest Gumbel-perturbed logit. ``key``
    ``(rows, 2)``, ``logits`` (rows, V) f32."""
    return (gumbel(key, logits.shape[-1:]) + logits).argmax(-1)
