"""Threefry-2x32 counter-based random numbers in torch integer ops: the
reference's `jax.random` draws, bit for bit, for the sampler.

The reference samples with `jax.random.gumbel(fold_in(fold_in(key(seed),
step), shard))` under partitionable threefry (its launch/steps.py turns
`jax_threefry_partitionable` on).  This module repeats that algorithm:

  key(seed)          the raw key (seed >> 32, seed & 0xFFFFFFFF); the
                     reference's lanes carry int32 seeds, so the high word
                     is 0 and the low word is the seed modulo 2^32;
  fold_in(key, d)    threefry2x32(key, (0, d));
  random_bits        partitionable 32-bit bits: counters (hi, lo) of a
                     uint64 iota over the shape, bits = out_hi ^ out_lo;
  uniform            mantissa bits (bits >> 9 | 0x3F800000) viewed as
                     float32, minus 1, scaled to [minval, 1), clamped below
                     at minval;
  gumbel             the "low" mode: -log(-log(uniform(tiny, 1))), the two
                     logs taken in float64 and rounded once to float32, so
                     the card and the CPU give the same bits (their float32
                     logs differ in the last bit); against XLA's float32
                     logs the noise differs by at most an ulp or two.

torch has no full uint32 arithmetic on CUDA, so every word is carried in an
int64 tensor and masked to 32 bits after each add and shift.  Keys are
tensors of any batch shape; everything runs vectorised on the keys' device
and makes no tensor from host data, so it can run inside a captured CUDA
graph.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on int64-carried uint32
    words; all four operands broadcast.  -> (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed):
    """Raw keys (k1, k2) for int32 seeds (a tensor; a Python int makes a
    0-dim CPU key)."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor(seed)
    s = seed.to(torch.int64)
    return torch.zeros_like(s), s & MASK32


def fold_in(k, data):
    """Fold the 32-bit `data` (broadcasts against the key) into key `k`."""
    k1, k2 = k
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & MASK32
    else:
        d = torch.full_like(k1, data & MASK32)
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def random_bits(k, n: int):
    """[..., n] uint32 bits (carried in int64) of a key batch [...]."""
    k1, k2 = k
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    hi = torch.zeros_like(lo)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], hi, lo)
    return b1 ^ b2


def uniform(k, n: int, *, minval: float = 0.0):
    """[..., n] float32 uniforms in [minval, 1)."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # minval and 1 - minval rounded to float32 as the reference rounds them
    lo = np.float32(minval)
    scale = np.float32(1.0) - lo
    return torch.clamp(floats * float(scale) + float(lo), min=float(lo))


def gumbel(k, n: int):
    """[..., n] float32 Gumbel(0, 1) noise."""
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(k, n, minval=tiny).double()
    return (-torch.log(-torch.log(u))).float()
