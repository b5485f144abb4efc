"""JAX's threefry PRNG on torch tensors: the port's own copy of the parts of
jax/_src/prng.py and jax/_src/random.py (jax 0.9.0) that seeded sampling
uses, in JAX's default configuration (32-bit seeds, partitionable threefry
bits, Gumbel mode "low").

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
function broadcasts over the leading dims, so a batch of per-slot keys
draws in one call. The words live in int64 because torch's uint32 lacks
CUDA shifts, adds and xors; every add is masked back to 32 bits. Nothing
here copies from the host or waits on the device, so the functions run
inside a captured CUDA graph; constants are Python scalars and counters
come from `torch.arange` on the key's device.

    key = PRNGKey(seed)                           # [2] on the CPU
    key = fold_in(fold_in(key, rid), ngen)        # the sampling key discipline
    u = uniform(key, (V,))                        # bit-equal to jax.random.uniform
    tok = categorical(key, logits)                # argmax(gumbel + logits)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.xla_math import log_f32

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                         # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000                   # the bits of 1.0f
TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash (jax/_src/prng.py:883, 20 rounds): key words
    (k1, k2) and counter words (x0, x1), broadcast together, each holding
    uint32 values in int64. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 [2] tensor. JAX turns a
    Python seed into an int32 in its default 32-bit mode, so the high word
    is 0 (the logical shift of a 32-bit value by 32) and a negative or
    wider seed keeps its low 32 bits (-1 gives 0xFFFFFFFF)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` (prng.py:1163): the hash of the
    counter pair ``threefry_seed(uint32(data)) = (0, data)`` under ``key``.
    ``data`` is an int or a tensor broadcasting against ``key[..., 0]``."""
    if torch.is_tensor(data):
        data = data.to(torch.int64) & MASK
    else:                      # a fill on the device: no tensor made from host data
        data = torch.full_like(key[..., 1], int(data) & MASK)
    y0, y1 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key of ``key``
    [..., 2] (result [..., *shape]): the partitionable form
    (prng.py:1184), the hash of the 64-bit iota's high and low words, its
    two output words xored."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    iota = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = (Ellipsis,) + (None,) * len(shape)
    b0, b1 = threefry_2x32(key[..., 0][lead], key[..., 1][lead], iota >> 32, iota & MASK)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (random.py:435): the top 23 bits as
    a mantissa under the exponent of 1.0, minus 1, scaled into [minval,
    maxval), then clamped below at minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> 9) | _ONE_F32_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in JAX's default "low" mode (random.py:1735):
    ``-log(-log(u))`` for u uniform in [tiny, 1). The log is XLA's CPU
    expansion on CPU tensors (`core.xla_math.log_f32`, so a CPU draw is the
    reference's bit for bit), the device's on CUDA."""
    return -log_f32(-log_f32(uniform(key, shape, TINY_F32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the first
    index of the largest ``gumbel + logits`` (the Gumbel-max draw), one per
    key. ``key`` [..., 2] matches ``logits`` [..., V]."""
    return torch.argmax(gumbel(key, logits.shape[-1:]) + logits, dim=-1)


def key_data(key: torch.Tensor) -> np.ndarray:
    """A key as the reference's raw ``uint32[..., 2]`` numpy data."""
    return key.cpu().numpy().astype(np.uint32)
