"""Counter-based stateless RNG for per-pair noise.

Port of ``uammd_tpu/core/rng.py`` (reference: src/third_party/saruprng.cuh,
src/Interactor/Potential/DPD.cuh:106-120): a murmur3-style integer mix of
(pair, counter) words, so pair noise needs no stored state and is
symmetric in (i, j). The hashes equal the JAX package's bit for bit: torch
has no complete uint32 arithmetic, so the uint32 values are held in int64,
masked to 32 bits after each operation (shifts of non-negative values are
logical). Bulk noise comes from the state's ``torch.Generator`` instead.
"""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(m: int, a: torch.Tensor) -> torch.Tensor:
    """(m * a) mod 2^32 for uint32 values held in int64, through 16-bit
    halves of ``a`` so that no product passes 2^63."""
    return (m * (a & 0xFFFF) + (((m * (a >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer: avalanche a uint32."""
    h = h ^ (h >> 16)
    h = _mul32(0x85EBCA6B, h)
    h = h ^ (h >> 13)
    h = _mul32(0xC2B2AE35, h)
    return h ^ (h >> 16)


def _u32(w) -> torch.Tensor:
    """An integer word (tensor or int) as uint32 bits in int64."""
    return torch.as_tensor(w).to(torch.int64) & _MASK32


def hash_u32(*words) -> torch.Tensor:
    """Hash several integer words (broadcast) into uniform uint32 values,
    returned in int64."""
    h = torch.tensor(0x9E3779B9, dtype=torch.int64)
    for w in words:
        h = (_mul32(0x01000193, _mix(h ^ _u32(w))) + 0x6A09E667) & _MASK32
    return _mix(h)


def pair_counter(i, j) -> torch.Tensor:
    """Symmetric pair counter: the same value for (i, j) and (j, i) (the
    order taken on the signed words, as JAX takes it before its cast)."""
    i, j = torch.as_tensor(i), torch.as_tensor(j)
    return hash_u32(torch.minimum(i, j), torch.maximum(i, j))


def uniform_from_bits(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint32 bits -> uniform in [0, 1)."""
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def pair_uniform(i, j, counter, dtype=torch.float32) -> torch.Tensor:
    """Uniform [0, 1) symmetric in (i, j), distinct per counter (e.g. step)."""
    return uniform_from_bits(hash_u32(pair_counter(i, j), counter), dtype)


def pair_normal(i, j, counter, dtype=torch.float32) -> torch.Tensor:
    """Standard normal, symmetric in (i, j), by Box-Muller on two hashes."""
    c = pair_counter(i, j)
    u1 = uniform_from_bits(hash_u32(c, counter, 0xDEADBEEF), dtype)
    u2 = uniform_from_bits(hash_u32(c, counter, 0xCAFEF00D), dtype)
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    # 2 pi rounded to the working dtype first, as JAX's asarray does
    two_pi = float(torch.tensor(2.0 * math.pi, dtype=dtype))
    return r * torch.cos(two_pi * u2)
