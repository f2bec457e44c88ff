"""Vectorized integer hashing for BCL containers (PyTorch port).

Bit-identical to ``repro.core.hashing``, which runs in wrapping u32
arithmetic (JAX keeps x64 off).  Inputs are 32-bit word tensors (int32
bit-views or uint32); results are int32 bit-views of the u32 hashes.
The ``*_u64`` variants return the unsigned value as int64 for callers
that go on doing u32 arithmetic.
"""

from __future__ import annotations

import torch

from repro_torch.core.u32 import M32, as_u64, mul32, to_i32

# murmur3 fmix32 constants
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
# golden-ratio stream-mixing constant
_PHI = 0x9E3779B9


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, _C1)
    h = h ^ (h >> 13)
    h = mul32(h, _C2)
    return h ^ (h >> 16)


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche mix of a u32 lane."""
    return to_i32(_fmix64(as_u64(h)))


def hash_u32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash u32 lanes with a seed (vectorized)."""
    return to_i32(_fmix64(as_u64(x) ^ ((seed * _PHI + 1) & M32)))


def hash_lanes_u64(lanes: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """:func:`hash_lanes` as unsigned int64 values."""
    if lanes.ndim == 1:
        lanes = lanes[:, None]
    n, num_lanes = lanes.shape
    h = torch.full((n,), (seed * _PHI + num_lanes) & M32, dtype=torch.int64,
                   device=lanes.device)
    for i in range(num_lanes):
        h = (mul32(h ^ _fmix64(as_u64(lanes[:, i])), _C1) + (i + 1)) & M32
    return _fmix64(h)


def hash_lanes(lanes: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash a (N, L) u32 lane matrix to one u32 per row.

    Horner-style stream mix over lanes followed by the avalanche
    finalizer, as in ``repro.core.hashing.hash_lanes``.
    """
    return to_i32(hash_lanes_u64(lanes, seed))


def double_hash(lanes: torch.Tensor, k: int, modulo: int) -> torch.Tensor:
    """k hash values per row in [0, modulo) via double hashing.

    Returns (N, k) u32 words (int32 view).  ``h2`` is forced odd so that
    for power-of-two ``modulo`` the probe sequence visits distinct slots.
    """
    h1 = hash_lanes_u64(lanes, seed=1)
    h2 = hash_lanes_u64(lanes, seed=2) | 1
    i = torch.arange(k, dtype=torch.int64, device=lanes.device)[None, :]
    hk = (h1[:, None] + i * h2[:, None]) & M32
    return to_i32(hk % modulo)
