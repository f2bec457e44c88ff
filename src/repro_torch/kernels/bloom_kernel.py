"""Blocked Bloom filter kernels: ``hash_words`` and ``membership``.

Each wrapper launches its hand-written CUDA kernel (``csrc/bloom.cu``)
on CUDA tensors and takes its plain PyTorch version (the ``*_plain``
function beside it) only for CPU tensors.  The plain versions compute
what the JAX package's Bloom filter computes outside its Pallas kernels
(``repro/containers/bloom.py:74``, ``repro/kernels/ops.py:253-262``),
bit for bit; u32 words are int32 bit-views.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import double_hash
from repro_torch.kernels.binning import require
from repro_torch.kernels.build import Kernel, register
from repro_torch.kernels.ref import bloom_words_ref

_I32 = torch.int32
_P, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

_HASH_WORDS = register("hash_words", Kernel(
    "bloom", "hash_words_launch", [_P, _LL, _LL, _INT, _INT, _P]))
_MEMBERSHIP = register("membership", Kernel(
    "bloom", "membership_launch", [_P, _P, _P, _LL, _P]))


def hash_words_plain(lanes: torch.Tensor, k: int) -> torch.Tensor:
    """(M, L) u32 item lanes -> (M, 2) [lo, hi] 64-bit block words with
    the item's k double-hashed bits set."""
    return bloom_words_ref(double_hash(lanes, k, 64), k)


def hash_words(lanes: torch.Tensor, k: int) -> torch.Tensor:
    """Bloom block words of each item; CUDA: one thread per item."""
    if not lanes.is_cuda:
        return hash_words_plain(lanes, k)
    if (lanes.dtype != _I32 or lanes.ndim != 2
            or (lanes.shape[0] and lanes.shape[1] > 1 and lanes.stride(1) != 1)):
        raise ValueError(f"hash_words lanes: want (M, L) int32 rows of contiguous "
                         f"words, got {lanes.dtype} {tuple(lanes.shape)} strides "
                         f"{lanes.stride()}")
    if not 1 <= k <= 64:
        raise ValueError(f"hash_words: k={k} bits do not fit a 64-bit block")
    m, num_lanes = lanes.shape
    out = torch.empty((m, 2), dtype=_I32, device=lanes.device)
    _HASH_WORDS(lanes, lanes.stride(0), m, num_lanes, k, out)
    return out


def membership_plain(prior: torch.Tensor, words: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """already_present = all bits of ``words`` set in ``prior``, for
    valid items; (M,) bool."""
    return ((prior & words) == words).all(dim=1) & valid


def membership(prior: torch.Tensor, words: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Membership of each item's bits in its prior block word; CUDA: one
    thread per item."""
    if not prior.is_cuda:
        return membership_plain(prior, words, valid)
    m = prior.shape[0]
    for t, name in ((prior, "prior"), (words, "words")):
        require(t, f"membership {name}", _I32, (m, 2), prior.device)
        if t.data_ptr() % 8:
            raise ValueError(f"membership {name}: rows must be 8-byte aligned")
    require(valid, "membership valid", torch.bool, (m,), prior.device)
    out = torch.empty(m, dtype=torch.bool, device=prior.device)
    _MEMBERSHIP(prior, words, valid, m, out)
    return out
