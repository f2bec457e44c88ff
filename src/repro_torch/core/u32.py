"""Unsigned 32-bit words on top of torch's signed integer types.

Every u32 word of the port (wire words, table keys/values/status,
hashes) is stored as an **int32 bit-view**: torch's uint32 tensors have
no add, shift, scatter, sum or remainder on the CPU, and gloo refuses
them.  Equality, ``&``, ``|`` and ``^`` act on the bits and work on the
views unchanged.  Arithmetic that must wrap modulo 2**32 (multiplies,
right shifts, ``%``) runs on int64 copies holding the unsigned value and
is masked back with :func:`to_i32`.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_TWO31 = 1 << 31
_TWO32 = 1 << 32


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """Unsigned value of 32-bit words as int64 in ``[0, 2**32)``."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor, as an int32 bit-view."""
    x = x & M32
    return torch.where(x >= _TWO31, x - _TWO32, x).to(torch.int32)


def i32(value: int) -> int:
    """Python int with the int32 bit pattern of the u32 ``value``."""
    value &= M32
    return value - _TWO32 if value >= _TWO31 else value


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in ``[0, 2**32)`` and u32 ``c``.

    The product is split at 16 bits so no intermediate leaves int64's
    range (a plain 32x32-bit product can reach 2**64).
    """
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32
