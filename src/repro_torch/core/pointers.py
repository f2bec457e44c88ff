"""Global pointers (paper section 3), PyTorch port.

A BCL global pointer is ``(rank, offset)`` into that rank's shared memory
segment; here a segment is a container shard.  A ``GlobalPointer`` is a
pair of int32 tensors, so pointers can be stored inside other
containers and moved through the exchange engine like any other data.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GlobalPointer(NamedTuple):
    """(rank, offset) pair; both int32 tensors of matching shape."""

    rank: torch.Tensor
    offset: torch.Tensor

    def __add__(self, n) -> "GlobalPointer":
        return GlobalPointer(self.rank, self.offset + int(n))

    def __sub__(self, n) -> "GlobalPointer":
        return GlobalPointer(self.rank, self.offset - int(n))

    def is_null(self) -> torch.Tensor:
        return self.rank < 0

    @staticmethod
    def null(shape=(), device="cpu") -> "GlobalPointer":
        return GlobalPointer(torch.full(shape, -1, dtype=torch.int32, device=device),
                             torch.zeros(shape, dtype=torch.int32, device=device))


def global_index(ptr: GlobalPointer, local_n: int) -> torch.Tensor:
    """Flatten (rank, offset) to a global element index."""
    return ptr.rank * local_n + ptr.offset


def from_global_index(idx: torch.Tensor, local_n: int) -> GlobalPointer:
    """Split a global element index into (rank, offset) for block layout."""
    idx = idx.to(torch.int32)
    return GlobalPointer(idx // local_n, idx % local_n)
