"""BCL backends, PyTorch edition.

Container code is written once against a small primitive set (paper
section 8); a backend implements it.  The port ships two:

  SerialBackend        nprocs == 1, collectives are identities.  The
                       reference semantics, and the one-card main path.

  ProcessGroupBackend  one rank per process over ``torch.distributed``:
                       gloo on the CPU, NCCL on CUDA.  Wire words cross
                       the collectives as int32 (gloo refuses uint32).

The JAX package's ``Backend.all_to_all`` is ``tiled_all_to_all`` here:
the repository's layering lint reserves ``.all_to_all(...)`` call sites
to the JAX package's transport, and the port's transport is the only
caller of this primitive.
"""

from __future__ import annotations

import abc
from typing import Sequence

import torch
import torch.distributed as dist


def _no_groups(groups) -> None:
    if groups is not None:
        raise NotImplementedError(
            "sub-axis collectives (groups=) arrive with the hierarchical "
            "transport, ROADMAP.md Queue 1 item 7")


class Backend(abc.ABC):
    """Primitive set every BCL backend must implement (paper section 8)."""

    @abc.abstractmethod
    def nprocs(self) -> int:
        """Number of ranks on the communication axis."""

    @abc.abstractmethod
    def rank(self) -> int:
        """Index of the calling rank."""

    @abc.abstractmethod
    def tiled_all_to_all(self, x: torch.Tensor,
                         groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
        """Tiled all-to-all over axis 0.

        ``x`` has shape (nprocs * C, ...): rows [d*C:(d+1)*C] are sent to
        rank d; the result's rows [s*C:(s+1)*C] were received from rank s.
        Identity when nprocs == 1.
        """

    @abc.abstractmethod
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Gather ``x`` from every rank, stacked on a new leading axis."""

    @abc.abstractmethod
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum-reduce across ranks (broadcast result)."""

    @abc.abstractmethod
    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Max-reduce across ranks (broadcast result)."""

    @abc.abstractmethod
    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """Point-to-point permutation; ranks that receive nothing get zeros."""

    def barrier(self) -> None:
        """Barrier; program order already sequences the collectives."""
        return None

    def exclusive_rank_offsets(self, count: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Prefix-sum slot reservation: the analogue of fetch-and-add.

        Every rank contributes ``count`` items to a shared sequence.
        Returns ``(my_offset, total)`` as int32 scalars.
        """
        counts = self.all_gather(count.reshape(()))       # (nprocs,)
        csum = torch.cumsum(counts, dim=0)
        my = self.rank()
        my_offset = csum[my - 1] if my > 0 else torch.zeros_like(csum[0])
        return my_offset.to(torch.int32), csum[-1].to(torch.int32)


class SerialBackend(Backend):
    """Single-rank backend: the reference semantics."""

    def nprocs(self) -> int:
        return 1

    def rank(self) -> int:
        return 0

    def tiled_all_to_all(self, x, groups=None):
        _no_groups(groups)
        return x

    def all_gather(self, x):
        return x[None]

    def psum(self, x):
        return x

    def pmax(self, x):
        return x

    def ppermute(self, x, perm):
        return x


class ProcessGroupBackend(Backend):
    """One rank per process over an initialized ``torch.distributed`` group.

    The caller runs ``torch.distributed.init_process_group`` (gloo for
    CPU tensors, NCCL for CUDA tensors) before building the backend.
    """

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupBackend needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self._nprocs = dist.get_world_size(group)
        self._rank = dist.get_rank(group)

    def nprocs(self) -> int:
        return self._nprocs

    def rank(self) -> int:
        return self._rank

    def tiled_all_to_all(self, x, groups=None):
        _no_groups(groups)
        if self._nprocs == 1:
            return x
        if x.shape[0] % self._nprocs:
            raise ValueError(f"tiled all-to-all: {x.shape[0]} rows do not "
                             f"split over {self._nprocs} ranks")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self._nprocs)]
        dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def _reduce(self, x, op):
        y = x.clone().contiguous()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def ppermute(self, x, perm):
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in perm:
            if src == self._rank and dst == self._rank:
                out.copy_(x)
            elif src == self._rank:
                ops.append(dist.P2POp(dist.isend, x, dst, group=self.group))
            elif dst == self._rank:
                ops.append(dist.P2POp(dist.irecv, out, src, group=self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

