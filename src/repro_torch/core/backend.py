"""BCL backends, PyTorch edition.

Container code is written once against a small primitive set (paper
section 8); a backend implements it.  The port ships two:

  SerialBackend        nprocs == 1, collectives are identities.  The
                       reference semantics, and the one-card main path.

  ProcessGroupBackend  one rank per process over ``torch.distributed``:
                       gloo (CPU tensors, or CUDA tensors of ranks that
                       share one card) or NCCL.  Wire words cross the
                       collectives as int32 (gloo refuses uint32).

The JAX package's ``Backend.all_to_all`` is ``tiled_all_to_all`` here,
with ``groups=`` sub-axis collectives and a start/wait form for the
split-phase exchange: the repository's layering lint reserves
``.all_to_all(...)`` call sites to the JAX package's transport, and the
port's transports are the only callers of this primitive.
"""

from __future__ import annotations

import abc
from typing import Sequence

import torch
import torch.distributed as dist


def _partition(groups, nprocs: int) -> tuple[tuple[int, ...], ...]:
    """``groups`` as a validated static partition of ``[0, nprocs)`` into
    equal-size groups, each listed in increasing rank order."""
    part = tuple(tuple(int(r) for r in g) for g in groups)
    members = sorted(r for g in part for r in g)
    if (members != list(range(nprocs)) or len({len(g) for g in part}) != 1
            or any(list(g) != sorted(g) for g in part)):
        raise ValueError(f"groups={part}: want a partition of the {nprocs} ranks into "
                         f"equal-size groups, each in increasing rank order")
    return part


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

        ``groups`` restricts the collective to a sub-axis: a static
        partition of ``[0, nprocs)`` into equal-size groups (the rows or
        the columns of a ``Pr x Pc`` factorization).  Then ``x`` has shape
        (G * C, ...) with G the group size: block j goes to the j-th
        member of my group, and the result's block j came from it.
        """

    def tiled_all_to_all_start(self, x: torch.Tensor,
                               groups: Sequence[Sequence[int]] | None = None):
        """Start :meth:`tiled_all_to_all`; :meth:`tiled_all_to_all_wait`
        on the returned handle gives its result.  Default: synchronous."""
        return self.tiled_all_to_all(x, groups)

    def tiled_all_to_all_wait(self, handle) -> torch.Tensor:
        """Complete a :meth:`tiled_all_to_all_start`."""
        return handle

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
        if groups is not None:
            _partition(groups, 1)        # single-member groups: the identity
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

    The caller runs ``torch.distributed.init_process_group`` and picks
    its backend (gloo, NCCL) before building this one; ``group`` is a
    subgroup of it (``models/sharding.Layout`` builds one per axis).
    NCCL takes no two ranks of one communicator on one device, so ranks
    that share a card run gloo, whose collectives take CUDA tensors
    (through host memory).  On an H100 gloo took every primitive here on
    CUDA int32, float32 and bfloat16 tensors, so none is staged through
    host memory by this class; it refuses int16 on either device, and no
    caller passes one (``scripts/torch_gloo_probe.py``).
    """

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupBackend needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self._nprocs = dist.get_world_size(group)
        self._rank = dist.get_rank(group)
        #: sub-axis process group of this rank, per partition (see _subgroup)
        self._subgroups: dict[tuple, object] = {}

    def nprocs(self) -> int:
        return self._nprocs

    def rank(self) -> int:
        return self._rank

    def _subgroup(self, groups):
        """This rank's process group of the partition ``groups``.

        ``new_group`` is collective over the whole group: every rank
        creates every subgroup of a partition, in the same order, the
        first time any collective uses that partition (ranks run the
        same program, so they reach it together); later calls reuse it.
        """
        part = _partition(groups, self._nprocs)
        if len(part[0]) == 1:
            return None, 1               # single-member groups: the identity
        sub = self._subgroups.get(part)
        if sub is None:
            for g in part:
                ranks = [r if self.group is None else dist.get_global_rank(self.group, r)
                         for r in g]
                handle = dist.new_group(ranks)
                if self._rank in g:
                    sub = handle
            self._subgroups[part] = sub
        return sub, len(part[0])

    def tiled_all_to_all_start(self, x, groups=None):
        group, size = ((self.group, self._nprocs) if groups is None
                       else self._subgroup(groups))
        if size == 1:
            return None, x
        if x.shape[0] % size:
            raise ValueError(f"tiled all-to-all: {x.shape[0]} rows do not "
                             f"split over {size} ranks")
        x = x.contiguous()
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=group, async_op=True)
        return work, out

    def tiled_all_to_all_wait(self, handle):
        work, out = handle
        if work is not None:
            work.wait()
        return out

    def tiled_all_to_all(self, x, groups=None):
        return self.tiled_all_to_all_wait(self.tiled_all_to_all_start(x, groups))

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

