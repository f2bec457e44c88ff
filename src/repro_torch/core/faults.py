"""Deterministic fault injection for the exchange stack (PyTorch port of
``repro.core.faults``).

Three failure classes, applied "on the wire" so the integrity machinery
(checksum flow, ``lost`` accounting, ack-driven carry) must catch them:

  kill      a rank goes silent: every word it would send is zero on every
            peer, for this and every later launch;
  drop      one (launch, src, dst) wire segment is zeroed in flight;
  corrupt   one word of one (launch, src, dst) segment is bit-flipped
            (XOR with a seed-derived mask at a seed-derived word).

A :class:`FaultSpec` names launches by their index in program order (the
``n``-th tiled all-to-all issued through the wrapping transport),
sources and destinations by block of that launch's send buffer, and
derives corrupted word positions from its seed by integer hashing, so a
faulty run reproduces bit for bit.  :class:`FaultInjectingTransport`
wraps any :class:`Transport` and hands it a backend whose tiled
all-to-all mutates the send buffer first; the inner transport's wire
format and cost attribution are untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.backend import Backend
from repro_torch.core.transport import Transport
from repro_torch.core.u32 import i32

#: Knuth multiplicative constants for the word/bit position hash
_H1 = 2654435761
_H2 = 1013904223


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded, deterministic description of injected wire faults.

    ``launch`` indices count tiled all-to-alls issued through the wrapping
    transport, in program order, from 0 (a dense request round is one
    launch, a hierarchical one two; replies follow).  ``src``/``dst`` are
    block indices of that launch's send buffer: global ranks for a
    full-axis collective, group-local positions for a grouped one.
    """

    seed: int = 0
    #: ranks whose sends are zeroed from ``kill_from_launch`` onwards
    kill_ranks: tuple[int, ...] = ()
    kill_from_launch: int = 0
    #: (launch, src, dst) wire segments dropped whole
    drop: tuple[tuple[int, int, int], ...] = ()
    #: (launch, src, dst) wire segments with one bit-flipped word
    corrupt: tuple[tuple[int, int, int], ...] = ()

    def word_and_mask(self, launch: int, src: int, dst: int,
                      block_words: int) -> tuple[int, int]:
        """Seed-derived (word index, XOR mask) for a corrupt fault."""
        h = (self.seed * _H1 + launch * _H2 + src * 97 + dst * 31)
        wi = h % max(block_words, 1)
        bit = (h // max(block_words, 1)) % 32
        return wi, 1 << bit


class _FaultyBackend(Backend):
    """Backend proxy whose tiled all-to-alls mutate their send buffers
    per a FaultSpec; every other primitive forwards untouched (faults
    model the data fabric, not the engine's own bookkeeping)."""

    def __init__(self, inner: Backend, spec: FaultSpec, launch_counter: list[int]):
        self._inner = inner
        self._spec = spec
        self._launch = launch_counter

    def nprocs(self) -> int:
        return self._inner.nprocs()

    def rank(self) -> int:
        return self._inner.rank()

    def all_gather(self, x):
        return self._inner.all_gather(x)

    def psum(self, x):
        return self._inner.psum(x)

    def pmax(self, x):
        return self._inner.pmax(x)

    def ppermute(self, x, perm):
        return self._inner.ppermute(x, perm)

    def barrier(self) -> None:
        return self._inner.barrier()

    # -- the faulty wire ------------------------------------------------
    def _next_launch(self) -> int:
        launch = self._launch[0]
        self._launch[0] = launch + 1
        return launch

    def tiled_all_to_all(self, x, groups: Sequence[Sequence[int]] | None = None):
        return self._inner.tiled_all_to_all(
            self._mutate(x, groups, self._next_launch()), groups)

    def tiled_all_to_all_start(self, x, groups=None):
        return self._inner.tiled_all_to_all_start(
            self._mutate(x, groups, self._next_launch()), groups)

    def tiled_all_to_all_wait(self, handle):
        return self._inner.tiled_all_to_all_wait(handle)

    def _mutate(self, x: torch.Tensor, groups, launch: int) -> torch.Tensor:
        spec = self._spec
        nblocks = len(groups[0]) if groups is not None else self._inner.nprocs()
        if nblocks < 1 or x.shape[0] % nblocks:
            return x          # degenerate layout: nothing to target
        rank = self._inner.rank()

        # kill: this rank's whole send zeroes out, permanently
        if spec.kill_ranks and launch >= spec.kill_from_launch \
                and rank in spec.kill_ranks:
            x = torch.zeros_like(x)

        drops = [(s, d) for (l, s, d) in spec.drop if l == launch]
        flips = [(s, d) for (l, s, d) in spec.corrupt if l == launch]
        if not drops and not flips:
            return x

        shape = x.shape
        blocks = x.reshape(nblocks, -1).clone()
        block_words = blocks.shape[1]
        for src, dst in drops:
            if 0 <= dst < nblocks and rank == src:
                blocks[dst] = 0
        for src, dst in flips:
            if 0 <= dst < nblocks and rank == src:
                wi, mask = spec.word_and_mask(launch, src, dst, block_words)
                blocks[dst, wi] ^= i32(mask)
        return blocks.reshape(shape)


class FaultInjectingTransport(Transport):
    """Wrap any transport so its collectives traverse a faulty fabric.

    The launch counter is shared by the request and reply phases and
    counts tiled all-to-alls since construction or the last
    :meth:`reset`: reuse an instance for a second run only after
    ``reset()``, or its spec's launch indices address other launches.
    """

    def __init__(self, inner: Transport, spec: FaultSpec):
        self.inner = inner
        self.spec = spec
        self.name = inner.name
        self._launch = [0]

    def reset(self) -> None:
        """Restart launch numbering."""
        self._launch[0] = 0

    @property
    def launches(self) -> int:
        """Collective launches issued through this wrapper so far."""
        return self._launch[0]

    def _wrap(self, backend: Backend) -> Backend:
        return _FaultyBackend(backend, self.spec, self._launch)

    def request(self, backend, args):
        return self.inner.request(self._wrap(backend), args)

    def request_start(self, backend, args):
        # split-phase launches count through the same counter, so a spec's
        # launch indices follow the overlapped program order
        return self.inner.request_start(self._wrap(backend), args)

    def request_wait(self, backend, handle):
        return self.inner.request_wait(self._wrap(backend), handle)

    def reply(self, backend, ctx, staged):
        return self.inner.reply(self._wrap(backend), ctx, staged)
