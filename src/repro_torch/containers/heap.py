"""Hosted bump-allocator heap: the variable-length ObjectContainer path
(paper section 6), PyTorch port.

Each rank hosts a segment; ``store_local`` bump-allocates rows on the
calling rank (a *local* fetch-and-add), and ``rget_rows`` reads
arbitrary remote spans through the exchange.  Records inside other
containers carry (rank, offset, length) while the bytes live here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.exchange import reply, route
from repro_torch.core.pointers import GlobalPointer

_I32 = torch.int32
_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class HeapSpec:
    local_rows: int
    lanes: int


class HeapState(NamedTuple):
    data: torch.Tensor   # (local_rows, lanes) int32 words
    top: torch.Tensor    # (1,) i32 bump pointer


def heap_create(backend: Backend, local_rows: int, lanes: int,
                device="cuda") -> tuple[HeapSpec, HeapState]:
    return (HeapSpec(local_rows, lanes),
            HeapState(torch.zeros((local_rows, lanes), dtype=_I32, device=device),
                      torch.zeros(1, dtype=_I32, device=device)))


def store_local(backend: Backend, spec: HeapSpec, state: HeapState,
                rows: torch.Tensor, lengths: torch.Tensor):
    """Allocate contiguous spans on this rank; one record per span.

    rows (N, lanes) words, the concatenated span payload rows; lengths
    (K,) i32 rows per record (sum == N).  Returns (state, ptrs
    GlobalPointer (K,), ok).  A failed allocation hands out the
    out-of-range sentinel offset, so later reads report not-found.
    """
    n = rows.shape[0]
    dev = state.data.device
    base = state.top[0]
    ok = base + n <= spec.local_rows
    data = state.data.clone()
    at = (base + torch.arange(n, dtype=_I32, device=dev)).to(_I64)
    keep = ok & (at < spec.local_rows)
    data[at[keep]] = rows.to(_I32)[keep]
    lengths = lengths.to(_I32)
    starts = torch.cumsum(lengths, 0, dtype=_I32) - lengths
    offsets = torch.where(ok, base + starts, spec.local_rows)
    rank = torch.full(offsets.shape, backend.rank(), dtype=_I32, device=dev)
    top = torch.where(ok, state.top + n, state.top)
    costs.record("heap.store_local", costs.Cost(local=n))
    return HeapState(data, top), GlobalPointer(rank, offsets), ok.expand(offsets.shape)


def rget_rows(backend: Backend, spec: HeapSpec, state: HeapState,
              ptrs: GlobalPointer, span: int, capacity: int, max_rounds: int = 1):
    """Read ``span`` consecutive rows behind each pointer (static span).

    Returns ``(rows (K, span, lanes), found (K,), dropped () i32)``, as
    ``repro.containers.heap.rget_rows``: ``found`` is False when the
    record's base row is not live or any of its row-requests fell off the
    wire; ``dropped`` is the global overflow count.
    """
    k = ptrs.rank.shape[0]
    dev = state.data.device
    off = (ptrs.offset.to(_I32)[:, None]
           + torch.arange(span, dtype=_I32, device=dev)[None]).reshape(-1)
    dst = ptrs.rank.to(_I32).repeat_interleave(span)
    req = route(backend, off[:, None], dst, capacity=capacity * span,
                op_name="heap.rget", max_rounds=max_rounds)
    loff = torch.where(req.valid, req.payload[:, 0], 0)
    in_range = req.valid & (loff >= 0) & (loff < spec.local_rows)
    served = torch.where(in_range[:, None],
                         state.data[loff.clamp(0, spec.local_rows - 1).to(_I64)], 0)
    body = torch.cat([served, in_range.to(_I32)[:, None]], dim=1)
    out, answered = reply(backend, req, body, k * span, op_name="heap.rget")
    base_live = (out[:, -1] == 1).reshape(k, span)[:, 0]
    costs.record("heap.rget", costs.Cost(R=k * span))
    return (out[:, :-1].reshape(k, span, spec.lanes),
            answered.reshape(k, span).all(dim=1) & base_live, req.dropped)
