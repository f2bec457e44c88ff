"""BCL::HashMapBuffer (paper section 5.3): buffered hash-table insertion,
PyTorch port.

The same three-stage pipeline as ``repro.containers.hashmap_buffer``:

  insert()  ->  local append (cost l, zero collectives)
  spill()   ->  FastQueue.push of the staged rows (one flow on an
                ExchangePlan, cost A + nW; ``spill_flow``/``spill_apply``
                let the push ride a caller's plan)
  flush()   ->  owner drains its own queue, local bulk insert (cost l):
                the column front end of the probe (``hash_probe.insert``,
                a CUDA kernel on the card)

Buffer capacity is static; ``insert`` reports overflow.  ``spill`` and
``flush`` take ``async_=True`` to run the spill wire split-phase.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.containers import hashmap as hm
from repro_torch.containers import queue as q
from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.exchange import CommittedPlan, ExchangePlan, PendingResult
from repro_torch.core.promises import ConProm
from repro_torch.kernels import ops as kops

_I32 = torch.int32
_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class HashMapBufferSpec:
    map_spec: hm.HashMapSpec
    queue_spec: q.QueueSpec
    buffer_cap: int      # local staging capacity (elements)

    @property
    def lanes(self) -> int:
        return self.map_spec.key_packer.lanes + self.map_spec.val_packer.lanes


class HashMapBufferState(NamedTuple):
    map: hm.HashMapState
    queue: q.QueueState
    buf: torch.Tensor       # (buffer_cap, Lk+Lv) int32 words
    buf_dest: torch.Tensor  # (buffer_cap,) i32 owner rank per staged item
    buf_n: torch.Tensor     # (1,) i32


def create(backend: Backend, map_spec: hm.HashMapSpec, map_state: hm.HashMapState,
           queue_capacity: int, buffer_cap: int
           ) -> tuple[HashMapBufferSpec, HashMapBufferState]:
    """Wrap an existing hash map (paper Fig. 4 constructor); the queue and
    the staging buffer live on the map's device."""
    lanes = map_spec.key_packer.lanes + map_spec.val_packer.lanes
    dev = map_state.status.device
    qspec, qstate = q.queue_create(backend, queue_capacity, lanes, device=dev)
    spec = HashMapBufferSpec(map_spec, qspec, buffer_cap)
    state = HashMapBufferState(
        map_state, qstate,
        torch.zeros((buffer_cap, lanes), dtype=_I32, device=dev),
        torch.zeros(buffer_cap, dtype=_I32, device=dev),
        torch.zeros(1, dtype=_I32, device=dev))
    return spec, state


def insert(spec: HashMapBufferSpec, state: HashMapBufferState, keys, vals,
           valid: torch.Tensor | None = None):
    """Stage a batch locally (no communication). Returns (state, overflow)."""
    ms = spec.map_spec
    klanes = ms.key_packer.pack(keys)
    vlanes = ms.val_packer.pack(vals)
    n = klanes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=klanes.device)
    owner = hm._block_of(ms, klanes, 0) // ms.nblocks_local

    rows = torch.cat([klanes, vlanes], dim=1)
    v = valid.to(_I32)
    pos = state.buf_n[0] + torch.cumsum(v, 0, dtype=_I32) - v
    in_cap = valid & (pos < spec.buffer_cap)
    at = pos[in_cap].to(_I64)
    buf, buf_dest = state.buf.clone(), state.buf_dest.clone()
    buf[at] = rows[in_cap]
    buf_dest[at] = owner[in_cap]
    want = state.buf_n[0] + valid.sum(dtype=_I32)
    n_new = torch.clamp(want, max=spec.buffer_cap)
    costs.record("hashmap_buffer.insert", costs.Cost(local=n))
    return state._replace(buf=buf, buf_dest=buf_dest, buf_n=n_new.reshape(1)), \
        want - n_new


def _live(spec: HashMapBufferSpec, state: HashMapBufferState) -> torch.Tensor:
    return torch.arange(spec.buffer_cap, dtype=_I32, device=state.buf.device) \
        < state.buf_n[0]


def _restage(spec: HashMapBufferSpec, state: HashMapBufferState,
             mask: torch.Tensor) -> HashMapBufferState:
    """Compact the masked rows to the front of the buffer."""
    buf, buf_dest = torch.zeros_like(state.buf), torch.zeros_like(state.buf_dest)
    at = torch.arange(int(mask.sum()), device=mask.device)
    buf[at] = state.buf[mask]
    buf_dest[at] = state.buf_dest[mask]
    return state._replace(buf=buf, buf_dest=buf_dest,
                          buf_n=mask.sum(dtype=_I32).reshape(1))


def spill_flow(plan: ExchangePlan, spec: HashMapBufferSpec, state: HashMapBufferState,
               capacity: int, ring_reply: bool = False) -> int:
    """Register the staged buffer's queue push as a flow on ``plan``;
    pair with :func:`spill_apply` after ``plan.commit``.  ``ring_reply``
    declares the 1-lane acceptance reply that closes the ring-full loss
    path (see :func:`spill_absorb`)."""
    return plan.add(state.buf, state.buf_dest, capacity, valid=_live(spec, state),
                    reply_lanes=1 if ring_reply else 0, op_name="queue.push")


def spill_apply(backend: Backend, committed: CommittedPlan, handle: int,
                spec: HashMapBufferSpec, state: HashMapBufferState,
                overflow: str = "drop"):
    """Owner-side half of the spill: ring-append the arrived flow.

    With ``overflow="carry"`` the rows the wire could not admit are
    re-staged at the front of the buffer; when the flow declared the ring
    reply, the accept mask is staged on the plan instead and
    :func:`spill_absorb` re-stages ring rejects too.  Returns
    ``(state, dropped)``.
    """
    view = committed.view(handle)
    qstate, _, full_drop, accept = q._append(spec.queue_spec, state.queue,
                                             view.payload, view.valid)
    a = q._amo_count(spec.queue_spec, ConProm.CircularQueue.push)
    costs.record("queue.push", costs.Cost(A=a, W=spec.buffer_cap))
    if overflow == "carry":
        if committed.reply_lanes(handle) > 0:
            committed.set_reply(handle, accept.to(_I32))
            return state._replace(queue=qstate), torch.zeros((), dtype=_I32,
                                                             device=accept.device)
        _, mask = committed.leftover(handle)
        state = _restage(spec, state._replace(queue=qstate), mask)
        return state, backend.psum(full_drop)
    state = state._replace(queue=qstate, buf_n=torch.zeros_like(state.buf_n))
    return state, view.dropped + backend.psum(full_drop)


def spill_absorb(outs: tuple, spec: HashMapBufferSpec,
                 state: HashMapBufferState) -> HashMapBufferState:
    """Requester-side close of a ring-reply carry spill: every live row
    that did not land (wire leftover or ring reject) is re-staged."""
    rows, answered = outs
    live = _live(spec, state)
    landed = answered & (rows[:, 0] == 1) & live
    return _restage(spec, state, live & ~landed)


def spill(backend: Backend, spec: HashMapBufferSpec, state: HashMapBufferState,
          capacity: int, max_rounds: int = 1, overflow: str = "drop",
          transport=None, async_: bool = False):
    """Push staged items to the owners' FastQueues (paper: buffer full).

    A fresh single-flow plan around :func:`spill_flow`/:func:`spill_apply`,
    committed with the map's kernel dispatch (``impl``); with
    ``overflow="carry"`` the flow declares the ring reply, so the spill
    loses nothing.  Returns ``(state, dropped)``; ``async_=True`` returns
    a :class:`~repro_torch.core.PendingResult` that finishes to it.
    """
    plan = ExchangePlan(name="queue.push")
    carrying = overflow == "carry"
    h = spill_flow(plan, spec, state, capacity, ring_reply=carrying)

    def complete(committed):
        st, dropped = spill_apply(backend, committed, h, spec, state, overflow=overflow)
        if carrying:
            st = spill_absorb(committed.finish(backend)[h], spec, st)
        return st, dropped

    kw = dict(impl=spec.map_spec.impl, max_rounds=max_rounds, overflow=overflow,
              transport=transport)
    if async_:
        pend = plan.commit_async(backend, **kw)
        return PendingResult(lambda: complete(pend.finish(backend)))
    return complete(plan.commit(backend, **kw))


def flush(backend: Backend, spec: HashMapBufferSpec, state: HashMapBufferState,
          capacity: int, mode: int = kops.MODE_SET, max_rounds: int = 1,
          overflow: str = "drop", transport=None, async_: bool = False):
    """Spill + drain own queue with fast local inserts (paper flush()).

    Returns (state, dropped); dropped counts route/ring/table overflow.
    With ``overflow="carry"`` unlanded items stay staged for the next
    flush.  ``async_=True`` runs the spill wire split-phase and returns a
    :class:`~repro_torch.core.PendingResult` that finishes to the same
    pair (the drain and the local insert wait for the spill).
    """
    kw = dict(max_rounds=max_rounds, overflow=overflow, transport=transport)
    if async_:
        pend = spill(backend, spec, state, capacity, async_=True, **kw)
        return PendingResult(lambda: _flush_complete(backend, spec, *pend.finish(),
                                                     mode=mode))
    return _flush_complete(backend, spec, *spill(backend, spec, state, capacity, **kw),
                           mode=mode)


def _flush_complete(backend, spec, state, dropped, mode):
    """Drain + local-insert half of :func:`flush` (the sync and the
    split-phase path both complete here)."""
    backend.barrier()
    rows, got = q.local_drain(spec.queue_spec, state.queue)
    qstate = state.queue._replace(head=state.queue.tail)
    ms = spec.map_spec
    lk = ms.key_packer.lanes
    mstate, ok = hm.insert(backend, ms, state.map,
                           ms.key_packer.unpack(rows[:, :lk]),
                           ms.val_packer.unpack(rows[:, lk:]),
                           capacity=1, promise=ConProm.HashMap.local,
                           valid=got, mode=mode)
    failed = backend.psum((got & ~ok).sum(dtype=_I32))
    return state._replace(map=mstate, queue=qstate), dropped + failed
