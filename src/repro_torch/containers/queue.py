"""BCL queues (paper section 5.2): FastQueue and CircularQueue, PyTorch port.

Both are *hosted* ring buffers: every rank hosts one ring, and any rank
may push to / pop from any ring.  As in ``repro.containers.queue``, ring
slots are reserved owner-side: routed items arrive in a deterministic
order (source rank, then source position), and an exclusive prefix sum
over the arrivals assigns disjoint slots, the associative analogue of
the paper's remote fetch-and-add.

``push``/``pop`` are eager single-flow ExchangePlans; ``push_pop`` fuses
both ops' flows into one round trip (``Promise.FINE`` recovers the
sequential schedule); ``push_pop(async_=True)`` commits it split-phase.

Cost model (paper Table 2):
  FastQueue      push = A + nW     pop = A + nR
  CircularQueue  push = 2A + nW    pop = 2A + nR
  local_nonatomic_pop = l           resize = B + l   migrate = B + nW

The ring lives on the device ``queue_create`` is given (the card by
default); cursors are (1,) int32 tensors beside it, so no op waits on
the host.  Every op returns a new state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.exchange import ExchangePlan, PendingResult, route
from repro_torch.core.object_container import Packer, packer_for
from repro_torch.core.promises import (Promise, fine_grained, fully_atomic_queue,
                                       validate)

_I32 = torch.int32
_I64 = torch.int64

@dataclasses.dataclass(frozen=True)
class QueueSpec:
    capacity: int           # ring capacity per host rank
    packer: Packer
    circular: bool = False  # CircularQueue: maintains ready cursors

    @property
    def lanes(self) -> int:
        return self.packer.lanes


class QueueState(NamedTuple):
    data: torch.Tensor        # (capacity, L) int32 words
    head: torch.Tensor        # (1,) i32, monotone pop cursor
    tail: torch.Tensor        # (1,) i32, monotone push cursor
    tail_ready: torch.Tensor  # (1,) i32, CircularQueue publish cursor
    head_ready: torch.Tensor  # (1,) i32


def queue_create(backend: Backend, capacity: int, value_spec, circular: bool = False,
                 device="cuda") -> tuple[QueueSpec, QueueState]:
    """Collective constructor: one ring of ``capacity`` on every rank."""
    packer = packer_for(value_spec)
    spec = QueueSpec(capacity, packer, circular)

    def z():
        return torch.zeros(1, dtype=_I32, device=device)
    state = QueueState(torch.zeros((capacity, packer.lanes), dtype=_I32, device=device),
                       z(), z(), z(), z())
    return spec, state


def size(state: QueueState) -> torch.Tensor:
    return (state.tail - state.head)[0]


def _amo_count(spec: QueueSpec, promise: Promise) -> int:
    """AMOs per op per the paper's Tables 2/4."""
    if promise & Promise.LOCAL:
        return 0
    return 2 if spec.circular else 1


def _exclusive(valid: torch.Tensor) -> torch.Tensor:
    v = valid.to(_I32)
    return torch.cumsum(v, 0, dtype=_I32) - v


def _zero(dev) -> torch.Tensor:
    return torch.zeros((), dtype=_I32, device=dev)


def push(backend: Backend, spec: QueueSpec, state: QueueState,
         values, dest: torch.Tensor, capacity: int,
         valid: torch.Tensor | None = None,
         promise: Promise = Promise.PUSH,
         max_rounds: int = 1,
         overflow: str = "drop",
         transport=None,
         dead_ranks=None,
         integrity: bool = False,
         impl: str = "auto"):
    """Push each value to the ring hosted on ``dest[i]``.

    Returns ``(state, pushed_here, dropped)``; with ``overflow="carry"``
    ``(state, pushed_here, 0, carry)``, where ``carry`` marks every valid
    item that never shipped or was refused by a full ring (see
    ``repro.containers.queue.push``).
    """
    validate(promise)
    if overflow not in ("drop", "carry"):
        raise ValueError(f'queue.push overflow must be "drop" or "carry", '
                         f"got {overflow!r}")
    lanes = spec.packer.pack(values)
    n = lanes.shape[0]
    dev = lanes.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)

    if promise & Promise.LOCAL:
        costs.record("queue.push", costs.Cost(local=n))
        state, pushed, full_drop, accept = _append(spec, state, lanes, valid)
        if overflow == "carry":
            return state, pushed, _zero(dev), valid & ~accept
        return state, pushed, full_drop

    if overflow == "carry":
        plan = ExchangePlan(name="queue.push")
        h = plan.add(lanes, dest, capacity, reply_lanes=1, valid=valid,
                     op_name="queue.push")
        c = plan.commit(backend, impl=impl, max_rounds=max_rounds, transport=transport,
                        dead_ranks=dead_ranks, integrity=integrity)
        res = c.view(h)
        state, pushed, _, accept = _append(spec, state, res.payload, res.valid)
        c.set_reply(h, accept.to(_I32))
        out, answered = c.finish(backend)[h]
        costs.record("queue.push", costs.Cost(A=_amo_count(spec, promise), W=n))
        landed = answered & (out[:, 0] == 1) & valid
        return state, pushed, _zero(dev), valid & ~landed

    res = route(backend, lanes, dest, capacity, valid=valid, op_name="queue.push",
                impl=impl, max_rounds=max_rounds, transport=transport,
                dead_ranks=dead_ranks, integrity=integrity)
    state, pushed, full_drop, _ = _append(spec, state, res.payload, res.valid)
    costs.record("queue.push", costs.Cost(A=_amo_count(spec, promise), W=n))
    return state, pushed, res.dropped + backend.psum(full_drop)


def _append(spec: QueueSpec, state: QueueState, rows: torch.Tensor,
            valid: torch.Tensor):
    """Owner-side ring append in deterministic arrival order.

    Returns ``(state, n_accepted, n_rejected, accept)``; ``accept`` is the
    per-arrival acceptance mask in wire order.
    """
    pos = _exclusive(valid)
    total = valid.sum(dtype=_I32)
    used = (state.tail - state.head)[0]
    room = (spec.capacity - used).clamp(min=0)
    accept = valid & (pos < room)
    n_acc = torch.minimum(total, room)
    slot = ((state.tail[0] + pos) % spec.capacity).to(_I64)
    data = state.data.clone()
    data[slot[accept]] = rows.to(_I32)[accept]
    tail = state.tail + n_acc
    tail_ready = tail if spec.circular else state.tail_ready
    new = QueueState(data, state.head, tail, tail_ready, state.head_ready)
    return new, n_acc, total - n_acc, accept


def _grant(spec: QueueSpec, state: QueueState, req_valid: torch.Tensor,
           promise: Promise):
    """Owner-side pop grant in deterministic arrival order (FAA analogue).

    Returns ``(new_state, body)``, body rows ``[value lanes | granted]``
    aligned with the request arrivals.
    """
    arrival = _exclusive(req_valid)
    limit = state.tail[0] - state.head[0]
    if spec.circular and fully_atomic_queue(promise):
        limit = state.tail_ready[0] - state.head[0]
    grant = req_valid & (arrival < limit)
    idx = torch.where(grant, (state.head[0] + arrival) % spec.capacity, 0).to(_I64)
    rows = torch.where(grant[:, None], state.data[idx], 0)
    n_grant = torch.minimum(req_valid.sum(dtype=_I32), limit)
    head = state.head + n_grant
    head_ready = head if spec.circular else state.head_ready
    new = QueueState(state.data, head, state.tail, state.tail_ready, head_ready)
    return new, torch.cat([rows, grant.to(_I32)[:, None]], dim=1)


def _src_ranks(src, n: int, dev) -> torch.Tensor:
    if isinstance(src, int):
        return torch.full((n,), src, dtype=_I32, device=dev)
    if src.ndim == 0:
        return src.to(_I32).expand(n).to(dev)
    return src.to(_I32)


def pop(backend: Backend, spec: QueueSpec, state: QueueState,
        n: int, src, promise: Promise = Promise.POP,
        max_rounds: int = 1, transport=None, dead_ranks=None,
        integrity: bool = False, impl: str = "auto"):
    """Pop up to ``n`` items from the ring hosted on rank ``src``.

    Every rank issues its own request; the owner grants ranges in
    deterministic requester order.  Returns (state, values, got_mask).
    """
    validate(promise)
    dev = state.data.device
    src = _src_ranks(src, n, dev)
    if promise & Promise.LOCAL:
        return local_nonatomic_pop(spec, state, n)

    plan = ExchangePlan(name="queue.pop")
    h = plan.add(torch.zeros((n, 1), dtype=_I32, device=dev), src, n,
                 reply_lanes=spec.lanes + 1, op_name="queue.pop")
    c = plan.commit(backend, impl=impl, max_rounds=max_rounds, transport=transport,
                    dead_ranks=dead_ranks, integrity=integrity)
    new, body = _grant(spec, state, c.view(h).valid, promise)
    c.set_reply(h, body)
    out, _ = c.finish(backend)[h]
    costs.record("queue.pop", costs.Cost(A=_amo_count(spec, promise), R=n))
    return new, spec.packer.unpack(out[:, :-1]), out[:, -1] == 1


def push_pop(backend: Backend, spec: QueueSpec, state: QueueState,
             values, dest: torch.Tensor, capacity: int,
             n: int, src, valid: torch.Tensor | None = None,
             promise: Promise = Promise.PUSH | Promise.POP,
             max_rounds: int = 1, overflow: str = "drop",
             transport=None, dead_ranks=None, integrity: bool = False,
             async_: bool = False, impl: str = "auto"):
    """Fused push + pop sharing ONE exchange round trip.

    The push is applied before the pop is granted (items pushed this
    round are poppable this round).  Returns ``(state, pushed, dropped,
    out_values, got)``, plus ``carry`` with ``overflow="carry"``.
    ``async_=True`` commits the plan split-phase and returns a
    :class:`~repro_torch.core.PendingResult` whose ``finish()`` gives the
    same tuple.
    """
    validate(promise)
    if overflow not in ("drop", "carry"):
        raise ValueError(f'queue.push_pop overflow must be "drop" or "carry", '
                         f"got {overflow!r}")
    kw = dict(max_rounds=max_rounds, transport=transport, dead_ranks=dead_ranks,
              integrity=integrity)
    if fine_grained(promise):
        pushed_out = push(backend, spec, state, values, dest, capacity, valid=valid,
                          promise=promise, overflow=overflow, impl=impl, **kw)
        state, out, got = pop(backend, spec, pushed_out[0], n, src, promise=promise,
                              impl=impl, **kw)
        res = (state, *pushed_out[1:3], out, got, *pushed_out[3:])
        # split-phase FINE stays the sequential oracle: run eagerly
        return PendingResult(lambda: res) if async_ else res

    lanes = spec.packer.pack(values)
    nv = lanes.shape[0]
    dev = lanes.device
    if valid is None:
        valid = torch.ones(nv, dtype=torch.bool, device=dev)
    src = _src_ranks(src, n, dev)
    carrying = overflow == "carry"

    plan = ExchangePlan(name="queue.push_pop")
    hp = plan.add(lanes, dest, capacity, valid=valid, reply_lanes=1 if carrying else 0,
                  op_name="queue.push")
    hq = plan.add(torch.zeros((n, 1), dtype=_I32, device=dev), src, n,
                  reply_lanes=spec.lanes + 1, op_name="queue.pop")

    def complete(c):
        return _push_pop_complete(backend, spec, state, c, hp, hq, valid, promise,
                                  carrying, nv, n)

    if async_:
        pend = plan.commit_async(backend, impl=impl, **kw)
        return PendingResult(lambda: complete(pend.finish(backend)))
    return complete(plan.commit(backend, impl=impl, **kw))


def _push_pop_complete(backend, spec, state, c, hp, hq, valid, promise, carrying, nv, n):
    """Owner-side work + reply round of :func:`push_pop` (the sync and the
    split-phase path both complete here)."""
    vp, vq = c.view(hp), c.view(hq)
    state, pushed, full_drop, accept = _append(spec, state, vp.payload, vp.valid)
    state, body = _grant(spec, state, vq.valid, promise)
    if carrying:
        c.set_reply(hp, accept.to(_I32))
    c.set_reply(hq, body)
    outs = c.finish(backend)
    out, _ = outs[hq]
    got = out[:, -1] == 1
    out_values = spec.packer.unpack(out[:, :-1])
    a = _amo_count(spec, promise)
    costs.record("queue.push", costs.Cost(A=a, W=nv))
    costs.record("queue.pop", costs.Cost(A=a, R=n))
    if carrying:
        outp, answered = outs[hp]
        landed = answered & (outp[:, 0] == 1) & valid
        return state, pushed, _zero(vp.payload.device), out_values, got, valid & ~landed
    return state, pushed, vp.dropped + backend.psum(full_drop), out_values, got


def local_nonatomic_pop(spec: QueueSpec, state: QueueState, n: int):
    """Pop n items from this rank's own ring; no collectives (paper 4f)."""
    dev = state.data.device
    avail = state.tail[0] - state.head[0]
    take = torch.arange(n, dtype=_I32, device=dev)
    got = take < avail
    idx = torch.where(got, (state.head[0] + take) % spec.capacity, 0).to(_I64)
    rows = torch.where(got[:, None], state.data[idx], 0)
    n_got = torch.clamp(avail, max=n)
    head = state.head + n_got
    head_ready = head if spec.circular else state.head_ready
    new = QueueState(state.data, head, state.tail, state.tail_ready, head_ready)
    costs.record("queue.local_nonatomic_pop", costs.Cost(local=n))
    return new, spec.packer.unpack(rows), got


def local_drain(spec: QueueSpec, state: QueueState):
    """Read the whole local ring in FIFO order (the ``as_vector`` of the
    paper's Fig. 3); state unchanged.  Returns (rows, valid)."""
    take = torch.arange(spec.capacity, dtype=_I32, device=state.data.device)
    got = take < state.tail[0] - state.head[0]
    idx = ((state.head[0] + take) % spec.capacity).to(_I64)
    rows = torch.where(got[:, None], state.data[idx], 0)
    return spec.packer.unpack(rows), got


def export_state(spec: QueueSpec, state: QueueState) -> dict:
    """This rank's ring as a plain dict of tensors."""
    return {"data": state.data, "head": state.head, "tail": state.tail,
            "tail_ready": state.tail_ready, "head_ready": state.head_ready}


def restore_state(spec: QueueSpec, exported: dict, device=None) -> QueueState:
    """Rebuild a QueueState from :func:`export_state` output."""
    data = exported["data"]
    if tuple(data.shape) != (spec.capacity, spec.lanes):
        raise ValueError(f"queue.restore_state: data shape {tuple(data.shape)} does "
                         f"not match spec (capacity={spec.capacity}, "
                         f"lanes={spec.lanes})")
    device = data.device if device is None else device

    def words(t):
        t = t.to(device)
        return t.view(_I32) if t.dtype == torch.uint32 else t.to(_I32)
    return QueueState(words(data), *(words(exported[k]).reshape(1) for k in
                                     ("head", "tail", "tail_ready", "head_ready")))


def resize(backend: Backend, spec: QueueSpec, state: QueueState,
           new_capacity: int) -> tuple[QueueSpec, QueueState]:
    """Collective resize (paper cost B + l)."""
    backend.barrier()
    dev = state.data.device
    rows, got = local_drain(spec, state)
    lanes = spec.packer.pack(rows)
    new_spec = dataclasses.replace(spec, capacity=new_capacity)
    m = torch.clamp((state.tail - state.head)[0], max=new_capacity)
    take = torch.arange(spec.capacity, dtype=_I32, device=dev)
    keep = got & (take < m)
    data = torch.zeros((new_capacity, spec.lanes), dtype=_I32, device=dev)
    data[take[keep].to(_I64)] = lanes[keep]
    z = torch.zeros(1, dtype=_I32, device=dev)
    tail = m.reshape(1)
    costs.record("queue.resize", costs.Cost(B=1, local=int(spec.capacity)))
    return new_spec, QueueState(data, z, tail, tail if spec.circular else z, z)


def migrate(backend: Backend, spec: QueueSpec, state: QueueState,
            shift: int = 1) -> QueueState:
    """Collective migration: ring moves to (rank + shift) % P (B + nW)."""
    nprocs = backend.nprocs()
    if nprocs == 1:
        return state
    backend.barrier()
    perm = [(i, (i + shift) % nprocs) for i in range(nprocs)]
    moved = QueueState(*(backend.ppermute(x, perm) for x in state))
    costs.record("queue.migrate", costs.Cost(B=1, W=int(spec.capacity)))
    return moved
