"""The many-to-many exchange engine (PyTorch port of ``repro.core.exchange``).

Callers register typed *flows* on an :class:`ExchangePlan`
(``plan.add(payload, dest, capacity, reply_lanes, op_name)``) and
``plan.commit(backend)`` bins every flow in ONE pass, ships them in ONE
tiled all-to-all per retry round, and hands out per-flow owner views;
replies from every flow share ONE inverse all-to-all
(``CommittedPlan.finish``).

Wire format: per destination rank, a flat word vector in which flow f
owns a segment of exactly ``C_f * (L_f + 1)`` words; the last word of a
row is the metadata lane (bit 31 valid, low 31 bits the item's position
in its flow's batch).  Replies are ``R_f`` words per row and land back
in the requester's send slot by the inverse permutation.

Retry rounds (``commit(max_rounds=R)``) ship, in round ``r``, the items
whose within-bucket rank falls in ``[r*C_f, (r+1)*C_f)``; owner views
concatenate rounds to an effective capacity ``R*C_f``; residual overflow
is dropped and counted (``"drop"``), raised on (``"raise-in-test"``), or
handed back for re-injection (``"carry"``).

Not ported yet (each raises ``NotImplementedError``): ``Promise.FINE``
plans, ``commit_async``, ``dead_ranks``, ``integrity`` and non-dense
transports, all ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.promises import Promise, fine_grained, validate
from repro_torch.core.transport import (FlowWire, RequestArgs, Transport,
                                        _DenseCtx, make_transport)
from repro_torch.core.u32 import i32, to_i32
from repro_torch.kernels import ops as kops

_I32 = torch.int32
_I64 = torch.int64

# metadata lane: bit 31 = valid, bits 0..30 = src_pos (int32 views)
_VALID_BIT = i32(1 << 31)
_POS_MASK = (1 << 31) - 1

#: legal ``overflow=`` policies
OVERFLOW_POLICIES = ("drop", "raise-in-test", "carry")

_LATER = "is not ported yet, ROADMAP.md Queue 1 item 7"


class ExchangeOverflowError(RuntimeError):
    """Raised by ``overflow="raise-in-test"`` when a flow drops items."""


class RouteResult(NamedTuple):
    """Owner-side view of a routed flow (+ requester-local slot map).

    payload   (P*C, L) i32 — rows [s*C:(s+1)*C] arrived from rank s
    valid     (P*C,) bool  — which rows hold real items
    src_rank  (P*C,) i32   — originating rank (from the slot position)
    src_pos   (P*C,) i32   — item's index in the sender's original batch
    dropped   () i32       — items dropped for capacity overflow (global)
    capacity  int          — effective per-(src,dst) capacity R*C
    send_item (P*C,) i32   — requester-local: batch index this rank placed
                             in each of its send slots (sentinel N if empty)
    send_occ  (P*C,) bool  — requester-local send-slot occupancy
    lost      () i32       — always 0 here (integrity checks not ported)
    """

    payload: torch.Tensor
    valid: torch.Tensor
    src_rank: torch.Tensor
    src_pos: torch.Tensor
    dropped: torch.Tensor
    capacity: int
    send_item: torch.Tensor
    send_occ: torch.Tensor
    lost: torch.Tensor | int = 0


def _words(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor as int32 words (u32 bit patterns kept)."""
    if x.dtype == torch.uint32:
        return x.view(_I32)
    if x.dtype == torch.bool:
        return x.to(_I32)
    return x.to(_I32) if x.element_size() <= 4 else to_i32(x.to(_I64))


@dataclasses.dataclass
class _Flow:
    """One registered flow of an ExchangePlan."""

    payload: torch.Tensor     # (N, L) i32
    dest: torch.Tensor        # (N,) i32
    capacity: int             # per-(src,dst) slot count C_f
    valid: torch.Tensor       # (N,) bool
    op_name: str
    reply_lanes: int          # 0 = fire-and-forget
    max_rounds: int | None = None

    @property
    def n(self) -> int:
        return self.payload.shape[0]

    @property
    def lanes(self) -> int:
        return self.payload.shape[1]


def _flow_rounds(f: _Flow, plan_rounds: int) -> int:
    """Effective retry rounds: the flow override else the plan's, clamped
    to ``ceil(N_f / C_f)`` (rounds past it could ship nothing new)."""
    r = plan_rounds if f.max_rounds is None else f.max_rounds
    return max(1, min(int(r), -(-f.n // f.capacity)))


class ExchangePlan:
    """Two-phase scheduler fusing concurrent container ops' collectives.

    Each flow is charged the exact bytes of its own ragged wire segment
    under its ``op_name``; the physical collective and its round once,
    under ``name`` (default: the first flow's op).
    """

    def __init__(self, promise: Promise = Promise.NONE, name: str | None = None):
        validate(promise)
        if fine_grained(promise):
            raise NotImplementedError(f"Promise.FINE on an ExchangePlan {_LATER}")
        self.promise = promise
        self.name = name
        self._flows: list[_Flow] = []
        self._committed = False

    def add(self, payload: torch.Tensor, dest: torch.Tensor, capacity: int,
            reply_lanes: int = 0, valid: torch.Tensor | None = None,
            op_name: str = "flow", max_rounds: int | None = None) -> int:
        """Register a flow; returns its handle (index into the plan)."""
        if self._committed:
            raise ValueError(
                "add() after commit(): the round's flows are already on "
                "the wire; build a new ExchangePlan for the next round")
        if payload.ndim not in (1, 2):
            raise ValueError(
                f"flow '{op_name}': payload must be (N,) or (N, L) u32 "
                f"lanes, got ndim={payload.ndim}")
        if payload.ndim == 1:
            payload = payload[:, None]
        payload = _words(payload)
        n = payload.shape[0]
        if dest.ndim != 1 or dest.shape[0] != n:
            raise ValueError(
                f"flow '{op_name}': dest must be ({n},) to match the "
                f"payload's {n} rows, got shape {tuple(dest.shape)}")
        if int(capacity) <= 0:
            raise ValueError(
                f"flow '{op_name}': capacity must be a positive static "
                f"per-(src,dst) slot count, got {capacity}")
        if int(reply_lanes) < 0:
            raise ValueError(
                f"flow '{op_name}': reply_lanes must be >= 0, got {reply_lanes}")
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=payload.device)
        elif valid.ndim != 1 or valid.shape[0] != n:
            raise ValueError(
                f"flow '{op_name}': valid must be ({n},) bool to match "
                f"the payload's {n} rows, got shape {tuple(valid.shape)}")
        if max_rounds is not None and int(max_rounds) < 1:
            raise ValueError(
                f"flow '{op_name}': max_rounds must be >= 1, got {max_rounds}")
        self._flows.append(_Flow(payload, dest.to(_I32), int(capacity),
                                 valid.to(torch.bool), op_name, int(reply_lanes),
                                 None if max_rounds is None else int(max_rounds)))
        return len(self._flows) - 1

    def commit(self, backend: Backend, impl: str = "auto", max_rounds: int = 1,
               overflow: str = "drop", transport: Transport | str | None = None,
               dead_ranks: tuple[int, ...] | None = None,
               integrity: bool = False) -> "CommittedPlan":
        """Issue the request round: one fused all-to-all per retry round."""
        if not self._flows:
            raise ValueError("commit() on an empty ExchangePlan")
        if self._committed:
            raise ValueError("ExchangePlan already committed")
        if int(max_rounds) < 1:
            raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
        if overflow not in OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow must be one of {OVERFLOW_POLICIES}, got {overflow!r}")
        if dead_ranks:
            raise NotImplementedError(f"dead_ranks (degraded commits) {_LATER}")
        if integrity:
            raise NotImplementedError(f"integrity (wire checksums) {_LATER}")
        transport = make_transport(transport)
        self._committed = True
        return self._commit_fused(backend, impl, int(max_rounds), overflow, transport)

    def commit_async(self, *args, **kwargs):
        raise NotImplementedError(f"commit_async (split-phase commits) {_LATER}")

    def _commit_fused(self, backend: Backend, impl: str, rounds: int,
                      overflow: str, transport: Transport) -> "CommittedPlan":
        flows = self._flows
        nprocs = backend.nprocs()
        nflows = len(flows)
        dev = flows[0].payload.device
        caps = [f.capacity for f in flows]
        rounds_f = [_flow_rounds(f, rounds) for f in flows]
        roww = [f.lanes + 1 for f in flows]

        dest_all = torch.cat([f.dest for f in flows])
        valid_all = torch.cat([f.valid for f in flows])
        flow_id = torch.cat([torch.full((f.n,), fi, dtype=_I32, device=dev)
                             for fi, f in enumerate(flows)])

        # ONE binning pass for every flow and every retry round
        costs.record("exchange.bin", costs.Cost(local=int(dest_all.shape[0])))
        counts, offsets = kops.multi_bin_offsets(
            dest_all, flow_id, nprocs, nflows, valid_all, impl=impl)
        eff_arr = torch.tensor([c * r for c, r in zip(caps, rounds_f)],
                               dtype=_I32, device=dev)
        ok = valid_all & (offsets < eff_arr[flow_id.to(_I64)])

        bodies, send_items, send_occs = [], [], []
        row0 = 0
        for fi, f in enumerate(flows):
            pos = torch.arange(f.n, dtype=_I32, device=dev)
            meta = torch.where(f.valid, pos | _VALID_BIT, 0)
            bodies.append(torch.cat([f.payload, meta[:, None]], dim=1))

            # requester-local inverse slot maps in flow-local coordinates
            # (d*(R*C_f) + within-bucket rank), built by the placer kernel
            cap_e = rounds_f[fi] * f.capacity
            okf = ok[row0:row0 + f.n]
            sl_f = torch.where(okf, f.dest * cap_e + offsets[row0:row0 + f.n],
                               nprocs * cap_e).to(_I32)
            send_items.append(kops.place_rows(
                torch.full((nprocs * cap_e,), f.n, dtype=_I32, device=dev), sl_f,
                pos[:, None], impl=impl))
            send_occs.append(kops.place_rows(
                torch.zeros(nprocs * cap_e, dtype=_I32, device=dev), sl_f,
                torch.ones((f.n, 1), dtype=_I32, device=dev), impl=impl) != 0)
            row0 += f.n

        plan_op = self.name or flows[0].op_name
        specs = [FlowWire(caps[fi], rounds_f[fi], roww[fi], flows[fi].reply_lanes,
                          flows[fi].n, flows[fi].op_name) for fi in range(nflows)]
        args = RequestArgs(specs, bodies, dest_all, flow_id, offsets, valid_all,
                           plan_op, impl)
        segments, extra_drop, tctx = transport.request(backend, args)

        # only rank >= R_f*C_f is a drop; one psum covers every flow
        over = (counts - eff_arr[None, :]).clamp(min=0).sum(dim=0)
        dropped = backend.psum(over).to(_I32)
        if extra_drop is not None:
            dropped = dropped + extra_drop[:nflows]

        views = []
        zero = torch.zeros((), dtype=_I32, device=dev)
        for fi, f in enumerate(flows):
            cap_e = rounds_f[fi] * f.capacity
            segment = segments[fi]
            meta_r = segment[:, f.lanes]
            src_rank = torch.arange(nprocs, dtype=_I32, device=dev).repeat_interleave(cap_e)
            views.append(RouteResult(segment[:, :f.lanes], meta_r < 0, src_rank,
                                     meta_r & _POS_MASK, dropped[fi], cap_e,
                                     send_items[fi], send_occs[fi], zero))

        if overflow == "raise-in-test":
            _raise_on_drops(flows, dropped)
        return CommittedPlan(self, views, transport, tctx)


class CommittedPlan:
    """Request round issued; owner-side views available, replies pending."""

    def __init__(self, plan: ExchangePlan, views: list[RouteResult],
                 transport: Transport, tctx):
        self._plan = plan
        self._views = views
        self._transport = transport
        self._tctx = tctx
        self._replies: dict[int, torch.Tensor] = {}
        self._finished = False

    def view(self, handle: int) -> RouteResult:
        """Owner-side view of one flow."""
        return self._views[handle]

    def leftover(self, handle: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(payload, mask)`` of items that were valid but never shipped,
        in the flow's original batch coordinates (``overflow="carry"``)."""
        f = self._plan._flows[handle]
        return f.payload, carry_mask(self._views[handle], f.valid)

    def set_reply(self, handle: int, rows: torch.Tensor) -> None:
        """Stage per-request replies ``(P*C_f, reply_lanes)`` for one flow."""
        f = self._plan._flows[handle]
        if rows.ndim == 1:
            rows = rows[:, None]
        if f.reply_lanes == 0:
            raise ValueError(f"flow {handle} ({f.op_name}) declared reply_lanes=0")
        if rows.shape[1] != f.reply_lanes:
            raise ValueError(
                f"flow {handle} ({f.op_name}) declared reply_lanes="
                f"{f.reply_lanes}, got {rows.shape[1]}")
        self._replies[handle] = _words(rows)

    def finish(self, backend: Backend) -> dict[int, tuple[torch.Tensor, torch.Tensor]]:
        """Issue the reply round: one fused inverse all-to-all.

        Returns ``{handle: (replies (N_f, reply_lanes), answered (N_f,))}``
        for every flow with ``reply_lanes > 0``, aligned with each flow's
        original request batch.
        """
        if self._finished:
            raise ValueError("CommittedPlan already finished")
        flows = self._plan._flows
        replying = [fi for fi, f in enumerate(flows) if f.reply_lanes > 0]
        for fi in replying:
            if fi not in self._replies:
                raise ValueError(f"finish() before set_reply() for flow {fi} "
                                 f"({flows[fi].op_name})")
        self._finished = True
        if not replying:
            return {}
        staged = {fi: torch.where(self._views[fi].valid[:, None], self._replies[fi], 0)
                  for fi in replying}
        slots = self._transport.reply(backend, self._tctx, staged)
        return {fi: _land(self._views[fi], slots[fi], flows[fi].n) for fi in replying}


def _land(view: RouteResult, back: torch.Tensor, n: int):
    """Replies in send-slot layout -> (replies (n, R), answered (n,))."""
    item = torch.where(view.send_occ, view.send_item, n).to(_I64)
    keep = item < n
    out = torch.zeros((n, back.shape[1]), dtype=_I32, device=back.device)
    out[item[keep]] = back[keep]
    answered = torch.zeros(n, dtype=torch.bool, device=back.device)
    answered[item[keep]] = True
    return out, answered


def carry_mask(req: RouteResult, valid: torch.Tensor) -> torch.Tensor:
    """Items of the original batch that were valid but never shipped."""
    n = valid.shape[0]
    item = torch.where(req.send_occ, req.send_item, n).to(_I64)
    shipped = torch.zeros(n + 1, dtype=torch.bool, device=valid.device)
    shipped[item] = True
    return valid & ~shipped[:n]


def _raise_on_drops(flows: list[_Flow], dropped: torch.Tensor) -> None:
    """``overflow="raise-in-test"``: raise on any drop count."""
    for fi, f in enumerate(flows):
        if int(dropped[fi]) > 0:
            raise ExchangeOverflowError(
                f"flow '{f.op_name}' dropped {int(dropped[fi])} item(s) "
                f"for capacity overflow (capacity={f.capacity}); raise "
                f"capacity or max_rounds, or use overflow='carry'")


def route(backend: Backend, payload: torch.Tensor, dest: torch.Tensor,
          capacity: int, valid: torch.Tensor | None = None, op_name: str = "route",
          impl: str = "auto", max_rounds: int = 1, overflow: str = "drop",
          transport: Transport | str | None = None,
          dead_ranks: tuple[int, ...] | None = None,
          integrity: bool = False) -> RouteResult:
    """Send each row of ``payload`` to rank ``dest[i]``; return the owner view.

    A single-flow :class:`ExchangePlan`, committed immediately.
    """
    plan = ExchangePlan(name=op_name)
    h = plan.add(payload, dest, capacity, valid=valid, op_name=op_name)
    return plan.commit(backend, impl=impl, max_rounds=max_rounds, overflow=overflow,
                       transport=transport, dead_ranks=dead_ranks,
                       integrity=integrity).view(h)


def reply(backend: Backend, req: RouteResult, reply_payload: torch.Tensor,
          orig_n: int, op_name: str = "reply",
          transport: Transport | str | None = None):
    """Route per-request replies back to the requesters (single flow).

    ``reply_payload`` is (P*C, L) aligned with ``req.payload`` rows.
    Returns ``(replies (orig_n, L), answered (orig_n,))``.
    """
    tr = make_transport(transport)
    if tr.name != "dense":
        raise ValueError(f"reply({op_name!r}): the standalone reply is the dense "
                         f"inverse permutation")
    if reply_payload.ndim == 1:
        reply_payload = reply_payload[:, None]
    lanes = reply_payload.shape[1]
    spec = FlowWire(req.capacity, 1, lanes + 1, lanes, orig_n, op_name)
    staged = {0: torch.where(req.valid[:, None], _words(reply_payload), 0)}
    back = tr.reply(backend, _DenseCtx([spec], op_name, "auto"), staged)[0]
    return _land(req, back, orig_n)


def suggest_rounds(loads, capacity: int, slack: float = 1.0, limit: int = 16) -> int:
    """Smallest ``max_rounds`` whose ``R * capacity`` covers the hottest
    observed bucket load times ``slack``, clamped to ``[1, limit]``."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    try:
        peak = max((int(x) for x in loads), default=0)
    except TypeError:
        peak = int(loads)
    need = -(-int(peak * slack) // int(capacity)) if peak > 0 else 1
    return max(1, min(int(limit), need))


def exchange_capacity(n_per_rank: int, nprocs: int, slack: float = 1.25) -> int:
    """Heuristic static capacity for roughly-uniform traffic."""
    if nprocs == 1:
        return n_per_rank
    base = (n_per_rank + nprocs - 1) // nprocs
    return max(1, int(base * slack) + 1)
