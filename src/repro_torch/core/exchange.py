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

The extensions, as in the JAX package: ``transport=`` picks the physical
layer (dense or the hierarchical two-stage one); ``dead_ranks=`` masks
traffic to ranks known to be down at admission (degraded commits);
``integrity=True`` appends a checksum flow, one word per (dest, round,
flow) window, and the owner invalidates every window whose checksum
fails (``lost``); ``commit_async`` starts the wire and
``PendingPlan.finish`` completes it, bit-identical to ``commit``; a plan
under ``Promise.FINE`` lowers to one sub-plan per flow, the sequential
oracle.

For gradients, ``CommittedPlan.transposer(handle)`` keeps what a flow's
transposes need (:class:`FlowTranspose`): an owner row's cotangent goes
back along the reply direction, a reply's along the request direction, on
the forward commit's maps (no second binning pass), through the same
transport and kernels, and nothing is recorded in the cost log.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.promises import Promise, fine_grained, validate
from repro_torch.core.transport import (FlowWire, RequestArgs, Transport, _DenseCtx,
                                        make_transport)
from repro_torch.core.u32 import M32, as_u64, i32, to_i32
from repro_torch.kernels import ops as kops

_I32 = torch.int32
_I64 = torch.int64

# metadata lane: bit 31 = valid, bits 0..30 = src_pos (int32 views)
_VALID_BIT = i32(1 << 31)
_POS_MASK = (1 << 31) - 1

#: salt added to every wire checksum word, so an intact empty window
#: (SALT + 0) differs from a zeroed segment (0, its meta lane zeroed too)
_CK_SALT = 0x9E3779B9

#: legal ``overflow=`` policies
OVERFLOW_POLICIES = ("drop", "raise-in-test", "carry")


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
    lost      () i32       — items shipped but not surviving arrival
                             (global): windows whose checksum failed;
                             always 0 unless committed with integrity=True
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
    under ``name`` (default: the first flow's op).  A plan under
    ``promise=Promise.FINE`` lowers to one single-flow plan per flow, in
    order: the sequential oracle of the fused schedule.
    """

    def __init__(self, promise: Promise = Promise.NONE, name: str | None = None):
        validate(promise)
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
        """Issue the request round: one fused all-to-all per retry round.

        ``transport``: ``None``/``"dense"``, ``"hier"`` or a Transport.
        ``dead_ranks``: ranks known to be down; traffic to them is masked
        at admission and stays in :meth:`CommittedPlan.leftover` and
        :meth:`CommittedPlan.unreachable`, with ``unreachable`` and
        ``lost_bytes`` recorded in the cost log.  ``integrity=True``: a
        checksum word per (dest, round, flow) window rides the same
        launches; a window that fails verification is invalidated whole
        and counted in the views' ``lost``.
        """
        dead, transport = self._precommit(backend, max_rounds, overflow, dead_ranks,
                                          transport)
        if fine_grained(self.promise):
            return self._commit_fine(backend, impl, int(max_rounds), overflow, transport,
                                     dead, integrity)
        st = self._stage_fused(backend, impl, int(max_rounds), overflow, dead, integrity)
        segments, extra_drop, tctx = transport.request(backend, st.args)
        return self._finalize_fused(backend, st, segments, extra_drop, tctx, transport)

    def commit_async(self, backend: Backend, impl: str = "auto", max_rounds: int = 1,
                     overflow: str = "drop", transport: Transport | str | None = None,
                     dead_ranks: tuple[int, ...] | None = None,
                     integrity: bool = False) -> "PendingPlan":
        """Split-phase :meth:`commit`: start the wire, defer completion.

        The transport's ``request_start`` issues the request's
        collectives; :meth:`PendingPlan.finish` waits for them and yields
        the :class:`CommittedPlan` a synchronous commit gives, bit for
        bit.  The launches record their collectives, hops and bytes once,
        at the wait; ``finish`` adds ``overlap_launches`` under the plan
        op.  Under ``Promise.FINE`` the plan commits eagerly and the
        returned PendingPlan is already complete.
        """
        dead, transport = self._precommit(backend, max_rounds, overflow, dead_ranks,
                                          transport)
        if fine_grained(self.promise):
            return PendingPlan(self, committed=self._commit_fine(
                backend, impl, int(max_rounds), overflow, transport, dead, integrity))
        st = self._stage_fused(backend, impl, int(max_rounds), overflow, dead, integrity)
        handle = transport.request_start(backend, st.args)
        return PendingPlan(self, staged=st, handle=handle, transport=transport)

    def _precommit(self, backend: Backend, max_rounds, overflow, dead_ranks, transport):
        """Shared commit/commit_async validation + one-shot latch."""
        if not self._flows:
            raise ValueError("commit() on an empty ExchangePlan")
        if self._committed:
            raise ValueError("ExchangePlan already committed")
        if int(max_rounds) < 1:
            raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
        if overflow not in OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow must be one of {OVERFLOW_POLICIES}, got {overflow!r}")
        dead = tuple(sorted({int(d) for d in (dead_ranks or ())}))
        for d in dead:
            if not 0 <= d < backend.nprocs():
                raise ValueError(f"dead_ranks names rank {d}, outside the "
                                 f"{backend.nprocs()}-rank axis")
        self._committed = True
        return dead, make_transport(transport)

    def _commit_fine(self, backend: Backend, impl: str, max_rounds: int, overflow: str,
                     transport: Transport, dead: tuple[int, ...],
                     integrity: bool) -> "CommittedPlan":
        # sequential oracle: one single-flow plan per flow, in registration
        # order, over the same transport; the sub-plans carry the replies
        subs = []
        for f in self._flows:
            p = ExchangePlan(name=f.op_name)
            p.add(f.payload, f.dest, f.capacity, reply_lanes=f.reply_lanes,
                  valid=f.valid, op_name=f.op_name)
            subs.append(p.commit(backend, impl=impl,
                                 max_rounds=_flow_rounds(f, max_rounds),
                                 overflow=overflow, transport=transport,
                                 dead_ranks=dead, integrity=integrity))
        return CommittedPlan(self, [c.view(0) for c in subs], sequential=True,
                             subplans=subs, dead_ranks=dead)

    # -- fused lowering ---------------------------------------------------

    def _stage_fused(self, backend: Backend, impl: str, rounds: int, overflow: str,
                     dead_ranks: tuple[int, ...], integrity: bool) -> "_StagedCommit":
        """Everything BEFORE the wire moves: the one binning pass,
        admission, wire bodies, send maps, and the RequestArgs the
        transport ships.  The synchronous and the split-phase commit
        share it, which keeps them bit-identical."""
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

        # degraded commit: traffic toward dead ranks is masked BEFORE
        # admission, so it never takes a send slot and stays a leftover
        for d in dead_ranks:
            valid_all = valid_all & (dest_all != d)

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
        if dead_ranks:
            # static degraded-commit observables: the masked destinations
            # and the worst-case wire bytes their buckets would have carried
            lb = sum(len(dead_ranks) * rounds_f[fi] * caps[fi] * roww[fi] * 4
                     for fi in range(nflows))
            costs.record(plan_op, costs.Cost(unreachable=len(dead_ranks), lost_bytes=lb))

        send_dest, send_flow, send_off, send_valid = dest_all, flow_id, offsets, valid_all
        ck_rmax = 0
        if integrity:
            # the checksum flow: one word (+ meta lane) per (dest, round,
            # flow) window, riding the same launches.  Row d*R*F + r*F + f
            # has the analytic bucket rank r*F + f at capacity F, so it
            # needs no binning; the word is SALT + the u32 sum of the
            # window's row hashes, which the owner recomputes on arrival
            ck_rmax = max(rounds_f)
            ck_vals = []
            row0 = 0
            for fi, f in enumerate(flows):
                h = as_u64(kops.mix_rows(bodies[fi], impl=impl))
                rf, cf = rounds_f[fi], caps[fi]
                okf = ok[row0:row0 + f.n]
                seg = torch.where(okf, f.dest.to(_I64) * rf
                                  + offsets[row0:row0 + f.n].to(_I64) // cf, nprocs * rf)
                # exact integer sums (int64), wrapped to u32 after
                sums = torch.zeros(nprocs * rf + 1, dtype=_I64, device=dev) \
                    .index_add_(0, seg, h)[:-1].reshape(nprocs, rf) & M32
                if rf < ck_rmax:
                    sums = torch.nn.functional.pad(sums, (0, ck_rmax - rf))
                ck_vals.append(sums)
                row0 += f.n
            ck_lane = to_i32(_CK_SALT + torch.stack(ck_vals, dim=2).reshape(-1))
            n_ck = nprocs * ck_rmax * nflows
            ar = torch.arange(n_ck, dtype=_I32, device=dev)
            bodies.append(torch.stack([ck_lane, ar | _VALID_BIT], dim=1))
            specs.append(FlowWire(nflows, ck_rmax, 2, 0, n_ck, "exchange.integrity"))
            send_dest = torch.cat([dest_all, ar // (ck_rmax * nflows)])
            send_flow = torch.cat([flow_id, torch.full((n_ck,), nflows, dtype=_I32,
                                                       device=dev)])
            send_off = torch.cat([offsets, ar % (ck_rmax * nflows)])
            send_valid = torch.cat([valid_all, torch.ones(n_ck, dtype=torch.bool,
                                                          device=dev)])

        return _StagedCommit(
            args=RequestArgs(specs, bodies, send_dest, send_flow, send_off, send_valid,
                             plan_op, impl),
            rounds_f=rounds_f, counts=counts, eff_arr=eff_arr, ok=ok,
            send_items=send_items, send_occs=send_occs, overflow=overflow,
            dead_ranks=dead_ranks, integrity=integrity, ck_rmax=ck_rmax)

    def _finalize_fused(self, backend: Backend, st: "_StagedCommit", segments,
                        extra_drop, tctx, transport: Transport) -> "CommittedPlan":
        """Everything AFTER the wire lands: integrity verification,
        overflow accounting, owner views."""
        flows = self._flows
        nprocs = backend.nprocs()
        nflows = len(flows)
        dev = flows[0].payload.device
        rounds_f, ok, impl, ck_rmax = st.rounds_f, st.ok, st.args.impl, st.ck_rmax

        # only rank >= R_f*C_f is a drop; one psum covers every flow
        over = (st.counts - st.eff_arr[None, :]).clamp(min=0).sum(dim=0, dtype=_I32)
        lost = None
        good_by_flow = []
        if st.integrity:
            # owner-side verification: recompute each (src, round) window's
            # hash sum from the arrival segment; a failed window (corrupt
            # word, zeroed segment) invalidates ALL its arrivals.  lost is
            # the global sent-minus-survived count, in the same psum
            ck_seg = segments[nflows]
            ck_ok3 = (ck_seg[:, 1] < 0).reshape(nprocs, ck_rmax, nflows)
            ck_val3 = as_u64(ck_seg[:, 0]).reshape(nprocs, ck_rmax, nflows)
            sent, surv = [], []
            row0 = 0
            for fi, f in enumerate(flows):
                rf, cf = rounds_f[fi], f.capacity
                comp = as_u64(kops.mix_rows(segments[fi], impl=impl)) \
                    .reshape(nprocs, rf, cf).sum(dim=2)
                good = ck_ok3[:, :rf, fi] & (ck_val3[:, :rf, fi] == ((_CK_SALT + comp) & M32))
                good_rows = good.reshape(-1).repeat_interleave(cf)
                good_by_flow.append(good_rows)
                sent.append(ok[row0:row0 + f.n].sum(dtype=_I32))
                alive = (segments[fi][:, f.lanes] < 0) & good_rows
                surv.append(alive.sum(dtype=_I32))
                row0 += f.n
            red = backend.psum(torch.cat([over, torch.stack(sent),
                                          torch.stack(surv)])).to(_I32)
            dropped = red[:nflows]
            lost = (red[nflows:2 * nflows] - red[2 * nflows:]).clamp(min=0)
        else:
            dropped = backend.psum(over).to(_I32)
        if extra_drop is not None:
            dropped = dropped + extra_drop[:nflows]

        views = []
        zero = torch.zeros((), dtype=_I32, device=dev)
        for fi, f in enumerate(flows):
            cap_e = rounds_f[fi] * f.capacity
            segment = segments[fi]
            meta_r = segment[:, f.lanes]
            out_valid = meta_r < 0                       # bit 31
            if st.integrity:
                out_valid = out_valid & good_by_flow[fi]
            src_rank = torch.arange(nprocs, dtype=_I32, device=dev).repeat_interleave(cap_e)
            views.append(RouteResult(segment[:, :f.lanes], out_valid, src_rank,
                                     meta_r & _POS_MASK, dropped[fi], cap_e,
                                     st.send_items[fi], st.send_occs[fi],
                                     zero if lost is None else lost[fi]))

        if st.overflow == "raise-in-test":
            _raise_on_drops(flows, dropped)
        return CommittedPlan(self, views, transport=transport, tctx=tctx,
                             dead_ranks=st.dead_ranks, staged=st)


@dataclasses.dataclass
class _StagedCommit:
    """Pre-wire state of a fused commit (shared by the sync and async
    paths): ``args`` is what the transport ships, the rest is what
    ``_finalize_fused`` needs once the owner segments land."""

    args: RequestArgs
    rounds_f: list[int]
    counts: torch.Tensor
    eff_arr: torch.Tensor
    ok: torch.Tensor
    send_items: list[torch.Tensor]
    send_occs: list[torch.Tensor]
    overflow: str
    dead_ranks: tuple[int, ...]
    integrity: bool
    ck_rmax: int


class CommittedPlan:
    """Request round issued; owner-side views available, replies pending."""

    def __init__(self, plan: ExchangePlan, views: list[RouteResult],
                 sequential: bool = False, transport: Transport | None = None,
                 tctx=None, subplans: list["CommittedPlan"] | None = None,
                 dead_ranks: tuple[int, ...] = (), staged: _StagedCommit | None = None):
        self._plan = plan
        self._views = views
        self._sequential = sequential
        self._transport = transport        # physical layer (fused path)
        self._tctx = tctx                  # transport's reply context
        self._subplans = subplans or []    # FINE: one sub-plan per flow
        self._dead_ranks = tuple(dead_ranks)
        self._staged = staged              # the request's maps (fused path)
        self._replies: dict[int, torch.Tensor] = {}
        self._finished = False

    def view(self, handle: int) -> RouteResult:
        """Owner-side view of one flow."""
        return self._views[handle]

    def reply_lanes(self, handle: int) -> int:
        """Reply words per row that flow ``handle`` declared (0 = none)."""
        return self._plan._flows[handle].reply_lanes

    def leftover(self, handle: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(payload, mask)`` of items that were valid but never shipped,
        in the flow's original batch coordinates (``overflow="carry"``)."""
        f = self._plan._flows[handle]
        return f.payload, carry_mask(self._views[handle], f.valid)

    def unreachable(self, handle: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(payload, mask)`` of the valid rows addressed to a dead rank
        (``commit(dead_ranks=...)``), in the flow's original batch
        coordinates; every such row is also in :meth:`leftover`."""
        f = self._plan._flows[handle]
        mask = torch.zeros_like(f.valid)
        for d in self._dead_ranks:
            mask = mask | (f.dest == d)
        return f.payload, f.valid & mask

    def transposer(self, handle: int) -> "FlowTranspose":
        """The maps the transposes of flow ``handle`` need (none of its
        payload), for a gradient carried back over the wire."""
        if self._sequential:
            return self._subplans[handle].transposer(0)
        f, st, view = self._plan._flows[handle], self._staged, self._views[handle]
        row0 = sum(g.n for g in self._plan._flows[:handle])
        sl = slice(row0, row0 + f.n)
        return FlowTranspose(self._transport, self._tctx, handle,
                             FlowWire(f.capacity, st.rounds_f[handle], 0, 0, f.n, f.op_name),
                             st.args.dest[sl], st.args.offsets[sl], st.args.valid[sl],
                             view.valid, view.send_item, view.send_occ, st.args.plan_op,
                             st.args.impl)

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
        if self._sequential:
            # FINE oracle: each flow's reply is its own sub-plan's finish
            outs = {}
            for fi in replying:
                sub = self._subplans[fi]
                sub.set_reply(0, self._replies[fi])
                outs[fi] = sub.finish(backend)[0]
            return outs
        staged = {fi: torch.where(self._views[fi].valid[:, None], self._replies[fi], 0)
                  for fi in replying}
        slots = self._transport.reply(backend, self._tctx, staged)
        return {fi: _land(self._views[fi], slots[fi], flows[fi].n) for fi in replying}


class PendingPlan:
    """Future returned by :meth:`ExchangePlan.commit_async`: the request's
    collectives are started; ``finish(backend)`` waits for them and
    returns the :class:`CommittedPlan`, bit-identical to ``commit``."""

    def __init__(self, plan: ExchangePlan, committed: CommittedPlan | None = None,
                 staged: _StagedCommit | None = None, handle=None,
                 transport: Transport | None = None):
        self._plan = plan
        self._committed = committed        # FINE oracle: already complete
        self._staged = staged
        self._handle = handle
        self._transport = transport
        self._done = False

    def finish(self, backend: Backend) -> CommittedPlan:
        """Complete the wire; one-shot."""
        if self._done:
            raise ValueError("PendingPlan already finished")
        self._done = True
        if self._committed is not None:
            return self._committed
        st = self._staged
        # the deferred launches record their collectives/hops/bytes once,
        # inside request_wait; the start adds only how many ran split-phase
        costs.record(st.args.plan_op, costs.Cost(overlap_launches=self._handle.launched))
        segments, extra_drop, tctx = self._transport.request_wait(backend, self._handle)
        return self._plan._finalize_fused(backend, st, segments, extra_drop, tctx,
                                          self._transport)


class PendingResult:
    """Future of a container op issued split-phase (``async_=True``):
    ``finish()`` runs the owner-side work and the reply round and returns
    exactly what the synchronous op returns.  One-shot."""

    def __init__(self, complete):
        self._complete = complete
        self._done = False

    def finish(self):
        if self._done:
            raise ValueError("PendingResult already finished")
        self._done = True
        out, self._complete = self._complete, None
        return out()


@dataclasses.dataclass
class FlowTranspose:
    """The transposes of one committed flow's two directions, for the
    gradient of what it moved (``CommittedPlan.transposer``).  They reuse
    the forward commit's maps (its one binning pass's destinations and
    ranks, its admission, the send slots and arrivals), move int32 words
    through the same transport, backend and kernels as the forward, and
    record nothing in the cost log: the JAX package records its log once,
    at trace time, and its transposes record none."""

    transport: Transport
    tctx: object
    handle: int              # the flow's index in the plan ``tctx`` belongs to
    spec: FlowWire           # capacity, rounds, batch size, op name
    dest: torch.Tensor       # (N_f,) the request's destinations
    offsets: torch.Tensor    # (N_f,) within-bucket ranks (the one binning pass)
    valid: torch.Tensor      # (N_f,) what the commit offered the wire
    arrived: torch.Tensor    # (P*C_f,) owner rows that hold an arrival
    send_item: torch.Tensor  # (P*C_f,) requester-local slot -> batch index
    send_occ: torch.Tensor   # (P*C_f,)
    plan_op: str
    impl: str

    def route(self, backend: Backend, rows: torch.Tensor) -> torch.Tensor:
        """Transpose of the request direction: owner-side rows ``(P*C_f, W)``
        (aligned with the view's payload) go back along the reply direction
        and land in the flow's batch order, ``(N_f, W)`` words; an item the
        wire did not admit gets zeros."""
        staged = torch.where(self.arrived[:, None], _words(rows), 0)
        with costs.muted():
            back = self.transport.reply(backend, self.tctx, {self.handle: staged})[self.handle]
        return _land_slots(self.send_item, self.send_occ, back, self.spec.n)[0]

    def reply(self, backend: Backend, rows: torch.Tensor) -> torch.Tensor:
        """Transpose of the reply direction: requester-side rows ``(N_f, W)``
        in the flow's batch order go to the owners along the request
        direction and come back aligned with the view's payload,
        ``(P*C_f, W)`` words; an owner row that held no arrival gets zeros."""
        rows = _words(rows)
        spec = dataclasses.replace(self.spec, roww=rows.shape[1])
        args = RequestArgs([spec], [rows], self.dest, torch.zeros_like(self.dest),
                           self.offsets, self.valid, self.plan_op, self.impl)
        with costs.muted():
            seg = self.transport.request(backend, args)[0][0]
        return torch.where(self.arrived[:, None], seg, 0)


def _land(view: RouteResult, back: torch.Tensor, n: int):
    """Replies in send-slot layout -> (replies (n, R), answered (n,))."""
    return _land_slots(view.send_item, view.send_occ, back, n)


def _land_slots(send_item: torch.Tensor, send_occ: torch.Tensor, back: torch.Tensor, n: int):
    item = torch.where(send_occ, send_item, n).to(_I64)
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

    A single-flow :class:`ExchangePlan`, committed immediately (the
    extension knobs as in :meth:`ExchangePlan.commit`).
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
                         f"inverse permutation; a flow routed over transport "
                         f"{tr.name!r} must declare reply_lanes and reply through "
                         f"CommittedPlan.finish")
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
