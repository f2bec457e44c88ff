"""Exchange transports: the physical collective layer (PyTorch port).

:mod:`repro_torch.core.exchange` owns the *logical* exchange (binning,
ragged wire layout, retry rounds, overflow policy, requester-local send
maps) and a :class:`Transport` owns the *physical* request/reply
movement, as in ``repro.core.transport``.  Two transports ship:

  :class:`DenseTransport`         one tiled all-to-all per launch over
                                  all ranks (the oracle).
  :class:`HierarchicalTransport`  the rank axis factored ``P = Pr x Pc``:
                                  stage 1 bins by destination column and
                                  all-to-alls over the row sub-axis, the
                                  relay re-bins by destination row and
                                  stage 2 all-to-alls over the column
                                  sub-axis; replies ride the inverse
                                  two-hop permutation.

Hierarchical rows carry ONE extra hop lane packing ``rank << 20 | o``
(``o`` the item's rank in its dense (dest, flow) bucket): the final
destination on the source->relay hop, the source on the relay->owner
hop, so the owner scatters each arrival straight into its dense slot
and the results are bit-identical to dense.  The packing bounds the
transport to 4096 ranks and effective capacities below ``2**20``.

Wire words are int32 bit-views of the JAX package's u32 words; the
word layout and the cost attribution are the JAX package's exactly.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.object_container import ragged_offsets
from repro_torch.core.u32 import as_u64, to_i32
from repro_torch.kernels import ops as kops

_I32 = torch.int32
_I64 = torch.int64

#: hop lane packing: bits [20, 32) = rank, bits [0, 20) = within-bucket rank
_HOP_SHIFT = 20
_HOP_MASK = (1 << _HOP_SHIFT) - 1
_MAX_RANKS = 1 << (32 - _HOP_SHIFT)


@dataclasses.dataclass(frozen=True)
class FlowWire:
    """Static wire description of one flow (from the ExchangePlan)."""

    capacity: int       # per-round per-(src,dst) slot count C_f
    rounds: int         # effective retry rounds R_f (already clamped)
    roww: int           # dense row words: payload lanes L_f + meta lane
    reply_lanes: int    # declared reply words per row (0 = no reply)
    n: int              # flow batch size N_f
    op_name: str

    @property
    def cap_e(self) -> int:
        """Effective capacity R_f * C_f (retry rounds concatenate)."""
        return self.rounds * self.capacity


@dataclasses.dataclass
class RequestArgs:
    """Everything a transport needs to move one committed plan's requests.

    The ONE ``multi_bin_offsets`` pass is computed by the plan and shared
    by every transport, so admission is transport-independent.
    """

    specs: list[FlowWire]
    bodies: list[torch.Tensor]   # per flow (N_f, roww_f) int32, meta lane last
    dest: torch.Tensor           # (N,) i32 concatenated over flows
    flow_id: torch.Tensor        # (N,) i32
    offsets: torch.Tensor        # (N,) i32 within-(dest, flow) bucket ranks
    valid: torch.Tensor          # (N,) bool
    plan_op: str
    impl: str


@dataclasses.dataclass
class InFlight:
    """Handle of a split-phase request: ``request_start`` returns one,
    ``request_wait`` consumes it."""

    launched: int   # collectives issued before start returned
    state: Any      # transport-private completion state


class Transport(abc.ABC):
    """Physical movement strategy for the exchange engine's collectives."""

    #: stable identifier ("dense" / "hier") used by config/benchmark knobs
    name: str

    def request_start(self, backend: Backend, args: RequestArgs) -> InFlight:
        """Issue the request's collectives; completion deferred to wait.

        Default: the synchronous one-shot, so :meth:`request_wait` just
        unwraps.  Dense keeps it (its single hop leaves nothing to
        defer); transports with dependent hops override both halves.
        """
        nrounds = max(s.rounds for s in args.specs)
        return InFlight(nrounds, self.request(backend, args))

    def request_wait(self, backend: Backend, handle: InFlight):
        """Complete a :meth:`request_start`; returns what request returns."""
        return handle.state

    @abc.abstractmethod
    def request(self, backend: Backend, args: RequestArgs):
        """Move every flow's admitted items to their owners.

        Returns ``(segments, extra_dropped, ctx)``: per-flow owner-side
        segments ``(P * cap_e_f, roww_f)`` in the dense layout (row
        ``s * cap_e + o`` holds the rank-``o`` arrival from rank ``s``),
        an optional per-flow count of transport-stage drops, and an
        opaque context for :meth:`reply`.
        """

    @abc.abstractmethod
    def reply(self, backend: Backend, ctx, staged: dict[int, torch.Tensor]
              ) -> dict[int, torch.Tensor]:
        """Move owner replies back to the requesters' send slots.

        ``staged[fi]`` is ``(P * cap_e_f, R_f)`` aligned with the owner
        segment rows; the result maps each flow to the same-shape array
        in the requester's dense send-slot layout.
        """


def _pad_rows(mats: list[torch.Tensor], wmax: int) -> torch.Tensor:
    """Right-pad per-flow row matrices to one (N, wmax) int32 matrix."""
    return torch.cat(
        [m if m.shape[1] == wmax
         else torch.nn.functional.pad(m, (0, wmax - m.shape[1])) for m in mats],
        dim=0).to(_I32)


@dataclasses.dataclass
class _DenseCtx:
    specs: list[FlowWire]
    plan_op: str
    impl: str


class DenseTransport(Transport):
    """One ragged-word all-to-all per launch over all P ranks.

    Retry round ``r`` is a narrower launch carrying the flows still
    retrying, masked off the ONE binning pass; the reply is ONE inverse
    all-to-all landing every reply in the requester's send slot.
    """

    name = "dense"

    def request(self, backend, args):
        specs = args.specs
        nprocs = backend.nprocs()
        nflows = len(specs)
        dev = args.dest.device

        def table(vals):
            return torch.tensor(vals, dtype=_I32, device=dev)

        caps_arr = table([s.capacity for s in specs])
        rounds_arr = table([s.rounds for s in specs])
        roww_arr = table([s.roww for s in specs])
        nrounds = max(s.rounds for s in specs)

        # round r's all-to-all carries only the flows still retrying at
        # r, each in its own ragged word segment; the fused pack turns
        # the ONE binning pass's ranks into word slots and writes the rows
        wmax = max(s.roww for s in specs)
        rows_all = _pad_rows(args.bodies, wmax)
        recvs, woffs_by_round = [], []
        for r in range(nrounds):
            live = [fi for fi in range(nflows) if specs[fi].rounds > r]
            starts, w_r = ragged_offsets(
                [specs[fi].capacity * specs[fi].roww for fi in live])
            woff_map = dict(zip(live, starts))
            woff_round = table([woff_map.get(fi, 0) for fi in range(nflows)])
            send = kops.pack_rows(
                rows_all, args.dest, args.flow_id, args.offsets, args.valid,
                r, woff_round, roww_arr, caps_arr, rounds_arr, w_r,
                nprocs * w_r, impl=args.impl)
            recvs.append(backend.tiled_all_to_all(send).reshape(nprocs, w_r))
            woffs_by_round.append(woff_map)

        segments = []
        for fi, s in enumerate(specs):
            # rounds concatenate per source: owner row s*(R*C_f) + o holds
            # the rank-o arrival from rank s
            parts = [recvs[r][:, woffs_by_round[r][fi]:
                              woffs_by_round[r][fi] + s.capacity * s.roww]
                     .reshape(nprocs, s.capacity, s.roww)
                     for r in range(s.rounds)]
            segments.append(torch.stack(parts, dim=1)
                            .reshape(nprocs * s.cap_e, s.roww))

        # each flow's bytes are its own capacity x its own row width; the
        # physical collective, its round and its hop once per launch under
        # the plan's op name, retry launches under "<op>.retry"
        for s in specs:
            fb = nprocs * s.capacity * s.roww * 4
            costs.record(s.op_name, costs.Cost(bytes_moved=fb, bytes_out=fb))
            if s.rounds > 1:
                rb = fb * (s.rounds - 1)
                costs.record(f"{s.op_name}.retry",
                             costs.Cost(bytes_moved=rb, bytes_out=rb))
        costs.record(args.plan_op, costs.Cost(collectives=1, rounds=1, hops=1))
        for _ in range(nrounds - 1):
            costs.record(f"{args.plan_op}.retry",
                         costs.Cost(collectives=1, rounds=1, hops=1))
        return segments, None, _DenseCtx(specs, args.plan_op, args.impl)

    def reply(self, backend, ctx, staged):
        specs = ctx.specs
        nprocs = backend.nprocs()
        replying = sorted(staged)
        dev = staged[replying[0]].device
        rls = {fi: staged[fi].shape[1] for fi in replying}
        # ragged reply wire: only replying flows get a word segment,
        # exactly R_f words per row, spanning the effective capacity
        starts, wtot = ragged_offsets(
            [specs[fi].cap_e * rls[fi] for fi in replying])
        seg_off = dict(zip(replying, starts))
        if nprocs * wtot >= 1 << 31:
            # place_rows takes int32 word slots: a wider buffer would wrap
            raise ValueError(f"{ctx.plan_op}: a reply buffer of {nprocs * wtot} words "
                             f"exceeds int32 slots")

        send = torch.zeros(nprocs * wtot, dtype=_I32, device=dev)
        for fi in replying:
            cap = specs[fi].cap_e
            rl = rls[fi]
            # owner arrival row s*C_f + j -> words
            # [s*wtot + seg_f + j*R_f, ... + R_f)
            ar = torch.arange(nprocs * cap, dtype=torch.int64, device=dev)
            base = ((ar // cap) * wtot + seg_off[fi] + (ar % cap) * rl).to(_I32)
            send = kops.place_rows(send, base, staged[fi], impl=ctx.impl)

        back2 = backend.tiled_all_to_all(send).reshape(nprocs, wtot)

        outs = {}
        for fi in replying:
            cap = specs[fi].cap_e
            rl = rls[fi]
            seg = back2[:, seg_off[fi]:seg_off[fi] + cap * rl]
            outs[fi] = seg.reshape(nprocs * cap, rl)
            fb = nprocs * cap * rl * 4
            costs.record(specs[fi].op_name, costs.Cost(bytes_moved=fb, bytes_in=fb))
        costs.record(ctx.plan_op, costs.Cost(collectives=1, rounds=1, hops=1))
        return outs


# ---------------------------------------------------------------------------
# hierarchical: two-stage exchange over a Pr x Pc factorization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HierRound:
    """Per-launch inverse-permutation state retained for the reply."""

    live: list[int]
    # source side, per flow: (stage-1 send row (N_f,), dense requester
    # slot (N_f,)); past-the-end sentinels drop
    src: dict[int, tuple[torch.Tensor, torch.Tensor]]
    # relay side, per flow: stage-2 send row per stage-1 arrival
    rel: dict[int, torch.Tensor]
    # owner side, per flow: dense owner slot per stage-2 arrival
    own: dict[int, torch.Tensor]


@dataclasses.dataclass
class _HierCtx:
    specs: list[FlowWire]
    plan_op: str
    impl: str
    pr: int
    pc: int
    c1: list[int]
    c2: list[int]
    row_groups: tuple
    col_groups: tuple
    rounds: list[_HierRound]


@dataclasses.dataclass
class _HierPre:
    """Launch-invariant state shared by every round's two stages."""

    args: RequestArgs
    pr: int
    pc: int
    row_groups: tuple
    col_groups: tuple
    myrow: int
    caps_arr: torch.Tensor
    rounds_arr: torch.Tensor
    w1: list[int]
    w1_arr: torch.Tensor
    c1: list[int]
    c2: list[int]
    c1_arr: torch.Tensor
    c2_arr: torch.Tensor
    nrounds: int
    destcol: torch.Tensor
    rows1: torch.Tensor   # (N, max w1) right-padded stage-1 rows, hop lane last


@dataclasses.dataclass
class _Stage1Out:
    """One round's source->relay hop, its collective possibly in flight."""

    live: list[int]
    woff1_map: dict[int, int]
    w1r: int
    recv1: Any            # the backend's tiled_all_to_all_start handle
    src: dict[int, tuple[torch.Tensor, torch.Tensor]]
    extra: torch.Tensor


@dataclasses.dataclass
class _RoundOut:
    """One completed round: inverse-permutation state + owner scatters."""

    rnd: _HierRound
    scatters: dict[int, tuple[torch.Tensor, torch.Tensor]]  # fi -> (dslot, rows)
    extra: torch.Tensor


def _gather_rows(src: torch.Tensor, idx: torch.Tensor, n_ok: int) -> torch.Tensor:
    """``src[idx]`` with rows of ``idx >= n_ok`` (past-the-end sentinels) zero."""
    keep = idx < n_ok
    rows = src[idx.clamp(max=max(n_ok - 1, 0)).to(_I64)]
    return torch.where(keep[:, None], rows, 0)


class HierarchicalTransport(Transport):
    """Two-stage all-to-all over the factored rank axis ``P = Pr x Pc``.

    Rank ``r`` sits at ``(r // Pc, r % Pc)``.  Stage 1 bins each item by
    its destination's column and all-to-alls over the row sub-axis (Pc
    peers); the relay re-bins by destination row and stage 2 all-to-alls
    over the column sub-axis (Pr peers).  Per-flow stage capacities
    default to the worst case of dense-admitted traffic,
    ``(min(Pr*C_f, N_f), Pc*min(C_f, N_f))``, so results are
    bit-identical to :class:`DenseTransport`; ``stage_caps={op_name:
    (c1, c2)}`` sizes them down (stage drops are then counted).
    ``pr``/``pc`` pin the factorization; by default it is as square as
    possible.
    """

    name = "hier"

    def __init__(self, pr: int | None = None, pc: int | None = None,
                 stage_caps: dict[str, tuple[int, int]] | None = None):
        self.pr = pr
        self.pc = pc
        self.stage_caps = dict(stage_caps or {})

    def _factor(self, nprocs: int) -> tuple[int, int]:
        pr, pc = self.pr, self.pc
        if pr is None and pc is None:
            pr = int(math.isqrt(nprocs))
            while nprocs % pr:
                pr -= 1
        elif pr is None:
            pr = nprocs // int(pc)
        pr = int(pr)
        pc = nprocs // pr if pc is None else int(pc)
        if pr < 1 or pc < 1 or pr * pc != nprocs:
            raise ValueError(f"HierarchicalTransport: {pr} x {pc} does not factor the "
                             f"{nprocs}-rank axis")
        return pr, pc

    def _stage_caps(self, s: FlowWire, pr: int, pc: int) -> tuple[int, int]:
        if s.op_name in self.stage_caps:
            c1, c2 = self.stage_caps[s.op_name]
            return int(c1), int(c2)
        # worst case of dense-admitted traffic in ONE launch: a source ships
        # <= min(C_f, N_f) to each of a column's Pr ranks; a relay forwards
        # <= min(C_f, N_f) per (row source, dest rank)
        return min(pr * s.capacity, s.n), pc * min(s.capacity, s.n)

    def _pre(self, backend, args):
        """Validate, factor the axis, and derive launch-invariant state."""
        specs = args.specs
        nprocs = backend.nprocs()
        pr, pc = self._factor(nprocs)
        if nprocs > _MAX_RANKS:
            raise ValueError(f"HierarchicalTransport hop lane packs rank<<{_HOP_SHIFT}: "
                             f"{nprocs} ranks exceeds the {_MAX_RANKS} bound")
        for s in specs:
            if s.cap_e > _HOP_MASK:
                raise ValueError(f"flow '{s.op_name}': effective capacity {s.cap_e} "
                                 f"exceeds the hop lane's {_HOP_MASK} bound")
        row_groups = tuple(tuple(i * pc + j for j in range(pc)) for i in range(pr))
        col_groups = tuple(tuple(i * pc + j for i in range(pr)) for j in range(pc))
        dev = args.dest.device

        def table(vals):
            return torch.tensor(vals, dtype=_I32, device=dev)

        w1 = [s.roww + 1 for s in specs]          # + hop lane
        c1 = [self._stage_caps(s, pr, pc)[0] for s in specs]
        c2 = [self._stage_caps(s, pr, pc)[1] for s in specs]
        destcol = (args.dest % pc).to(_I32)
        # hop lane, source->relay: final dest rank | dense bucket rank o
        hop1 = to_i32((args.dest.to(_I64) << _HOP_SHIFT)
                      | (args.offsets.to(_I64) & _HOP_MASK))
        # stage-1 rows (body + hop lane), the same for every round
        row0, mats = 0, []
        for fi, s in enumerate(specs):
            mats.append(torch.cat([args.bodies[fi], hop1[row0:row0 + s.n, None]], dim=1))
            row0 += s.n
        return _HierPre(args, pr, pc, row_groups, col_groups, backend.rank() // pc,
                        table([s.capacity for s in specs]),
                        table([s.rounds for s in specs]), w1, table(w1), c1, c2,
                        table(c1), table(c2), max(s.rounds for s in specs), destcol,
                        _pad_rows(mats, max(w1)))

    def _stage1(self, backend, pre, r):
        """Round r's source->relay hop: bin by dest column, row all-to-all
        (started, not waited for)."""
        args, specs = pre.args, pre.args.specs
        nflows = len(specs)
        pc, w1, c1 = pre.pc, pre.w1, pre.c1
        dev = args.dest.device
        live = [fi for fi in range(nflows) if specs[fi].rounds > r]
        live_arr = torch.tensor([1 if specs[fi].rounds > r else 0 for fi in range(nflows)],
                                dtype=_I32, device=dev)
        # this launch ships exactly the dense round-r window
        fl = args.flow_id.to(_I64)
        cap_i = pre.caps_arr[fl]
        in_round = (args.valid & (pre.rounds_arr[fl] > r)
                    & (args.offsets >= r * cap_i) & (args.offsets < (r + 1) * cap_i))

        costs.record("exchange.bin", costs.Cost(local=int(args.dest.shape[0])))
        cnt1, off1 = kops.multi_bin_offsets(pre.destcol, args.flow_id, pc, nflows,
                                            in_round, impl=args.impl)
        starts1, w1r = ragged_offsets([c1[fi] * w1[fi] for fi in live])
        woff1_map = dict(zip(live, starts1))
        woff1 = torch.tensor([woff1_map.get(fi, 0) for fi in range(nflows)],
                             dtype=_I32, device=dev)
        # fused wire pack: the stage form is the round-0 window with the
        # per-flow live mask as "rounds" (kops.stage_slots's contract)
        send1 = kops.pack_rows(pre.rows1, pre.destcol, args.flow_id, off1, in_round, 0,
                               woff1, pre.w1_arr, pre.c1_arr, live_arr, w1r, pc * w1r,
                               impl=args.impl)
        src_state = {}
        row0 = 0
        nprocs = backend.nprocs()
        for fi, s in enumerate(specs):
            sl = slice(row0, row0 + s.n)
            if s.rounds > r:
                ship1 = in_round[sl] & (off1[sl] < c1[fi])
                r1 = torch.where(ship1, pre.destcol[sl] * c1[fi] + off1[sl],
                                 pc * c1[fi]).to(_I32)
                dslot = torch.where(ship1, args.dest[sl] * s.cap_e + args.offsets[sl],
                                    nprocs * s.cap_e).to(_I32)
                src_state[fi] = (r1, dslot)
            row0 += s.n
        extra = (cnt1 - pre.c1_arr[None, :]).clamp(min=0).sum(dim=0, dtype=_I32)
        recv1 = backend.tiled_all_to_all_start(send1, groups=pre.row_groups)
        return _Stage1Out(live, woff1_map, w1r, recv1, src_state, extra)

    def _stage2(self, backend, pre, s1):
        """One round's relay re-bin + relay->owner hop + owner slots."""
        args, specs = pre.args, pre.args.specs
        nflows = len(specs)
        pr, pc, w1, c1, c2 = pre.pr, pre.pc, pre.w1, pre.c1, pre.c2
        live, woff1_map = s1.live, s1.woff1_map
        recv1 = backend.tiled_all_to_all_wait(s1.recv1).reshape(pc, s1.w1r)
        nprocs = backend.nprocs()
        dev = args.dest.device

        # ---- relay: recover the source positionally, re-bin by row ----
        rel_bins, rel_flow, rel_valid, rel_rows = [], [], [], []
        for fi in live:
            s = specs[fi]
            seg = recv1[:, woff1_map[fi]:woff1_map[fi] + c1[fi] * w1[fi]] \
                .reshape(pc * c1[fi], w1[fi])
            rv = seg[:, s.roww - 1] < 0                  # meta lane's bit 31
            hop = as_u64(seg[:, s.roww])
            dst = (hop >> _HOP_SHIFT).to(_I32)
            o = hop & _HOP_MASK
            # the stage-1 arrival block index IS the source's column
            src_col = torch.arange(pc * c1[fi], dtype=_I64, device=dev) // c1[fi]
            src = pre.myrow * pc + src_col
            hop2 = to_i32((src << _HOP_SHIFT) | o)
            rel_rows.append(torch.cat([seg[:, :s.roww], hop2[:, None]], dim=1))
            rel_bins.append(torch.where(rv, dst // pc, 0))
            rel_flow.append(torch.full((pc * c1[fi],), fi, dtype=_I32, device=dev))
            rel_valid.append(rv)
        rbins = torch.cat(rel_bins)
        rflow = torch.cat(rel_flow)
        rvalid = torch.cat(rel_valid)

        # ---- stage 2: bin by destination row, column all-to-all ----
        costs.record("exchange.bin", costs.Cost(local=int(rbins.shape[0])))
        cnt2, off2 = kops.multi_bin_offsets(rbins, rflow, pr, nflows, rvalid,
                                            impl=args.impl)
        live_arr = torch.tensor([1 if fi in live else 0 for fi in range(nflows)],
                                dtype=_I32, device=dev)
        starts2, w2r = ragged_offsets([c2[fi] * w1[fi] for fi in live])
        woff2_map = dict(zip(live, starts2))
        woff2 = torch.tensor([woff2_map.get(fi, 0) for fi in range(nflows)],
                             dtype=_I32, device=dev)
        send2 = kops.pack_rows(_pad_rows(rel_rows, max(w1[fi] for fi in live)), rbins,
                               rflow, off2, rvalid, 0, woff2, pre.w1_arr, pre.c2_arr,
                               live_arr, w2r, pr * w2r, impl=args.impl)
        rel_state = {}
        m0 = 0
        for fi in live:
            sl = slice(m0, m0 + pc * c1[fi])
            ship2 = rvalid[sl] & (off2[sl] < c2[fi])
            rel_state[fi] = torch.where(ship2, rbins[sl] * c2[fi] + off2[sl],
                                        pr * c2[fi]).to(_I32)
            m0 += pc * c1[fi]
        extra = s1.extra + (cnt2 - pre.c2_arr[None, :]).clamp(min=0).sum(dim=0, dtype=_I32)
        recv2 = backend.tiled_all_to_all(send2, groups=pre.col_groups).reshape(pr, w2r)

        # ---- owner: recover dense slots for the scatter ----
        own_state, scatters = {}, {}
        for fi in live:
            s = specs[fi]
            seg2 = recv2[:, woff2_map[fi]:woff2_map[fi] + c2[fi] * w1[fi]] \
                .reshape(pr * c2[fi], w1[fi])
            v2 = seg2[:, s.roww - 1] < 0
            hop2v = as_u64(seg2[:, s.roww])
            dslot = torch.where(v2, (hop2v >> _HOP_SHIFT) * s.cap_e + (hop2v & _HOP_MASK),
                                nprocs * s.cap_e).to(_I32)
            scatters[fi] = (dslot, seg2[:, :s.roww])
            own_state[fi] = dslot
        return _RoundOut(_HierRound(live, s1.src, rel_state, own_state), scatters, extra)

    def _assemble(self, backend, pre, rounds):
        """Fold completed rounds into owner segments + cost records."""
        args, specs = pre.args, pre.args.specs
        nflows = len(specs)
        pr, pc, w1, c1, c2 = pre.pr, pre.pc, pre.w1, pre.c1, pre.c2
        nprocs = backend.nprocs()
        dev = args.dest.device

        seg_out = [torch.zeros((nprocs * s.cap_e, s.roww), dtype=_I32, device=dev)
                   for s in specs]
        extra = torch.zeros(nflows, dtype=_I32, device=dev)
        for out in rounds:
            for fi, (dslot, rows) in out.scatters.items():
                # dense-slot owner scatter through the placer: word slot =
                # row slot * row width; sentinel rows land at the end and drop
                s = specs[fi]
                seg_out[fi] = kops.place_rows(seg_out[fi].reshape(-1), dslot * s.roww, rows,
                                              impl=args.impl).reshape(nprocs * s.cap_e,
                                                                      s.roww)
            extra = extra + out.extra

        # the requester-side hop under the flow's own op (retry launches
        # under "<op>.retry"); every relay->owner hop under "<op>.relay";
        # each launch is 2 collectives / 2 rounds / 2 hops under the plan op
        for fi, s in enumerate(specs):
            b1 = pc * c1[fi] * w1[fi] * 4
            b2 = pr * c2[fi] * w1[fi] * 4
            costs.record(s.op_name, costs.Cost(bytes_moved=b1, bytes_out=b1))
            if s.rounds > 1:
                rb = b1 * (s.rounds - 1)
                costs.record(f"{s.op_name}.retry", costs.Cost(bytes_moved=rb, bytes_out=rb))
            rel = b2 * s.rounds
            costs.record(f"{s.op_name}.relay", costs.Cost(bytes_moved=rel, bytes_out=rel))
        costs.record(args.plan_op, costs.Cost(collectives=2, rounds=2, hops=2))
        for _ in range(pre.nrounds - 1):
            costs.record(f"{args.plan_op}.retry", costs.Cost(collectives=2, rounds=2, hops=2))

        dropped = backend.psum(extra).to(_I32)
        ctx = _HierCtx(specs, args.plan_op, args.impl, pr, pc, c1, c2, pre.row_groups,
                       pre.col_groups, [out.rnd for out in rounds])
        return seg_out, dropped, ctx

    def request(self, backend, args):
        # synchronous: the stages interleave per round [s1_r0, s2_r0, s1_r1,
        # ...], the launch numbering fault specs and cost pins rely on
        pre = self._pre(backend, args)
        rounds = [self._stage2(backend, pre, self._stage1(backend, pre, r))
                  for r in range(pre.nrounds)]
        return self._assemble(backend, pre, rounds)

    def request_start(self, backend, args):
        # split-phase: every round's source->relay hop is issued up front
        # (they are independent); relays, owner hops and scatters wait.
        # Launch order [s1_r0 .. s1_rk, s2_r0 ..]
        pre = self._pre(backend, args)
        s1s = [self._stage1(backend, pre, r) for r in range(pre.nrounds)]
        return InFlight(pre.nrounds, (pre, s1s))

    def request_wait(self, backend, handle):
        pre, s1s = handle.state
        rounds = [self._stage2(backend, pre, s1) for s1 in s1s]
        return self._assemble(backend, pre, rounds)

    def reply(self, backend, ctx, staged):
        specs = ctx.specs
        nprocs = backend.nprocs()
        pr, pc, c1, c2 = ctx.pr, ctx.pc, ctx.c1, ctx.c2
        rls = {fi: staged[fi].shape[1] for fi in staged}
        dev = next(iter(staged.values())).device
        for fi in staged:
            if nprocs * specs[fi].cap_e * rls[fi] >= 1 << 31:
                # the source lands replies by int32 word slots (place_rows)
                raise ValueError(f"{ctx.plan_op}: flow '{specs[fi].op_name}' replies "
                                 f"{nprocs * specs[fi].cap_e * rls[fi]} words, past int32 "
                                 f"slots")

        # ---- inverse stage 2: owner -> relay, ONE collective covering
        # every launch (per-launch blocks concatenate along words) ----
        blocks2, layout = [], []
        for rnd in ctx.rounds:
            rf = [fi for fi in rnd.live if fi in staged]
            parts = [_gather_rows(staged[fi], rnd.own[fi], nprocs * specs[fi].cap_e)
                     .reshape(pr, c2[fi] * rls[fi]) for fi in rf]
            layout.append(rf)
            blocks2.append(torch.cat(parts, dim=1) if parts
                           else torch.zeros((pr, 0), dtype=_I32, device=dev))
        send2 = torch.cat(blocks2, dim=1)
        wtot2 = send2.shape[1]
        back2 = backend.tiled_all_to_all(send2.reshape(-1), groups=ctx.col_groups) \
            .reshape(pr, wtot2)

        # ---- inverse stage 1: relay -> source, ONE collective ----
        blocks1 = []
        woff = 0
        for rnd, rf in zip(ctx.rounds, layout):
            parts = []
            for fi in rf:
                rl = rls[fi]
                rep2 = back2[:, woff:woff + c2[fi] * rl].reshape(pr * c2[fi], rl)
                woff += c2[fi] * rl
                parts.append(_gather_rows(rep2, rnd.rel[fi], pr * c2[fi])
                             .reshape(pc, c1[fi] * rl))
            blocks1.append(torch.cat(parts, dim=1) if parts
                           else torch.zeros((pc, 0), dtype=_I32, device=dev))
        send1 = torch.cat(blocks1, dim=1)
        wtot1 = send1.shape[1]
        back1 = backend.tiled_all_to_all(send1.reshape(-1), groups=ctx.row_groups) \
            .reshape(pc, wtot1)

        # ---- source: land replies in the dense send-slot layout ----
        outs = {fi: torch.zeros((nprocs * specs[fi].cap_e, rls[fi]), dtype=_I32,
                                device=dev) for fi in staged}
        woff = 0
        for rnd, rf in zip(ctx.rounds, layout):
            for fi in rf:
                s = specs[fi]
                rl = rls[fi]
                rep1 = back1[:, woff:woff + c1[fi] * rl].reshape(pc * c1[fi], rl)
                woff += c1[fi] * rl
                r1, dslot = rnd.src[fi]
                rows = _gather_rows(rep1, r1, pc * c1[fi])
                outs[fi] = kops.place_rows(outs[fi].reshape(-1), dslot * rl, rows,
                                           impl=ctx.impl).reshape(nprocs * s.cap_e, rl)

        for fi in sorted(staged):
            s = specs[fi]
            b1 = pc * c1[fi] * rls[fi] * 4 * s.rounds
            b2 = pr * c2[fi] * rls[fi] * 4 * s.rounds
            costs.record(s.op_name, costs.Cost(bytes_moved=b1, bytes_in=b1))
            costs.record(f"{s.op_name}.relay", costs.Cost(bytes_moved=b2, bytes_in=b2))
        costs.record(ctx.plan_op, costs.Cost(collectives=2, rounds=2, hops=2))
        return outs


#: process-wide default transport
DENSE = DenseTransport()


def make_transport(name, pr: int | None = None, pc: int | None = None) -> Transport:
    """``None``/``"dense"`` -> :data:`DENSE`; ``"hier"`` -> a
    :class:`HierarchicalTransport` (optionally with a pinned ``pr x pc``
    factorization); a Transport instance passes through."""
    if name is None:
        return DENSE
    if isinstance(name, Transport):
        return name
    if name == "dense":
        return DENSE
    if name == "hier":
        return HierarchicalTransport(pr, pc)
    raise ValueError(f"unknown transport {name!r} (want 'dense' or 'hier')")
