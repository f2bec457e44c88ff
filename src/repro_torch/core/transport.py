"""Exchange transports: the physical collective layer (PyTorch port).

:mod:`repro_torch.core.exchange` owns the *logical* exchange (binning,
ragged wire layout, retry rounds, overflow policy, requester-local send
maps) and a :class:`Transport` owns the *physical* request/reply
movement, as in ``repro.core.transport``.  The port ships the dense
transport: one tiled all-to-all per launch over all ranks.  The
hierarchical two-stage transport is ROADMAP.md Queue 1 item 7.

Wire words are int32 bit-views of the JAX package's u32 words; the
word layout and the cost attribution are the JAX package's exactly.
"""

from __future__ import annotations

import abc
import dataclasses

import torch

from repro_torch.core import costs
from repro_torch.core.backend import Backend
from repro_torch.core.object_container import ragged_offsets
from repro_torch.kernels import ops as kops

_I32 = torch.int32


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


class Transport(abc.ABC):
    """Physical movement strategy for the exchange engine's collectives."""

    #: stable identifier ("dense") used by config/benchmark knobs
    name: str

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


#: process-wide default transport
DENSE = DenseTransport()


def make_transport(name) -> Transport:
    """``None``/``"dense"`` -> :data:`DENSE`; a Transport passes through."""
    if name is None or name == "dense":
        return DENSE
    if isinstance(name, Transport):
        return name
    if name == "hier":
        raise NotImplementedError(
            "HierarchicalTransport is not ported yet, ROADMAP.md Queue 1 item 7")
    raise ValueError(f"unknown transport {name!r} (want 'dense')")
