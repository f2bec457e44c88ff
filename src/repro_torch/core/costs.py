"""Operation-cost accounting mirroring paper Tables 2, 3 and 4 (PyTorch port).

The paper expresses the best-case cost of each data-structure operation in
terms of

  R  remote reads           W  remote writes
  A  remote atomic ops      B  global barriers
  l  local memory ops       n  elements involved

On the GPU the *mechanism* differs (owner-computes collectives instead of
RDMA/AMOs) but the cost model is preserved: every container method reports
the cost of the schedule it actually lowered, in the paper's own units,
plus the device-side observables (number of collectives launched and bytes
moved).  Tests assert the paper's exact cost formulas; benchmarks report
bytes and collective counts next to wall time.

Costs depend only on shapes and promises, never on data.  The JAX
package records them once per trace; the port runs eagerly and records
them on every call, so one eager call logs what one trace logs there.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Iterator


@dataclasses.dataclass
class Cost:
    """Cost of one data-structure operation in the paper's units."""

    A: int = 0          # remote atomic ops (owner-RMW rounds here)
    R: int = 0          # remote reads (elements)
    W: int = 0          # remote writes (elements)
    B: int = 0          # barriers
    local: int = 0      # local ops (elements)
    collectives: int = 0  # device observable: collectives launched
    bytes_moved: int = 0  # device observable: bytes through collectives
    rounds: int = 0       # device observable: all-to-all round trips on the
    #                       critical path (the latency term of the paper's
    #                       aggregation argument, section 4.2)
    bytes_out: int = 0    # bytes in the request direction (requester->owner)
    bytes_in: int = 0     # bytes in the reply direction (owner->requester)
    hops: int = 0         # device observable: physical exchange stages on the
    #                       critical path — 1 per dense all-to-all launch,
    #                       2 per hierarchical (two-stage) launch, so a
    #                       cost log shows which transport moved the bytes
    #                       (DESIGN.md section 1.7)
    lost_bytes: int = 0   # wire bytes admitted toward destinations known
    #                       to be dead at commit time (degraded commits,
    #                       DESIGN.md section 1.8); static upper bound
    unreachable: int = 0  # dead destination ranks masked at admission
    overlap_launches: int = 0  # collective launches issued split-phase
    #                       (commit_async start) whose completion was
    #                       deferred to finish(); counted once, at wait
    #                       time, alongside the launch's normal
    #                       collectives/hops/bytes (DESIGN.md section 1.9)

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(
            self.A + other.A,
            self.R + other.R,
            self.W + other.W,
            self.B + other.B,
            self.local + other.local,
            self.collectives + other.collectives,
            self.bytes_moved + other.bytes_moved,
            self.rounds + other.rounds,
            self.bytes_out + other.bytes_out,
            self.bytes_in + other.bytes_in,
            self.hops + other.hops,
            self.lost_bytes + other.lost_bytes,
            self.unreachable + other.unreachable,
            self.overlap_launches + other.overlap_launches,
        )

    def formula(self) -> str:
        """Render in the paper's notation, e.g. ``2A + nW``."""
        parts = []
        for val, sym in ((self.A, "A"), (self.R, "R"), (self.W, "W"),
                         (self.B, "B"), (self.local, "l")):
            if val == 1:
                parts.append(sym)
            elif val > 1:
                parts.append(f"{val}{sym}")
        return " + ".join(parts) if parts else "0"


@dataclasses.dataclass
class CostLog:
    """Accumulates per-operation costs; installed via :func:`recording`."""

    entries: list = dataclasses.field(default_factory=list)

    def record(self, op: str, cost: Cost) -> None:
        self.entries.append((op, cost))

    def total(self) -> Cost:
        tot = Cost()
        for _, c in self.entries:
            tot = tot + c
        return tot

    def by_op(self, op: str) -> Cost:
        tot = Cost()
        for name, c in self.entries:
            if name == op:
                tot = tot + c
        return tot


_ACTIVE: list[CostLog] = []


def record(op: str, cost: Cost) -> None:
    """Record a cost against the innermost active log (no-op otherwise)."""
    if _ACTIVE:
        _ACTIVE[-1].record(op, cost)


@contextmanager
def recording() -> Iterator[CostLog]:
    """Context manager: collect costs of all container ops issued inside."""
    log = CostLog()
    _ACTIVE.append(log)
    try:
        yield log
    finally:
        _ACTIVE.pop()
