"""Fault-tolerance control plane: heartbeats, stragglers, failover
(a copy of ``repro/runtime/ft.py``: plain Python, no JAX).

At 1000+ nodes, MTBF drops below job length; the framework must treat
node failure as routine.  The control plane here is a set of pure state
machines (simulation-testable on one host, drivable by a real heartbeat
transport on a cluster):

  NodeState / FaultToleranceManager
      heartbeat bookkeeping, failure declaration after ``timeout``
      missed beats, restart-from-checkpoint decision, spare promotion.

  StragglerDetector
      per-node step-time EWMA; z-score against fleet median flags
      stragglers; mitigation hooks (data rebalance / hot spare swap).

Recovery contract with the rest of the stack:
  * checkpoint/ckpt.py restores the newest intact step;
  * data/tokens.py streams are pure functions of (seed, step, shard) so
    a restarted or re-sharded job replays the exact global batches;
  * runtime/elastic.py computes the new (data, model) shape.

The train driver (launch/train.py) wires these together; tests inject
synthetic failures and assert the manager's decisions.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable


class NodeHealth(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    FAILED = "failed"
    SPARE = "spare"


@dataclasses.dataclass
class NodeState:
    node_id: int
    health: NodeHealth = NodeHealth.HEALTHY
    last_heartbeat: float = 0.0
    step_time_ewma: float = 0.0
    missed: int = 0


@dataclasses.dataclass
class FTDecision:
    action: str                    # "none" | "restart" | "rebalance"
    failed_nodes: list[int]
    promoted_spares: list[int]
    restart_step: int | None = None


class FaultToleranceManager:
    """Declares failures and plans recovery. Pure bookkeeping — the
    caller supplies time and the checkpoint step."""

    def __init__(self, n_nodes: int, n_spares: int = 0,
                 heartbeat_interval: float = 10.0, timeout_beats: int = 3):
        self.nodes = {i: NodeState(i) for i in range(n_nodes)}
        for i in range(n_nodes - n_spares, n_nodes):
            self.nodes[i].health = NodeHealth.SPARE
        self.interval = heartbeat_interval
        self.timeout_beats = timeout_beats

    def heartbeat(self, node_id: int, now: float) -> None:
        st = self.nodes[node_id]
        st.last_heartbeat = now
        st.missed = 0
        if st.health == NodeHealth.SUSPECT:
            st.health = NodeHealth.HEALTHY

    def tick(self, now: float, last_ckpt_step: int) -> FTDecision:
        """Advance the failure detector; returns the recovery decision."""
        newly_failed = []
        for st in self.nodes.values():
            if st.health in (NodeHealth.FAILED, NodeHealth.SPARE):
                continue
            gap = now - st.last_heartbeat
            st.missed = int(gap // self.interval)
            if st.missed >= self.timeout_beats:
                st.health = NodeHealth.FAILED
                newly_failed.append(st.node_id)
            elif st.missed >= 1:
                st.health = NodeHealth.SUSPECT

        if not newly_failed:
            return FTDecision("none", [], [])

        promoted = []
        for nid in newly_failed:
            spare = next((s for s in self.nodes.values()
                          if s.health == NodeHealth.SPARE), None)
            if spare is not None:
                spare.health = NodeHealth.HEALTHY
                # a spare has never heartbeated; without a fresh stamp the
                # very next tick would see gap = now - 0 and re-fail it
                spare.last_heartbeat = now
                spare.missed = 0
                promoted.append(spare.node_id)
        # any failure => deterministic restart from the last checkpoint;
        # with spares the world size is unchanged, otherwise elastic.
        return FTDecision("restart", newly_failed, promoted,
                          restart_step=last_ckpt_step)

    def healthy_nodes(self) -> list[int]:
        return [i for i, s in self.nodes.items()
                if s.health == NodeHealth.HEALTHY]


class StragglerDetector:
    """Flags nodes whose step time drifts above the fleet (EWMA + MAD)."""

    def __init__(self, n_nodes: int, alpha: float = 0.2,
                 threshold: float = 2.0):
        self.ewma = [0.0] * n_nodes
        self.alpha = alpha
        self.threshold = threshold

    def observe(self, node_id: int, step_time: float) -> None:
        prev = self.ewma[node_id]
        self.ewma[node_id] = (step_time if prev == 0.0 else
                              (1 - self.alpha) * prev +
                              self.alpha * step_time)

    def stragglers(self) -> list[int]:
        vals = sorted(v for v in self.ewma if v > 0)
        if len(vals) < 3:
            return []
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        sigma = max(1.4826 * mad, 1e-2 * med, 1e-12)
        return [i for i, v in enumerate(self.ewma)
                if v > 0 and (v - med) / sigma > self.threshold]

    def mitigation(self, node_id: int) -> str:
        """Policy: first rebalance input shards away; persistently slow
        nodes get swapped with a spare at the next checkpoint."""
        return ("swap_at_checkpoint"
                if self.ewma[node_id] > 0 and self._persistent(node_id)
                else "rebalance_data")

    def _persistent(self, node_id: int) -> bool:
        vals = sorted(v for v in self.ewma if v > 0)
        if not vals:
            return False     # cold start: no observations, nothing is slow
        med = vals[len(vals) // 2]
        return self.ewma[node_id] > 1.5 * med
