"""Baseline: vanilla OpenWhisk scheduling (paper §2), topology-agnostic.

This is the comparison system of every experiment in the paper, so it is
implemented as a first-class scheduler:

* the gateway (Nginx) forwards requests to controllers **round-robin**
  (hard-coded, §4.3);
* each controller runs **co-prime scheduling** (§2 footnotes 5–6): the
  function's hash selects a *home* (primary) worker — the same function
  always lands on the same worker when it is usable, which implements
  OpenWhisk's code-locality caching — and a co-prime step size walks the
  remaining workers when the preceding ones are overloaded;
* the only invalidation is worker overload/unreachability — there is no
  notion of zones, sets, or data locality, which is exactly the failure
  mode of §5.1 (the MQTT function repeatedly lands on the cloud worker).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.scheduler.engine import (
    Invocation,
    Outcome,
    ScheduleDecision,
    TraceEvent,
)
from repro_torch.core.scheduler.state import ClusterState, WorkerState
from repro_torch.core.scheduler.strategy import coprime_order_cached


class VanillaScheduler:
    """Round-robin gateway + co-prime controller schedule."""

    def __init__(self) -> None:
        self._controller_cursor = 0

    def scheduling_state(self):
        """Snapshot the round-robin cursor (probe/what-if rollback)."""
        return self._controller_cursor

    def restore_scheduling_state(self, state) -> None:
        self._controller_cursor = state

    def schedule(
        self,
        invocation: Invocation,
        cluster: ClusterState,
        *,
        trace: bool = False,
        entry_zone: Optional[str] = None,
    ) -> ScheduleDecision:
        """Vanilla co-prime schedule; ``entry_zone`` restricts the worker
        pool to one zone (the federation's policy-free zone-local pass) —
        vanilla stays topology-blind *within* that pool, exactly as the
        baseline is zone-blind over the whole cluster when unset."""
        decision = ScheduleDecision(outcome=Outcome.FAILED, tag=None)
        tr = decision.trace if trace else None
        controllers = [c for c in cluster.controllers.values() if c.available]
        if not controllers:
            if tr is not None:
                tr.append(TraceEvent("controller", "no available controller"))
            return decision
        controller = controllers[self._controller_cursor % len(controllers)]
        self._controller_cursor += 1
        if tr is not None:
            tr.append(
                TraceEvent(
                    "controller",
                    f"round-robin → {controller.name!r} (vanilla gateway)",
                )
            )

        workers: List[WorkerState] = [
            w for w in cluster.workers.values()
            if entry_zone is None or w.zone == entry_zone
        ]
        if not workers:
            if tr is not None:
                tr.append(TraceEvent("candidate", "no workers"))
            return decision

        for idx in coprime_order_cached(len(workers), invocation.hash):
            worker = workers[idx]
            if not worker.reachable:
                if tr is not None:
                    tr.append(
                        TraceEvent("candidate", f"{worker.name}: unreachable")
                    )
                continue
            if worker.overloaded:
                if tr is not None:
                    tr.append(
                        TraceEvent(
                            "candidate",
                            f"{worker.name}: overloaded "
                            f"({worker.inflight}/{worker.capacity_slots})",
                        )
                    )
                continue
            decision.outcome = Outcome.SCHEDULED
            decision.controller = controller.name
            decision.worker = worker.name
            if tr is not None:
                tr.append(
                    TraceEvent(
                        "candidate", f"{worker.name}: VALID (co-prime home)"
                    )
                )
            return decision

        if tr is not None:
            tr.append(
                TraceEvent("followup", "all workers overloaded → fail (vanilla)")
            )
        return decision
