"""Per-zone controller bookkeeping (the paper's ConfigurableLoadBalancer).

The policy *evaluation* lives in :mod:`engine`; this module provides the
stateful controller object the runtime/simulator uses to admit, execute,
and complete invocations on workers — i.e. the part of OpenWhisk's
LoadBalancer that tracks in-flight activations per invoker.

It also exposes the hook the serving engine uses for **straggler
mitigation**: completing an admission with ``slow=True`` feeds the
watcher's load signal so tAPP ``capacity_used`` / ``overload`` conditions
steer subsequent invocations away from the slow worker.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core.scheduler.state import ClusterState
from repro_torch.core.scheduler.watcher import Watcher


@dataclasses.dataclass
class Admission:
    """A ticket for one invocation admitted onto a worker."""

    worker: str
    controller: str
    invocation_id: int
    # Function name for the running-function multiset (affinity signal);
    # empty string = untracked (legacy callers).
    function: str = ""


class AdmissionError(RuntimeError):
    pass


class ControllerRuntime:
    """Tracks slot occupancy for the workers a deployment exposes.

    All mutations go through the watcher so every gateway/controller view
    of load is consistent (single writer, versioned snapshots).
    """

    def __init__(self, watcher: Watcher) -> None:
        self._watcher = watcher
        self._next_id = 0

    @property
    def cluster(self) -> ClusterState:
        return self._watcher.cluster

    def admit(
        self, worker_name: str, controller_name: str, *, function: str = ""
    ) -> Admission:
        try:
            self._watcher.record_admission(worker_name, controller_name, function)
        except KeyError:
            raise AdmissionError(f"unknown worker {worker_name!r}") from None
        except ValueError:
            raise AdmissionError(f"worker {worker_name!r} unreachable") from None
        self._next_id += 1
        return Admission(
            worker=worker_name,
            controller=controller_name,
            invocation_id=self._next_id,
            function=function,
        )

    def admit_many(
        self, placements: Sequence[Tuple]
    ) -> List[Admission]:
        """Batch admission for ``(worker, controller[, function])`` placements.

        The admission-side counterpart of ``TappEngine.schedule_batch``:
        every placement is validated before any state is mutated, so a bad
        placement leaves the cluster untouched, and the recorded state is
        identical to the equivalent sequence of :meth:`admit` calls.
        """
        normalized: List[Tuple[str, str, str]] = []
        for placement in placements:
            worker_name, controller_name = placement[0], placement[1]
            function = placement[2] if len(placement) > 2 else ""
            worker = self.cluster.workers.get(worker_name)
            if worker is None:
                raise AdmissionError(f"unknown worker {worker_name!r}")
            if not worker.reachable:
                raise AdmissionError(f"worker {worker_name!r} unreachable")
            normalized.append((worker_name, controller_name, function))

        admissions: List[Admission] = []
        for worker_name, controller_name, function in normalized:
            self._next_id += 1
            self._watcher.record_admission(
                worker_name, controller_name, function
            )
            admissions.append(
                Admission(
                    worker=worker_name,
                    controller=controller_name,
                    invocation_id=self._next_id,
                    function=function,
                )
            )
        return admissions

    def complete(self, admission: Admission, *, slow: bool = False) -> None:
        self._watcher.record_completion(
            admission.worker,
            admission.controller,
            admission.function,
            slow=slow,
        )

    def heartbeat(self, worker_name: str, *, healthy: bool = True) -> None:
        worker = self.cluster.workers.get(worker_name)
        if worker is None:
            return
        self._watcher.update_worker(
            worker_name,
            healthy=healthy,
            capacity_used_pct=_pct(worker.inflight, worker.capacity_slots),
        )


def _pct(inflight: int, slots: int) -> float:
    if slots <= 0:
        return 100.0
    return min(100.0, 100.0 * inflight / slots)
