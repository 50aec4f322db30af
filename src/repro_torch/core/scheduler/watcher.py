"""The Watcher service (paper §4.2) + live tAPP reload (paper §4.5).

The watcher owns the authoritative cluster state — the mapping from
tAPP-level labels/zones/sets to live workers — and the single global copy
of the current tAPP script. Gateways and controllers keep cached copies;
the watcher bumps a version counter and notifies subscribers on change,
which models the paper's NFS-store + cache-invalidation design without
the NFS indirection.

On a TPU fleet, `poll()` would consume per-host agent heartbeats (HBM
occupancy, queue depth, liveness); in-process the runtime/simulator calls
the mutation methods directly.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.state import (
    ClusterState,
    ControllerState,
    HealthState,
    WorkerState,
)
from repro_torch.core.tapp.ast import TappScript
from repro_torch.core.tapp.parser import parse_tapp
from repro_torch.core.tapp.validate import ValidationReport, validate_script

Subscriber = Callable[[str], None]  # event kind: "topology" | "script"

# Worker fields whose transitions invalidate the epoch-cached views.
# zone/sets/capacity_slots change the view *shape*; health, reachability,
# and residency are read live through WorkerState references (the cached
# views stay correct without a rebuild) but are invalidated conservatively,
# so any future policy that filters them out of the view stays safe. These
# are rare transitions; inflight counters, load percentages, and the
# running-function multiset (the affinity signal) are the per-decision
# churn and never bump the epoch, so admissions and completions stay
# cache-hit.
_STRUCTURAL_WORKER_FIELDS = frozenset(
    {
        "zone",
        "sets",
        "capacity_slots",
        "reachable",
        "healthy",
        "health",
        "resident_models",
        "memory_bytes",
    }
)


@dataclasses.dataclass(frozen=True)
class LeaseConfig:
    """Heartbeat-lease thresholds of the failure detector (seconds).

    A worker whose last heartbeat is older than ``suspect_after`` turns
    SUSPECT (deprioritized but placeable); older than ``dead_after`` turns
    DEAD (excluded, in-flight tickets evicted). All lease methods take an
    explicit ``now`` — the detector never reads a wall clock, so seeded
    runs stay deterministic.
    """

    suspect_after: float = 1.5
    dead_after: float = 5.0

    def __post_init__(self) -> None:
        if self.suspect_after <= 0 or self.dead_after <= 0:
            raise ValueError("lease thresholds must be positive")
        if self.dead_after < self.suspect_after:
            raise ValueError(
                f"dead_after ({self.dead_after}) must be >= suspect_after "
                f"({self.suspect_after})"
            )


@dataclasses.dataclass(frozen=True)
class HealthTransition:
    """One failure-detector verdict change, as reported by the watcher."""

    worker: str
    previous: HealthState
    state: HealthState
    at: float
    evicted: int = 0  # in-flight tickets that died with a DEAD transition


class Watcher:
    def __init__(
        self,
        cluster: Optional[ClusterState] = None,
        *,
        lease: Optional[LeaseConfig] = None,
    ) -> None:
        self._lock = threading.RLock()
        # Admission-ledger locks, sharded per zone: the per-decision hot
        # path (record_admission / record_completion) takes only the
        # worker's zone lock, so federated entrypoints never serialize on
        # each other's admission streams. Structural mutations take the
        # global lock first, then the affected zone lock — a strict
        # ordering (global → zone), so the paths cannot deadlock.
        self._zone_locks: Dict[str, threading.Lock] = {}
        self._zone_locks_guard = threading.Lock()
        self._cluster = cluster or ClusterState()
        self._script: Optional[TappScript] = None
        self._script_version = 0
        self._subscribers: List[Subscriber] = []
        self._last_report: Optional[ValidationReport] = None
        self._lease = lease
        # Last-heartbeat timestamps, per worker. Leases are opt-in: a
        # worker enters the detector on its first heartbeat_lease().
        self._leases: Dict[str, float] = {}
        # Warm-pool lifecycle manager (PR 10), attached by an armed
        # platform so worker removal forgets the worker's instances —
        # an instance never outlives its worker. None when unarmed.
        self._lifecycle = None

    # -- subscriptions ---------------------------------------------------------

    def subscribe(self, callback: Subscriber) -> None:
        with self._lock:
            self._subscribers.append(callback)

    def _notify(self, kind: str) -> None:
        for cb in list(self._subscribers):
            cb(kind)

    # -- cluster state ----------------------------------------------------------

    @property
    def cluster(self) -> ClusterState:
        return self._cluster

    def attach_lifecycle(self, manager) -> None:
        """Bind the platform's warm-pool lifecycle manager (PR 10) so
        deregistration and DEAD transitions forget the worker's
        instances in the same breath as the eviction."""
        self._lifecycle = manager

    def _zone_lock(self, zone: str) -> threading.Lock:
        lock = self._zone_locks.get(zone)
        if lock is None:
            with self._zone_locks_guard:
                lock = self._zone_locks.get(zone)
                if lock is None:
                    lock = self._zone_locks[zone] = threading.Lock()
        return lock

    def register_worker(self, worker: WorkerState) -> None:
        """A worker joins (elastic scale-up / node replacement)."""
        with self._lock:
            self._cluster.add_worker(worker)
        self._notify("topology")

    def deregister_worker(self, name: str) -> Optional[WorkerState]:
        """A worker leaves (scale-down, failure eviction).

        Removal goes through the drain path: health and reachability are
        cleared *before* the membership change, all under one lock, so no
        admission can race the removal (``record_admission`` rejects
        unreachable workers), and the single epoch bump of the removal
        invalidates every cached view. Returns the removed state — its
        ``inflight`` count is the number of admission tickets that died
        with the worker, which the platform ledger reconciles as
        evictions (nothing strands).
        """
        with self._lock:
            worker = self._cluster.workers.get(name)
            if worker is not None:
                with self._zone_lock(worker.zone):
                    worker.healthy = False
                    worker.reachable = False
                    self._cluster.remove_worker(name)
            self._leases.pop(name, None)
        if worker is not None and self._lifecycle is not None:
            # Warm instances die with their worker: drop the pools and
            # clear the warmth signal before anyone re-reads it.
            self._lifecycle.forget_worker(name)
        self._notify("topology")
        return worker

    def register_controller(self, controller: ControllerState) -> None:
        with self._lock:
            self._cluster.add_controller(controller)
        self._notify("topology")

    def deregister_controller(self, name: str) -> Optional[ControllerState]:
        """A controller leaves; drained symmetrically to workers (marked
        unavailable before removal, one lock, one epoch bump). Its
        per-worker ``inflight_by`` entitlement entries are retired by the
        normal completion path."""
        with self._lock:
            controller = self._cluster.controllers.get(name)
            if controller is not None:
                controller.healthy = False
                controller.reachable = False
                self._cluster.remove_controller(name)
        self._notify("topology")
        return controller

    def update_worker(self, name: str, **fields) -> None:
        """Apply a heartbeat (load/health/residency update).

        Structural transitions (zone/set/capacity/health/reachability)
        invalidate the epoch-cached topology views; pure load updates
        (inflight counters, capacity percentages) do not.
        """
        with self._lock:
            worker = self._cluster.workers.get(name)
            if worker is None:
                raise KeyError(f"unknown worker {name!r}")
            structural = False
            volatile = False
            zone_changed = False
            updates = []
            for key, value in fields.items():
                if not hasattr(worker, key):
                    raise AttributeError(f"WorkerState has no field {key!r}")
                if key in ("sets", "resident_models"):
                    value = frozenset(value)
                elif key == "health" and not isinstance(value, HealthState):
                    value = HealthState(value)
                if key in _STRUCTURAL_WORKER_FIELDS:
                    if getattr(worker, key) != value:
                        structural = True
                        if key == "zone":
                            zone_changed = True
                else:
                    volatile = True
                updates.append((key, value))
            zone = worker.zone
            if zone_changed:
                # A zone move must exclude the hot paths of BOTH zones:
                # the instant the ``zone`` setattr lands, a concurrent
                # record_admission re-reading worker.zone takes the NEW
                # zone's lock, so holding only the old lock would let
                # counter writes interleave with the structural update.
                # Both locks are taken in sorted order (and only ever
                # under the global lock, which serializes structural
                # mutations), so lock ordering stays deterministic.
                new_zone = next(v for k, v in updates if k == "zone")
                first, second = sorted((zone, new_zone))
                with self._zone_lock(first), self._zone_lock(second):
                    for key, value in updates:
                        setattr(worker, key, value)
                    self._cluster.version += 1
            else:
                with self._zone_lock(zone):
                    for key, value in updates:
                        setattr(worker, key, value)
                    self._cluster.version += 1
                    if not structural and volatile:
                        # Load-only update: candidate indexes refresh
                        # this worker's availability bits incrementally
                        # instead of rebuilding.
                        self._cluster.note_worker_load(name, zone)
            if structural:
                if zone_changed:
                    # A zone move touches two zones' views; invalidate
                    # globally and rebuild the per-zone member map.
                    self._cluster.invalidate_zone_members()
                    self._cluster.bump_topology_epoch()
                else:
                    self._cluster.bump_topology_epoch(zone)

    def update_controller(self, name: str, **fields) -> None:
        """Apply a controller transition (health / reachability).

        Controller availability is read live by the engine's resolution
        paths, but the epoch is bumped conservatively (like worker
        health) so any future view that filters on it stays safe.
        """
        with self._lock:
            controller = self._cluster.controllers.get(name)
            if controller is None:
                raise KeyError(f"unknown controller {name!r}")
            for key, value in fields.items():
                if not hasattr(controller, key):
                    raise AttributeError(
                        f"ControllerState has no field {key!r}"
                    )
                setattr(controller, key, value)
            self._cluster.version += 1
            self._cluster.bump_topology_epoch()
        self._notify("topology")

    def mark_unreachable(self, name: str) -> None:
        self.update_worker(name, reachable=False)
        self._notify("topology")

    def mark_unhealthy(self, name: str) -> None:
        self.update_worker(name, healthy=False)
        self._notify("topology")

    def mark_drained(self, name: str) -> None:
        """Clear health AND reachability in one transition (graceful
        drain): unreachability is the preliminary invalidate condition of
        every policy, so no script admits onto the worker, while
        :meth:`record_completion` still retires its running tickets."""
        self.update_worker(name, healthy=False, reachable=False)
        self._notify("topology")

    def mark_restored(self, name: str) -> None:
        """Clear health + reachability flags (recovery / undrain) — the
        symmetric notification to :meth:`mark_unhealthy` /
        :meth:`mark_unreachable`. Also resets the failure detector's
        verdict: a restored worker is HEALTHY again (its eviction history
        stays recorded through the generation counter)."""
        self.update_worker(
            name, healthy=True, reachable=True, health=HealthState.HEALTHY
        )
        self._notify("topology")

    # -- failure detection (heartbeat leases, PR 6) ------------------------------

    @property
    def lease_config(self) -> Optional[LeaseConfig]:
        return self._lease

    def configure_lease(self, lease: LeaseConfig) -> None:
        """Install (or replace) the failure detector's lease thresholds."""
        with self._lock:
            self._lease = lease

    def heartbeat_lease(
        self, name: str, now: float, **fields
    ) -> Optional[HealthTransition]:
        """Renew a worker's heartbeat lease at time ``now``.

        Enters the worker into the failure detector on first call. A
        heartbeat from a SUSPECT or DEAD worker is the recovery signal:
        the verdict returns to HEALTHY, health + reachability flags are
        restored, and the transition is reported (None: no verdict
        change). Extra keyword fields are applied as a regular
        :meth:`update_worker` heartbeat in the same lock hold. Unknown
        workers raise ``KeyError`` — a drained/deregistered worker's lease
        is gone and cannot resurrect its state.
        """
        transition: Optional[HealthTransition] = None
        with self._lock:
            worker = self._cluster.workers.get(name)
            if worker is None:
                raise KeyError(f"unknown worker {name!r}")
            self._leases[name] = float(now)
            if worker.health is not HealthState.HEALTHY:
                previous = worker.health
                self.update_worker(
                    name, healthy=True, reachable=True,
                    health=HealthState.HEALTHY,
                )
                transition = HealthTransition(
                    worker=name, previous=previous,
                    state=HealthState.HEALTHY, at=float(now),
                )
            if fields:
                self.update_worker(name, **fields)
        if transition is not None:
            self._notify("topology")
        return transition

    def check_leases(self, now: float) -> List[HealthTransition]:
        """Advance the failure detector to time ``now``.

        Expired leases transition HEALTHY→SUSPECT→DEAD per the
        :class:`LeaseConfig` thresholds; each DEAD transition evicts the
        worker's in-flight tickets (see :meth:`mark_dead`) and reports the
        evicted count so the platform ledger can reconcile. Returns the
        transitions in worker registration order.
        """
        lease = self._lease
        if lease is None:
            raise ValueError(
                "watcher has no LeaseConfig; pass lease= at construction "
                "or call configure_lease()"
            )
        transitions: List[HealthTransition] = []
        structural = False
        with self._lock:
            for name in list(self._leases):
                worker = self._cluster.workers.get(name)
                if worker is None:
                    del self._leases[name]
                    continue
                age = float(now) - self._leases[name]
                if age >= lease.dead_after:
                    if worker.health is not HealthState.DEAD:
                        previous = worker.health
                        evicted = self._kill_locked(worker)
                        structural = True
                        transitions.append(
                            HealthTransition(
                                worker=name, previous=previous,
                                state=HealthState.DEAD, at=float(now),
                                evicted=evicted,
                            )
                        )
                elif age >= lease.suspect_after:
                    if worker.health is HealthState.HEALTHY:
                        worker.health = HealthState.SUSPECT
                        structural = True
                        transitions.append(
                            HealthTransition(
                                worker=name, previous=HealthState.HEALTHY,
                                state=HealthState.SUSPECT, at=float(now),
                            )
                        )
            if structural:
                self._cluster.version += 1
                self._cluster.bump_topology_epoch()
        if transitions:
            self._notify("topology")
        return transitions

    def _kill_locked(self, worker: WorkerState) -> int:
        """DEAD transition under the lock: evict in-flight tickets, bump
        the incarnation, clear health + reachability. Returns the number
        of tickets that died with the worker (the caller reconciles them
        as ledger evictions, reusing the deregistration-drain shape).
        Takes the worker's zone lock so the counter wipe cannot interleave
        with a concurrent admission/completion on the hot path."""
        with self._zone_lock(worker.zone):
            evicted = worker.inflight
            worker.inflight = 0
            worker.inflight_by.clear()
            worker.running_functions.clear()
            worker.queued = 0
            worker.capacity_used_pct = 100.0
            worker.generation += 1
            worker.health = HealthState.DEAD
            worker.healthy = False
            worker.reachable = False
        if self._lifecycle is not None:
            # A crash kills the worker's instances too (the restarted
            # incarnation boots with empty pools).
            self._lifecycle.forget_worker(worker.name)
        return evicted

    def mark_dead(self, name: str) -> int:
        """Declare a worker DEAD immediately (crash signal / injected
        fault) — the same transition :meth:`check_leases` performs on a
        fully-expired lease. Idempotent (0 evictions the second time);
        unknown workers raise ``KeyError``. Returns the evicted in-flight
        ticket count for ledger reconciliation."""
        with self._lock:
            worker = self._cluster.workers.get(name)
            if worker is None:
                raise KeyError(f"unknown worker {name!r}")
            if worker.health is HealthState.DEAD:
                return 0
            evicted = self._kill_locked(worker)
            self._cluster.version += 1
            self._cluster.bump_topology_epoch(worker.zone)
        self._notify("topology")
        return evicted

    def mark_suspect(self, name: str) -> None:
        """Flag a worker SUSPECT (flappy-heartbeat signal): deprioritized
        in candidate ordering but still placeable. No-op unless currently
        HEALTHY; unknown workers raise ``KeyError``."""
        with self._lock:
            worker = self._cluster.workers.get(name)
            if worker is None:
                raise KeyError(f"unknown worker {name!r}")
            if worker.health is not HealthState.HEALTHY:
                return
            worker.health = HealthState.SUSPECT
            self._cluster.version += 1
            self._cluster.bump_topology_epoch(worker.zone)
        self._notify("topology")

    # -- retry exclusion masks ---------------------------------------------------

    def mask_unreachable(self, names: Iterable[str]) -> Tuple[str, ...]:
        """Temporarily mark workers unreachable (a retry's already-tried
        exclusion set). Returns exactly the workers that were reachable
        and got masked — pass it to :meth:`unmask` to restore, so workers
        unreachable for *other* reasons are never resurrected by the
        restore. Retries are the failure path, so the epoch bump's index
        rebuild cost is acceptable."""
        masked: List[str] = []
        zones: set = set()
        with self._lock:
            for name in names:
                worker = self._cluster.workers.get(name)
                if worker is not None and worker.reachable:
                    worker.reachable = False
                    masked.append(name)
                    zones.add(worker.zone)
            if masked:
                self._cluster.version += 1
                self._cluster.bump_topology_epoch(
                    zones.pop() if len(zones) == 1 else None
                )
        return tuple(masked)

    def unmask(self, names: Sequence[str]) -> None:
        """Restore reachability for workers previously masked by
        :meth:`mask_unreachable` (no subscriber notification — the mask
        is a transient routing-internal state, not a topology event)."""
        restored = False
        zones: set = set()
        with self._lock:
            for name in names:
                worker = self._cluster.workers.get(name)
                if worker is not None and not worker.reachable:
                    worker.reachable = True
                    restored = True
                    zones.add(worker.zone)
            if restored:
                self._cluster.version += 1
                self._cluster.bump_topology_epoch(
                    zones.pop() if len(zones) == 1 else None
                )

    # -- admission ledger fast path ---------------------------------------------
    #
    # Admissions and completions touch only volatile load fields (inflight
    # counters, the per-controller split, the running-function multiset,
    # capacity percentage) — never the structural fields that invalidate
    # epoch-cached views. These two methods are the per-decision hot path
    # the controller runtime uses: one lock hold, in-place counter updates,
    # no structural scan. Each records the worker on the cluster's
    # volatile-load log (``note_worker_load``), which is how the per-epoch
    # candidate indexes learn — in O(1) — that exactly this worker's
    # availability bits need refreshing. Heartbeats and topology
    # transitions still go through :meth:`update_worker`.

    def record_admission(
        self, name: str, controller: str, function: str = ""
    ) -> WorkerState:
        """Record one admitted invocation (raises ``KeyError`` for an
        unknown worker, ``ValueError`` for an unreachable one — the
        preliminary condition of every policy, paper §3.3). Returns the
        live worker the ticket was taken on: completion paths pass it
        back as ``expected`` so a ticket can never retire against a
        *different* worker that later re-used the name.

        Locking: takes only the worker's *zone* lock — zone-local writes —
        so concurrent entrypoints of different zones admit in parallel
        instead of serializing on one global ledger lock. The zone is
        re-read after acquiring the lock: a concurrent zone move
        (update_worker holds both zones' locks for the whole update) may
        have re-homed the worker between the unlocked read and the
        acquire, in which case the admission retries on the new zone's
        lock instead of writing counters under the wrong one."""
        cluster = self._cluster
        worker = cluster.workers[name]
        while True:
            zone = worker.zone
            lock = self._zone_locks.get(zone)
            if lock is None:
                lock = self._zone_lock(zone)
            lock.acquire()
            if worker.zone == zone:
                break
            lock.release()
        try:
            if not worker.reachable:
                raise ValueError(f"worker {name!r} unreachable")
            inflight = worker.inflight + 1
            worker.inflight = inflight
            by = worker.inflight_by
            by[controller] = by.get(controller, 0) + 1
            if function:
                running = worker.running_functions
                running[function] = running.get(function, 0) + 1
            slots = worker.capacity_slots
            if 0 < inflight < slots:
                worker.capacity_used_pct = 100.0 * inflight / slots
            else:
                worker.capacity_used_pct = 100.0
            cluster.version += 1
            cluster.note_worker_load(name, zone)
            return worker
        finally:
            lock.release()

    def record_completion(
        self,
        name: str,
        controller: str,
        function: str = "",
        *,
        slow: bool = False,
        expected: Optional[WorkerState] = None,
        generation: Optional[int] = None,
    ) -> bool:
        """Retire one admission ticket; returns whether a live ticket was
        actually released (``False`` when the worker was evicted while the
        work ran — its tickets were already reconciled at removal).
        ``expected`` is the worker the admission was recorded on: if a
        *different* worker has since re-used the name, the ticket is NOT
        released against it (it died with the original and was reconciled
        at deregistration), keeping the replacement's counters honest.
        ``generation`` is the worker's incarnation at admission: if the
        worker has since crashed (a DEAD transition evicted its tickets
        and bumped the counter), the ticket is likewise declined even if
        the same instance recovered.
        """
        worker = self._cluster.workers.get(name)
        if worker is None:
            return False  # worker evicted while running; ticket gone
        # Same zone re-validation as record_admission: a concurrent zone
        # move may re-home the worker between the unlocked zone read and
        # the lock acquire.
        while True:
            zone = worker.zone
            lock = self._zone_locks.get(zone)
            if lock is None:
                lock = self._zone_lock(zone)
            lock.acquire()
            if worker.zone == zone:
                break
            lock.release()
        try:
            if expected is not None and worker is not expected:
                return False  # name re-used by a different worker
            if generation is not None and worker.generation != generation:
                return False  # ticket evicted at a crash; already reconciled
            inflight = worker.inflight - 1
            if inflight < 0:
                inflight = 0
            worker.inflight = inflight
            by = worker.inflight_by
            own = by.get(controller, 1) - 1
            by[controller] = own if own > 0 else 0
            if function:
                running = worker.running_functions
                remaining = running.get(function, 1) - 1
                if remaining > 0:
                    running[function] = remaining
                else:
                    running.pop(function, None)
            slots = worker.capacity_slots
            if slow:
                # Straggler signal: report the worker as fully loaded so
                # capacity_used-based policies route around it until the
                # next healthy heartbeat clears the flag.
                worker.capacity_used_pct = 100.0
            else:
                worker.capacity_used_pct = (
                    100.0 if slots <= 0
                    else min(100.0, 100.0 * inflight / slots)
                )
            self._cluster.version += 1
            self._cluster.note_worker_load(name, zone)
            return True
        finally:
            lock.release()

    # -- script store (live reload, §4.5) ---------------------------------------

    @property
    def script(self) -> Optional[TappScript]:
        return self._script

    @property
    def script_version(self) -> int:
        return self._script_version

    @property
    def last_validation(self) -> Optional[ValidationReport]:
        return self._last_report

    def load_script(self, yaml_text: str, *, strict: bool = True) -> TappScript:
        """Parse + validate + atomically publish a new tAPP script.

        With ``strict`` the update is rejected on validation *errors*
        (the live system keeps the previous script — no partial state);
        topology warnings never block, since set membership is dynamic.
        """
        return self.publish_script(parse_tapp(yaml_text), strict=strict)

    def publish_script(
        self, script: TappScript, *, strict: bool = True, gate=None
    ) -> TappScript:
        """Validate + atomically publish an already-parsed tAPP script.

        The platform's policy lifecycle (apply / dry-run / rollback) builds
        on this: validation, the caller's acceptance check, and the
        version-bumped swap all happen under one lock, so readers either
        see the previous script or the complete new one — never partial
        state, and never a script gated against a stale topology.

        ``gate`` is an optional callable invoked with the
        :class:`~repro_torch.core.tapp.validate.ValidationReport` while the lock
        is held (the lock is reentrant, so the callable may read this
        watcher's cluster); raising from it aborts the publish with nothing
        swapped. When ``gate`` is given it replaces the default ``strict``
        error check.
        """
        with self._lock:
            report = validate_script(
                script,
                known_controllers=self._cluster.controller_names(),
                known_worker_labels=self._cluster.worker_names(),
                known_set_labels=self._cluster.set_labels(),
            )
            self._last_report = report
            if gate is not None:
                gate(report)
            elif strict:
                report.raise_on_error()
            self._script_version += 1
            self._script = TappScript(
                tags=script.tags,
                source=script.source,
                version=self._script_version,
            )
        self._notify("script")
        return self._script

    def clear_script(self) -> None:
        """Remove the script → platforms fall back to vanilla (paper §4.3)."""
        with self._lock:
            self._script = None
            self._script_version += 1
        self._notify("script")

    # -- snapshotting --------------------------------------------------------------

    def snapshot_labels(self) -> Dict[str, Dict]:
        """The label→node mapping the paper's watcher stores on NFS."""
        with self._lock:
            return {
                "workers": {
                    w.name: {"zone": w.zone, "sets": sorted(w.sets)}
                    for w in self._cluster.workers.values()
                },
                "controllers": {
                    c.name: {"zone": c.zone}
                    for c in self._cluster.controllers.values()
                },
                "version": self._cluster.version,
            }
