"""Live cluster state consumed by the tAPP scheduler.

In the paper's OpenWhisk deployment this information is produced by the
*Watcher* (polling the Kubernetes API) and stored on an NFS share. Here it
is an in-process snapshot maintained by :mod:`repro_torch.core.scheduler.watcher`;
on a real TPU fleet it would be fed by per-host agents reporting HBM use,
queue depth, and liveness heartbeats.

A *worker* is the unit of placement: in this framework, a model replica —
a mesh slice (a set of chips) that hosts one compiled model's weights and
serves invocations against it. The same abstraction covers the paper's
container-based invokers, which is what the discrete-event simulator
instantiates for the paper-table benchmarks.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence


class HealthState(enum.Enum):
    """Failure-detector verdict on one worker (PR 6).

    ``HEALTHY`` → ``SUSPECT`` when the heartbeat lease expires (the worker
    stays placeable but is deprioritized in candidate ordering);
    ``SUSPECT`` → ``DEAD`` when the lease stays expired past the dead
    threshold (the worker is excluded like a drain and its in-flight
    tickets are reconciled as evictions). A recovery heartbeat restores
    ``HEALTHY`` from either state. Orthogonal to the boolean ``healthy``
    platform signal: SUSPECT keeps ``healthy``/``reachable`` true, DEAD
    clears both.
    """

    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class WorkerState:
    """Mutable live state of one worker (model replica / invoker).

    Attributes:
      name: unique worker label (the tAPP ``wrk`` label).
      zone: physical topology zone (here: pod / ICI domain).
      sets: logical worker-set labels this worker belongs to (tAPP ``set``).
      capacity_slots: max concurrent invocations the worker can run.
      inflight: currently executing invocations.
      queued: buffered (not yet executing) invocations.
      capacity_used_pct: load percentage (CPU in the paper; HBM+slot
        occupancy here). Fed by the watcher.
      healthy: platform health signal (OpenWhisk "unhealthy invoker" API ~
        serving-engine heartbeat). ``overload`` invalidation triggers on
        ``not healthy`` or slot exhaustion.
      reachable: network reachability; unreachability is the *preliminary*
        invalidate condition for every policy (paper §3.3).
      resident_models: model ids whose weights are resident (data locality:
        scheduling onto a non-resident worker incurs a cold start).
      running_functions: multiset of admitted (buffered + executing)
        invocations by function name — the signal the affinity /
        anti-affinity constraints read. Fed by the controller runtime on
        admit/complete; volatile like ``inflight`` (never bumps the
        topology epoch).
      memory_bytes / memory_used_bytes: HBM capacity bookkeeping.
      perf_factor: relative execution-speed multiplier (1.0 = nominal);
        the simulator uses it for heterogeneous workers and stragglers.
    """

    name: str
    zone: str = "default"
    sets: FrozenSet[str] = frozenset()
    capacity_slots: int = 16
    inflight: int = 0
    inflight_by: Dict[str, int] = dataclasses.field(default_factory=dict)
    running_functions: Dict[str, int] = dataclasses.field(default_factory=dict)
    queued: int = 0
    capacity_used_pct: float = 0.0
    healthy: bool = True
    reachable: bool = True
    resident_models: FrozenSet[str] = frozenset()
    memory_bytes: int = 16 * 1024**3
    memory_used_bytes: int = 0
    perf_factor: float = 1.0
    # Failure-detector verdict (lease machinery in the watcher). SUSPECT
    # workers remain placeable but sort after healthy peers in every
    # candidate order; DEAD workers are structurally excluded.
    health: HealthState = HealthState.HEALTHY
    # Incarnation counter: bumped when the worker's in-flight tickets are
    # evicted wholesale (a crash / DEAD transition). Placements capture it
    # at admission so a ticket can never retire against a later
    # incarnation's counters.
    generation: int = 0
    # Warm-pool occupancy: function hash -> count of IDLE (reusable)
    # instances on this worker. Maintained by the platform lifecycle
    # manager (``platform/lifecycle.py``) — empty unless a lifecycle is
    # armed. Volatile like ``inflight`` (never bumps the topology epoch);
    # 0<->1 transitions are reported via
    # :meth:`ClusterState.note_worker_warmth` so the per-epoch candidate
    # indexes can refresh their warm bitmasks incrementally.
    warm_idle: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Per-worker keep-alive override (seconds an IDLE instance survives);
    # None defers to the controller-/spec-level default. Volatile: set at
    # registration from WorkerSpec.keep_alive, read by the lifecycle.
    keep_alive: Optional[float] = None

    @property
    def suspect(self) -> bool:
        return self.health is HealthState.SUSPECT

    @property
    def dead(self) -> bool:
        return self.health is HealthState.DEAD

    @property
    def concurrent(self) -> int:
        """Buffered concurrent invocations (queued + running)."""
        return self.inflight + self.queued

    @property
    def overloaded(self) -> bool:
        return (not self.healthy) or self.inflight >= self.capacity_slots

    @property
    def load_fraction(self) -> float:
        if self.capacity_slots <= 0:
            return 1.0
        return self.inflight / self.capacity_slots

    def in_set(self, label: Optional[str]) -> bool:
        """Blank set label (None) matches every worker (paper §3.3)."""
        return label is None or label in self.sets

    def inflight_for(self, controller: str) -> int:
        """Admissions by one controller (its entitlement consumption)."""
        return self.inflight_by.get(controller, 0)

    def running_count(self, function: str) -> int:
        """Admitted invocations of ``function`` currently on this worker."""
        return self.running_functions.get(function, 0)

    def warm_for(self, fhash: int) -> bool:
        """True when an IDLE instance of the hashed function is poolable."""
        return self.warm_idle.get(fhash, 0) > 0


@dataclasses.dataclass
class ControllerState:
    """One controller (per-zone scheduler)."""

    name: str
    zone: str = "default"
    healthy: bool = True
    reachable: bool = True

    @property
    def available(self) -> bool:
        return self.healthy and self.reachable


# Volatile-load log compaction threshold: when a shard's log outgrows
# this, it is truncated and stale index consumers fall back to a full
# avail-mask rebuild (amortized O(1) per logged event).
_LOAD_LOG_LIMIT = 4096


class _LoadShard:
    """One zone's volatile-load event log (zone-local writes).

    Sharding the log per zone keeps federated entrypoints from
    serializing on — and, worse, replaying — each other's admission
    streams: a zone-restricted candidate index tracks only the shards
    its candidates live in, so churn in zone A never costs zone B's
    routing path a single replayed event.
    """

    __slots__ = ("log", "trimmed")

    def __init__(self) -> None:
        self.log: List[str] = []
        self.trimmed = 0

    @property
    def seq(self) -> int:
        """Absolute sequence number of the next event in this shard."""
        return self.trimmed + len(self.log)

    def note(self, name: str) -> None:
        log = self.log
        log.append(name)
        if len(log) > _LOAD_LOG_LIMIT:
            # Compaction *replaces* the list rather than clearing it in
            # place: lock-free readers that already grabbed a reference
            # replay a complete (merely stale) window instead of a
            # truncated one, and the advanced ``trimmed`` cursor pushes
            # them onto the full-recompute path on their next refresh.
            # Writer order (trimmed, then log) pairs with the readers'
            # capture order (trimmed, then log) so a torn read can only
            # look over-trimmed — which also lands on the recompute path.
            self.trimmed += len(log)
            self.log = []


@dataclasses.dataclass
class ClusterState:
    """A consistent snapshot of controllers + workers.

    The scheduler never mutates entries it did not create; the watcher owns
    the authoritative copy and hands out snapshots (the paper's NFS-stored
    mapping, §4.2).

    **Volatile-load contract:** mutations of the volatile worker fields
    (inflight counters, queue depth, capacity percentage, the
    running-function multiset) must be reported via
    :meth:`note_worker_load` — the watcher's ledger and heartbeat paths
    do this — so the per-epoch candidate indexes
    (:class:`~repro_torch.core.scheduler.topology.BlockIndex`) can refresh the
    touched worker's availability bits in O(1) instead of rescanning.
    Structural changes go through :meth:`bump_topology_epoch` as before.
    """

    workers: Dict[str, WorkerState] = dataclasses.field(default_factory=dict)
    controllers: Dict[str, ControllerState] = dataclasses.field(default_factory=dict)
    version: int = 0
    # Bumped only on *structural* changes (membership, zones, sets,
    # reachability/health, capacity) — never on inflight counters. The
    # compiled scheduling fast path memoizes distribution views per epoch;
    # see :mod:`repro_torch.core.scheduler.topology`.
    topology_epoch: int = 0
    view_cache: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    # Volatile-load event logs, sharded per zone: worker names whose
    # dynamic fields changed, in order, appended to the shard of the
    # worker's zone. Candidate indexes consume only the shards their
    # candidates span; see load_seq/note_worker_load.
    load_shards: Dict[str, _LoadShard] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    # Advisory total of volatile-load events across every shard (the
    # cheap "anything at all changed?" signal; per-shard seqs are the
    # exact cursors).
    _load_total: int = 0
    # Merged journal of the same events, all zones interleaved in global
    # order (its seq always equals _load_total). Indexes whose candidates
    # span multiple zones replay this window — O(events since last sync)
    # — instead of scanning every zone shard for new cursors, which would
    # be O(zones) per decision even when nothing moved. Single-zone
    # indexes keep reading their zone shard, so the containment story
    # (foreign churn costs a zone-restricted index nothing) is unchanged.
    _load_journal: _LoadShard = dataclasses.field(
        default_factory=_LoadShard, repr=False, compare=False
    )
    # Guards _load_journal and _load_total. Zone shards are protected by
    # their zone's ledger lock (the watcher holds it around every
    # note_worker_load call), but the merged journal and the total are
    # written by *every* zone's entrypoint, so without a dedicated lock
    # two zones admitting concurrently can lose increments — a lost
    # increment makes index refresh see "nothing changed" and serve a
    # stale availability mask, and it permanently breaks the
    # ``journal.seq == _load_total`` invariant the multi-zone replay
    # window arithmetic depends on.
    _journal_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    # Warm-pool event journal: ``(worker_name, fhash)`` entries appended
    # whenever a worker's IDLE-instance count for a function crosses the
    # 0<->1 boundary (the only transitions that can flip a warm-bitmask
    # bit). One merged journal, not zone-sharded: warm events exist only
    # when a lifecycle is armed and are far rarer than load events, so
    # replay cost is negligible — and expirations fire from a janitor,
    # not from a zone entrypoint, so there is no natural shard writer.
    _warm_journal: _LoadShard = dataclasses.field(
        default_factory=_LoadShard, repr=False, compare=False
    )
    # Advisory total of warm events (the warm analogue of _load_total).
    # Part of the batch router's memo validity token: a janitor expiry
    # changes warmth WITHOUT a load event, so load cursors alone would
    # replay stale warm-first outcomes.
    _warm_total: int = 0
    # Per-epoch memo for the derived topology queries (workers_in_set /
    # set_labels / zones); cleared with the view cache.
    _query_cache: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    # Lazily built zone → [WorkerState] map (insertion order preserved),
    # maintained incrementally on add_worker and dropped on removals /
    # zone moves; lets zone-restricted view rebuilds scan O(zone workers)
    # instead of the whole cluster.
    _zone_members: Optional[Dict[str, List[WorkerState]]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def bump_topology_epoch(self, zone: Optional[str] = None) -> None:
        """Invalidate memoized topology views (structural change).

        ``zone=None`` (the conservative default) drops every cached view.
        Passing a zone scopes the eviction to entries that can actually
        see that zone's workers — zone-restricted entries of *other*
        zones survive, so a worker flapping in zone A never forces zone
        B's entrypoint to rebuild its candidate indexes (the Archipelago
        partitioned-invalidation property). The global epoch counter
        always advances: plan/derived-query memos stay conservative.
        """
        self.topology_epoch += 1
        if self.view_cache:
            if zone is None:
                self.view_cache.clear()
            else:
                stale = [
                    key
                    for key in self.view_cache
                    if key[3] is None or key[3] == zone
                ]
                for key in stale:
                    del self.view_cache[key]
        if self._query_cache:
            self._query_cache.clear()

    # -- volatile-load event log --------------------------------------------

    @property
    def load_seq(self) -> int:
        """Monotonic count of volatile-load events recorded so far."""
        return self._load_total

    @property
    def load_trimmed(self) -> int:
        """Total events dropped by compaction, summed across shards."""
        return sum(shard.trimmed for shard in self.load_shards.values())

    def load_shard(self, zone: str) -> _LoadShard:
        shard = self.load_shards.get(zone)
        if shard is None:
            shard = self.load_shards[zone] = _LoadShard()
        return shard

    def note_worker_load(self, name: str, zone: Optional[str] = None) -> None:
        """Record that ``name``'s volatile load fields changed.

        O(1) amortized: appends to the worker's zone shard, compacting a
        shard once it exceeds ``_LOAD_LOG_LIMIT`` (consumers whose cursor
        predates the compaction rebuild from scratch, which the limit
        amortizes). ``zone`` may be passed by callers that already hold
        the worker (the watcher's admission ledger) to skip the lookup.

        Thread contract: the caller must hold the worker's zone ledger
        lock (the watcher's admission/heartbeat paths do), which makes
        the zone-shard append single-writer. The merged journal and the
        event total are shared across zones and are updated under the
        cluster's journal lock, preserving ``journal.seq == _load_total``
        under concurrent multi-zone admission.
        """
        if zone is None:
            worker = self.workers.get(name)
            zone = worker.zone if worker is not None else ""
        shard = self.load_shards.get(zone)
        if shard is None:
            shard = self.load_shards[zone] = _LoadShard()
        # Inlined _LoadShard.note body: this runs once per ledger event
        # on the admission fast path, where the method call is
        # measurable against the ~µs decision budget. Compaction
        # replaces the list (see _LoadShard.note) so lock-free readers
        # never see a half-cleared window.
        log = shard.log
        log.append(name)
        if len(log) > _LOAD_LOG_LIMIT:
            shard.trimmed += len(log)
            shard.log = []
        with self._journal_lock:
            journal = self._load_journal
            log = journal.log
            log.append(name)
            if len(log) > _LOAD_LOG_LIMIT:
                journal.trimmed += len(log)
                journal.log = []
            self._load_total += 1

    # -- warm-pool event journal --------------------------------------------

    @property
    def warm_seq(self) -> int:
        """Monotonic count of warm-bit flip events recorded so far."""
        return self._warm_total

    def note_worker_warmth(self, name: str, fhash: int) -> None:
        """Record that ``name``'s warm bit for ``fhash`` flipped (0<->1).

        Called by the lifecycle manager under its own lock whenever an
        idle-instance count crosses the 0/1 boundary. The journal lock
        keeps ``journal.seq == _warm_total`` under concurrent callers,
        mirroring :meth:`note_worker_load`.
        """
        with self._journal_lock:
            journal = self._warm_journal
            log = journal.log
            log.append((name, fhash))
            if len(log) > _LOAD_LOG_LIMIT:
                journal.trimmed += len(log)
                journal.log = []
            self._warm_total += 1

    # -- membership ---------------------------------------------------------

    def add_worker(self, worker: WorkerState) -> None:
        if worker.name in self.workers:
            raise ValueError(f"duplicate worker {worker.name!r}")
        self.workers[worker.name] = worker
        if self._zone_members is not None:
            self._zone_members.setdefault(worker.zone, []).append(worker)
        self.version += 1
        self.bump_topology_epoch(worker.zone)

    def remove_worker(self, name: str) -> None:
        removed = self.workers.pop(name, None)
        self._zone_members = None
        self.version += 1
        self.bump_topology_epoch(removed.zone if removed is not None else None)

    def add_controller(self, controller: ControllerState) -> None:
        if controller.name in self.controllers:
            raise ValueError(f"duplicate controller {controller.name!r}")
        self.controllers[controller.name] = controller
        self.version += 1
        self.bump_topology_epoch()

    def remove_controller(self, name: str) -> None:
        self.controllers.pop(name, None)
        self.version += 1
        self.bump_topology_epoch()

    # -- queries -------------------------------------------------------------

    def worker_names(self) -> List[str]:
        return list(self.workers.keys())

    def workers_in_zone(self, zone: str) -> List[WorkerState]:
        return list(self.workers_by_zone(zone))

    def workers_by_zone(self, zone: str) -> Sequence[WorkerState]:
        """Workers of one zone, in cluster insertion order.

        Backed by an incrementally maintained per-zone map (rebuilt
        lazily after removals or zone moves), so zone-restricted view
        rebuilds cost O(zone workers) rather than O(cluster).
        """
        return self.zone_members().get(zone, ())

    def zone_members(self) -> Dict[str, List[WorkerState]]:
        """The full per-zone member map backing :meth:`workers_by_zone`
        (treat as read-only). Lets per-zone scans — e.g. the federation's
        dead-zone detection — iterate zones with early-out instead of
        walking every worker in the cluster."""
        members = self._zone_members
        if members is None:
            members = {}
            for worker in self.workers.values():
                members.setdefault(worker.zone, []).append(worker)
            self._zone_members = members
        return members

    def invalidate_zone_members(self) -> None:
        """Drop the per-zone member map (a worker changed zones)."""
        self._zone_members = None

    def workers_in_set(self, label: Optional[str]) -> List[WorkerState]:
        """Workers matching a tAPP set label; memoized per topology epoch
        (set membership is structural, so epoch bumps invalidate)."""
        hit = self._query_cache.get(("set", label))
        if hit is None:
            hit = tuple(w for w in self.workers.values() if w.in_set(label))
            self._query_cache[("set", label)] = hit
        return list(hit)

    def set_labels(self) -> List[str]:
        """All set labels in the deployment; memoized per topology epoch."""
        hit = self._query_cache.get("set_labels")
        if hit is None:
            labels: set = set()
            for w in self.workers.values():
                labels |= w.sets
            hit = tuple(sorted(labels))
            self._query_cache["set_labels"] = hit
        return list(hit)

    def zones(self) -> List[str]:
        """All zones hosting a worker or controller; memoized per epoch."""
        hit = self._query_cache.get("zones")
        if hit is None:
            zs = {w.zone for w in self.workers.values()}
            zs |= {c.zone for c in self.controllers.values()}
            hit = tuple(sorted(zs))
            self._query_cache["zones"] = hit
        return list(hit)

    def controllers_in_zone(self, zone: str) -> List[ControllerState]:
        return [c for c in self.controllers.values() if c.zone == zone]

    def controller_names(self) -> List[str]:
        return list(self.controllers.keys())


def make_cluster(
    workers: Iterable[Mapping],
    controllers: Iterable[Mapping] = (),
) -> ClusterState:
    """Convenience constructor from plain dicts (used by tests/configs)."""
    cluster = ClusterState()
    for spec in workers:
        spec = dict(spec)
        if "sets" in spec:
            spec["sets"] = frozenset(spec["sets"])
        if "resident_models" in spec:
            spec["resident_models"] = frozenset(spec["resident_models"])
        cluster.add_worker(WorkerState(**spec))
    for spec in controllers:
        cluster.add_controller(ControllerState(**dict(spec)))
    return cluster
