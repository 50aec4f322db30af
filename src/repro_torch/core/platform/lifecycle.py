"""Warm-pool instance lifecycle (PR 10): cold-start-aware scheduling.

Serverless latency is dominated by *cold starts*: provisioning a fresh
function instance costs orders of magnitude more than dispatching onto
one that is already provisioned and idle. The scheduler through PR 9
decides *where* a function runs but models every placement identically —
the simulator kept a private per-worker warm-container cache
(``FunctionProfile.warm_ttl``), invisible to routing, so a policy could
not prefer a worker holding a warm instance over one that would pay the
cold start.

This module supplies the platform-level instance model, **opt-in** and
off by default (the PR 9 discipline): with no :class:`LifecycleSpec`
configured, placements, traces, RNG streams, cursors, and ledger
counters are bit-identical to the pre-lifecycle platform
(property-tested in ``tests/test_lifecycle.py``).

* :class:`LifecycleSpec` — the keep-alive window (how long a completed
  instance stays reusable) plus an optional per-pool idle cap.
* :class:`InstancePool` — the per-(worker, function) pool with the
  COLD → WARM → IDLE → TERM state machine: an instance is born COLD
  (spawned for an admission that found nothing reusable), parks IDLE on
  completion with an expiry deadline, is reused WARM by a later
  admission (most-recently-used first, the OpenWhisk/Knative shape),
  and terminates TERM when the janitor expires it, the idle cap evicts
  it, or its worker leaves.
* :class:`LifecycleManager` — the armed platform's pool table plus the
  deterministic clock-driven expiration janitor. Fed by the admission
  ledger: ``record_admission`` spawns-or-reuses an instance
  (:meth:`~LifecycleManager.on_admit`), ``Placement.complete()`` parks
  it (:meth:`~LifecycleManager.on_complete`). The manager maintains
  each worker's ``warm_idle`` map — the O(1) warm-first signal the
  engine's ``warm-first`` strategy reads — and emits warmth journal
  events (``ClusterState.note_worker_warmth``) so the compiled engine's
  per-function warm bitmask (``ItemIndex.warm_mask``) stays
  incrementally synced without rebuilds. The janitor never reads a wall
  clock: every deadline check takes an explicit ``now`` (the
  ``check_leases`` discipline), so seeded runs reproduce bit-for-bit.
* :class:`LegacyWarmCache` — a bit-for-bit compat shim of the
  simulator's pre-lifecycle warm table (warm iff ``now - last_end <=
  warm_ttl``, non-consuming, forgotten on worker crash), kept so the
  unarmed simulator path reproduces historical scenario results exactly
  while ``FunctionProfile.warm_ttl`` goes through its deprecation
  cycle.

Keep-alive resolution per completed instance: the worker's
``keep_alive`` override, else the routed controller's
(:class:`~repro_torch.core.platform.specs.ControllerSpec` — platform
configuration, adopted like its retry policy), else the spec default.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scheduler.state import ClusterState, WorkerState
from repro_torch.core.scheduler.strategy import stable_hash

__all__ = [
    "InstancePool",
    "InstanceState",
    "LegacyWarmCache",
    "LifecycleManager",
    "LifecycleSpec",
]


class InstanceState(enum.Enum):
    """One function instance's lifecycle state."""

    COLD = "cold"  # spawning: provisioned for an admission that missed the pool
    WARM = "warm"  # provisioned and busy (reused from the idle pool)
    IDLE = "idle"  # provisioned, not running; reusable until its deadline
    TERM = "term"  # expired / evicted; never reused


@dataclasses.dataclass(frozen=True)
class LifecycleSpec:
    """Warm-pool configuration (per platform; workers/controllers override).

    ``keep_alive`` is how long (seconds) a completed instance stays IDLE
    and reusable before the janitor terminates it — the OpenWhisk
    warm-container TTL, but platform-owned and scheduler-visible.
    ``max_idle`` caps the idle instances one (worker, function) pool may
    hold; a completion into a full pool terminates the instance
    immediately (0: never pool — every admission is a cold start).
    """

    keep_alive: float = 600.0
    max_idle: Optional[int] = None

    def __post_init__(self) -> None:
        if self.keep_alive <= 0:
            raise ValueError(
                f"keep_alive must be positive, got {self.keep_alive}"
            )
        if self.max_idle is not None and self.max_idle < 0:
            raise ValueError(
                f"max_idle must be non-negative, got {self.max_idle}"
            )


class InstancePool:
    """The instances of one function on one worker.

    ``busy`` maps instance id → COLD/WARM (provisioned, running a
    request); ``idle`` is a stack of ``(iid, deadline)`` — reuse pops
    the top (most recently parked, the entry most likely still paged
    in), expiry trims from the bottom. The pool pins the live
    :class:`WorkerState` it was built against, so a later worker
    re-using the name can never inherit a dead incarnation's instances.
    """

    __slots__ = ("worker", "function", "fhash", "busy", "idle")

    def __init__(self, worker: WorkerState, function: str) -> None:
        self.worker = worker
        self.function = function
        # Same hash the engine caches on Invocation — the key warm-first
        # reads back out of worker.warm_idle / ItemIndex.warm_mask.
        self.fhash = stable_hash(function)
        self.busy: Dict[int, InstanceState] = {}
        self.idle: List[Tuple[int, Optional[float]]] = []


class LifecycleManager:
    """Pool table + expiration janitor of an armed platform.

    All mutation happens under one manager lock; within it, each
    worker's ``warm_idle`` entry is updated *before* the warmth journal
    event is emitted, so an index replaying the journal always reads
    the post-transition state (the same discipline the load journal
    uses). Counters are monotonic; ``snapshot()`` reads them
    consistently.
    """

    def __init__(self, spec: LifecycleSpec, cluster: ClusterState) -> None:
        self._spec = spec
        self._cluster = cluster
        self._lock = threading.Lock()
        self._pools: Dict[Tuple[str, str], InstancePool] = {}
        # Lazy-deleted expiry heap: entries are (deadline, iid, worker,
        # function); an entry is live iff the iid's *current* idle
        # deadline still equals the entry's (a reused-then-reparked
        # instance leaves its stale entry behind to be skipped).
        self._expiry: List[Tuple[float, int, str, str]] = []
        self._idle_deadline: Dict[int, float] = {}
        self._iid = itertools.count(1)
        self._controller_keep_alive: Dict[str, float] = {}
        self.cold_starts = 0
        self.warm_hits = 0
        self.expirations = 0

    @property
    def spec(self) -> LifecycleSpec:
        return self._spec

    # -- configuration (adopted from controller specs, like retry) ----------

    def set_controller_keep_alive(self, name: str, keep_alive: float) -> None:
        if keep_alive <= 0:
            raise ValueError(
                f"keep_alive must be positive, got {keep_alive}"
            )
        with self._lock:
            self._controller_keep_alive[name] = keep_alive

    def forget_controller(self, name: str) -> None:
        with self._lock:
            self._controller_keep_alive.pop(name, None)

    # -- warmth signal maintenance ------------------------------------------

    def _set_idle_count(self, worker: WorkerState, fhash: int,
                        count: int) -> None:
        """Publish a pool's idle count into the worker's ``warm_idle``
        map, emitting a warmth journal event on 0 ↔ nonzero flips (the
        only transitions that change any warm bitmask). The map write
        lands before the journal note, so replays read the new state."""
        warm_idle = worker.warm_idle
        prev = warm_idle.get(fhash, 0)
        if count > 0:
            warm_idle[fhash] = count
        elif prev:
            del warm_idle[fhash]
        if (prev == 0) != (count == 0):
            self._cluster.note_worker_warmth(worker.name, fhash)

    def _pool(self, worker: WorkerState, function: str) -> InstancePool:
        key = (worker.name, function)
        pool = self._pools.get(key)
        if pool is None or pool.worker is not worker:
            # First admission, or the name was re-used by a fresh
            # incarnation (the old pool died with forget_worker).
            pool = self._pools[key] = InstancePool(worker, function)
        return pool

    # -- admission-ledger hooks ---------------------------------------------

    def on_admit(self, worker: WorkerState, function: str) -> bool:
        """An admission ticket was taken: reuse the most recently parked
        idle instance (→ WARM) or spawn a new one (→ COLD). Returns
        whether the placement hit a warm instance."""
        with self._lock:
            pool = self._pool(worker, function)
            idle = pool.idle
            if idle:
                iid, _deadline = idle.pop()
                self._idle_deadline.pop(iid, None)
                pool.busy[iid] = InstanceState.WARM
                self.warm_hits += 1
                self._set_idle_count(worker, pool.fhash, len(idle))
                return True
            pool.busy[next(self._iid)] = InstanceState.COLD
            self.cold_starts += 1
            return False

    def on_complete(
        self,
        worker: WorkerState,
        function: str,
        controller: Optional[str] = None,
        now: Optional[float] = None,
    ) -> None:
        """A ticket retired: park its instance IDLE with a keep-alive
        deadline (worker override > controller override > spec default).
        Without a clock (``now`` is None) the instance never expires —
        the armed-but-clockless path tests pin against. A full pool
        (``max_idle``) terminates the instance instead of parking it."""
        with self._lock:
            pool = self._pools.get((worker.name, function))
            if pool is None or pool.worker is not worker or not pool.busy:
                # The instance died with its worker (crash/deregister
                # already forgot the pool); the ledger reconciled it.
                return
            iid, _state = pool.busy.popitem()
            max_idle = self._spec.max_idle
            if max_idle is not None and len(pool.idle) >= max_idle:
                self.expirations += 1  # idle-cap eviction is a TERM too
                if not pool.busy and not pool.idle:
                    del self._pools[(worker.name, function)]
                return
            keep = worker.keep_alive
            if keep is None and controller is not None:
                keep = self._controller_keep_alive.get(controller)
            if keep is None:
                keep = self._spec.keep_alive
            deadline = None if now is None else float(now) + keep
            pool.idle.append((iid, deadline))
            if deadline is not None:
                self._idle_deadline[iid] = deadline
                heapq.heappush(
                    self._expiry, (deadline, iid, worker.name, function)
                )
            self._set_idle_count(worker, pool.fhash, len(pool.idle))

    # -- janitor --------------------------------------------------------------

    def expire(self, now: float) -> int:
        """Terminate every idle instance whose deadline is ≤ ``now``.

        Deterministic: instances expire in (deadline, iid) order, and
        only against the explicit clock — the platform runs this lazily
        from ``invoke``/``complete`` when given ``now``, and callers
        may tick it directly (``expire_instances``). Returns the number
        of instances terminated."""
        expired = 0
        with self._lock:
            heap = self._expiry
            deadlines = self._idle_deadline
            while heap and heap[0][0] <= now:
                deadline, iid, wname, function = heapq.heappop(heap)
                if deadlines.get(iid) != deadline:
                    continue  # stale entry: instance was reused meanwhile
                del deadlines[iid]
                pool = self._pools.get((wname, function))
                if pool is None:
                    continue  # pool already forgotten with its worker
                for index, (pid, _dl) in enumerate(pool.idle):
                    if pid == iid:
                        del pool.idle[index]
                        break
                else:
                    continue
                self.expirations += 1
                expired += 1
                self._set_idle_count(pool.worker, pool.fhash, len(pool.idle))
                if not pool.idle and not pool.busy:
                    del self._pools[(wname, function)]
        return expired

    def next_deadline(self) -> Optional[float]:
        """The earliest live expiry deadline (None: nothing expires) —
        the simulator uses it to schedule janitor ticks exactly."""
        with self._lock:
            heap = self._expiry
            deadlines = self._idle_deadline
            while heap and deadlines.get(heap[0][1]) != heap[0][0]:
                heapq.heappop(heap)  # shed stale entries on the way
            return heap[0][0] if heap else None

    # -- topology churn -------------------------------------------------------

    def forget_worker(self, name: str) -> None:
        """A worker left (deregistration or DEAD transition): its
        instances die with it. Pools are dropped, the worker's warmth
        signal is cleared (journal events emitted for the flips), and
        the heap's stale entries are left for lazy deletion."""
        with self._lock:
            for key in [k for k in self._pools if k[0] == name]:
                pool = self._pools.pop(key)
                for iid, _deadline in pool.idle:
                    self._idle_deadline.pop(iid, None)
                if pool.idle:
                    self._set_idle_count(pool.worker, pool.fhash, 0)

    # -- observability --------------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        """Monotonic counters + current pool occupancy, consistently."""
        with self._lock:
            idle = busy = 0
            for pool in self._pools.values():
                idle += len(pool.idle)
                busy += len(pool.busy)
            return {
                "cold_starts": self.cold_starts,
                "warm_hits": self.warm_hits,
                "expirations": self.expirations,
                "idle_instances": idle,
                "busy_instances": busy,
                "pools": len(self._pools),
            }

    def pool_sizes(self) -> Dict[Tuple[str, str], Tuple[int, int]]:
        """(worker, function) → (idle, busy) instance counts."""
        with self._lock:
            return {
                key: (len(pool.idle), len(pool.busy))
                for key, pool in sorted(self._pools.items())
            }


class LegacyWarmCache:
    """Bit-for-bit shim of the simulator's pre-lifecycle warm table.

    The historical model (``FunctionProfile.warm_ttl``): a worker is
    warm for a function iff some earlier execution *ended* within the
    TTL. Non-consuming (one warm entry serves any number of concurrent
    reuses), touched with the execution's end time, and forgotten when
    the worker crashes. The unarmed simulator path keeps using exactly
    this model — pinned by regression tests — while ``warm_ttl`` is
    deprecated in favour of :class:`LifecycleSpec`.
    """

    __slots__ = ("_last",)

    def __init__(self) -> None:
        self._last: Dict[Tuple[str, str], float] = {}

    def is_warm(self, worker: str, function: str, now: float,
                ttl: float) -> bool:
        last = self._last.get((worker, function))
        return last is not None and (now - last) <= ttl

    def touch(self, worker: str, function: str, end_time: float) -> None:
        self._last[(worker, function)] = end_time

    def forget_worker(self, worker: str) -> None:
        for key in [k for k in self._last if k[0] == worker]:
            del self._last[key]
