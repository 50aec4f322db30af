"""``TappPlatform`` — the paper's platform (§4) behind one typed API.

The paper's contribution is a *system*: gateway (§4.3), watcher (§4.2),
per-zone controllers, and live tAPP reload (§4.5) working together. This
façade owns that wiring so callers stop hand-assembling it:

* **declarative construction** — a :class:`ClusterSpec` builds the live
  topology; lifecycle methods (``add_worker``, ``drain``,
  ``mark_unhealthy``) route through the watcher, so epoch-based view
  invalidation stays correct no matter who mutates the deployment;
* **policy lifecycle** — ``apply_policy`` validates, dry-runs against
  the live topology, compiles, and atomically swaps a versioned
  :class:`PolicyHandle`; ``rollback`` restores the previous policy from
  a bounded history;
* **unified invocation flow** — ``invoke`` / ``invoke_batch`` route
  *and* admit in one step and hand back a :class:`Placement` whose
  ``complete()`` retires the running-function ticket (the affinity
  signal), collapsing the gateway/controller two-step;
* **observability** — ``explain`` returns a typed per-block/per-worker
  rejection report, ``stats`` a point-in-time snapshot, and
  ``subscribe`` a feed of platform events.

Since PR 5 the machinery is split: :class:`PlatformCore` holds
everything that does not depend on how many entrypoints exist (the
watcher, the admission ledger, the policy lifecycle, topology
lifecycle, events), and ``TappPlatform`` is the degenerate
single-entrypoint instantiation — one flat :class:`Gateway` over the
whole cluster. The multi-zone instantiation is
:class:`~repro_torch.core.platform.federation.TappFederation`: one
:class:`~repro_torch.core.scheduler.gateway.ZoneGateway` per zone over the
same core. The underlying parts remain importable for tests and power
users, but the façades are the only modules that should construct them.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import (
    Callable,
    Deque,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from repro_torch.core.analysis import AnalysisReport, FederationView, analyze_plan
from repro_torch.core.platform.explain import (
    ExplainReport,
    annotate_inevitable,
    annotate_warmth,
    build_explain_report,
)
from repro_torch.core.platform.lifecycle import LifecycleManager, LifecycleSpec
from repro_torch.core.platform.overload import (
    AdmissionQueue,
    BrownoutController,
    CircuitBreaker,
    OverloadSpec,
    degrade_script,
)
from repro_torch.core.platform.policy import (
    PolicyDryRun,
    PolicyError,
    PolicyHandle,
)
from repro_torch.core.platform.specs import (
    ClusterSpec,
    ControllerSpec,
    RetryPolicy,
    WorkerSpec,
)
from repro_torch.core.scheduler.controller import ControllerRuntime
from repro_torch.core.scheduler.engine import Invocation, ScheduleDecision
from repro_torch.core.scheduler.gateway import Gateway
from repro_torch.core.scheduler.state import (
    ClusterState,
    ControllerState,
    HealthState,
    WorkerState,
)
from repro_torch.core.scheduler.topology import DistributionPolicy
from repro_torch.core.scheduler.watcher import (
    HealthTransition,
    LeaseConfig,
    Watcher,
)
from repro_torch.core.tapp.ast import DEFAULT_TAG, OnOverload, TappScript
from repro_torch.core.tapp.compile import compile_script
from repro_torch.core.tapp.parser import parse_tapp
from repro_torch.core.tapp.validate import validate_script

#: Platform event kinds forwarded to subscribers: the watcher's
#: "topology" / "script", plus "policy" (apply) and "rollback".
Subscriber = Callable[[str], None]

PolicyInput = Union[str, TappScript]


class UnknownWorkerError(KeyError):
    """A platform entry point named a worker the cluster does not have.

    Raised (instead of a bare ``KeyError``) by the topology/health
    lifecycle methods so a heartbeat for a deregistered worker fails
    loudly rather than resurrecting a drained worker's state.
    """

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self.worker = name

    def __str__(self) -> str:
        return (
            f"unknown worker {self.worker!r} (never registered, or already "
            f"deregistered — a drained worker's state is not resurrectable)"
        )


class _UnknownWorkerGuard:
    """Context manager turning the watcher's ``KeyError`` for an unknown
    worker into :class:`UnknownWorkerError` (already-wrapped errors pass
    through untouched)."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_UnknownWorkerGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if (
            exc_type is not None
            and issubclass(exc_type, KeyError)
            and not isinstance(exc, UnknownWorkerError)
        ):
            raise UnknownWorkerError(self.name) from None
        return False


class _Ledger:
    """Mutable admit/complete/evict counters shared with live placements.

    Invariant: ``admitted == completed + evicted + live inflight``. A
    ticket is *evicted* when its worker is deregistered while the work
    runs — the drain-path removal reconciles those tickets here, and the
    placement's later ``complete()`` sees the watcher decline the retire
    (the worker is gone) and does not double-count it as a completion.

    Since PR 7 the platform keeps one shard per worker *zone* (plus a
    ``None`` shard for un-admitted placements), so per-zone entrypoints
    mostly touch zone-local counters instead of one shared object; the
    invariant holds per shard, and therefore for the sums the stats
    snapshots report. Writes are *not* single-writer, though —
    cross-zone forwarding charges the ticket to the ticket worker's
    zone, so an entrypoint of zone A can increment zone B's shard
    concurrently with zone B's own thread — hence every counter update
    and every snapshot read of the triple goes through the shard's own
    lock (uncontended in the zone-local common case).
    """

    __slots__ = ("admitted", "completed", "evicted", "lock")

    def __init__(self) -> None:
        self.admitted = 0
        self.completed = 0
        self.evicted = 0
        self.lock = threading.Lock()

    def add_admitted(self, n: int = 1) -> None:
        with self.lock:
            self.admitted += n

    def add_completed(self, n: int = 1) -> None:
        with self.lock:
            self.completed += n

    def add_evicted(self, n: int = 1) -> None:
        with self.lock:
            self.evicted += n

    def snapshot(self) -> Tuple[int, int, int]:
        """Consistent ``(admitted, completed, evicted)`` triple."""
        with self.lock:
            return (self.admitted, self.completed, self.evicted)


class Placement:
    """The result of one unified invoke: decision + admission ticket.

    ``complete()`` retires the ticket (releasing the slot and the
    running-function multiset entry the affinity constraints read); it is
    idempotent, and a no-op for placements that were never admitted
    (policy failure / no valid worker). A plain ``__slots__`` class: one
    is created per invocation on the serving hot path, so construction
    cost is kept at raw-attribute-write level.
    """

    __slots__ = ("invocation", "decision", "admitted", "completed",
                 "_watcher", "_ledger", "_worker_ref", "_generation",
                 "attempts", "retry_wait", "failed_workers",
                 "_core", "queued", "queue_outcome", "queue_wait",
                 "warm_hit")

    def __init__(
        self,
        invocation: Invocation,
        decision: ScheduleDecision,
        admitted: bool,
        watcher: Watcher,
        ledger: _Ledger,
        worker_ref: Optional[WorkerState] = None,
    ) -> None:
        self.invocation = invocation
        self.decision = decision
        self.admitted = admitted
        self.completed = False
        self._watcher = watcher
        self._ledger = ledger
        # The live worker the ticket was taken on: complete() retires
        # against exactly this instance, so a later worker re-using the
        # name can never have its counters decremented by a dead ticket.
        self._worker_ref = worker_ref
        # Incarnation at admission: a crash (DEAD transition) evicts the
        # ticket and bumps the worker's generation, so complete() declines.
        self._generation = 0 if worker_ref is None else worker_ref.generation
        # Retry bookkeeping (see TappPlatform.retry): total attempts this
        # placement represents, cumulative deterministic backoff charged,
        # and the workers earlier attempts failed on (excluded from
        # subsequent re-routes).
        self.attempts = 1
        self.retry_wait = 0.0
        self.failed_workers: Tuple[str, ...] = ()
        # Overload layer (PR 9). ``_core`` backref lets complete() drain
        # the admission queues and record duplicate completes; ``queued``
        # marks a placement parked in an admission queue, and
        # ``queue_outcome`` its fate ("drained" / "shed" /
        # "deadline_exceeded"; None while still waiting).
        self._core: Optional["PlatformCore"] = None
        self.queued = False
        self.queue_outcome: Optional[str] = None
        self.queue_wait = 0.0
        # Warm-pool layer (PR 10): did the admission reuse an idle warm
        # instance? None when the lifecycle layer is unarmed or nothing
        # was admitted; the simulator prices cold starts off this flag.
        self.warm_hit: Optional[bool] = None

    @property
    def scheduled(self) -> bool:
        return self.decision.scheduled

    @property
    def worker(self) -> Optional[str]:
        return self.decision.worker

    @property
    def controller(self) -> Optional[str]:
        return self.decision.controller

    @property
    def tag(self) -> Optional[str]:
        return self.decision.tag

    @property
    def failed_by_policy(self) -> bool:
        return self.decision.failed_by_policy

    @property
    def retried(self) -> bool:
        return self.attempts > 1

    @property
    def ticket_alive(self) -> bool:
        """Is the admission ticket still live on its original worker
        incarnation? ``False`` once completed, or after the worker was
        deregistered or crashed (either way the ticket was reconciled as
        a ledger eviction and the work it covered died)."""
        if not self.admitted or self.completed:
            return False
        worker = self._worker_ref
        if worker is None or worker.generation != self._generation:
            return False
        return self._watcher.cluster.workers.get(self.decision.worker) is worker

    def _rebind(
        self,
        decision: ScheduleDecision,
        admitted: bool,
        ledger: _Ledger,
        worker_ref: Optional[WorkerState],
    ) -> None:
        """Re-point this placement at a freshly-admitted decision (the
        queue-drain / brownout-reroute path): the original invoke handed
        out an un-admitted ticket, and capacity showed up later."""
        self.decision = decision
        self.admitted = admitted
        self.completed = False
        self._ledger = ledger
        self._worker_ref = worker_ref
        self._generation = 0 if worker_ref is None else worker_ref.generation

    def complete(self, *, slow: bool = False,
                 now: Optional[float] = None) -> bool:
        """Retire the admission ticket. Idempotent-or-loud: returns
        ``True`` only the one time a live ticket is actually released;
        ``False`` on a double complete (recorded in the platform's
        ``duplicate_completions`` counter), an un-admitted placement, or
        a ticket that was already reconciled as an eviction (worker
        deregistered or crashed while the work ran) — none of which
        touch the ledger again. ``now`` is the caller's clock, used to
        expire admission-queue deadlines when the freed slot triggers a
        queue drain (PR 9)."""
        if self.completed or not self.admitted:
            if self.completed and self.admitted and self._core is not None:
                # A second complete() on the same ticket: harmless (the
                # ledger is untouched) but a caller bug worth surfacing.
                self._core._duplicate_completions += 1
            return False
        self.completed = True
        retired = False
        if self._watcher.record_completion(
            self.decision.worker,
            self.decision.controller or "?",
            self.invocation.function,
            slow=slow,
            expected=self._worker_ref,
            generation=self._generation,
        ):
            self._ledger.add_completed()
            retired = True
        # else: the worker was evicted mid-run (deregistration or crash);
        # the eviction already reconciled this ticket.
        core = self._core
        if retired and core is not None and core._lifecycle is not None:
            # Park the instance back in its warm pool *before* the queue
            # drain below, so a drained head routed onto this worker sees
            # the warmth this completion just created. The lazy janitor
            # tick runs first: deadlines ≤ now expire before the new
            # instance parks (its own deadline is now + keep_alive).
            lifecycle = core._lifecycle
            if now is not None:
                lifecycle.expire(now)
            lifecycle.on_complete(
                self._worker_ref,
                self.invocation.function,
                self.decision.controller,
                now,
            )
        if core is not None and core._overload_queues:
            # A slot was freed (or at least a ticket retired): give the
            # admission queues a chance to place their heads through the
            # same O(1) index path the original invoke used.
            core._drain_queues(now)
        return retired

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Placement(function={self.invocation.function!r}, "
            f"tag={self.invocation.tag!r}, worker={self.worker!r}, "
            f"controller={self.controller!r}, admitted={self.admitted}, "
            f"completed={self.completed})"
        )


@dataclasses.dataclass(frozen=True)
class PlatformStats:
    """Point-in-time platform snapshot (routing + admissions + topology)."""

    routed: int
    tapp_routed: int
    vanilla_routed: int
    failed: int
    script_reloads: int
    admitted: int
    completed: int
    inflight: int
    workers: int
    controllers: int
    policy_version: Optional[int]
    topology_epoch: int
    # Volatile-load events recorded by the admission ledger / heartbeats —
    # the stream the candidate indexes consume incrementally.
    load_events: int = 0
    # Admission tickets that died with a deregistered worker (see _Ledger).
    evicted: int = 0
    # Retry re-routes issued by the platform's RetryPolicy machinery.
    retries: int = 0
    # Failure-detector verdicts currently in force.
    suspect_workers: int = 0
    dead_workers: int = 0
    # Overload layer (PR 9); all zero while the layer is off/idle.
    queued: int = 0              # entries ever enqueued (cumulative)
    shed: int = 0                # entries shed by priority / reject
    deadline_exceeded: int = 0   # entries expired waiting
    queue_depth: int = 0         # entries currently waiting
    duplicate_completions: int = 0
    brownout_reroutes: int = 0   # placements served via the degraded plan
    # Warm-pool lifecycle (PR 10); all zero while the layer is unarmed.
    cold_starts: int = 0         # admissions that spawned a new instance
    warm_hits: int = 0           # admissions that reused an idle instance
    expirations: int = 0         # instances terminated (janitor + idle cap)
    idle_instances: int = 0      # instances currently parked warm


class PlatformCore:
    """Entrypoint-count-agnostic platform machinery.

    Owns the watcher (authoritative cluster state + script store), the
    controller runtime, the admission ledger, the policy lifecycle, the
    topology lifecycle, and event fan-out. Subclasses provide the
    entrypoints: :class:`TappPlatform` one flat gateway,
    :class:`~repro_torch.core.platform.federation.TappFederation` one
    :class:`ZoneGateway` per zone — all sharing this core's watcher, so a
    policy swap or topology change invalidates every entrypoint's caches
    through one notification.
    """

    def __init__(
        self,
        cluster: Optional[ClusterState],
        *,
        watcher: Optional[Watcher] = None,
        compiled: bool = True,
        strict_policies: bool = False,
        max_policy_history: int = 8,
        retry: Optional[RetryPolicy] = None,
        lease: Optional[LeaseConfig] = None,
        overload: Optional[OverloadSpec] = None,
        lifecycle: Optional[LifecycleSpec] = None,
    ) -> None:
        # ``watcher`` adopts an existing instance (the legacy-shim
        # migration path) instead of building one around ``cluster``.
        self._watcher = (
            watcher if watcher is not None else Watcher(cluster, lease=lease)
        )
        if watcher is not None and lease is not None:
            self._watcher.configure_lease(lease)
        self._runtime = ControllerRuntime(self._watcher)
        # Warm-pool lifecycle (PR 10), entirely dormant without a
        # LifecycleSpec: no pools, no warmth journal events, and every
        # hook site is one None check — the unarmed platform stays
        # bit-identical to the pre-lifecycle one.
        self._lifecycle = (
            LifecycleManager(lifecycle, self._watcher.cluster)
            if lifecycle is not None else None
        )
        if self._lifecycle is not None:
            self._watcher.attach_lifecycle(self._lifecycle)
        # Zone-sharded admission ledger (PR 7): one counter shard per
        # worker zone, plus the ``None`` shard for un-admitted
        # placements. Writes are zone-local (each placement holds the
        # shard of the zone its ticket was taken in); the lock guards
        # only shard-map growth and cross-zone snapshot reads, never the
        # admit/complete hot path.
        self._ledger_lock = threading.Lock()
        self._ledgers: Dict[Optional[str], _Ledger] = {None: _Ledger()}
        # Platform-default retry policy + per-controller overrides (from
        # ControllerSpec.retry); resolution order per placement: explicit
        # call argument > routed controller's policy > platform default.
        self._retry = retry
        self._controller_retry: Dict[str, RetryPolicy] = {}
        self._retries = 0
        self._compiled = compiled
        self._strict_policies = strict_policies
        self._active: Optional[PolicyHandle] = None
        self._history: Deque[PolicyHandle] = deque(maxlen=max_policy_history)
        # Serialises whole policy transitions (publish + handle/history
        # bookkeeping + plan priming), not just the watcher's swap, so
        # concurrent applies cannot leave `policy` pointing at a handle
        # that is not the published script.
        self._policy_lock = threading.Lock()
        # Overload-resilience layer (PR 9), entirely dormant without an
        # OverloadSpec: the queue map stays empty (complete()'s drain
        # check is one falsy dict read), and the breaker / brownout
        # hooks are None-checked on their (already off-hot-path) sites.
        self._overload = overload
        self._overload_queues: Dict[Optional[str], AdmissionQueue] = {}
        self._breaker = (
            CircuitBreaker(overload.breaker)
            if overload is not None and overload.breaker is not None
            else None
        )
        self._brownout = (
            BrownoutController(overload.brownout)
            if overload is not None and overload.brownout is not None
            else None
        )
        self._drain_lock = threading.Lock()
        self._duplicate_completions = 0
        self._brownout_reroutes = 0
        # The pre-compiled brownout plan: (degraded_script, plan), set by
        # apply_policy when the active script opts in via on-overload.
        self._degraded = None
        # Observer hook for queue lifecycle events ("drained" / "shed" /
        # "expired"); the sim uses it to resume parked requests.
        self.on_queue_event: Optional[
            Callable[[str, Placement, Optional[float]], None]
        ] = None
        self._subscribers: List[Subscriber] = []
        self._watcher.subscribe(self._emit)

    # -- entrypoints (provided by subclasses) -----------------------------------

    def _gateways(self) -> Iterable[Gateway]:
        raise NotImplementedError

    # -- static analysis context (subclasses refine) ----------------------------

    def _analysis_distribution(self) -> Optional[DistributionPolicy]:
        """The distribution policy the analyzer evaluates views under."""
        for gateway in self._gateways():
            return gateway.distribution
        return None

    def _analysis_entry_zones(self) -> Tuple[Optional[str], ...]:
        """Entry contexts to verify: flat platforms evaluate context-free."""
        return (None,)

    def _analysis_federation(self) -> Optional[FederationView]:
        """Forwarding context (federated platforms only)."""
        return None

    def _analyze_policy_plan(
        self,
        plan,
        *,
        starvation_floor: int = 1,
        tags: Optional[Sequence[str]] = None,
    ) -> Optional[AnalysisReport]:
        """Run the static verifier on a lowered plan against live topology."""
        distribution = self._analysis_distribution()
        if distribution is None:
            return None
        return analyze_plan(
            plan,
            self._watcher.cluster,
            distribution,
            entry_zones=self._analysis_entry_zones(),
            starvation_floor=starvation_floor,
            federation=self._analysis_federation(),
            tags=tags,
        )

    def _analysis_plan(self, script: TappScript):
        """Identity-memoized lowering of the active script (explain path)."""
        memo = getattr(self, "_plan_memo", None)
        if memo is None or memo[0] is not script:
            memo = (script, compile_script(script))
            self._plan_memo = memo
        return memo[1]

    def _annotate_explain(
        self,
        report: ExplainReport,
        tag: Optional[str],
        entry_zone: Optional[str],
    ) -> ExplainReport:
        """Mark rejected candidates the active policy can *never* accept.

        A rejection is statically inevitable when the analyzer's verdict
        for the invocation's resolved tag (from this entry context,
        forwarding included) shows no admission sequence ever placing the
        tag on that worker — the operator-facing split between "policy
        can never work here" and "cluster is busy right now".

        With the warm-pool lifecycle armed, every candidate is also
        stamped warm/cold — the exact ``warm_idle`` evidence a
        ``warm-first`` strategy ranked by at evaluation time.
        """
        if self._lifecycle is not None:
            workers = self._watcher.cluster.workers
            fhash = report.invocation.hash

            def _is_warm(name: str) -> bool:
                worker = workers.get(name)
                return (worker is not None
                        and worker.warm_idle.get(fhash, 0) > 0)

            report = annotate_warmth(report, _is_warm)
        handle = self._active
        if handle is None or not handle.script.tags:
            return report
        script = handle.script
        try:
            plan = self._analysis_plan(script)
        except Exception:
            # Interpreter-only script the compiler rejects: the engine
            # still runs it, so there is nothing static to prove.
            return report
        resolved = tag if tag is not None and tag in plan.tags else DEFAULT_TAG
        if resolved not in plan.tags:
            return report
        analysis = self._analyze_policy_plan(plan, tags=(resolved,))
        if analysis is None:
            return report
        selectable = analysis.selectable(resolved, entry_zone)
        if selectable is None:
            return report
        return annotate_inevitable(report, selectable)

    # -- events ----------------------------------------------------------------

    def subscribe(self, callback: Subscriber) -> None:
        """Receive platform events: "topology", "script", "policy",
        "rollback" (watcher events are forwarded)."""
        self._subscribers.append(callback)

    def _emit(self, kind: str) -> None:
        for cb in list(self._subscribers):
            cb(kind)

    # -- component access (read-mostly; never construct these yourself) --------

    @property
    def watcher(self) -> Watcher:
        return self._watcher

    @property
    def runtime(self) -> ControllerRuntime:
        return self._runtime

    @property
    def cluster(self) -> ClusterState:
        return self._watcher.cluster

    @property
    def compiled(self) -> bool:
        """Whether the entrypoints run the compiled fast path."""
        return self._compiled

    # -- topology lifecycle -----------------------------------------------------

    def add_worker(
        self, spec: Union[WorkerSpec, WorkerState, Mapping, None] = None, **fields
    ) -> None:
        """Register a worker (spec, live state, mapping, or kwargs)."""
        if spec is None:
            spec = WorkerSpec(**fields)
        if isinstance(spec, WorkerState):
            worker = spec
        else:
            worker = WorkerSpec.coerce(spec).build()
        self._watcher.register_worker(worker)

    def remove_worker(self, name: str) -> None:
        """Deregister a worker through the watcher's drain path.

        The watcher clears health + reachability before the membership
        change (no admission can race the removal) and reports how many
        admission tickets died with the worker; those are reconciled as
        ledger evictions, so ``admitted == completed + evicted + inflight``
        keeps holding and nothing strands.
        """
        removed = self._watcher.deregister_worker(name)
        if removed is not None and removed.inflight:
            self._ledger_for(removed.zone).add_evicted(removed.inflight)

    def add_controller(
        self,
        spec: Union[ControllerSpec, ControllerState, Mapping, str, None] = None,
        **fields,
    ) -> None:
        if spec is None:
            spec = ControllerSpec(**fields)
        elif isinstance(spec, str):
            spec = ControllerSpec(name=spec, **fields)
        if isinstance(spec, ControllerState):
            controller = spec
        else:
            coerced = ControllerSpec.coerce(spec)
            if coerced.retry is not None:
                self._controller_retry[coerced.name] = coerced.retry
            if coerced.keep_alive is not None and self._lifecycle is not None:
                self._lifecycle.set_controller_keep_alive(
                    coerced.name, coerced.keep_alive
                )
            controller = coerced.build()
        self._watcher.register_controller(controller)

    def remove_controller(self, name: str) -> None:
        """Deregister a controller (drained by the watcher before removal,
        symmetric to :meth:`remove_worker`)."""
        self._controller_retry.pop(name, None)
        if self._lifecycle is not None:
            self._lifecycle.forget_controller(name)
        self._watcher.deregister_controller(name)

    def _adopt_controller_policies(
        self, controllers: Iterable[ControllerSpec]
    ) -> None:
        """Collect per-controller retry policies (and lifecycle
        keep-alive overrides) from declarative specs (the constructor
        path, where the cluster is built wholesale)."""
        for spec in controllers:
            if spec.retry is not None:
                self._controller_retry[spec.name] = spec.retry
            if spec.keep_alive is not None and self._lifecycle is not None:
                self._lifecycle.set_controller_keep_alive(
                    spec.name, spec.keep_alive
                )

    def drain(self, name: str) -> None:
        """Stop new admissions on a worker; running work keeps completing.

        Clears both health and reachability: unreachability is the
        *preliminary* invalidate condition of every policy (paper §3.3),
        so a drained worker is rejected no matter which ``invalidate``
        clause a script uses (``capacity_used`` and
        ``max_concurrent_invocations`` never consult health), and the
        admission ledger refuses new tickets outright — while completions
        still retire, which is what distinguishes a drain from a loss.
        """
        with self._wrap_unknown_worker(name):
            self._watcher.mark_drained(name)

    def restore(self, name: str) -> None:
        """Undo :meth:`drain` / :meth:`mark_unhealthy` /
        :meth:`mark_unreachable` / a failure-detector verdict (subscribers
        see the "topology" event, same as the marking side)."""
        with self._wrap_unknown_worker(name):
            self._watcher.mark_restored(name)

    def mark_unhealthy(self, name: str) -> None:
        with self._wrap_unknown_worker(name):
            self._watcher.mark_unhealthy(name)

    def mark_unreachable(self, name: str) -> None:
        with self._wrap_unknown_worker(name):
            self._watcher.mark_unreachable(name)

    def heartbeat(self, name: str, **fields) -> None:
        """Report live worker state (load / health / residency update).

        Raises :class:`UnknownWorkerError` for a worker that was never
        registered or has been deregistered — a late heartbeat must not
        resurrect a drained worker's state.
        """
        with self._wrap_unknown_worker(name):
            self._watcher.update_worker(name, **fields)

    @staticmethod
    def _wrap_unknown_worker(name: str):
        """Context manager lifting the watcher's ``KeyError`` for an
        unknown worker into the platform's :class:`UnknownWorkerError`."""
        return _UnknownWorkerGuard(name)

    # -- failure detection + recovery (PR 6) -------------------------------------

    def heartbeat_lease(
        self, name: str, now: float, **fields
    ) -> Optional[HealthTransition]:
        """Renew a worker's heartbeat lease (see
        :meth:`~repro_torch.core.scheduler.watcher.Watcher.heartbeat_lease`);
        a heartbeat from a SUSPECT/DEAD worker restores it to HEALTHY and
        returns the transition. Unknown/deregistered workers raise
        :class:`UnknownWorkerError`."""
        with self._wrap_unknown_worker(name):
            return self._watcher.heartbeat_lease(name, now, **fields)

    def check_leases(self, now: float) -> List[HealthTransition]:
        """Advance the failure detector to ``now`` and reconcile the
        ledger: each DEAD verdict's evicted in-flight tickets are counted
        as ledger evictions (the deregistration-drain shape), keeping
        ``admitted == completed + evicted + inflight``."""
        transitions = self._watcher.check_leases(now)
        for transition in transitions:
            if transition.evicted:
                # DEAD workers stay registered, so the zone lookup holds.
                self._ledger_shard_of(transition.worker).add_evicted(
                    transition.evicted
                )
        return transitions

    def fail_worker(self, name: str) -> int:
        """Declare a worker DEAD now (crash signal / fault injection);
        evicts its in-flight tickets into the ledger and returns the
        evicted count. Idempotent; unknown workers raise
        :class:`UnknownWorkerError`."""
        with self._wrap_unknown_worker(name):
            worker = self._watcher.cluster.workers.get(name)
            zone = worker.zone if worker is not None else None
            evicted = self._watcher.mark_dead(name)
        self._ledger_for(zone).add_evicted(evicted)
        return evicted

    def suspect_worker(self, name: str) -> None:
        """Flag a worker SUSPECT (flappy heartbeat): deprioritized in
        candidate ordering but still placeable."""
        with self._wrap_unknown_worker(name):
            self._watcher.mark_suspect(name)

    # -- retry policy resolution --------------------------------------------------

    @property
    def retry_policy(self) -> Optional[RetryPolicy]:
        """The platform-default :class:`RetryPolicy` (None: no retries)."""
        return self._retry

    def _retry_policy_for(
        self,
        controller: Optional[str],
        override: Optional[RetryPolicy],
    ) -> Optional[RetryPolicy]:
        if override is not None:
            return override
        if controller is not None:
            policy = self._controller_retry.get(controller)
            if policy is not None:
                return policy
        return self._retry

    def _masked_route(self, exclude: Sequence[str], route):
        """Run ``route()`` with ``exclude`` workers masked unreachable —
        the already-tried exclusion of a retry re-route. The mask restores
        exactly the workers it masked, so a worker unreachable for other
        reasons stays that way."""
        masked = self._watcher.mask_unreachable(exclude)
        try:
            return route()
        finally:
            if masked:
                self._watcher.unmask(masked)

    # -- policy lifecycle ---------------------------------------------------------

    @property
    def policy(self) -> Optional[PolicyHandle]:
        return self._active

    @property
    def policy_history(self) -> Sequence[PolicyHandle]:
        """Previously-active policies, oldest first (bounded)."""
        return tuple(self._history)

    def _dry_run_from_report(self, report) -> PolicyDryRun:
        cluster = self._watcher.cluster
        return PolicyDryRun(
            report=report,
            known_zones=tuple(cluster.zones()),
            known_sets=tuple(cluster.set_labels()),
            known_controllers=tuple(cluster.controller_names()),
        )

    def dry_run_policy(self, policy: PolicyInput) -> PolicyDryRun:
        """Validate + statically analyze a script without applying it."""
        script, _ = self._coerce_policy(policy)
        cluster = self._watcher.cluster
        report = validate_script(
            script,
            known_controllers=cluster.controller_names(),
            known_worker_labels=cluster.worker_names(),
            known_set_labels=cluster.set_labels(),
        )
        dry_run = self._dry_run_from_report(report)
        try:
            plan = compile_script(script)
        except Exception:
            # Interpreter-only script: validation findings stand alone.
            return dry_run
        analysis = self._analyze_policy_plan(plan)
        if analysis is not None:
            dry_run = dataclasses.replace(dry_run, analysis=analysis)
        degraded = degrade_script(script)
        if degraded is not None:
            # The brownout plan is a deploy artifact too: verify it with
            # the same analyzer so its verdicts gate the apply.
            degraded_analysis = self._analyze_policy_plan(
                compile_script(degraded)
            )
            if degraded_analysis is not None:
                dry_run = dataclasses.replace(
                    dry_run, degraded_analysis=degraded_analysis
                )
        return dry_run

    def verify_policy(
        self,
        policy: Optional[PolicyInput] = None,
        *,
        starvation_floor: int = 1,
    ) -> AnalysisReport:
        """Statically verify a policy against the live topology.

        Defaults to the active policy. Returns the analyzer's
        :class:`~repro_torch.core.analysis.AnalysisReport` — ``report.verdict()``
        renders the per-(tag × entry zone) reachability/satisfiability/
        starvation verdicts. ``starvation_floor`` flags tags whose static
        admission bound is positive but below it.
        """
        if policy is None:
            handle = self._active
            if handle is None:
                raise PolicyError("no active policy to verify")
            script: TappScript = handle.script
        else:
            script, _ = self._coerce_policy(policy)
        plan = compile_script(script)
        report = self._analyze_policy_plan(
            plan, starvation_floor=starvation_floor
        )
        if report is None:
            raise PolicyError(
                "platform has no entrypoints to analyze against"
            )
        return report

    def apply_policy(
        self, policy: PolicyInput, *, strict: Optional[bool] = None
    ) -> PolicyHandle:
        """Validate → dry-run → compile → atomically swap a new policy.

        The swap is all-or-nothing AND race-free: the dry-run gate, the
        compile check, and the swap all run under the watcher's lock (via
        ``publish_script``'s gate hook), so the script is never gated
        against a stale topology snapshot. A parse error, a blocking
        dry-run finding, or a failing compile leaves the active policy,
        the watcher's published script, and the history untouched.
        ``strict`` additionally rejects topology/constraint warnings
        (unknown controllers, worker labels, or set labels; contradictory
        affinity lists) and static-analysis *proofs* (tags no admission
        sequence can ever place); it defaults to the platform's
        ``strict_policies`` setting.
        """
        if strict is None:
            strict = self._strict_policies
        script, source = self._coerce_policy(policy)
        gated: dict = {}
        compiled_path = self._compiled

        def _gate(report) -> None:
            dry_run = self._dry_run_from_report(report)
            gated["dry_run"] = dry_run
            dry_run.raise_for(strict=strict)
            # Compile before the swap: a failing lowering must not
            # un-publish the previous script (the engine would otherwise
            # recompile lazily on the next decision and blow up
            # mid-traffic). The interpreter path never lowers, so it
            # skips the check rather than rejecting scripts it would run
            # — but still lowers opportunistically so the analyzer gets
            # a plan to verify.
            if compiled_path:
                plan = gated["plan"] = compile_script(script)
            else:
                try:
                    plan = compile_script(script)
                except Exception:
                    plan = None
            if plan is not None:
                # Static verification (reachability / satisfiability /
                # starvation) runs under the same lock, against the same
                # snapshot the dry-run saw; strict mode re-gates on the
                # analyzer's proofs before the swap.
                analysis = self._analyze_policy_plan(plan)
                if analysis is not None:
                    dry_run = dataclasses.replace(dry_run, analysis=analysis)
                    gated["dry_run"] = dry_run
                    dry_run.raise_for(strict=strict)
                # on-overload tags pre-compile a degraded brownout plan;
                # verify it under the same lock/snapshot as the primary,
                # so a brownout can never swap in a plan with
                # proven-unplaceable tags (strict mode re-gates).
                degraded = degrade_script(script)
                if degraded is not None:
                    degraded_plan = compile_script(degraded)
                    gated["degraded"] = (degraded, degraded_plan)
                    degraded_analysis = self._analyze_policy_plan(
                        degraded_plan
                    )
                    if degraded_analysis is not None:
                        dry_run = dataclasses.replace(
                            dry_run, degraded_analysis=degraded_analysis
                        )
                        gated["dry_run"] = dry_run
                        dry_run.raise_for(strict=strict)

        with self._policy_lock:
            published = self._watcher.publish_script(script, gate=_gate)
            if compiled_path:
                # The published script shares `script.tags`, so the gate's
                # plan is its plan — seed every entrypoint's engine cache
                # instead of recompiling on the first decision after the
                # swap (one plan object, shared by all zone gateways).
                for gateway in self._gateways():
                    gateway.prime(published, gated["plan"])
            self._degraded = gated.get("degraded")
            if self._degraded is not None and compiled_path:
                # Prime the degraded plan too: the brownout re-route must
                # not pay compilation mid-saturation.
                for gateway in self._gateways():
                    gateway.prime(*self._degraded)
            handle = PolicyHandle(
                version=published.version,
                script=published,
                source=source,
                dry_run=gated["dry_run"],
            )
            if self._active is not None:
                self._history.append(self._active)
            self._active = handle
        self._emit("policy")
        return handle

    def rollback(self) -> Optional[PolicyHandle]:
        """Restore the previous policy (bit-identical decisions).

        The restored script is re-published under a fresh version number;
        its content — and therefore every scheduling decision it produces —
        is identical to when it was last active. Rolling back past the
        oldest retained policy raises; rolling back a platform whose
        previous state was "no policy" restores the vanilla fallback.
        """
        with self._policy_lock:
            if self._active is None and not self._history:
                raise PolicyError("no policy history to roll back to")
            if not self._history:
                # Active policy but empty history → back to "no script".
                self._active = None
                self._degraded = None
                self._watcher.clear_script()
                self._emit("rollback")
                return None
            previous = self._history.pop()
            published = self._watcher.publish_script(
                previous.script, strict=True
            )
            if self._compiled:
                # Same compile-then-prime discipline as apply_policy, so
                # the first decision after the rollback stays
                # compilation-free too.
                plan = compile_script(previous.script)
                for gateway in self._gateways():
                    gateway.prime(published, plan)
            degraded = degrade_script(previous.script)
            try:
                self._degraded = (
                    None if degraded is None
                    else (degraded, compile_script(degraded))
                )
            except Exception:
                # Interpreter-only script: no lowered plan to pre-prime,
                # but the degraded script itself still routes.
                self._degraded = (degraded, None)
            if (self._degraded is not None and self._compiled
                    and self._degraded[1] is not None):
                for gateway in self._gateways():
                    gateway.prime(*self._degraded)
            self._active = dataclasses.replace(
                previous, version=published.version, script=published
            )
        self._emit("rollback")
        return self._active

    def clear_policy(self) -> None:
        """Remove the policy → vanilla fallback (paper §4.3). The cleared
        policy stays in history, so :meth:`rollback` restores it."""
        with self._policy_lock:
            if self._active is not None:
                self._history.append(self._active)
                self._active = None
            self._degraded = None
            self._watcher.clear_script()

    @staticmethod
    def _coerce_policy(policy: PolicyInput):
        if isinstance(policy, TappScript):
            return policy, policy.source
        script = parse_tapp(policy)
        return script, policy

    # -- admission ----------------------------------------------------------------

    def _ledger_for(self, zone: Optional[str]) -> _Ledger:
        """The ledger shard of one zone (created on first use; the lock
        covers only shard-map growth, not counter updates)."""
        shard = self._ledgers.get(zone)
        if shard is None:
            with self._ledger_lock:
                shard = self._ledgers.setdefault(zone, _Ledger())
        return shard

    def _ledger_shard_of(self, worker_name: Optional[str]) -> _Ledger:
        """The shard admissions on ``worker_name`` land in (the worker's
        zone; the ``None`` shard for unknown/deregistered workers)."""
        if worker_name is None:
            return self._ledgers[None]
        worker = self._watcher.cluster.workers.get(worker_name)
        return self._ledger_for(worker.zone if worker is not None else None)

    def ledger_snapshot(self) -> Dict[Optional[str], Tuple[int, int, int]]:
        """Per-zone ``(admitted, completed, evicted)`` counters.

        The shard map is frozen under the ledger lock; each shard's
        triple is then read under that shard's own counter lock (the
        same lock every increment takes — cross-zone forwarding means a
        shard is *not* single-writer), so each per-shard triple is
        internally consistent and the sums satisfy the ledger invariant.
        """
        with self._ledger_lock:
            shards = list(self._ledgers.items())
        return {zone: s.snapshot() for zone, s in shards}

    def _admit(
        self, invocation: Invocation, decision: ScheduleDecision
    ) -> Tuple[Optional[WorkerState], _Ledger, Optional[bool]]:
        """Record a scheduled decision's admission ticket (the single
        admission point of both façades); returns the live worker the
        ticket was taken on (None: nothing to admit), the ledger shard
        the ticket was charged to — the placement completes against
        exactly that shard — and the warm-pool verdict (did the armed
        lifecycle reuse an idle instance? None unarmed/unadmitted)."""
        worker = decision.worker
        if worker is None:
            return None, self._ledgers[None], None
        ticket_worker = self._watcher.record_admission(
            worker, decision.controller or "?", invocation.function
        )
        ledger = self._ledger_for(
            ticket_worker.zone if ticket_worker is not None else None
        )
        ledger.add_admitted()
        warm_hit: Optional[bool] = None
        if self._lifecycle is not None and ticket_worker is not None:
            warm_hit = self._lifecycle.on_admit(
                ticket_worker, invocation.function
            )
        return ticket_worker, ledger, warm_hit

    def place(
        self, invocation: Invocation, decision: ScheduleDecision
    ) -> Placement:
        """Admit a routed decision and hand back its ticket.

        The single admission point behind ``invoke`` / ``invoke_batch``;
        also usable directly with an externally-routed decision (legacy
        scheduler adapters).
        """
        worker_ref, ledger, warm_hit = self._admit(invocation, decision)
        placement = Placement(invocation, decision, worker_ref is not None,
                              self._watcher, ledger, worker_ref)
        placement._core = self
        placement.warm_hit = warm_hit
        return placement

    # -- warm-pool lifecycle (PR 10) ----------------------------------------------

    @property
    def lifecycle_spec(self) -> Optional[LifecycleSpec]:
        return self._lifecycle.spec if self._lifecycle is not None else None

    @property
    def lifecycle(self) -> Optional[LifecycleManager]:
        """The armed lifecycle manager (None: layer off). Read-mostly —
        the admission hooks feed it; callers tick the janitor via
        :meth:`expire_instances` and read :meth:`lifecycle_snapshot`."""
        return self._lifecycle

    def expire_instances(self, now: float) -> int:
        """Run the warm-pool expiration janitor up to ``now`` (explicit
        clock, same discipline as :meth:`check_leases`); returns the
        number of idle instances terminated. No-op (0) unarmed. The
        armed ``invoke``/``complete`` paths also run this lazily
        whenever they are handed a clock, so calling it directly is
        only needed to expire pools across idle gaps."""
        if self._lifecycle is None:
            return 0
        return self._lifecycle.expire(now)

    def lifecycle_snapshot(self) -> Dict[str, int]:
        """Warm-pool counters + occupancy (all-zero mapping unarmed)."""
        if self._lifecycle is None:
            return {
                "cold_starts": 0, "warm_hits": 0, "expirations": 0,
                "idle_instances": 0, "busy_instances": 0, "pools": 0,
            }
        return self._lifecycle.snapshot()

    # -- overload layer (PR 9) ----------------------------------------------------

    @property
    def overload_spec(self) -> Optional[OverloadSpec]:
        return self._overload

    @property
    def brownout_active(self) -> bool:
        return self._brownout is not None and self._brownout.active

    def queue_snapshot(self) -> Dict[Optional[str], Dict[str, int]]:
        """Per-zone admission-queue counters (empty when the layer is
        off or no overflow has ever been enqueued)."""
        return {
            zone: queue.snapshot()
            for zone, queue in sorted(
                self._overload_queues.items(),
                key=lambda kv: (kv[0] is not None, kv[0] or ""),
            )
        }

    def _queue_for(self, zone: Optional[str]) -> AdmissionQueue:
        """The admission queue of one entry zone (armed path only)."""
        queue = self._overload_queues.get(zone)
        if queue is None:
            queue = self._overload_queues[zone] = AdmissionQueue(
                self._overload.queue
            )
        return queue

    def _compiled_policy_tag(self, tag: Optional[str]):
        """The active policy's CompiledTag an invocation tag resolves to
        (None without a policy, or when the script cannot be lowered)."""
        handle = self._active
        if handle is None or not handle.script.tags:
            return None
        try:
            plan = self._analysis_plan(handle.script)
        except Exception:
            return None
        resolved = tag if tag is not None and tag in plan.tags else DEFAULT_TAG
        return plan.tags.get(resolved, plan.default)

    def _queue_priority(self, tag: Optional[str]) -> int:
        ctag = self._compiled_policy_tag(tag)
        return 0 if ctag is None else ctag.priority

    def _queue_on_overload(self, tag: Optional[str]) -> Optional[OnOverload]:
        ctag = self._compiled_policy_tag(tag)
        return None if ctag is None else ctag.on_overload

    def _drain_route(
        self,
        zone: Optional[str],
        invocation: Invocation,
        script: Optional[TappScript] = None,
    ) -> ScheduleDecision:
        """Route a queued (or brownout-degraded) invocation from its
        entry zone; subclasses bind this to their entrypoint shape."""
        raise NotImplementedError

    def _notify_queue(
        self, event: str, placement: Placement, now: Optional[float]
    ) -> None:
        callback = self.on_queue_event
        if callback is not None:
            callback(event, placement, now)

    def _enqueue_overflow(
        self,
        placement: Placement,
        zone: Optional[str],
        now: Optional[float],
    ) -> Placement:
        """Park an unplaceable invocation in its zone's admission queue
        (the armed overflow path — never reached without a QueueSpec).
        Under an active brownout the tag's ``on-overload:`` escape hatch
        runs first: ``reject`` sheds immediately, ``relax-affinity`` /
        ``any-zone`` try the pre-compiled degraded plan; only then does
        the invocation queue (shedding the lowest-priority entrant when
        full)."""
        queue = self._queue_for(zone)
        if self._brownout is not None:
            self._brownout.observe(queue.depth)
            if self._brownout.active:
                handled = self._brownout_overflow(placement, zone, queue, now)
                if handled is not None:
                    return handled
        priority = self._queue_priority(placement.invocation.tag)
        status, entry = queue.offer(placement, priority, now)
        if status == "queued":
            placement.queued = True
            return placement
        # "shed": the entry is the losing side — the newcomer itself,
        # or the lower-priority incumbent evicted to make room for it.
        shed = entry.placement
        shed.queue_outcome = "shed"
        if shed is not placement:
            placement.queued = True
        self._notify_queue("shed", shed, now)
        return placement

    def _brownout_overflow(
        self,
        placement: Placement,
        zone: Optional[str],
        queue: AdmissionQueue,
        now: Optional[float],
    ) -> Optional[Placement]:
        """Apply the tag's on-overload escape hatch under an active
        brownout; returns the handled placement, or None to fall
        through to the queue."""
        mode = self._queue_on_overload(placement.invocation.tag)
        if mode is None:
            return None
        if mode is OnOverload.REJECT:
            placement.queue_outcome = "shed"
            queue.shed += 1
            self._notify_queue("shed", placement, now)
            return placement
        degraded = self._degraded
        if degraded is None:
            return None
        decision = self._drain_route(
            zone, placement.invocation, script=degraded[0]
        )
        if not decision.scheduled:
            return None
        worker_ref, ledger, warm_hit = self._admit(
            placement.invocation, decision
        )
        placement._rebind(decision, worker_ref is not None, ledger,
                          worker_ref)
        placement.warm_hit = warm_hit
        self._brownout_reroutes += 1
        return placement

    def _drain_queues(self, now: Optional[float] = None) -> None:
        """Try to place queued invocations through the normal route path
        (called from ``Placement.complete()`` whenever a ticket retires).
        Expired entries are counted as ``deadline_exceeded`` and never
        placed; draining stops at the first head the cluster still
        cannot take. Re-entrant calls (a drain admitting work while
        another drain runs) are coalesced into the ongoing pass."""
        if not self._drain_lock.acquire(blocking=False):
            return
        try:
            for zone in sorted(
                self._overload_queues,
                key=lambda z: (z is not None, z or ""),
            ):
                queue = self._overload_queues[zone]
                for entry in queue.expire(now):
                    expired = entry.placement
                    expired.queue_outcome = "deadline_exceeded"
                    self._notify_queue("expired", expired, now)
                while True:
                    head = queue.head()
                    if head is None:
                        break
                    invocation = head.placement.invocation
                    decision = self._drain_route(zone, invocation)
                    if not decision.scheduled:
                        break
                    queue.remove(head, drained=True)
                    worker_ref, ledger, warm_hit = self._admit(
                        invocation, decision
                    )
                    drained = head.placement
                    drained._rebind(decision, worker_ref is not None,
                                    ledger, worker_ref)
                    drained.warm_hit = warm_hit
                    drained.queue_outcome = "drained"
                    if now is not None and head.enqueued_at is not None:
                        drained.queue_wait = now - head.enqueued_at
                    self._notify_queue("drained", drained, now)
                if self._brownout is not None:
                    self._brownout.observe(queue.depth)
        finally:
            self._drain_lock.release()

    def _overload_note(self, zone: Optional[str]) -> Optional[str]:
        """One-line queue/brownout state for explain reports (None when
        the queue layer is off)."""
        if self._overload is None or self._overload.queue is None:
            return None
        spec = self._overload.queue
        queue = self._overload_queues.get(zone)
        snap = queue.snapshot() if queue is not None else {}
        note = (
            f"overload queue[{zone if zone is not None else 'platform'}]: "
            f"depth {snap.get('depth', 0)}/{spec.depth} "
            f"({spec.discipline}), shed {snap.get('shed', 0)}, "
            f"deadline_exceeded {snap.get('deadline_exceeded', 0)}, "
            f"drained {snap.get('drained', 0)}"
        )
        if self._brownout is not None and self._brownout.active:
            note += "; brownout active"
        return note

    def _queue_totals(self) -> Tuple[int, int, int, int]:
        """(queued_total, shed, deadline_exceeded, current depth) summed
        over every zone's admission queue."""
        queued = shed = expired = depth = 0
        for queue in list(self._overload_queues.values()):
            snap = queue.snapshot()
            queued += snap["queued_total"]
            shed += snap["shed"]
            expired += snap["deadline_exceeded"]
            depth += snap["depth"]
        return queued, shed, expired, depth

    def _platform_stats(
        self,
        *,
        routed: int,
        tapp_routed: int,
        vanilla_routed: int,
        failed: int,
        script_reloads: int,
    ) -> PlatformStats:
        """Assemble the ledger/cluster half of a stats snapshot; the
        caller supplies only its entrypoints' routing totals (the single
        place both façades' snapshots are built)."""
        cluster = self._watcher.cluster
        suspects = dead = 0
        for w in cluster.workers.values():
            if w.health is HealthState.SUSPECT:
                suspects += 1
            elif w.health is HealthState.DEAD:
                dead += 1
        admitted = completed = evicted = 0
        for shard in list(self._ledgers.values()):
            a, c, e = shard.snapshot()
            admitted += a
            completed += c
            evicted += e
        queued, shed, expired, depth = self._queue_totals()
        cold_starts = warm_hits = expirations = idle_instances = 0
        if self._lifecycle is not None:
            pools = self._lifecycle.snapshot()
            cold_starts = pools["cold_starts"]
            warm_hits = pools["warm_hits"]
            expirations = pools["expirations"]
            idle_instances = pools["idle_instances"]
        return PlatformStats(
            routed=routed,
            tapp_routed=tapp_routed,
            vanilla_routed=vanilla_routed,
            failed=failed,
            script_reloads=script_reloads,
            admitted=admitted,
            completed=completed,
            inflight=sum(w.inflight for w in cluster.workers.values()),
            workers=len(cluster.workers),
            controllers=len(cluster.controllers),
            policy_version=(
                self._active.version if self._active is not None else None
            ),
            topology_epoch=cluster.topology_epoch,
            load_events=cluster.load_seq,
            evicted=evicted,
            retries=self._retries,
            suspect_workers=suspects,
            dead_workers=dead,
            queued=queued,
            shed=shed,
            deadline_exceeded=expired,
            queue_depth=depth,
            duplicate_completions=self._duplicate_completions,
            brownout_reroutes=self._brownout_reroutes,
            cold_starts=cold_starts,
            warm_hits=warm_hits,
            expirations=expirations,
            idle_instances=idle_instances,
        )

    @staticmethod
    def _coerce_invocation(
        function: Union[str, Invocation],
        tag: Optional[str],
        model_id: Optional[str],
        request_id: int = 0,
    ) -> Invocation:
        if isinstance(function, Invocation):
            if tag is not None or model_id is not None or request_id != 0:
                raise TypeError(
                    "pass either a pre-built Invocation or the field "
                    "keywords, not both (the keywords would be silently "
                    "ignored)"
                )
            return function
        return Invocation(
            function=function, tag=tag, model_id=model_id,
            request_id=request_id,
        )


class TappPlatform(PlatformCore):
    """One serverless platform instance: watcher + gateway + controllers.

    The degenerate single-entrypoint federation: one flat
    :class:`Gateway` routes over the whole cluster (``entry_zone=None``
    semantics — no zone-local pass, no forwarding). For multi-zone
    deployments with per-zone entrypoints use
    :class:`~repro_torch.core.platform.federation.TappFederation`, which shares
    every behaviour of this façade through :class:`PlatformCore`.
    """

    def __init__(
        self,
        spec: Optional[Union[ClusterSpec, ClusterState]] = None,
        *,
        distribution: DistributionPolicy = DistributionPolicy.DEFAULT,
        seed: Optional[int] = None,
        compiled: bool = True,
        policy: Optional[PolicyInput] = None,
        strict_policies: bool = False,
        max_policy_history: int = 8,
        retry: Optional[RetryPolicy] = None,
        lease: Optional[LeaseConfig] = None,
        overload: Optional[OverloadSpec] = None,
        lifecycle: Optional[LifecycleSpec] = None,
    ) -> None:
        if isinstance(spec, ClusterState):
            cluster = spec
        elif spec is not None:
            cluster = spec.build()
        else:
            cluster = None
        super().__init__(
            cluster,
            compiled=compiled,
            strict_policies=strict_policies,
            max_policy_history=max_policy_history,
            retry=retry,
            lease=lease,
            overload=overload,
            lifecycle=lifecycle,
        )
        if isinstance(spec, ClusterSpec):
            self._adopt_controller_policies(spec.controllers)
        self._gateway = Gateway(
            self._watcher,
            distribution=distribution,
            seed=seed,
            compiled=compiled,
        )
        if policy is not None:
            self.apply_policy(policy, strict=strict_policies)

    @classmethod
    def from_watcher(
        cls,
        watcher: Watcher,
        *,
        distribution: DistributionPolicy = DistributionPolicy.DEFAULT,
        seed: Optional[int] = None,
        compiled: bool = True,
    ) -> "TappPlatform":
        """Wrap an existing watcher (the legacy-shim migration path)."""
        platform = cls.__new__(cls)
        # One copy of the core init invariants: delegate, don't clone.
        PlatformCore.__init__(platform, None, watcher=watcher,
                              compiled=compiled)
        platform._gateway = Gateway(
            watcher, distribution=distribution, seed=seed, compiled=compiled
        )
        return platform

    def _gateways(self) -> Tuple[Gateway, ...]:
        return (self._gateway,)

    @property
    def gateway(self) -> Gateway:
        return self._gateway

    # -- unified invocation flow ---------------------------------------------------

    def invoke(
        self,
        function: Union[str, Invocation],
        *,
        tag: Optional[str] = None,
        model_id: Optional[str] = None,
        request_id: int = 0,
        trace: bool = False,
        retry: Optional[RetryPolicy] = None,
        now: Optional[float] = None,
    ) -> Placement:
        """Route **and** admit one invocation; returns its :class:`Placement`.

        This is the paper's full request path in one call: the gateway
        resolves the policy tag to a (controller, worker) pair, and the
        admission is recorded immediately so the very next decision sees
        the slot occupancy and running-function multiset this one created.
        Unscheduled invocations return an un-admitted placement (check
        ``scheduled`` / ``failed_by_policy``).

        With a :class:`RetryPolicy` in force (the ``retry`` argument, the
        routed controller's spec, or the platform default — in that
        order), an invocation that finds *no valid worker* is re-routed
        up to ``max_attempts`` times with deterministic backoff charged
        to ``Placement.retry_wait``. A tAPP ``followup: fail`` policy
        failure is terminal and never retried (paper §3.3).

        With an :class:`OverloadSpec` queue configured, an invocation
        that still finds no capacity after retries is *parked* in the
        admission queue instead of failing (``Placement.queued``); a
        later ``complete()`` drains it through the same route path.
        ``now`` is the caller's clock, stamped on the queue entry so
        deadlines can expire (None: entries never expire).
        """
        invocation = self._coerce_invocation(function, tag, model_id,
                                             request_id)
        if self._lifecycle is not None and now is not None:
            # Lazy janitor: expire stale warm instances before routing,
            # so warm-first ranks against the warmth that exists at now.
            self._lifecycle.expire(now)
        placement = self.place(invocation, self._gateway.route(invocation,
                                                               trace=trace))
        if placement.scheduled:
            return placement
        placement = self._retry_unscheduled(invocation, placement, retry,
                                            trace=trace)
        # Queue armed → park instead of failing. Note a saturated tAPP
        # evaluation reports failed_by_policy (followup-fail exhaustion
        # IS the no-capacity outcome under a policy), so that flag does
        # not gate the queue; deadlines bound genuinely unplaceable work.
        if (not placement.scheduled
                and self._overload is not None
                and self._overload.queue is not None):
            placement = self._enqueue_overflow(placement, None, now)
        return placement

    def _retry_unscheduled(
        self,
        invocation: Invocation,
        placement: Placement,
        override: Optional[RetryPolicy],
        *,
        trace: bool = False,
    ) -> Placement:
        """Re-route an unscheduled invoke under the resolved retry policy
        (off the fast path — only entered when the first route failed)."""
        if placement.failed_by_policy:
            return placement
        policy = self._retry_policy_for(placement.controller, override)
        if policy is None:
            return placement
        attempts, waited = placement.attempts, placement.retry_wait
        while (not placement.scheduled
               and not placement.failed_by_policy
               and policy.allows(attempts, waited)):
            waited += policy.backoff(attempts)
            attempts += 1
            self._retries += 1
            placement = self.place(
                invocation, self._gateway.route(invocation, trace=trace)
            )
        placement.attempts = attempts
        placement.retry_wait = waited
        return placement

    def retry(
        self,
        placement: Placement,
        *,
        retry: Optional[RetryPolicy] = None,
    ) -> Optional[Placement]:
        """Re-route a failed placement around the workers it already tried.

        Returns the replacement :class:`Placement` (carrying cumulative
        ``attempts`` / ``retry_wait`` / ``failed_workers`` bookkeeping),
        or ``None`` when no retry is issued: no policy in force, the
        policy's attempt/deadline budget is spent, or the original
        failure was a tAPP ``followup: fail`` — a *policy* verdict, which
        is terminal (only *worker* failures retry; paper §3.3).

        The caller owns the old ticket: a crashed worker's ticket was
        already reconciled as an eviction, a timed-out one should be
        completed (``slow=True``) by whoever declared the timeout.
        """
        policy = self._retry_policy_for(placement.controller, retry)
        if policy is None or placement.failed_by_policy:
            return None
        if not policy.allows(placement.attempts, placement.retry_wait):
            return None
        failed = placement.failed_workers
        if placement.worker is not None:
            failed = failed + (placement.worker,)
        self._retries += 1
        invocation = placement.invocation
        replacement = self._masked_route(
            failed,
            lambda: self.place(invocation, self._gateway.route(invocation)),
        )
        replacement.attempts = placement.attempts + 1
        replacement.retry_wait = (
            placement.retry_wait + policy.backoff(placement.attempts)
        )
        replacement.failed_workers = failed
        return replacement

    def invoke_batch(
        self,
        invocations: Iterable[Union[str, Invocation]],
        *,
        trace: bool = False,
        on_placement: Optional[Callable[[Placement], None]] = None,
        retry: Optional[RetryPolicy] = None,
        now: Optional[float] = None,
    ) -> List[Placement]:
        """Route + admit a batch against one script/snapshot resolution.

        Each invocation is admitted before the next is routed (and
        ``on_placement`` fires in between), so results are bit-identical
        to a sequence of :meth:`invoke` calls — including policies whose
        affinity constraints read the placements made earlier in the same
        batch, and including the unscheduled-retry loop when a
        :class:`RetryPolicy` is in force (its re-routes interleave into
        the batch exactly where sequential invokes would place them),
        and including the admission-queue overflow path when an
        :class:`OverloadSpec` queue is armed.
        """
        invs = [
            inv if isinstance(inv, Invocation) else Invocation(function=inv)
            for inv in invocations
        ]
        if self._lifecycle is not None and now is not None:
            # One janitor tick for the whole batch: the batch resolves
            # against a single snapshot, so warmth expires once, up
            # front, exactly like a sequence of invokes at equal now.
            self._lifecycle.expire(now)
        placements: List[Placement] = []
        queue_armed = (
            self._overload is not None and self._overload.queue is not None
        )

        def _admit(invocation: Invocation, decision: ScheduleDecision) -> None:
            placement = self.place(invocation, decision)
            if not placement.scheduled:
                placement = self._retry_unscheduled(invocation, placement,
                                                    retry, trace=trace)
                if queue_armed and not placement.scheduled:
                    placement = self._enqueue_overflow(placement, None, now)
            placements.append(placement)
            if on_placement is not None:
                on_placement(placement)

        self._gateway.route_batch(invs, trace=trace, on_decision=_admit)
        return placements

    # -- observability ---------------------------------------------------------------

    def explain(
        self,
        function: Union[str, Invocation],
        *,
        tag: Optional[str] = None,
        model_id: Optional[str] = None,
    ) -> ExplainReport:
        """Why would this invocation schedule where it does (or fail)?

        Evaluates the invocation with tracing on and lifts the trace into
        a typed per-block / per-worker rejection report. Side-effect-free:
        nothing is admitted, gateway stats are untouched, and the engine's
        RNG stream / controller cursors are restored afterwards, so
        explaining between two real invokes never changes the second one.
        Rejected candidates the active policy can *never* accept (per the
        static analyzer) are marked statically inevitable.
        """
        invocation = self._coerce_invocation(function, tag, model_id)
        decision = self._gateway.probe(invocation)
        report = build_explain_report(invocation, decision)
        report = self._annotate_explain(report, invocation.tag, None)
        note = self._overload_note(None)
        if note is not None:
            report = dataclasses.replace(
                report, failure_notes=report.failure_notes + (note,)
            )
        return report

    def _drain_route(
        self,
        zone: Optional[str],
        invocation: Invocation,
        script: Optional[TappScript] = None,
    ) -> ScheduleDecision:
        return self._gateway.route(invocation, script=script)

    def prewarm(self) -> int:
        """Eagerly build the scheduler's candidate indexes for the active
        policy against the live topology (see :meth:`Gateway.prewarm`).

        Useful right after :meth:`apply_policy` or a batch of topology
        changes, so the lazy index build does not land on the first live
        invocation. Returns the number of block indexes warmed.
        """
        return self._gateway.prewarm()

    def stats(self) -> PlatformStats:
        gw = self._gateway.stats
        return self._platform_stats(
            routed=gw.routed,
            tapp_routed=gw.tapp_routed,
            vanilla_routed=gw.vanilla_routed,
            failed=gw.failed,
            script_reloads=gw.script_reloads,
        )
