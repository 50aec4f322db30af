"""Discrete-event simulator for serverless function scheduling.

Reproduces the paper's evaluation environment (§5.3) as a closed-loop
(JMeter-style) queueing simulation over a zoned cluster:

* **users** issue requests sequentially (send → wait for response →
  optional pause → next), with a ramp-up stagger;
* the **gateway** (tAPP or vanilla) resolves each invocation to a worker
  using the *live* cluster snapshot — the same scheduler code that drives
  the JAX serving runtime;
* **workers** have concurrent slots, per-function warm containers (code
  locality) — modelled by the platform's warm-pool lifecycle when one is
  armed, by a sim-local TTL cache otherwise — a performance factor
  (heterogeneity / stragglers), and zone placement;
* a **network model** charges zone-to-zone RTTs and bandwidth for
  functions that touch remote data (data locality) and the gateway→zone
  forwarding hop;
* functions may **require** a resource label reachable only from some
  zones (the §5.1 MQTT broker) — running elsewhere raises a function
  error, which is exactly how vanilla OpenWhisk fails that case study.

The simulator is deterministic under a seed, so benchmark tables are
reproducible bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
import statistics
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.platform import (
    LegacyWarmCache,
    Placement,
    TappFederation,
    TappPlatform,
)
from repro_torch.core.platform.faults import ChaosSpec, FaultEvent, FaultInjector
from repro_torch.core.scheduler.engine import Invocation, ScheduleDecision
from repro_torch.core.scheduler.state import ClusterState
from repro_torch.core.scheduler.vanilla import VanillaScheduler
from repro_torch.core.scheduler.watcher import Watcher


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FunctionProfile:
    """Execution profile of one benchmark function."""

    name: str
    exec_time: float                      # service time at perf_factor=1 (s)
    exec_jitter: float = 0.05             # lognormal-ish multiplicative jitter
    cold_start_time: float = 0.35         # container/init time on first use (s)
    warm_overhead: float = 0.004          # warm-path platform overhead (s)
    # Deprecated (PR 10): the sim-local warm cache TTL. An armed warm-pool
    # lifecycle (TappPlatform(..., lifecycle=LifecycleSpec(keep_alive=...)))
    # is authoritative for warm/cold and ignores this field; setting it to
    # a non-default value emits a DeprecationWarning but keeps the seed-era
    # unarmed behaviour bit-for-bit (OpenWhisk: 10 min).
    warm_ttl: float = 600.0
    data_zone: Optional[str] = None       # zone hosting the function's data
    data_bytes: int = 0                   # payload moved from data zone
    data_roundtrips: int = 1              # queries per invocation
    requires: Optional[str] = None        # resource reachable only in some zones
    tag: Optional[str] = None             # tAPP policy tag attached to requests
    # Co-location interference (noisy-neighbour model): execution time is
    # scaled by (1 + sensitivity * co_runners), where co_runners counts
    # admitted invocations of *other* functions on the worker at start time
    # (cache/membus pressure from dissimilar workloads; instances of the
    # same function share working sets and are not charged).
    interference_sensitivity: float = 0.0

    def __post_init__(self) -> None:
        if self.warm_ttl != 600.0:
            warnings.warn(
                "FunctionProfile.warm_ttl is deprecated; arm the platform's "
                "warm-pool lifecycle (TappPlatform(..., lifecycle="
                "LifecycleSpec(keep_alive=...))) to model container expiry "
                "— armed platforms ignore warm_ttl entirely",
                DeprecationWarning,
                stacklevel=3,
            )


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Zone-to-zone RTT (seconds) and bandwidth (bytes/s). Symmetric keys."""

    rtt: Mapping[Tuple[str, str], float]
    bandwidth: Mapping[Tuple[str, str], float]
    default_rtt: float = 0.080
    default_bandwidth: float = 50e6
    # Resource reachability: resource label -> zones that can reach it.
    resource_zones: Mapping[str, Sequence[str]] = dataclasses.field(
        default_factory=dict
    )

    def get_rtt(self, a: str, b: str) -> float:
        if a == b:
            return self.rtt.get((a, b), 0.0005)
        return self.rtt.get((a, b), self.rtt.get((b, a), self.default_rtt))

    def get_bandwidth(self, a: str, b: str) -> float:
        if a == b:
            return self.bandwidth.get((a, b), 10e9)
        return self.bandwidth.get(
            (a, b), self.bandwidth.get((b, a), self.default_bandwidth)
        )

    def reachable(self, resource: str, zone: str) -> bool:
        zones = self.resource_zones.get(resource)
        return zones is None or zone in zones


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A JMeter-style closed-loop workload for one function."""

    function: str
    users: int = 4
    requests_per_user: int = 200
    ramp_up: float = 10.0                 # thread-start stagger window (s)
    pause: float = 0.0                    # think time between requests (s)
    # Federation zone these users' requests enter at (None: the platform's
    # single gateway / the federation's default entry). Multi-entry
    # workloads mix specs with different entry zones.
    entry_zone: Optional[str] = None


@dataclasses.dataclass
class RequestRecord:
    request_id: int
    function: str
    user: int
    submitted: float
    completed: float = 0.0
    worker: Optional[str] = None
    controller: Optional[str] = None
    scheduled: bool = False
    error: Optional[str] = None
    cold: bool = False
    # Federation bookkeeping: which zone the request entered at, whether
    # it was forwarded out of it, and the total cross-zone RTT its hops
    # (failed attempts included) were charged.
    entry_zone: Optional[str] = None
    forwarded: bool = False
    forward_rtt: float = 0.0
    # Failure handling (PR 6): re-routes this request survived (worker
    # crashes / no-valid-worker retries under a RetryPolicy), and the
    # cumulative deterministic backoff charged into its latency.
    retries: int = 0
    retry_wait: float = 0.0
    # Overload handling (PR 9): time spent parked in the admission queue
    # before a completion drained the request onto a worker. Requests
    # shed or expired by the queue terminate with error "shed" /
    # "deadline_exceeded" instead.
    queue_wait: float = 0.0

    @property
    def latency(self) -> float:
        return self.completed - self.submitted

    @property
    def ok(self) -> bool:
        return self.scheduled and self.error is None


@dataclasses.dataclass
class SimResult:
    records: List[RequestRecord]

    def ok_latencies(self) -> List[float]:
        return [r.latency for r in self.records if r.ok]

    @property
    def n_failed(self) -> int:
        return sum(1 for r in self.records if not r.ok)

    @property
    def failure_rate(self) -> float:
        return self.n_failed / max(1, len(self.records))

    def summary(self) -> Dict[str, float]:
        lats = self.ok_latencies()
        if not lats:
            return {
                "count": len(self.records),
                "ok": 0,
                "failure_rate": self.failure_rate,
                "mean": float("nan"),
                "std": float("nan"),
                "p50": float("nan"),
                "p99": float("nan"),
                "max": float("nan"),
            }
        lats_sorted = sorted(lats)

        def pct(p: float) -> float:
            idx = min(len(lats_sorted) - 1, int(p * len(lats_sorted)))
            return lats_sorted[idx]

        return {
            "count": len(self.records),
            "ok": len(lats),
            "failure_rate": self.failure_rate,
            "mean": statistics.fmean(lats),
            "std": statistics.pstdev(lats) if len(lats) > 1 else 0.0,
            "p50": pct(0.50),
            "p99": pct(0.99),
            "max": lats_sorted[-1],
        }

    @property
    def n_forwarded(self) -> int:
        """Requests whose placement left their entry zone (federation)."""
        return sum(1 for r in self.records if r.forwarded)

    @property
    def n_retried(self) -> int:
        """Requests that survived at least one retry re-route."""
        return sum(1 for r in self.records if r.retries)

    @property
    def n_shed(self) -> int:
        """Requests the admission queue shed or expired (PR 9)."""
        return sum(
            1 for r in self.records
            if r.error in ("shed", "deadline_exceeded")
        )

    @property
    def n_queued(self) -> int:
        """Requests that waited in the admission queue before placing."""
        return sum(1 for r in self.records if r.queue_wait > 0.0)

    def queue_waits(self) -> List[float]:
        return [r.queue_wait for r in self.records if r.queue_wait > 0.0]

    def per_worker_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self.records:
            if r.worker:
                counts[r.worker] = counts.get(r.worker, 0) + 1
        return counts

    def for_function(self, function: str) -> "SimResult":
        """The sub-result of one function's requests (per-class summaries)."""
        return SimResult(
            records=[r for r in self.records if r.function == function]
        )


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

# Scheduler adapter: anything mapping (Invocation, ClusterState) -> decision.
SchedulerFn = Callable[[Invocation, ClusterState], ScheduleDecision]


@dataclasses.dataclass
class SimConfig:
    # Control-plane costs (seconds). tAPP interprets a script per request
    # (paper §4.3 keeps this footprint small via caching); vanilla's
    # round-robin is marginally cheaper. Tagged requests additionally pay
    # tag extraction + policy resolution + label→node mapping retrieval —
    # the paper calls many-lightweight-request workloads "the worst case
    # for the overhead" (§5.4.2), so this constant is deliberately visible.
    scheduler_overhead_tapp: float = 0.0020
    scheduler_overhead_vanilla: float = 0.0008
    tag_resolution_overhead: float = 0.045
    gateway_zone: str = "cloud"           # where the entry point lives
    queue_limit: int = 10_000             # per-worker buffered invocations
    seed: int = 0


class Simulation:
    """Closed-loop discrete-event simulation of one deployment + workload.

    The primary constructor takes a :class:`TappPlatform` — the simulator
    drives the exact invoke→admit→complete flow the serving runtime uses.
    A :class:`TappFederation` works the same way and additionally honours
    each :class:`WorkloadSpec`'s ``entry_zone``: requests enter at their
    zone's gateway, forwarded placements land wherever the tolerance
    allows, and failed forward attempts are charged their cross-zone RTT
    on top of the usual gateway→controller→worker hops. The seed-era
    ``Simulation(watcher, scheduler_fn, ...)`` signature is kept as a
    deprecated shim: the watcher is wrapped in a platform, the scheduler
    function only overrides routing, and admissions still flow through
    the platform.
    """

    def __init__(
        self,
        platform: "TappPlatform | TappFederation | Watcher",
        *args,
        network: Optional[NetworkModel] = None,
        profiles: Optional[Mapping[str, FunctionProfile]] = None,
        config: Optional[SimConfig] = None,
        is_tapp: bool = True,
        scheduler: Optional[SchedulerFn] = None,
        chaos: Optional[ChaosSpec] = None,
    ) -> None:
        if isinstance(platform, Watcher):
            warnings.warn(
                "Simulation(watcher, scheduler, ...) is deprecated; "
                "construct a repro_torch.core.platform.TappPlatform and pass it "
                "as the first argument",
                DeprecationWarning,
                stacklevel=2,
            )
            if args and callable(args[0]):
                scheduler, args = args[0], args[1:]
            platform = TappPlatform.from_watcher(platform)
        elif args and callable(args[0]):
            raise TypeError(
                "scheduler functions combine with a Watcher first argument "
                "(deprecated) or the scheduler= keyword — a TappPlatform "
                "routes by itself"
            )
        if len(args) > 3:
            raise TypeError(
                f"Simulation takes at most (network, profiles, config) "
                f"positionally after the platform; got {len(args)} extra "
                f"arguments"
            )
        if args:
            network = args[0]
        if len(args) > 1:
            profiles = args[1]
        if len(args) > 2:
            config = args[2]
        if network is None or profiles is None:
            raise TypeError("Simulation requires network and profiles")
        self.platform = platform
        self.scheduler = scheduler  # legacy routing override (None: platform)
        self.network = network
        self.profiles = dict(profiles)
        self.config = config or SimConfig()
        self.is_tapp = is_tapp
        self.rng = random.Random(self.config.seed)
        self._warm = LegacyWarmCache()                 # (worker, fn) -> last end
        self._queues: Dict[str, List] = {}             # worker -> FIFO of pending
        self._link_load: Dict[Tuple[str, str], int] = {}  # active transfers/link
        self._events: List = []
        self._seq = itertools.count()
        self.records: List[RequestRecord] = []
        # Seeded fault injection (PR 6): the injector is built lazily in
        # run() (it draws targets from the live cluster membership). With
        # chaos=None nothing is scheduled and the event stream — and
        # therefore every placement, trace, and RNG draw — is bit-identical
        # to pre-chaos simulators.
        self.chaos = chaos
        self._injector: Optional[FaultInjector] = None
        # Overload layer (PR 9): requests parked in the platform's
        # admission queue, keyed by placement identity, until a queue
        # event (drained / shed / expired) resolves them; and the
        # precomputed overload_burst windows (start, end, zone, factor)
        # the submit path uses to amplify arrivals — no RNG involved.
        self._waiting: Dict[int, Tuple[Dict, RequestRecord]] = {}
        self._burst_windows: List[Tuple[float, float, object, float]] = []
        self._burst_rid = itertools.count(10_000_000)

    @property
    def watcher(self) -> Watcher:
        """The platform's watcher (compat accessor)."""
        return self.platform.watcher

    @property
    def cluster(self) -> ClusterState:
        return self.platform.cluster

    @property
    def _lifecycle_armed(self) -> bool:
        """Warm-pool lifecycle armed on the platform (PR 10)?

        Armed platforms own warm/cold: the placement's ``warm_hit``
        verdict drives the latency model and the sim-local TTL cache is
        never consulted or written.
        """
        return getattr(self.platform, "lifecycle_spec", None) is not None

    # -- event helpers -----------------------------------------------------------

    def _push(self, time: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (time, next(self._seq), kind, payload))

    # -- main loop ---------------------------------------------------------------

    def run(self, workload: Sequence[WorkloadSpec]) -> SimResult:
        if not self._federated:
            zoned = sorted(
                {s.function for s in workload if s.entry_zone is not None}
            )
            if zoned:
                # A flat platform has one gateway: silently routing these
                # through it while charging entry-zone RTTs would skew
                # every latency — refuse instead.
                raise ValueError(
                    f"workloads {zoned} set entry_zone but the platform is "
                    f"not a TappFederation; drop entry_zone or pass a "
                    f"federation"
                )
        if self.chaos is not None and self._injector is None:
            cluster = self.platform.cluster
            self._injector = FaultInjector(
                self.chaos,
                list(cluster.workers),
                list(cluster.controllers),
                (tuple(self.platform.zones) if self._federated
                 else tuple(cluster.zones())),
            )
            for event in self._injector.schedule():
                self._push(event.at, "fault", event)
                if event.kind == "overload_burst":
                    self._burst_windows.append((
                        event.at,
                        event.until if event.until is not None
                        else float("inf"),
                        event.target,
                        float(event.value or 1.0),
                    ))
        if hasattr(self.platform, "on_queue_event"):
            # Admission-queue callbacks (a no-op unless the platform was
            # built with an OverloadSpec queue): drained requests resume
            # their timeline, shed/expired ones terminate with an error.
            self.platform.on_queue_event = self._on_queue_event
        rid = itertools.count()
        for spec in workload:
            profile = self.profiles[spec.function]
            for user in range(spec.users):
                start = (
                    (user / max(1, spec.users)) * spec.ramp_up
                    if spec.users > 1
                    else 0.0
                )
                self._push(
                    start,
                    "submit",
                    {
                        "spec": spec,
                        "profile": profile,
                        "user": user,
                        "remaining": spec.requests_per_user,
                        "rid": next(rid),
                    },
                )

        while self._events:
            time, _, kind, payload = heapq.heappop(self._events)
            if kind == "submit":
                # Coalesce heap-adjacent submits at the same timestamp into
                # one batch so the scheduler shares a single snapshot/plan
                # resolution (results are identical to one-by-one: decisions
                # and admissions interleave in the same order).
                batch = [payload]
                while (
                    self._events
                    and self._events[0][2] == "submit"
                    and self._events[0][0] == time
                ):
                    batch.append(heapq.heappop(self._events)[3])
                self._on_submit_batch(time, batch)
            elif kind == "start":
                self._on_start(time, payload)
            elif kind == "finish":
                self._on_finish(time, payload)
            elif kind == "fault":
                self._on_fault(time, payload)
            else:  # pragma: no cover - defensive
                raise RuntimeError(f"unknown event {kind}")
        return SimResult(records=self.records)

    # -- event handlers -------------------------------------------------------------

    def _begin_submit(
        self, time: float, payload: Dict
    ) -> Tuple[Invocation, RequestRecord]:
        profile: FunctionProfile = payload["profile"]
        spec: WorkloadSpec = payload["spec"]
        record = RequestRecord(
            request_id=payload["rid"],
            function=profile.name,
            user=payload["user"],
            submitted=time,
            # The *actual* entry zone is stamped from the placement in
            # _finish_submit (a None entry resolves to the federation's
            # default entry there).
            entry_zone=spec.entry_zone if self._federated else None,
        )
        self.records.append(record)
        invocation = Invocation(
            function=profile.name, tag=profile.tag, request_id=record.request_id
        )
        return invocation, record

    def _on_submit(self, time: float, payload: Dict) -> None:
        invocation, record = self._begin_submit(time, payload)
        placement = self._route_one(invocation, record.entry_zone, time)
        self._finish_submit(time, payload, record, placement)

    @property
    def _federated(self) -> bool:
        return isinstance(self.platform, TappFederation)

    def _route_one(
        self,
        invocation: Invocation,
        entry_zone: Optional[str] = None,
        now: Optional[float] = None,
    ) -> Placement:
        if self.scheduler is None:
            if self._federated:
                return self.platform.invoke(invocation, entry_zone=entry_zone,
                                            now=now)
            return self.platform.invoke(invocation, now=now)
        # Legacy adapter: external routing, platform-side admission.
        decision = self.scheduler(invocation, self.platform.cluster)
        return self.platform.place(invocation, decision)

    def _burst_copies(self, time: float, payloads: List[Dict]) -> List[Dict]:
        """Extra one-shot submit copies for payloads inside an active
        overload_burst window: factor − 1 amplification against the
        burst's target zone (a flat platform has one entry, so any
        window amplifies it). Deterministic — rids come off a dedicated
        counter and no RNG is drawn."""
        extra: List[Dict] = []
        for start, end, zone, factor in self._burst_windows:
            if not (start <= time < end):
                continue
            copies = max(0, int(round(factor)) - 1)
            if not copies:
                continue
            for payload in payloads:
                if self._federated:
                    entry = (payload["spec"].entry_zone
                             or self.platform.spec.entry_zone)
                    if entry != zone:
                        continue
                for _ in range(copies):
                    burst = dict(payload)
                    burst["remaining"] = 1  # one-shot: no user chain
                    burst["rid"] = next(self._burst_rid)
                    extra.append(burst)
        return extra

    def _on_submit_batch(self, time: float, payloads: List[Dict]) -> None:
        if self._burst_windows:
            payloads = payloads + self._burst_copies(time, payloads)
        if len(payloads) == 1:
            self._on_submit(time, payloads[0])
            return
        prepared = [self._begin_submit(time, p) for p in payloads]
        invocations = [inv for inv, _ in prepared]
        pending = iter(zip(payloads, prepared))

        if self.scheduler is None:
            def _on_placement(placement: Placement) -> None:
                payload, (_, record) = next(pending)
                self._finish_submit(time, payload, record, placement)

            # One batched routing pass: script version check, plan, and
            # epoch-cached views shared; each placement is admitted (and
            # its sim bookkeeping done) before the next decision is made,
            # so results are identical to one-by-one submits.
            if self._federated:
                self.platform.invoke_batch(
                    invocations,
                    entry_zones=[p["spec"].entry_zone for p in payloads],
                    on_placement=_on_placement,
                    now=time,
                )
            else:
                self.platform.invoke_batch(
                    invocations, on_placement=_on_placement, now=time
                )
            return

        schedule_batch = getattr(self.scheduler, "schedule_batch", None)
        if schedule_batch is None:
            for payload, (invocation, record) in zip(payloads, prepared):
                placement = self._route_one(invocation)
                self._finish_submit(time, payload, record, placement)
            return

        def _place(invocation: Invocation, decision: ScheduleDecision) -> None:
            payload, (_, record) = next(pending)
            self._finish_submit(
                time, payload, record, self.platform.place(invocation, decision)
            )

        schedule_batch(invocations, on_decision=_place)

    def _finish_submit(
        self,
        time: float,
        payload: Dict,
        record: RequestRecord,
        placement: Placement,
    ) -> None:
        profile: FunctionProfile = payload["profile"]
        decision = placement.decision
        overhead = (
            self.config.scheduler_overhead_tapp
            if self.is_tapp
            else self.config.scheduler_overhead_vanilla
        )
        if self.is_tapp and profile.tag is not None:
            overhead += self.config.tag_resolution_overhead
        now = time + overhead

        attempts = getattr(placement, "attempts", 1)
        if attempts > 1:
            # Retry bookkeeping: count the re-routes and charge the not-
            # yet-charged share of the policy's deterministic backoff into
            # this request's latency (re-entries via _retry_or_fail carry
            # cumulative retry_wait, so the delta is what this pass adds).
            record.retries = attempts - 1
            if placement.retry_wait > record.retry_wait:
                now += placement.retry_wait - record.retry_wait
                record.retry_wait = placement.retry_wait

        placement_entry = getattr(placement, "entry_zone", None)
        if placement_entry is not None:
            # The federation resolved the actual entry (a workload with
            # entry_zone=None entered at the default entry zone) — the
            # record and the RTT charge below must use it, not the flat
            # config.gateway_zone fallback.
            record.entry_zone = placement_entry
        hops = getattr(placement, "hops", ())
        if hops:
            # Cross-zone forwarding: failed attempts cost their hop RTT
            # before the request moves on; the taken hops' latency is
            # charged below through the entry→controller→worker path.
            # Accumulated (+=): a retried request's earlier attempts
            # already charged theirs.
            now += sum(h.rtt for h in hops if not h.scheduled)
            record.forward_rtt += sum(h.rtt for h in hops)
            record.forwarded |= any(h.scheduled for h in hops)

        if not decision.scheduled or decision.worker is None:
            outcome = getattr(placement, "queue_outcome", None)
            if getattr(placement, "queued", False) and outcome is None:
                # Parked in the admission queue (PR 9): the request's
                # timeline pauses here; a completion-driven drain (or a
                # shed/expiry) resumes it via _on_queue_event.
                self._waiting[id(placement)] = (payload, record)
                return
            if outcome is not None:
                # Shed at admission (queue full / brownout reject).
                record.completed = now
                record.error = outcome
                self._finish_user_chain(now, payload, record)
                return
            self._retry_or_fail(
                now,
                {"payload": payload, "record": record, "placement": placement},
                "no-valid-worker",
            )
            return

        record.scheduled = True
        record.worker = decision.worker
        record.controller = decision.controller
        cluster = self.platform.cluster
        worker = cluster.workers[decision.worker]

        # Request path: gateway → controller (zone hop) → worker (zone hop).
        # Vanilla's topology-blind worker choice pays cross-zone
        # controller→worker hops that tAPP's local-first ordering avoids —
        # this is the §5.4.1 effect (default policy beating vanilla).
        # Federated requests enter at their workload's zone gateway, so a
        # forwarded placement pays its cross-zone hop right here.
        ctl = (
            cluster.controllers.get(decision.controller)
            if decision.controller
            else None
        )
        ctl_zone = ctl.zone if ctl is not None else worker.zone
        entry = record.entry_zone or self.config.gateway_zone
        now += self.network.get_rtt(entry, ctl_zone)
        now += self.network.get_rtt(ctl_zone, worker.zone)

        state = {"payload": payload, "record": record, "placement": placement}
        queue = self._queues.setdefault(decision.worker, [])
        # `inflight` counts all admitted (buffered) work — the paper's
        # "concurrent invocations"; executing work = inflight - queued.
        executing = worker.inflight - len(queue)
        if executing <= worker.capacity_slots:
            self._push(now, "start", state)
        else:
            queue.append((now, state))

    def _on_start(self, time: float, state: Dict) -> None:
        record: RequestRecord = state["record"]
        profile: FunctionProfile = self.profiles[record.function]
        worker = self.platform.cluster.workers.get(record.worker)
        if worker is None or not state["placement"].ticket_alive:
            # Deregistered while queued, or crashed before the work could
            # start (the ticket was reconciled as a ledger eviction either
            # way). complete() is a bookkeeping no-op on a dead ticket;
            # the request retries under the policy, or fails.
            state["placement"].complete()
            self._retry_or_fail(
                time, state,
                "worker-evicted" if worker is None else "worker-crashed",
            )
            return

        duration = 0.0
        # Code locality: cold vs warm container. An armed warm-pool
        # lifecycle (PR 10) is authoritative: admission already
        # spawned-or-reused an instance and stamped the verdict on the
        # placement, and expiry runs platform-side off keep_alive —
        # warm_ttl is ignored. Unarmed platforms keep the seed-era
        # sim-local TTL cache bit-for-bit.
        if self._lifecycle_armed:
            if state["placement"].warm_hit:
                duration += profile.warm_overhead
            else:
                duration += profile.cold_start_time
                record.cold = True
        elif self._warm.is_warm(
            worker.name, profile.name, time, profile.warm_ttl
        ):
            duration += profile.warm_overhead
        else:
            duration += profile.cold_start_time
            record.cold = True

        # Required local-only resource (the MQTT broker case).
        if profile.requires and not self.network.reachable(
            profile.requires, worker.zone
        ):
            # Connection attempt times out → function error.
            duration += self.network.get_rtt(worker.zone, profile.data_zone or worker.zone)
            duration += 1.0  # connect timeout
            record.error = f"cannot-reach:{profile.requires}"
            self._push(time + duration, "finish", state)
            return

        # Execution time with heterogeneity + jitter + co-location
        # interference (anti-affinity policies exist to dodge the latter).
        jitter = 1.0 + self.rng.uniform(-profile.exec_jitter, profile.exec_jitter)
        slowdown = 1.0
        if profile.interference_sensitivity > 0.0:
            co_runners = sum(
                count
                for fn, count in worker.running_functions.items()
                if fn != profile.name
            )
            slowdown = 1.0 + profile.interference_sensitivity * co_runners
        duration += (
            profile.exec_time * jitter * slowdown / max(1e-6, worker.perf_factor)
        )

        # Data locality: RTTs + payload transfer from the data zone. Link
        # bandwidth is shared by concurrent transfers on the same zone pair
        # (fair-share approximation at transfer start).
        if profile.data_zone is not None:
            link = _link_key(worker.zone, profile.data_zone)
            rtt = self.network.get_rtt(worker.zone, profile.data_zone)
            bw = self.network.get_bandwidth(worker.zone, profile.data_zone)
            duration += profile.data_roundtrips * rtt
            if profile.data_bytes:
                sharers = self._link_load.get(link, 0) + 1
                self._link_load[link] = sharers
                state["link"] = link
                duration += profile.data_bytes * sharers / bw

        if not self._lifecycle_armed:
            self._warm.touch(worker.name, profile.name, time + duration)
        self._push(time + duration, "finish", state)

    def _on_queue_event(
        self, event: str, placement: Placement, now: Optional[float]
    ) -> None:
        """Resolve a request parked in the platform's admission queue.

        ``drained``: the placement was re-bound onto a worker by a
        completion-driven drain — resume its timeline (queue wait is
        wall time between park and drain, stamped by the platform).
        ``shed`` / ``expired``: terminal failure; the user chain moves
        on. Events for placements the sim is not tracking (e.g. direct
        platform use from a test) are ignored."""
        tracked = self._waiting.pop(id(placement), None)
        if tracked is None:
            return
        payload, record = tracked
        at = now if now is not None else record.submitted
        if event == "drained":
            record.queue_wait = placement.queue_wait
            self._finish_submit(at, payload, record, placement)
            return
        record.completed = at
        record.error = placement.queue_outcome or event
        self._finish_user_chain(at, payload, record)

    def _on_finish(self, time: float, state: Dict) -> None:
        record: RequestRecord = state["record"]
        placement: Placement = state["placement"]
        retired = placement.complete(now=time)
        link = state.pop("link", None)
        if link is not None:
            self._link_load[link] = max(0, self._link_load.get(link, 1) - 1)

        if (
            not retired
            and placement.admitted
            and record.worker in self.platform.cluster.workers
        ):
            # The ticket was reconciled as an eviction while the work
            # executed and the worker is still a cluster member — a crash
            # (DEAD transition): the result died with that incarnation.
            # A *deregistered* worker is the drain case instead — running
            # work completes — so it falls through to the normal path.
            self._retry_or_fail(time, state, "worker-crashed")
            return

        record.completed = time
        # Pull the next queued invocation for this worker, if any.
        queue = self._queues.get(record.worker or "", [])
        if queue:
            _, next_state = queue.pop(0)
            self._push(time, "start", next_state)

        self._finish_user_chain(time, state["payload"], record)

    def _retry_or_fail(self, time: float, state: Dict, error: str) -> None:
        """Re-route a failed request under the platform's retry policy,
        or record its terminal failure.

        ``platform.retry`` resolves the policy (explicit > controller >
        platform default) and returns ``None`` when no retry is issued —
        including the no-policy case, which keeps chaos-free runs
        bit-identical: nothing here touches RNG streams or routing state
        unless a retry actually happens. The re-route happens at failure
        time against the live cluster; the policy's backoff is charged
        into the request's latency by ``_finish_submit``'s delta charge.
        """
        record: RequestRecord = state["record"]
        retry = getattr(self.platform, "retry", None)
        replacement = retry(state["placement"]) if retry is not None else None
        if replacement is None:
            record.completed = time
            record.error = error
            self._finish_user_chain(time, state["payload"], record)
            return
        self._finish_submit(time, state["payload"], record, replacement)

    def _on_fault(self, time: float, event: FaultEvent) -> None:
        """Apply one injected fault to the platform and reconcile the
        sim-side bookkeeping the platform cannot see."""
        if not self._injector.apply(event, self.platform, now=time):
            return
        if event.kind == "crash":
            # The worker's warm containers die with it (a restarted
            # worker starts cold), and its queued-but-not-started work is
            # retried or failed — the platform already evicted the
            # tickets. Executing work is handled at its finish event (the
            # dead-ticket complete() there routes into retry-or-fail).
            target = event.target
            self._warm.forget_worker(target)
            for _, state in self._queues.pop(target, ()):
                state["placement"].complete()
                self._retry_or_fail(time, state, "worker-crashed")

    def _finish_user_chain(self, time: float, payload: Dict, record: RequestRecord) -> None:
        payload = dict(payload)
        payload["remaining"] -= 1
        if payload["remaining"] > 0:
            spec: WorkloadSpec = payload["spec"]
            payload["rid"] = record.request_id + 1_000_000  # unique per chain hop
            self._push(time + spec.pause, "submit", payload)


def _link_key(a: str, b: str) -> Tuple[str, str]:
    return (a, b) if a <= b else (b, a)


# ---------------------------------------------------------------------------
# Scheduler adapters
# ---------------------------------------------------------------------------


def gateway_scheduler(gateway) -> SchedulerFn:
    """Deprecated: adapt a :class:`Gateway` to the legacy scheduler signature.

    New code should construct a :class:`~repro_torch.core.platform.TappPlatform`
    and pass it to :class:`Simulation` directly — the platform routes AND
    admits in one step, so no adapter is needed.
    """
    warnings.warn(
        "gateway_scheduler is deprecated; pass a TappPlatform to Simulation",
        DeprecationWarning,
        stacklevel=2,
    )

    def schedule(invocation: Invocation, _cluster: ClusterState) -> ScheduleDecision:
        return gateway.route(invocation)

    def schedule_batch(invocations, *, on_decision=None):
        return gateway.route_batch(invocations, on_decision=on_decision)

    schedule.schedule_batch = schedule_batch  # type: ignore[attr-defined]
    return schedule


def vanilla_scheduler(vanilla: Optional[VanillaScheduler] = None) -> SchedulerFn:
    """Deprecated: a policy-free :class:`TappPlatform` routes vanilla."""
    warnings.warn(
        "vanilla_scheduler is deprecated; a TappPlatform with no policy "
        "applied routes through the same vanilla fallback",
        DeprecationWarning,
        stacklevel=2,
    )
    v = vanilla or VanillaScheduler()

    def schedule(invocation: Invocation, cluster: ClusterState) -> ScheduleDecision:
        return v.schedule(invocation, cluster)

    return schedule
