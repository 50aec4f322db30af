"""``TappFederation`` — multi-zone deployment API v2 (PR 5).

The paper's setting is cloud–edge, multi-region serverless: requests
enter at *different* zones, each zone runs its own controller, and
``topology_tolerance`` bounds how far from its designated home a
function may run. This module makes that scenario class expressible
end-to-end: a :class:`~repro_torch.core.platform.specs.FederationSpec`
declares the zones (each a ``ClusterSpec`` slice) and the inter-zone
network model, and ``TappFederation`` stands up one
:class:`~repro_torch.core.scheduler.gateway.ZoneGateway` per zone — the
Archipelago shape (arXiv:1911.09849): semi-autonomous per-entrypoint
schedulers over a shared authoritative state.

All zone gateways share **one** watcher (cluster state, script store,
admission ledger) and therefore one epoch-cached view/index store; each
owns its zone-local compiled candidate indexes (the
``zone_restriction``-keyed entries of that store), its own RNG stream,
and its own round-robin cursors. ``invoke(fn, entry_zone=...)`` routes
zone-locally first; on failure the request is **forwarded** across
zones per the policy's ``topology_tolerance`` (see
:func:`~repro_torch.core.scheduler.gateway.forward_targets`), nearest zone
first, with the network model charging each hop's RTT into the
returned :class:`FederatedPlacement`, the :class:`FederationStats`
counters, and the :meth:`TappFederation.explain` hop report.

``TappPlatform`` remains the degenerate single-entrypoint case — both
façades share :class:`~repro_torch.core.platform.facade.PlatformCore`, so a
single-zone federation makes bit-identical decisions to the flat
platform on the same spec, policy, and seed (property-tested in
``tests/test_federation.py``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import (
    Callable,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
    Union,
)

from repro_torch.core.analysis import FederationView
from repro_torch.core.platform.explain import (
    FederationExplainReport,
    ZoneHopReport,
    build_explain_report,
)
from repro_torch.core.platform.facade import (
    Placement,
    PlatformCore,
    PlatformStats,
    PolicyInput,
)
from repro_torch.core.platform.lifecycle import LifecycleSpec
from repro_torch.core.platform.overload import OverloadSpec
from repro_torch.core.platform.specs import FederationSpec, RetryPolicy
from repro_torch.core.tapp.ast import TappScript
from repro_torch.core.scheduler.engine import (
    Invocation,
    Outcome,
    ScheduleDecision,
    TraceEvent,
)
from repro_torch.core.scheduler.gateway import ZoneGateway, forward_targets
from repro_torch.core.scheduler.topology import DistributionPolicy
from repro_torch.core.scheduler.watcher import LeaseConfig


@dataclasses.dataclass(frozen=True)
class ForwardHop:
    """One cross-zone hop of a federated request (attempted or taken)."""

    from_zone: str
    to_zone: str
    rtt: float
    scheduled: bool  # did this hop's zone place the invocation?


class FederatedPlacement(Placement):
    """A :class:`Placement` plus its entry zone and forwarding record.

    ``hops`` lists every cross-zone hop in trial order — failed forward
    attempts included, because the entry gateway paid their RTT to ask.
    ``forward_rtt`` is the total the network model charged; zero for a
    zone-local placement.
    """

    __slots__ = ("entry_zone", "hops")

    def __init__(
        self,
        invocation: Invocation,
        decision: ScheduleDecision,
        admitted: bool,
        watcher,
        ledger,
        entry_zone: str,
        hops: Tuple[ForwardHop, ...],
        worker_ref=None,
    ) -> None:
        super().__init__(invocation, decision, admitted, watcher, ledger,
                         worker_ref)
        self.entry_zone = entry_zone
        self.hops = hops

    def _rebind(self, decision, admitted, ledger, worker_ref) -> None:
        """Re-point at a drain/brownout re-route decision; the drain
        pass's hop record replaces the original attempt's (whose hops
        were already charged to the federation counters)."""
        super()._rebind(decision, admitted, ledger, worker_ref)
        core = self._core
        if core is not None:
            hops = getattr(core._drain_hops, "value", None)
            if hops is not None:
                self.hops = hops
                core._drain_hops.value = None

    @property
    def forwarded(self) -> bool:
        """Did the placement land outside the entry zone?"""
        return any(h.scheduled for h in self.hops)

    @property
    def forward_rtt(self) -> float:
        """Total cross-zone RTT charged (attempts included)."""
        return sum(h.rtt for h in self.hops)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"FederatedPlacement(function={self.invocation.function!r}, "
            f"entry={self.entry_zone!r}, worker={self.worker!r}, "
            f"forwarded={self.forwarded}, hops={len(self.hops)})"
        )


@dataclasses.dataclass(frozen=True)
class ZoneStats:
    """One zone's routing + load snapshot inside a federation."""

    zone: str
    routed: int
    tapp_routed: int
    vanilla_routed: int
    failed: int
    script_reloads: int
    entered: int         # invocations whose entry zone this was
    forwarded_in: int    # placements this zone accepted from elsewhere
    forwarded_out: int   # entries this zone handed to another zone
    workers: int
    inflight: int
    # This zone's admission-ledger shard (PR 7): tickets taken on / retired
    # from / evicted with this zone's workers, regardless of entry zone.
    admitted: int = 0
    completed: int = 0
    evicted: int = 0
    # This zone's admission-queue shard (PR 9): overflow entries parked
    # by requests *entering* here, keyed by entry zone. All zero with no
    # OverloadSpec queue armed.
    queued: int = 0
    shed: int = 0
    deadline_exceeded: int = 0
    queue_depth: int = 0


@dataclasses.dataclass(frozen=True)
class FederationStats:
    """Federation snapshot: per-zone breakdown + forwarding economics.

    ``aggregate`` sums the per-zone gateway counters into the familiar
    :class:`PlatformStats` shape; note its ``routed``/``failed`` count
    *evaluations* (a forwarded request is evaluated once per zone
    tried), while ``unplaced`` counts *requests* no zone could take.
    """

    aggregate: PlatformStats
    zones: Tuple[ZoneStats, ...]
    forwards: int          # cross-zone hops that placed the request
    forward_attempts: int  # all cross-zone hops tried (incl. failed)
    unplaced: int          # routing passes that exhausted every allowed
                           # zone (a retried request counts once per pass)
    cross_zone_rtt: float  # total RTT charged to hops (seconds)
    # (source, target) zone links whose circuit breaker is currently open
    # (PR 9) — forwards across them are suppressed to the probe rate.
    open_circuits: Tuple[Tuple[str, str], ...] = ()

    def zone(self, name: str) -> ZoneStats:
        for z in self.zones:
            if z.zone == name:
                return z
        raise KeyError(name)


class TappFederation(PlatformCore):
    """A set of per-zone entrypoints over one shared platform core."""

    def __init__(
        self,
        spec: FederationSpec,
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
        if not isinstance(spec, FederationSpec):
            raise TypeError(
                "TappFederation takes a FederationSpec (zone → ClusterSpec "
                "slices); wrap a flat ClusterSpec in a single zone, or use "
                "TappPlatform for the single-entrypoint case"
            )
        if not spec.zones:
            raise ValueError("federation spec declares no zones")
        super().__init__(
            spec.build(),
            compiled=compiled,
            strict_policies=strict_policies,
            max_policy_history=max_policy_history,
            retry=retry,
            lease=lease,
            overload=overload,
            lifecycle=lifecycle,
        )
        self._adopt_controller_policies(spec.merged().controllers)
        self._spec = spec
        self._distribution = distribution
        # Every zone gateway gets the same seed: streams are independent
        # per zone (each gateway owns its engine/RNG), and the single-zone
        # federation consumes exactly the flat platform's stream.
        self._zone_gateways: Dict[str, ZoneGateway] = {
            zone: ZoneGateway(
                self._watcher,
                zone=zone,
                distribution=distribution,
                seed=seed,
                compiled=compiled,
            )
            for zone in spec.zone_names
        }
        self._zone_order: Dict[str, Tuple[str, ...]] = {
            zone: spec.zone_order_from(zone) for zone in spec.zone_names
        }
        self._entered: Dict[str, int] = {z: 0 for z in spec.zone_names}
        self._forwarded_in: Dict[str, int] = {z: 0 for z in spec.zone_names}
        self._forwarded_out: Dict[str, int] = {z: 0 for z in spec.zone_names}
        self._forwards = 0
        self._forward_attempts = 0
        self._unplaced = 0
        self._cross_zone_rtt = 0.0
        # Severed inter-zone links (unordered pairs) + the per-epoch memo
        # of zones whose every worker is DEAD; both feed the partition-
        # aware forwarding walk (PR 6).
        self._partitions: Set[FrozenSet[str]] = set()
        self._dead_zone_cache: Tuple[int, FrozenSet[str]] = (-1, frozenset())
        # Hand-off slot for the drain path (PR 9): _drain_route stashes
        # the drain pass's hops here and FederatedPlacement._rebind picks
        # them up; thread-local because invoke-path brownout re-routes
        # run outside the drain lock.
        self._drain_hops = threading.local()
        if policy is not None:
            self.apply_policy(policy, strict=strict_policies)

    # -- entrypoint access -------------------------------------------------------

    def _gateways(self) -> Tuple[ZoneGateway, ...]:
        return tuple(self._zone_gateways[z] for z in self._spec.zone_names)

    # -- static analysis context -------------------------------------------------

    def _analysis_entry_zones(self) -> Tuple[Optional[str], ...]:
        """Federated plans are verified once per entry zone."""
        return tuple(self._spec.zone_names)

    def _analysis_federation(self) -> FederationView:
        """Forwarding table so per-entry verdicts fold in forward targets."""
        return FederationView(zone_order=dict(self._zone_order))

    @property
    def spec(self) -> FederationSpec:
        return self._spec

    @property
    def zones(self) -> Tuple[str, ...]:
        return self._spec.zone_names

    def zone_gateway(self, zone: str) -> ZoneGateway:
        """The entrypoint of one zone (read-mostly; tests and metrics)."""
        return self._zone_gateways[zone]

    def _resolve_entry(self, entry_zone: Optional[str]) -> str:
        if entry_zone is None:
            return self._spec.entry_zone
        if entry_zone not in self._zone_gateways:
            raise ValueError(
                f"unknown entry zone {entry_zone!r}; federation zones are "
                f"{list(self._spec.zone_names)}"
            )
        return entry_zone

    # -- partitions + zone reachability (PR 6) -----------------------------------

    def _require_zone(self, zone: str) -> None:
        if zone not in self._zone_gateways:
            raise ValueError(
                f"unknown federation zone {zone!r}; zones are "
                f"{list(self._spec.zone_names)}"
            )

    def sever(self, zone_a: str, zone_b: str) -> None:
        """Partition the inter-zone link ``zone_a ↔ zone_b`` (symmetric).

        While severed, neither zone forwards to the other: the partition
        filters :func:`~repro_torch.core.scheduler.gateway.forward_targets` and
        converts a designated direct placement across the severed link
        into a failure (the request then continues the filtered
        forwarding walk, or fails if its tolerance pins it home).
        Idempotent; in-zone scheduling on both sides is unaffected.
        """
        self._require_zone(zone_a)
        self._require_zone(zone_b)
        if zone_a == zone_b:
            raise ValueError(f"cannot sever zone {zone_a!r} from itself")
        self._partitions.add(frozenset((zone_a, zone_b)))

    def heal(self, zone_a: str, zone_b: str) -> None:
        """Undo :meth:`sever` (idempotent). Forwarding order after the
        heal is exactly the pre-partition order — the partition filter
        preserves dedup slots, so nothing is reordered."""
        self._require_zone(zone_a)
        self._require_zone(zone_b)
        self._partitions.discard(frozenset((zone_a, zone_b)))

    def partitioned(self, zone_a: str, zone_b: str) -> bool:
        """Is the ``zone_a ↔ zone_b`` link currently severed?"""
        return frozenset((zone_a, zone_b)) in self._partitions

    @property
    def partitions(self) -> Tuple[Tuple[str, str], ...]:
        """Currently-severed links as sorted (a, b) pairs, sorted."""
        return tuple(sorted(tuple(sorted(p)) for p in self._partitions))

    def _dead_zones(self) -> FrozenSet[str]:
        """Zones whose every worker is DEAD — unroutable, so the
        forwarding walk skips them. Memoized per topology epoch: DEAD
        transitions and revivals are structural (they bump the epoch).
        The rescan walks the per-zone member map with early-out — a
        healthy zone costs one worker check — so an epoch bump in one
        zone charges O(zones), not O(cluster workers), to every
        entrypoint's next request."""
        epoch = self._watcher.cluster.topology_epoch
        cached_epoch, cached = self._dead_zone_cache
        if cached_epoch == epoch:
            return cached
        dead_zones: Set[str] = set()
        for zone, members in self._watcher.cluster.zone_members().items():
            if members and all(w.dead for w in members):
                dead_zones.add(zone)
        dead = frozenset(dead_zones)
        self._dead_zone_cache = (epoch, dead)
        return dead

    def _unreachable_from(self, zone: str) -> FrozenSet[str]:
        """Zones ``zone`` cannot currently deliver work to: partitioned
        peers plus all-DEAD zones. Empty (and cheap) in the fault-free
        case."""
        dead = self._dead_zones()
        if not self._partitions:
            return dead
        cut = {
            other
            for other in self._spec.zone_names
            if frozenset((zone, other)) in self._partitions
        }
        return dead | cut if cut else dead

    @staticmethod
    def _severed_decision(
        decision: ScheduleDecision, worker_zone: str, from_zone: str
    ) -> ScheduleDecision:
        """Convert a scheduled decision whose worker sits behind a severed
        link into a failure (``failed_by_policy`` stays False — this is a
        *worker-side* failure, so retry policies apply)."""
        trace = list(decision.trace)
        trace.append(
            TraceEvent(
                "forward",
                f"placement in zone {worker_zone!r} severed: unreachable "
                f"from {from_zone!r} (partition)",
            )
        )
        return ScheduleDecision(
            outcome=Outcome.FAILED,
            controller=decision.controller,
            tag=decision.tag,
            used_default_fallback=decision.used_default_fallback,
            zone_restriction=decision.zone_restriction,
            failed_by_policy=False,
            trace=trace,
        )

    # -- routing + forwarding ----------------------------------------------------

    def route(
        self,
        invocation: Invocation,
        *,
        entry_zone: Optional[str] = None,
        trace: bool = False,
    ) -> Tuple[ScheduleDecision, Tuple[ForwardHop, ...]]:
        """Route one invocation without admitting it.

        Zone-local pass at the entry zone first; on failure, the
        forwarding walk over :func:`forward_targets` — each target
        zone's own gateway evaluates the request zone-locally, so the
        forwarded decision consumes *that* zone's RNG stream/cursors.
        Returns the final decision plus the hop record (failed forward
        attempts included).
        """
        entry = self._resolve_entry(entry_zone)
        self._entered[entry] += 1
        return self._route_from(entry, invocation, trace)

    def _route_from(
        self,
        entry: str,
        invocation: Invocation,
        trace: bool,
        script: Optional[TappScript] = None,
    ) -> Tuple[ScheduleDecision, Tuple[ForwardHop, ...]]:
        gateway = self._zone_gateways[entry]
        cluster = self._watcher.cluster
        unreachable = self._unreachable_from(entry)
        breaker = self._breaker
        decision = gateway.route(invocation, trace=trace, entry_zone=entry,
                                 script=script)
        if decision.scheduled:
            worker_zone = cluster.workers[decision.worker].zone
            if worker_zone == entry:
                return decision, ()
            if (worker_zone not in unreachable
                    and (breaker is None
                         or breaker.allow(entry, worker_zone))):
                # A designated-controller block placed the work in its home
                # zone directly: that is a cross-zone hop too, and it pays.
                hop = ForwardHop(
                    entry, worker_zone, self._spec.rtt(entry, worker_zone),
                    True,
                )
                self._account_hops(entry, worker_zone, (hop,))
                if breaker is not None:
                    breaker.record_success(entry, worker_zone, rtt=hop.rtt)
                return decision, (hop,)
            # The designated placement sits behind a severed link (or an
            # open circuit): the entry zone cannot deliver it. Convert to
            # a failure and walk the (partition-filtered) forward targets
            # instead — which, for tolerance none/same, pin the function
            # to its (now unreachable) home zone, so the walk is empty and
            # the request fails rather than escaping its designated zone.
            # The entry gateway's routed/scheduled counters already moved;
            # the severed outcome is accounted at this (platform) layer.
            if breaker is not None and worker_zone in unreachable:
                breaker.record_failure(entry, worker_zone)
            decision = self._severed_decision(decision, worker_zone, entry)

        hops: List[ForwardHop] = []
        for target in forward_targets(
            script if script is not None else self._watcher.script,
            invocation.tag,
            cluster,
            entry,
            self._zone_order[entry],
            unreachable=unreachable,
        ):
            target_gateway = self._zone_gateways.get(target)
            if target_gateway is None:
                continue  # a home zone outside the federation's entrypoints
            if breaker is not None and not breaker.allow(entry, target):
                # Open circuit: the link consumed no forward attempt — the
                # breaker lets one probe through every probe_interval-th
                # suppressed attempt, and only that probe pays a hop.
                continue
            forwarded = target_gateway.route(
                invocation, trace=trace, entry_zone=target, script=script
            )
            if forwarded.scheduled:
                # The target zone's scheduler may itself place the work in
                # a *third* zone (a designated block's tolerance
                # restriction). That last leg is chargeable too — unless
                # *it* crosses a severed link, in which case the target
                # cannot deliver either and the walk continues.
                worker_zone = cluster.workers[forwarded.worker].zone
                if (worker_zone == target
                        or worker_zone not in self._unreachable_from(target)):
                    taken = [
                        ForwardHop(
                            entry, target, self._spec.rtt(entry, target), True
                        )
                    ]
                    if worker_zone != target:
                        taken.append(
                            ForwardHop(
                                target, worker_zone,
                                self._spec.rtt(target, worker_zone), True,
                            )
                        )
                    hops.extend(taken)
                    self._account_hops(entry, worker_zone, taken)
                    if breaker is not None:
                        breaker.record_success(entry, target,
                                               rtt=taken[0].rtt)
                    return forwarded, tuple(hops)
            hop = ForwardHop(
                entry, target, self._spec.rtt(entry, target), False
            )
            hops.append(hop)
            self._account_hops(entry, None, (hop,))
            if breaker is not None:
                breaker.record_failure(entry, target)
        self._unplaced += 1
        # Every allowed zone declined: report the entry zone's decision
        # (its failure narrative is the one the caller entered through).
        return decision, tuple(hops)

    def _account_hops(
        self,
        entry: str,
        placed_zone: Optional[str],
        hops: Sequence[ForwardHop],
    ) -> None:
        """Charge a routing step's hops; ``placed_zone`` is where the work
        actually landed (None: nothing placed). Zones added to the live
        cluster after construction are counted too (``.get`` defaults),
        though only spec-declared zones get a :class:`ZoneStats` row."""
        for hop in hops:
            self._forward_attempts += 1
            self._cross_zone_rtt += hop.rtt
        if placed_zone is not None:
            self._forwards += 1
            self._forwarded_out[entry] = (
                self._forwarded_out.get(entry, 0) + 1
            )
            self._forwarded_in[placed_zone] = (
                self._forwarded_in.get(placed_zone, 0) + 1
            )

    def _drain_route(
        self,
        zone: Optional[str],
        invocation: Invocation,
        script: Optional[TappScript] = None,
    ) -> ScheduleDecision:
        """Route a queued (or brownout-degraded) invocation from the
        entry zone it was parked at, through the full forwarding walk.
        The drain pass's hops are stashed for the immediately following
        :meth:`FederatedPlacement._rebind` (thread-local: the core calls
        the pair back-to-back on this thread)."""
        entry = self._resolve_entry(zone)
        decision, hops = self._route_from(entry, invocation, False,
                                          script=script)
        self._drain_hops.value = hops if decision.scheduled else None
        return decision

    # -- unified invocation flow -------------------------------------------------

    def invoke(
        self,
        function: Union[str, Invocation],
        *,
        entry_zone: Optional[str] = None,
        tag: Optional[str] = None,
        model_id: Optional[str] = None,
        request_id: int = 0,
        trace: bool = False,
        retry: Optional[RetryPolicy] = None,
        now: Optional[float] = None,
    ) -> FederatedPlacement:
        """Route (zone-local first, forward per tolerance) **and** admit.

        With a :class:`RetryPolicy` in force (argument > routed
        controller's spec > platform default), an invocation no zone
        could take is re-routed from the same entry zone up to
        ``max_attempts`` times, deterministic backoff charged to
        ``retry_wait``; every attempt's hops are in ``hops`` (the entry
        gateway paid their RTT). ``followup: fail`` stays terminal.

        With an :class:`OverloadSpec` queue armed, an invocation no zone
        could take after retries is parked in the *entry zone's*
        admission queue instead (``Placement.queued``); completions
        drain it through the same entry-zone forwarding walk. ``now``
        is the caller's clock for queue deadlines.
        """
        invocation = self._coerce_invocation(function, tag, model_id,
                                             request_id)
        entry = self._resolve_entry(entry_zone)
        if self._lifecycle is not None and now is not None:
            # Lazy janitor tick, same as the flat façade: stale warm
            # instances expire before any zone ranks by warmth.
            self._lifecycle.expire(now)
        self._entered[entry] += 1
        decision, hops = self._route_from(entry, invocation, trace)
        attempts, waited = 1, 0.0
        if not decision.scheduled and not decision.failed_by_policy:
            policy = self._retry_policy_for(decision.controller, retry)
            if policy is not None:
                all_hops = list(hops)
                while (not decision.scheduled
                       and not decision.failed_by_policy
                       and policy.allows(attempts, waited)):
                    waited += policy.backoff(attempts)
                    attempts += 1
                    self._retries += 1
                    decision, hops = self._route_from(entry, invocation,
                                                      trace)
                    all_hops.extend(hops)
                hops = tuple(all_hops)
        worker_ref, ledger, warm_hit = self._admit(invocation, decision)
        placement = FederatedPlacement(
            invocation, decision, worker_ref is not None, self._watcher,
            ledger, entry, hops, worker_ref,
        )
        placement._core = self
        placement.warm_hit = warm_hit
        placement.attempts = attempts
        placement.retry_wait = waited
        # Queue armed → park in the entry zone's queue instead of failing
        # (failed_by_policy does not gate it: a saturated tAPP evaluation
        # reports followup-fail exhaustion — see TappPlatform.invoke).
        if (not placement.scheduled
                and self._overload is not None
                and self._overload.queue is not None):
            placement = self._enqueue_overflow(placement, entry, now)
        return placement

    def retry(
        self,
        placement: FederatedPlacement,
        *,
        retry: Optional[RetryPolicy] = None,
    ) -> Optional[FederatedPlacement]:
        """Re-route a failed federated placement from its entry zone.

        The workers earlier attempts failed on are masked out of the
        re-route, and the forwarding walk runs against the *current*
        partition/death picture — a retry routes around zones that died
        or were severed since the original attempt. Returns ``None``
        when no retry is issued (no policy, budget spent, or the failure
        was a terminal ``followup: fail`` policy verdict); otherwise the
        replacement placement, whose ``hops`` cover only the re-route
        (the original attempt's hops were already charged).
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
        entry = placement.entry_zone
        self._entered[entry] += 1
        invocation = placement.invocation
        decision, hops = self._masked_route(
            failed, lambda: self._route_from(entry, invocation, False)
        )
        worker_ref, ledger, warm_hit = self._admit(invocation, decision)
        replacement = FederatedPlacement(
            invocation, decision, worker_ref is not None, self._watcher,
            ledger, entry, hops, worker_ref,
        )
        replacement._core = self
        replacement.warm_hit = warm_hit
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
        entry_zone: Optional[str] = None,
        entry_zones: Optional[Sequence[Optional[str]]] = None,
        trace: bool = False,
        on_placement: Optional[Callable[[FederatedPlacement], None]] = None,
        now: Optional[float] = None,
    ) -> List[FederatedPlacement]:
        """Invoke a batch, each item entering at its own zone.

        ``entry_zones`` aligns with ``invocations`` (``None`` entries
        fall back to ``entry_zone`` / the default entry); placements are
        admitted in order, each before the next is routed, so results
        are identical to a sequence of :meth:`invoke` calls — the same
        contract as ``TappPlatform.invoke_batch``.
        """
        invs = [
            inv if isinstance(inv, Invocation) else Invocation(function=inv)
            for inv in invocations
        ]
        if entry_zones is not None and len(entry_zones) != len(invs):
            raise ValueError(
                f"entry_zones has {len(entry_zones)} entries for "
                f"{len(invs)} invocations"
            )
        placements: List[FederatedPlacement] = []
        for index, invocation in enumerate(invs):
            zone = entry_zones[index] if entry_zones is not None else None
            placement = self.invoke(
                invocation, entry_zone=zone or entry_zone, trace=trace,
                now=now,
            )
            placements.append(placement)
            if on_placement is not None:
                on_placement(placement)
        return placements

    # -- observability -----------------------------------------------------------

    def explain(
        self,
        function: Union[str, Invocation],
        *,
        entry_zone: Optional[str] = None,
        tag: Optional[str] = None,
        model_id: Optional[str] = None,
    ) -> FederationExplainReport:
        """The federated "why": one typed report per zone visited.

        Mirrors :meth:`route` — entry-zone pass, then the forwarding walk
        until a zone accepts — but through each gateway's side-effect-free
        ``probe``, so nothing is admitted, no stats move, and every
        zone's RNG stream/cursors are restored.
        """
        invocation = self._coerce_invocation(function, tag, model_id)
        entry = self._resolve_entry(entry_zone)
        cluster = self._watcher.cluster
        unreachable = self._unreachable_from(entry)
        gateway = self._zone_gateways[entry]
        decision = gateway.probe(invocation, entry_zone=entry)
        if decision.scheduled:
            worker_zone = cluster.workers[decision.worker].zone
            if worker_zone != entry and worker_zone in unreachable:
                # Mirror _route_from's severed conversion: the designated
                # placement is behind a partition, so the live path fails
                # it and walks the filtered targets.
                decision = self._severed_decision(decision, worker_zone,
                                                  entry)
        hops = [
            ZoneHopReport(
                zone=entry, rtt=0.0, forwarded=False,
                report=self._annotate_explain(
                    build_explain_report(invocation, decision),
                    invocation.tag, entry,
                ),
            )
        ]
        final = decision
        if not decision.scheduled:
            for target in forward_targets(
                self._watcher.script, invocation.tag, cluster, entry,
                self._zone_order[entry],
                unreachable=unreachable,
            ):
                target_gateway = self._zone_gateways.get(target)
                if target_gateway is None:
                    continue
                probed = target_gateway.probe(invocation, entry_zone=target)
                if probed.scheduled:
                    # Mirror the third-leg severed check of _route_from.
                    worker_zone = cluster.workers[probed.worker].zone
                    if (worker_zone != target
                            and worker_zone in self._unreachable_from(target)):
                        probed = self._severed_decision(probed, worker_zone,
                                                        target)
                hops.append(
                    ZoneHopReport(
                        zone=target,
                        rtt=self._spec.rtt(entry, target),
                        forwarded=True,
                        report=self._annotate_explain(
                            build_explain_report(invocation, probed),
                            invocation.tag, target,
                        ),
                    )
                )
                if probed.scheduled:
                    final = probed
                    break
        placement_zone = None
        forward_rtt = sum(h.rtt for h in hops)
        if final.scheduled:
            placement_zone = cluster.workers[final.worker].zone
            # Mirror _route_from's charging exactly: the last leg from
            # the zone that evaluated the request (the entry pass, or the
            # last forwarding hop) to where the worker actually lives is
            # a chargeable hop too — the designated cross-zone placement
            # case, whichever zone's pass produced it.
            evaluated_at = hops[-1].zone
            if placement_zone != evaluated_at:
                forward_rtt += self._spec.rtt(evaluated_at, placement_zone)
        return FederationExplainReport(
            invocation=invocation,
            entry_zone=entry,
            scheduled=final.scheduled,
            worker=final.worker,
            controller=final.controller,
            placement_zone=placement_zone,
            forward_rtt=forward_rtt,
            hops=tuple(hops),
            unreachable_zones=tuple(sorted(unreachable)),
            overload_note=self._overload_note(entry),
            open_circuits=(
                self._breaker.open_circuits()
                if self._breaker is not None else ()
            ),
        )

    def prewarm(self) -> int:
        """Warm every zone gateway's indexes (shared store: overlapping
        entries are cache hits). Returns total block indexes touched."""
        return sum(gw.prewarm() for gw in self._gateways())

    def stats(self) -> FederationStats:
        cluster = self._watcher.cluster
        zone_rows: List[ZoneStats] = []
        totals = {"routed": 0, "tapp": 0, "vanilla": 0, "failed": 0,
                  "reloads": 0}
        shards = self.ledger_snapshot()
        for zone in self._spec.zone_names:
            gw_stats = self._zone_gateways[zone].stats
            workers = [w for w in cluster.workers.values() if w.zone == zone]
            admitted, completed, evicted = shards.get(zone, (0, 0, 0))
            queue = self._overload_queues.get(zone)
            qsnap = queue.snapshot() if queue is not None else {}
            zone_rows.append(
                ZoneStats(
                    zone=zone,
                    routed=gw_stats.routed,
                    tapp_routed=gw_stats.tapp_routed,
                    vanilla_routed=gw_stats.vanilla_routed,
                    failed=gw_stats.failed,
                    script_reloads=gw_stats.script_reloads,
                    entered=self._entered[zone],
                    forwarded_in=self._forwarded_in[zone],
                    forwarded_out=self._forwarded_out[zone],
                    workers=len(workers),
                    inflight=sum(w.inflight for w in workers),
                    admitted=admitted,
                    completed=completed,
                    evicted=evicted,
                    queued=qsnap.get("queued_total", 0),
                    shed=qsnap.get("shed", 0),
                    deadline_exceeded=qsnap.get("deadline_exceeded", 0),
                    queue_depth=qsnap.get("depth", 0),
                )
            )
            totals["routed"] += gw_stats.routed
            totals["tapp"] += gw_stats.tapp_routed
            totals["vanilla"] += gw_stats.vanilla_routed
            totals["failed"] += gw_stats.failed
            totals["reloads"] += gw_stats.script_reloads
        aggregate = self._platform_stats(
            routed=totals["routed"],
            tapp_routed=totals["tapp"],
            vanilla_routed=totals["vanilla"],
            failed=totals["failed"],
            script_reloads=totals["reloads"],
        )
        return FederationStats(
            aggregate=aggregate,
            zones=tuple(zone_rows),
            forwards=self._forwards,
            forward_attempts=self._forward_attempts,
            unplaced=self._unplaced,
            cross_zone_rtt=self._cross_zone_rtt,
            open_circuits=(
                self._breaker.open_circuits()
                if self._breaker is not None else ()
            ),
        )
