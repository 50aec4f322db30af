"""The platform gateway (the paper's modified Nginx, §4.3).

The gateway is the single entry point: it extracts the policy tag from an
invocation, consults the cached tAPP script, and resolves the invocation
through the :class:`TappEngine`. Without a script it falls back to the
vanilla round-robin/co-prime baseline — exactly the paper's behaviour
("when no tAPP script is provided, it falls back to the built-in
round-robin").

Caching model (paper §4.3/§4.5): the gateway keeps a local copy of the
script and the label mapping, and re-pulls from the watcher only when the
watcher bumps a version — mirroring the NFS-store + cache-invalidation
design.

**Federation (PR 5).** A :class:`ZoneGateway` is a gateway bound to one
zone: it routes with ``entry_zone`` set, so the evaluation is the
semi-autonomous per-zone scheduler of the Archipelago shape
(arXiv:1911.09849) — zone-local controllers and workers first. When the
zone-local pass fails, :func:`forward_targets` derives, from the
policy's ``topology_tolerance`` clauses, which zones the invocation may
be forwarded to (and in what order); the federation façade walks them.
All zone gateways of a federation share one watcher and therefore one
epoch-cached view/index store — the per-zone candidate indexes are just
the ``zone_restriction``-keyed entries of that store.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Sequence

from repro_torch.core.scheduler.engine import (
    Invocation,
    ScheduleDecision,
    TappEngine,
)
from repro_torch.core.scheduler.state import ClusterState
from repro_torch.core.scheduler.topology import DistributionPolicy
from repro_torch.core.scheduler.vanilla import VanillaScheduler
from repro_torch.core.scheduler.watcher import Watcher
from repro_torch.core.tapp.ast import (
    DEFAULT_TAG,
    FollowupKind,
    TappScript,
    TopologyTolerance,
)


@dataclasses.dataclass
class GatewayStats:
    routed: int = 0
    tapp_routed: int = 0
    vanilla_routed: int = 0
    failed: int = 0
    script_reloads: int = 0


class Gateway:
    def __init__(
        self,
        watcher: Watcher,
        *,
        distribution: DistributionPolicy = DistributionPolicy.DEFAULT,
        seed: Optional[int] = None,
        compiled: bool = True,
    ) -> None:
        self._watcher = watcher
        self._engine = TappEngine(distribution, seed=seed, compiled=compiled)
        self._vanilla = VanillaScheduler()
        self._cached_script: Optional[TappScript] = None
        self._cached_version = -1
        self.stats = GatewayStats()
        watcher.subscribe(self._on_event)

    # -- cache management ---------------------------------------------------------

    def _on_event(self, kind: str) -> None:
        if kind == "script":
            # Invalidate only; the refresh happens lazily on the next request.
            self._cached_version = -1

    def _script(self) -> Optional[TappScript]:
        version = self._watcher.script_version
        if version != self._cached_version:
            self._cached_script = self._watcher.script
            self._cached_version = version
            self.stats.script_reloads += 1
        return self._cached_script

    # -- routing --------------------------------------------------------------------

    def route(
        self,
        invocation: Invocation,
        *,
        trace: bool = False,
        entry_zone: Optional[str] = None,
        script: Optional[TappScript] = None,
    ) -> ScheduleDecision:
        """Route one invocation. ``script`` overrides the published
        script for this decision only (the brownout-degraded plan, PR 9);
        when omitted the watcher-cached script is used."""
        self.stats.routed += 1
        if script is None:
            script = self._script()
        cluster = self._watcher.cluster
        if script is None or not script.tags:
            decision = self._vanilla.schedule(
                invocation, cluster, trace=trace, entry_zone=entry_zone
            )
            self.stats.vanilla_routed += 1
        else:
            decision = self._engine.schedule(
                invocation, script, cluster, trace=trace,
                entry_zone=entry_zone,
            )
            self.stats.tapp_routed += 1
        if not decision.scheduled:
            self.stats.failed += 1
        return decision

    @property
    def compiled(self) -> bool:
        """Whether this gateway's engine runs the compiled fast path."""
        return self._engine.compiled

    @property
    def distribution(self) -> DistributionPolicy:
        """The distribution policy this gateway's engine evaluates under."""
        return self._engine.distribution

    def prime(self, script: TappScript, plan) -> None:
        """Seed the engine's plan cache for a freshly-published script so
        the first routed decision does not pay compilation (no-op on the
        interpreter path)."""
        if self._engine.compiled:
            self._engine.adopt_plan(script, plan)

    def prewarm(self, *, extra_restrictions: Sequence[str] = ()) -> int:
        """Build the plan's candidate indexes against the live topology.

        The indexed fast path builds views, block indexes, and
        availability masks lazily on first use; after a policy swap or a
        topology-epoch bump that lazy build lands on live traffic.
        Prewarming walks every (controller × compiled block) pair of the
        current plan — including the zone-restricted entries a
        ``topology_tolerance: same`` clause (or its sticky followup)
        routes through when its designated controller is unavailable —
        so the next decision is index-warm on the unrestricted paths and
        the statically-knowable restricted ones. ``extra_restrictions``
        adds further zone restrictions to warm (a :class:`ZoneGateway`
        passes its own zone — the entry-local view its every decision
        starts from). Returns the number of block indexes touched (0 when
        there is no script or on the interpreter path, which has no
        indexes).
        """
        if not self._engine.compiled:
            return 0
        script = self._script()
        if script is None or not script.tags:
            return 0
        from repro_torch.core.scheduler.topology import cached_view_entry

        cluster = self._watcher.cluster
        plan = self._engine.compiled_plan(script)
        # Zone restrictions that evaluation can impose: a tolerance=same
        # clause whose designated controller is known pins candidates to
        # that controller's zone (directly, or via the sticky followup).
        sticky_zones = set(extra_restrictions)
        for ctag in plan.tags.values():
            for cblock in ctag.blocks:
                clause = cblock.controller
                if (
                    clause is not None
                    and clause.topology_tolerance is TopologyTolerance.SAME
                ):
                    designated = cluster.controllers.get(clause.label)
                    if designated is not None:
                        sticky_zones.add(designated.zone)
        warmed = 0
        for controller in cluster.controllers.values():
            for restriction in (None, *sorted(sticky_zones)):
                entry = cached_view_entry(
                    cluster,
                    controller.zone,
                    self._engine.distribution,
                    controller_name=controller.name,
                    zone_restriction=restriction,
                )
                for ctag in plan.tags.values():
                    for cblock in ctag.blocks:
                        entry.block_index(cblock)
                        warmed += 1
        return warmed

    def probe(
        self, invocation: Invocation, *, entry_zone: Optional[str] = None
    ) -> ScheduleDecision:
        """Evaluate an invocation with a full trace, without counting it.

        The observability path behind ``TappPlatform.explain``: identical
        policy evaluation to :meth:`route` (same engine), but genuinely
        side-effect-free — no stats accounting (the authoritative watcher
        script is read directly rather than through the reload-counting
        cache), and the engine's RNG stream and round-robin controller
        cursors are restored afterwards, so a probe between two real
        decisions never changes what the second one picks (seeded runs
        stay reproducible even under ``strategy: random``).
        """
        script = self._watcher.script
        cluster = self._watcher.cluster
        if script is None or not script.tags:
            state = self._vanilla.scheduling_state()
            try:
                return self._vanilla.schedule(
                    invocation, cluster, trace=True, entry_zone=entry_zone
                )
            finally:
                self._vanilla.restore_scheduling_state(state)
        state = self._engine.scheduling_state()
        try:
            return self._engine.schedule(
                invocation, script, cluster, trace=True,
                entry_zone=entry_zone,
            )
        finally:
            self._engine.restore_scheduling_state(state)

    def route_batch(
        self,
        invocations,
        *,
        trace: bool = False,
        entry_zone: Optional[str] = None,
        on_decision=None,
    ):
        """Route a batch of invocations against one script/snapshot pull.

        The script version check and plan compilation happen once for the
        whole batch; decisions are made in order and ``on_decision`` fires
        after each one (before the next is evaluated), so callers that
        admit placements inside the callback get results identical to a
        sequence of :meth:`route` calls.
        """
        script = self._script()
        cluster = self._watcher.cluster

        def _account(invocation: Invocation, decision: ScheduleDecision) -> None:
            self.stats.routed += 1
            if script is None or not script.tags:
                self.stats.vanilla_routed += 1
            else:
                self.stats.tapp_routed += 1
            if not decision.scheduled:
                self.stats.failed += 1
            if on_decision is not None:
                on_decision(invocation, decision)

        if script is None or not script.tags:
            decisions = []
            for invocation in invocations:
                decision = self._vanilla.schedule(
                    invocation, cluster, trace=trace, entry_zone=entry_zone
                )
                _account(invocation, decision)
                decisions.append(decision)
            return decisions
        return self._engine.schedule_batch(
            invocations, script, cluster, trace=trace,
            entry_zone=entry_zone, on_decision=_account,
        )


class ZoneGateway(Gateway):
    """A gateway bound to one federation zone (a per-zone entrypoint).

    Routing defaults to the zone-local pass: controller-less blocks use
    only this zone's controllers and candidate workers are restricted to
    this zone, while designated-controller blocks follow their
    ``topology_tolerance`` — ``none``/``same`` pinned to the designated
    home zone, ``all`` under the entry restriction (see the engine's
    entry-zone contract). The federation
    façade calls :meth:`route_local` first and walks
    :func:`forward_targets` on failure; each target zone's own
    ``ZoneGateway`` evaluates the forwarded invocation, so every zone's
    RNG stream and round-robin cursors stay independent — Archipelago's
    semi-autonomous per-entrypoint schedulers.
    """

    def __init__(
        self,
        watcher: Watcher,
        *,
        zone: str,
        distribution: DistributionPolicy = DistributionPolicy.DEFAULT,
        seed: Optional[int] = None,
        compiled: bool = True,
    ) -> None:
        super().__init__(
            watcher, distribution=distribution, seed=seed, compiled=compiled
        )
        self.zone = zone

    def route_local(
        self, invocation: Invocation, *, trace: bool = False
    ) -> ScheduleDecision:
        """Route with this gateway's zone as the entry zone."""
        return self.route(invocation, trace=trace, entry_zone=self.zone)

    def probe_local(self, invocation: Invocation) -> ScheduleDecision:
        """Side-effect-free traced evaluation of the zone-local pass."""
        return self.probe(invocation, entry_zone=self.zone)

    def prewarm(self, *, extra_restrictions: Sequence[str] = ()) -> int:
        """Warm indexes including this zone's entry-local restricted view."""
        return super().prewarm(
            extra_restrictions=(self.zone, *extra_restrictions)
        )


def forward_targets(
    script: Optional[TappScript],
    tag: Optional[str],
    cluster: ClusterState,
    entry_zone: str,
    zone_order: Sequence[str],
    unreachable: FrozenSet[str] = frozenset(),
) -> List[str]:
    """Ordered candidate zones for forwarding a zone-locally-failed request.

    Implements the federation reading of ``topology_tolerance``: the
    designated controller's zone is the function's *home*, and the
    tolerance bounds how far from home the invocation may run —

    * ``none``  → only the home zone (routing a request *to* its
      designated home is designated routing, not tolerance-governed
      forwarding, so the home stays reachable from any entrypoint);
    * ``same``  → only the home zone (other controllers may manage the
      scheduling there, which the engine's zone-restriction fallback
      already implements);
    * ``all``   → the home zone first, then every other zone;
    * no controller clause → no home: any zone may take the work.

    Targets are emitted in block order (designated homes first), then —
    when some block permits unrestricted forwarding — the remaining
    zones of ``zone_order`` (the federation's latency order from the
    entry zone). The entry zone itself is excluded (its pass already
    failed), as are duplicates. A ``followup: default`` tag also
    contributes the default tag's targets, since the forwarded
    evaluation re-runs the followup chain. With no script (vanilla
    fallback) every other zone is a target in latency order: the
    baseline is topology-blind, so nothing bounds the forwarding.

    ``unreachable`` names zones the entry zone cannot currently reach
    (network partition, or every worker DEAD): they are dropped from the
    emitted targets but still consume their dedup slot, so healing a
    partition restores the exact pre-partition order. A tolerance
    ``none``/``same`` function whose home zone is unreachable therefore
    gets *no* targets — the invocation fails rather than escaping its
    designated zone (the partition-tolerance invariant).
    """
    targets: List[str] = []
    seen = {entry_zone}

    def _push(zone: Optional[str]) -> None:
        if zone is not None and zone not in seen:
            seen.add(zone)
            if zone not in unreachable:
                targets.append(zone)

    if script is None or not script.tags:
        for zone in zone_order:
            _push(zone)
        return targets

    policy = script.get(tag or DEFAULT_TAG) or script.default
    if policy is None:
        return targets  # failed by policy; nothing to forward to

    unrestricted = False
    walked = set()
    while policy is not None and policy.tag not in walked:
        walked.add(policy.tag)
        for block in policy.blocks:
            clause = block.controller
            if clause is None:
                unrestricted = True
                continue
            designated = cluster.controllers.get(clause.label)
            if designated is not None:
                _push(designated.zone)
            if clause.topology_tolerance is TopologyTolerance.ALL:
                unrestricted = True
        if policy.effective_followup is FollowupKind.DEFAULT:
            policy = script.default
        else:
            policy = None
    if unrestricted:
        for zone in zone_order:
            _push(zone)
    return targets
