"""The tAPP policy-evaluation engine (paper §3.3 semantics).

Given an invocation (function name + tag), a parsed :class:`TappScript`,
and a cluster snapshot, the engine produces a :class:`ScheduleDecision`:
either a (controller, worker) placement or a followup outcome, together
with an optional full evaluation trace (used by tests, the simulator, and
serving observability).

Evaluation order, faithful to the paper:

1. Resolve the tag (untagged → ``default``; unknown tag → ``default``;
   no script at all → the caller falls back to the vanilla scheduler).
2. Order the tag's blocks by the tag-level strategy (default best_first).
3. Per block: resolve the executing controller (the gateway step):
   the named controller if available, otherwise per ``topology_tolerance``
   (all → any available controller; same → any available controller but
   workers restricted to the designated controller's zone; none → block
   invalid). Blocks without a controller clause are executed by a
   gateway-chosen controller (round-robin cursor).
4. Per block: expand worker items against the controller's distribution
   view, order candidates by block/set strategy, and pick the first one
   whose resolved constraint set (invalidate condition + affinity /
   anti-affinity clauses; see :mod:`repro_torch.core.scheduler.constraints`)
   does not invalidate it.
5. All blocks exhausted → followup (``fail`` | re-evaluate ``default``;
   the default tag's own followup is always ``fail``).

Two execution paths implement these semantics:

* the **interpreter** (``TappEngine(compiled=False)``) — the original
  reference implementation, which re-derives script facts and rebuilds
  distribution views on every call;
* the **compiled fast path** (default) — evaluates a pre-lowered
  :class:`~repro_torch.core.tapp.compile.CompiledScript` against epoch-cached
  topology views (:func:`~repro_torch.core.scheduler.topology.cached_view_entry`),
  with tracing fully elided unless ``trace=True``.

Both paths produce bit-identical placements and traces under a fixed
seed; ``tests/test_scheduler_compile.py`` property-tests this over
randomized scripts and clusters. Tracing defaults to **off**: the sim and
serving hot loops pay nothing for :class:`TraceEvent` construction, while
tests and observability pass ``trace=True`` and get the identical trace.

**Entry zones (federation, PR 5).** ``schedule(..., entry_zone=Z)``
evaluates the policy as zone ``Z``'s semi-autonomous scheduler sees it:
controller-less blocks round-robin only over ``Z``'s controllers with
workers restricted to ``Z``. Designated-controller blocks depend on the
clause's ``topology_tolerance``: ``none``/``same`` pin candidates to
the designated controller's home zone (routing *to* the home is the
script's explicit intent and always allowed; executing outside it never
is), while ``all`` evaluates under the entry restriction like any other
block — the federation's forwarding walk covers the rest of the
cluster. Block-level restrictions (the pin, or the tolerance fallback
zone) take precedence over the entry restriction. With
``entry_zone=None`` (the default) evaluation is exactly the flat
single-entry behaviour of PR 1–4; both execution paths consume identical
RNG draws and emit identical traces either way.
"""
from __future__ import annotations

import dataclasses
import enum
import random as _random
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.core.scheduler.constraints import (
    constraint_reason,
    resolve_constraints,
)
from repro_torch.core.scheduler.state import ClusterState, ControllerState, WorkerState
from repro_torch.core.scheduler.strategy import (
    coprime_order_cached,
    iter_ordered,
    iter_random,
    stable_hash,
)
from repro_torch.core.scheduler.topology import (
    DistributionPolicy,
    ItemIndex,
    WorkerView,
    cached_view_entry,
    distribution_view,
)
from repro_torch.core.tapp.ast import (
    DEFAULT_TAG,
    Block,
    FollowupKind,
    Strategy,
    TagPolicy,
    TappScript,
    TopologyTolerance,
    WorkerRef,
    WorkerSet,
)
if TYPE_CHECKING:  # imported lazily at runtime (in compiled_plan):
    # tapp.compile lowers through the scheduler-side constraint layer, so
    # keeping this edge out of import time leaves tapp ↔ scheduler free of
    # module-scope cycles in either load order.
    from repro_torch.core.tapp.compile import (
        CompiledBlock,
        CompiledScript,
        CompiledTag,
    )


class Outcome(enum.Enum):
    SCHEDULED = "scheduled"
    FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    kind: str  # "block", "controller", "candidate", "followup", "tag"
    detail: str


@dataclasses.dataclass
class ScheduleDecision:
    outcome: Outcome
    worker: Optional[str] = None
    controller: Optional[str] = None
    tag: Optional[str] = None
    used_default_fallback: bool = False
    # The zone constraint of the block that actually scheduled (None when
    # unrestricted); on failure, the constraint of the last block evaluated.
    zone_restriction: Optional[str] = None
    # True iff a tAPP policy evaluated and explicitly failed the request
    # (followup: fail exhausted, or no usable default tag). Structured
    # replacement for sniffing the trace, which is empty on the hot path.
    failed_by_policy: bool = False
    trace: List[TraceEvent] = dataclasses.field(default_factory=list)

    @property
    def scheduled(self) -> bool:
        return self.outcome is Outcome.SCHEDULED

    def explain(self) -> str:
        return "\n".join(f"{e.kind:>10}: {e.detail}" for e in self.trace)


@dataclasses.dataclass(frozen=True)
class Invocation:
    """One function-execution request."""

    function: str
    tag: Optional[str] = None
    # Data-plane context: which model / resource the function touches.
    model_id: Optional[str] = None
    request_id: int = 0
    # Stable function hash, computed once at construction (it is read
    # several times per decision — block ordering, co-prime primaries —
    # and a per-access blake2b would dominate the indexed fast path).
    hash: int = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        object.__setattr__(self, "hash", stable_hash(self.function))


# Optional per-decision callback for batch scheduling: invoked immediately
# after each decision, before the next invocation is evaluated, so callers
# can interleave admissions and keep results identical to sequential calls.
OnDecision = Callable[[Invocation, ScheduleDecision], None]


# -- warm-first orderings (stable partitions, zero RNG draws) ---------------
#
# The warm-pool lifecycle (platform/lifecycle.py) maintains
# WorkerState.warm_idle; with no lifecycle armed every count is 0, every
# partition is the identity, and warm-first degenerates to best_first
# exactly — which is what keeps the unconfigured path bit-identical.


def _warm_view_order(views, fhash: int):
    """One tier's views, warm candidates first (stable within each half)."""
    warm = [v for v in views if v.worker.warm_idle.get(fhash, 0) > 0]
    if not warm:
        return views
    warm.extend(v for v in views if v.worker.warm_idle.get(fhash, 0) <= 0)
    return warm


def _warm_worker_order(workers, fhash: int):
    """One tier's workers, warm first (interpreter set expansion)."""
    warm = [w for w in workers if w.warm_idle.get(fhash, 0) > 0]
    if not warm:
        return workers
    warm.extend(w for w in workers if w.warm_idle.get(fhash, 0) <= 0)
    return warm


def _warm_item_order(items, by_name, fhash: int):
    """A wrk item list, items whose worker is warm first (ghost or
    out-of-view labels count as cold)."""
    warm, cold = [], []
    for item in items:
        view = by_name.get(item.label)
        if view is not None and view.worker.warm_idle.get(fhash, 0) > 0:
            warm.append(item)
        else:
            cold.append(item)
    warm.extend(cold)
    return warm


def _warm_set_order(items, entry, fhash: int):
    """Set items with any warm member first (compiled traced path)."""
    warm, cold = [], []
    for item in items:
        local, foreign = entry.set_members(item.label)
        if any(
            v.worker.warm_idle.get(fhash, 0) > 0 for v in local
        ) or any(v.worker.warm_idle.get(fhash, 0) > 0 for v in foreign):
            warm.append(item)
        else:
            cold.append(item)
    warm.extend(cold)
    return warm


def _interp_warm_set_order(items, views, fhash: int):
    """Set items with any warm member first (interpreter path)."""
    warm, cold = [], []
    for item in items:
        if any(
            v.worker.in_set(item.label)
            and v.worker.warm_idle.get(fhash, 0) > 0
            for v in views
        ):
            warm.append(item)
        else:
            cold.append(item)
    warm.extend(cold)
    return warm


class TappEngine:
    """Stateless policy evaluator (all mutable state lives in the cluster
    snapshot and in the RNG/cursors the caller owns)."""

    def __init__(
        self,
        distribution: DistributionPolicy = DistributionPolicy.DEFAULT,
        *,
        seed: Optional[int] = None,
        compiled: bool = True,
        batch_backend: Optional[str] = None,
    ) -> None:
        self.distribution = distribution
        self.compiled = compiled
        self._rng = _random.Random(seed)
        self._controller_cursor = 0  # round-robin for controller-less blocks
        self._plan: Optional[CompiledScript] = None
        self._plan_source: Optional[TappScript] = None
        # Mask-plane batch routing (scheduler/batch.py): which kernel
        # backend resolves the stacked order planes. None → the
        # REPRO_BATCH_BACKEND env var, then "numpy".
        if batch_backend is None:
            import os

            batch_backend = os.environ.get("REPRO_BATCH_BACKEND") or "numpy"
        self._batch_backend = batch_backend
        self._batch_router = None

    # -- public API ----------------------------------------------------------

    def schedule(
        self,
        invocation: Invocation,
        script: Optional[TappScript],
        cluster: ClusterState,
        *,
        trace: bool = False,
        entry_zone: Optional[str] = None,
    ) -> ScheduleDecision:
        """Resolve one invocation to a worker placement.

        ``entry_zone`` evaluates the policy zone-locally (see the module
        docstring): ``None`` keeps the flat single-entry semantics.
        """
        if self.compiled:
            return self._schedule_compiled(
                invocation, script, cluster, trace, entry_zone
            )
        return self._schedule_interpreted(
            invocation, script, cluster, trace, entry_zone
        )

    def schedule_batch(
        self,
        invocations: Sequence[Invocation],
        script: Optional[TappScript],
        cluster: ClusterState,
        *,
        trace: bool = False,
        entry_zone: Optional[str] = None,
        on_decision: Optional[OnDecision] = None,
    ) -> List[ScheduleDecision]:
        """Resolve a batch of invocations against one cluster snapshot.

        The compiled plan and the epoch-cached topology views are shared
        across the whole batch; decisions are evaluated in order, with
        ``on_decision`` fired after each one so the caller can admit the
        placement before the next decision is made — which keeps batch
        results bit-identical to a sequence of :meth:`schedule` calls with
        interleaved admissions.

        Untraced compiled batches of two or more invocations route
        through the vectorized mask-plane path
        (:class:`~repro_torch.core.scheduler.batch.BatchRouter`): items whose
        cascade consumes no RNG draws are resolved against stacked
        order/availability planes with memoized outcomes, the rest fall
        back to per-item :meth:`schedule` calls — placements, traces,
        RNG streams, and cursor movement are bit-identical either way.
        """
        if self.compiled and script is not None and script.tags:
            plan = self.compiled_plan(script)  # hoist out of the loop
            if not trace and len(invocations) >= 2:
                router = self._batch_router
                if router is None:
                    from repro_torch.core.scheduler.batch import BatchRouter

                    router = self._batch_router = BatchRouter(
                        self, backend=self._batch_backend
                    )
                return router.route_batch(
                    invocations, script, plan, cluster, entry_zone,
                    on_decision,
                )
        decisions: List[ScheduleDecision] = []
        for invocation in invocations:
            decision = self.schedule(
                invocation, script, cluster, trace=trace,
                entry_zone=entry_zone,
            )
            if on_decision is not None:
                on_decision(invocation, decision)
            decisions.append(decision)
        return decisions

    def scheduling_state(self):
        """Snapshot the mutable decision state (RNG stream + controller
        cursor) so a probe/what-if evaluation can be rolled back."""
        return self._rng.getstate(), self._controller_cursor

    def restore_scheduling_state(self, state) -> None:
        rng_state, cursor = state
        self._rng.setstate(rng_state)
        self._controller_cursor = cursor

    def compiled_plan(self, script: TappScript) -> "CompiledScript":
        """The lowered plan for ``script``, compiled once per script object."""
        if script is not self._plan_source:
            from repro_torch.core.tapp.compile import compile_script

            self._plan = compile_script(script)
            self._plan_source = script
        assert self._plan is not None
        return self._plan

    def adopt_plan(self, script: TappScript, plan: "CompiledScript") -> None:
        """Pre-seed the plan cache with an externally-compiled plan.

        The platform's policy apply compiles the script once as its
        lowering check; adopting that plan here means the first decision
        after the swap does not recompile. The caller guarantees ``plan``
        was lowered from the same tag content as ``script`` (the watcher's
        published script shares the source script's ``tags`` tuple).
        """
        self._plan = plan
        self._plan_source = script

    # ======================================================================
    # Compiled fast path
    # ======================================================================

    def _schedule_compiled(
        self,
        invocation: Invocation,
        script: Optional[TappScript],
        cluster: ClusterState,
        trace: bool,
        entry_zone: Optional[str] = None,
    ) -> ScheduleDecision:
        decision = ScheduleDecision(outcome=Outcome.FAILED)
        tr = decision.trace if trace else None
        if script is None or not script.tags:
            if tr is not None:
                tr.append(
                    TraceEvent(
                        "tag", "no tAPP script: caller should use vanilla fallback"
                    )
                )
            return decision

        plan = self.compiled_plan(script)
        tag_name = invocation.tag or DEFAULT_TAG
        ctag = plan.tags.get(tag_name)
        if ctag is None:
            if tr is not None:
                tr.append(
                    TraceEvent(
                        "tag",
                        f"tag {tag_name!r} not in script; falling back to "
                        f"{DEFAULT_TAG!r}",
                    )
                )
            ctag = plan.default
            if ctag is None:
                if tr is not None:
                    tr.append(
                        TraceEvent("tag", "no default tag either: fail")
                    )
                decision.failed_by_policy = True
                return decision

        return self._c_tag(
            invocation, ctag, plan, cluster, decision, tr,
            is_fallback=False, zone_override=entry_zone,
            entry_zone=entry_zone,
        )

    def _c_tag(
        self,
        invocation: Invocation,
        ctag: CompiledTag,
        plan: CompiledScript,
        cluster: ClusterState,
        decision: ScheduleDecision,
        tr: Optional[List[TraceEvent]],
        *,
        is_fallback: bool,
        zone_override: Optional[str],
        entry_zone: Optional[str] = None,
    ) -> ScheduleDecision:
        decision.tag = ctag.tag
        decision.used_default_fallback = is_fallback
        if tr is not None:
            tr.append(
                TraceEvent(
                    "tag",
                    f"evaluating tag {ctag.tag!r} "
                    f"(strategy={ctag.strategy.value}, "
                    f"followup={ctag.followup.value})",
                )
            )

        for block_index, cblock in self._c_ordered(
            ctag.enumerated, ctag.strategy, invocation.hash
        ):
            placed = self._c_block(
                invocation, cblock, block_index, cluster, decision, tr,
                zone_override, entry_zone,
            )
            if placed is not None:
                controller, worker = placed
                decision.outcome = Outcome.SCHEDULED
                decision.controller = controller
                decision.worker = worker
                return decision

        # All blocks exhausted → followup.
        if tr is not None:
            tr.append(
                TraceEvent(
                    "followup",
                    f"tag {ctag.tag!r} exhausted → {ctag.followup.value}",
                )
            )
        if ctag.followup is FollowupKind.DEFAULT and not is_fallback:
            # Paper §3.4: `topology_tolerance: same` pins the default-tag
            # fallback to the designated controller's zone. The label table
            # is precompiled; only the live zone lookup happens here.
            sticky_zone = zone_override
            for label in ctag.sticky_same_labels:
                designated = cluster.controllers.get(label)
                if designated is not None:
                    sticky_zone = designated.zone
                    if tr is not None:
                        tr.append(
                            TraceEvent(
                                "followup",
                                f"tolerance=same → default restricted to "
                                f"zone {sticky_zone!r}",
                            )
                        )
                    break
            default_tag = plan.default
            if default_tag is not None and default_tag.tag != ctag.tag:
                return self._c_tag(
                    invocation, default_tag, plan, cluster, decision, tr,
                    is_fallback=True, zone_override=sticky_zone,
                    entry_zone=entry_zone,
                )
            if tr is not None:
                tr.append(
                    TraceEvent("followup", "no usable default tag: fail")
                )
            decision.failed_by_policy = True
        else:
            decision.failed_by_policy = True
        decision.outcome = Outcome.FAILED
        return decision

    def _c_block(
        self,
        invocation: Invocation,
        cblock: CompiledBlock,
        block_index: int,
        cluster: ClusterState,
        decision: ScheduleDecision,
        tr: Optional[List[TraceEvent]],
        zone_override: Optional[str],
        entry_zone: Optional[str] = None,
    ) -> Optional[Tuple[str, str]]:
        if cblock.controller is None:
            # No controller clause: the gateway tries the available
            # controllers starting at the round-robin cursor (§5.4.1).
            # With an entry zone, only that zone's controllers take part
            # (the per-zone gateway hands work to its own zone first).
            if entry_zone is None:
                controllers = [
                    c for c in cluster.controllers.values() if c.available
                ]
            else:
                controllers = [
                    c for c in cluster.controllers.values()
                    if c.available and c.zone == entry_zone
                ]
            if not controllers:
                if tr is not None:
                    tr.append(
                        TraceEvent(
                            "controller",
                            f"block[{block_index}]: no available controller",
                        )
                    )
                return None
            start = self._controller_cursor
            self._controller_cursor += 1
            n = len(controllers)
            for offset in range(n):
                controller = controllers[(start + offset) % n]
                if tr is not None:
                    tr.append(
                        TraceEvent(
                            "controller",
                            f"block[{block_index}]: gateway → {controller.name!r}",
                        )
                    )
                placed = self._c_block_on(
                    invocation, cblock, controller, zone_override, cluster, tr
                )
                if placed is not None:
                    decision.zone_restriction = zone_override
                    return placed
            return None

        controller, zone_restriction = self._c_resolve_controller(
            cblock, block_index, cluster, tr, entry_zone
        )
        if controller is None:
            return None
        effective = zone_restriction or zone_override
        decision.zone_restriction = effective
        return self._c_block_on(
            invocation, cblock, controller, effective, cluster, tr
        )

    def _c_resolve_controller(
        self,
        cblock: CompiledBlock,
        block_index: int,
        cluster: ClusterState,
        tr: Optional[List[TraceEvent]],
        entry_zone: Optional[str] = None,
    ) -> Tuple[Optional[ControllerState], Optional[str]]:
        clause = cblock.controller
        assert clause is not None

        def note(text: str) -> None:
            if tr is not None:
                tr.append(
                    TraceEvent("controller", f"block[{block_index}]: {text}")
                )

        tol = clause.topology_tolerance
        designated = cluster.controllers.get(clause.label)
        if designated is not None and designated.available:
            # Entry-zone (federated) evaluation: tolerance none/same means
            # the work must *execute* in the designated controller's home
            # zone, so the block's candidates are pinned to it — the
            # guarantee "tolerance none never places outside its zone"
            # must hold no matter which zone the request entered at.
            # Flat evaluation (entry_zone=None) keeps the paper's §3.3
            # semantics, where tolerance only matters when the designated
            # controller is unavailable.
            if entry_zone is not None and tol is not TopologyTolerance.ALL:
                note(
                    f"designated controller {clause.label!r} available "
                    f"(tolerance={tol.value} → workers pinned to zone "
                    f"{designated.zone!r})"
                )
                return designated, designated.zone
            note(f"designated controller {clause.label!r} available")
            return designated, None

        designated_zone = designated.zone if designated is not None else None
        if tol is TopologyTolerance.NONE:
            note(
                f"controller {clause.label!r} unavailable, tolerance=none → "
                f"block invalid"
            )
            return None, None
        alternative = self._round_robin_controller(cluster)
        if alternative is None:
            note("no alternative controller available")
            return None, None
        if tol is TopologyTolerance.SAME:
            if designated_zone is None:
                note(
                    f"controller {clause.label!r} unknown and tolerance=same → "
                    f"cannot resolve its zone, block invalid"
                )
                return None, None
            note(
                f"controller {clause.label!r} unavailable, tolerance=same → "
                f"{alternative.name!r} restricted to zone {designated_zone!r}"
            )
            return alternative, designated_zone
        note(
            f"controller {clause.label!r} unavailable, tolerance=all → "
            f"{alternative.name!r}"
        )
        return alternative, None

    def _c_block_on(
        self,
        invocation: Invocation,
        cblock: CompiledBlock,
        controller: ControllerState,
        zone_restriction: Optional[str],
        cluster: ClusterState,
        tr: Optional[List[TraceEvent]],
    ) -> Optional[Tuple[str, str]]:
        entry = cached_view_entry(
            cluster,
            controller.zone,
            self.distribution,
            controller_name=controller.name,
            zone_restriction=zone_restriction,
        )
        fhash = invocation.hash
        if tr is None:
            # Indexed fast path: epoch-compiled candidate orders + the
            # incrementally-maintained availability bitmask. Produces the
            # same placement (and consumes the same RNG draws) as the
            # traced per-candidate walk below.
            return self._c_block_indexed(cblock, controller, entry, cluster,
                                         fhash)

        if not cblock.uses_sets:
            by_name = entry.by_name
            if cblock.strategy is Strategy.WARM_FIRST:
                items = _warm_item_order(cblock.wrks, by_name, fhash)
            else:
                items = self._c_ordered(cblock.wrks, cblock.strategy, fhash)
            for item in items:
                view = by_name.get(item.label)
                if view is None:
                    # Unknown label or filtered out by the zone restriction
                    # ⇒ outside this controller's distribution view.
                    tr.append(
                        TraceEvent(
                            "candidate",
                            f"{item.label}: outside controller "
                            f"{controller.name!r}'s distribution view",
                        )
                    )
                    continue
                placed = self._c_try(item, view, controller, tr)
                if placed is not None:
                    return placed
            return None

        # Set list: block-level strategy orders the *set items*; each set's
        # inner strategy orders its members, local tier first. Member lists
        # come from the epoch-cached per-set expansion. Random tiers are
        # drawn lazily (iter_random), so RNG consumption stops at the
        # first valid candidate on every path.
        if cblock.strategy is Strategy.WARM_FIRST:
            set_items = _warm_set_order(cblock.sets, entry, fhash)
        else:
            set_items = self._c_ordered(cblock.sets, cblock.strategy, fhash)
        for item in set_items:
            local, foreign = entry.set_members(item.label)
            inner = item.strategy
            if inner is Strategy.RANDOM:
                groups: Tuple[Sequence[WorkerView], ...] = (
                    iter_random(local, self._rng),
                    iter_random(foreign, self._rng),
                )
            elif inner is Strategy.PLATFORM:
                groups = (
                    [local[i] for i in coprime_order_cached(len(local), fhash)],
                    [foreign[i] for i in coprime_order_cached(len(foreign), fhash)],
                )
            elif inner is Strategy.WARM_FIRST:
                # Warm partition within each tier; zero RNG draws.
                groups = (
                    _warm_view_order(local, fhash),
                    _warm_view_order(foreign, fhash),
                )
            else:  # BEST_FIRST: view order (local-first, insertion order)
                groups = (local, foreign)
            for group in groups:
                for view in group:
                    placed = self._c_try(item, view, controller, tr)
                    if placed is not None:
                        return placed
        return None

    def _c_block_indexed(
        self,
        cblock: CompiledBlock,
        controller: ControllerState,
        entry,
        cluster: ClusterState,
        fhash: int,
    ) -> Optional[Tuple[str, str]]:
        """Evaluate one block against its candidate index (no tracing).

        Every epoch-static fact — candidate membership, static constraint
        halves, strategy orders — was materialized when the index was
        built; the only per-decision work is syncing the availability
        bitmask with the ledger's load log (O(1) per admission/completion)
        and taking the first available position in precomputed order.
        """
        bindex = entry.block_index(cblock)
        if not cblock.uses_sets:
            idx = bindex.wrk
            pos = self._c_pick(idx, cblock.strategy, fhash, cluster)
            if pos is None:
                return None
            return controller.name, idx.workers[pos].name

        sets = cblock.sets
        n_items = len(sets)
        strategy = cblock.strategy
        indexes = bindex.sets
        if strategy is Strategy.BEST_FIRST or n_items <= 1:
            item_order: Sequence[int] = range(n_items)
        elif strategy is Strategy.PLATFORM:
            item_order = coprime_order_cached(n_items, fhash)
        elif strategy is Strategy.WARM_FIRST:
            # Stable partition: set items with any warm member first.
            item_order = sorted(
                range(n_items),
                key=lambda i: not indexes[i].has_warm(cluster, fhash),
            )
        else:  # RANDOM: same lazy draw sequence as ordering the items
            item_order = iter_random(range(n_items), self._rng)
        for ipos in item_order:
            pos = self._c_pick(indexes[ipos], sets[ipos].strategy, fhash,
                               cluster)
            if pos is not None:
                idx = indexes[ipos]
                return controller.name, idx.workers[pos].name
        return None

    def _c_pick(
        self,
        idx: ItemIndex,
        strategy: Strategy,
        fhash: int,
        cluster: ClusterState,
    ) -> Optional[int]:
        """First available candidate position under ``strategy``."""
        avail = idx.refresh(cluster)
        if strategy is Strategy.RANDOM:
            # Draws through the tiers even when nothing is available —
            # the reference paths consume those draws too.
            return idx.pick_random(avail, self._rng)
        if not avail:
            return None  # e.g. fully saturated: O(1), no rescan
        if strategy is Strategy.PLATFORM:
            return idx.pick_platform(avail, fhash)
        if strategy is Strategy.WARM_FIRST:
            # Warm partition per tier: warm locals, cold locals, warm
            # foreigns, cold foreigns — pure bit ops, zero RNG draws.
            # With no lifecycle armed the warm mask is 0 and this is
            # exactly the BEST_FIRST lowest-bit pick.
            warm = idx.warm_mask(cluster, fhash) & avail
            if warm:
                local = idx.local_mask
                wl = warm & local
                if wl:
                    return (wl & -wl).bit_length() - 1
                al = avail & local
                if al:
                    return (al & -al).bit_length() - 1
                return (warm & -warm).bit_length() - 1
        return (avail & -avail).bit_length() - 1  # BEST_FIRST: lowest bit

    def _c_try(
        self,
        item,  # CompiledWrk | CompiledSet
        view: WorkerView,
        controller: ControllerState,
        tr: Optional[List[TraceEvent]],
    ) -> Optional[Tuple[str, str]]:
        """Check one candidate; fast path does no string work at all."""
        worker = view.worker
        if tr is None:
            if item.invalid(worker) or view.saturated:
                return None
            return controller.name, worker.name
        reason = constraint_reason(worker, item.spec)
        if reason is None and view.saturated:
            reason = (
                f"controller entitlement saturated "
                f"({worker.inflight}/{view.slot_cap} slots)"
            )
        if reason is None:
            tr.append(
                TraceEvent(
                    "candidate",
                    f"{worker.name}: VALID (zone={worker.zone}, "
                    f"inflight={worker.inflight}/{worker.capacity_slots})",
                )
            )
            return controller.name, worker.name
        tr.append(
            TraceEvent("candidate", f"{worker.name}: invalid — {reason}")
        )
        return None

    def _c_ordered(self, items: Sequence, strategy: Strategy, fhash: int):
        """Order pre-compiled items; mirrors iter_ordered draw-for-draw.

        Random orderings are lazy (one draw per item actually tried), so
        the traced path, the interpreter, and the indexed fast path all
        consume identical RNG streams no matter where evaluation stops.
        """
        if strategy is Strategy.BEST_FIRST or not items:
            return items
        if strategy is Strategy.PLATFORM:
            order = coprime_order_cached(len(items), fhash)
            return (items[i] for i in order)
        if strategy is Strategy.WARM_FIRST:
            # Only reachable at tag level (blocks have no single warmth);
            # the validator rejects it there, so treat defensively as
            # best_first. Block/set warm-first is handled at call sites.
            return items
        return iter_random(items, self._rng)

    # ======================================================================
    # Interpreter (reference path; `TappEngine(compiled=False)`)
    # ======================================================================

    def _schedule_interpreted(
        self,
        invocation: Invocation,
        script: Optional[TappScript],
        cluster: ClusterState,
        trace: bool,
        entry_zone: Optional[str] = None,
    ) -> ScheduleDecision:
        decision = ScheduleDecision(outcome=Outcome.FAILED)
        tr = decision.trace if trace else None
        if script is None or not script.tags:
            if tr is not None:
                tr.append(
                    TraceEvent(
                        "tag", "no tAPP script: caller should use vanilla fallback"
                    )
                )
            return decision

        tag_name = invocation.tag or DEFAULT_TAG
        policy = script.get(tag_name)
        if policy is None:
            if tr is not None:
                tr.append(
                    TraceEvent(
                        "tag",
                        f"tag {tag_name!r} not in script; falling back to "
                        f"{DEFAULT_TAG!r}",
                    )
                )
            policy = script.default
            tag_name = DEFAULT_TAG
            if policy is None:
                if tr is not None:
                    tr.append(
                        TraceEvent("tag", "no default tag either: fail")
                    )
                decision.failed_by_policy = True
                return decision

        return self._evaluate_tag(
            invocation, policy, script, cluster, decision, tr,
            zone_override=entry_zone, entry_zone=entry_zone,
        )

    # -- tag evaluation -------------------------------------------------------

    def _evaluate_tag(
        self,
        invocation: Invocation,
        policy: TagPolicy,
        script: TappScript,
        cluster: ClusterState,
        decision: ScheduleDecision,
        tr: Optional[List[TraceEvent]],
        *,
        is_fallback: bool = False,
        zone_override: Optional[str] = None,
        entry_zone: Optional[str] = None,
    ) -> ScheduleDecision:
        decision.tag = policy.tag
        decision.used_default_fallback = is_fallback
        if tr is not None:
            tr.append(
                TraceEvent(
                    "tag",
                    f"evaluating tag {policy.tag!r} "
                    f"(strategy={policy.effective_strategy.value}, "
                    f"followup={policy.effective_followup.value})",
                )
            )

        blocks = iter_ordered(
            list(enumerate(policy.blocks)),
            policy.effective_strategy,
            rng=self._rng,
            function_hash=invocation.hash,
        )
        for block_index, block in blocks:
            placed = self._evaluate_block(
                invocation, block, block_index, cluster, decision, tr,
                zone_override=zone_override, entry_zone=entry_zone,
            )
            if placed is not None:
                controller, worker = placed
                decision.outcome = Outcome.SCHEDULED
                decision.controller = controller
                decision.worker = worker
                return decision

        # All blocks exhausted → followup.
        followup = policy.effective_followup
        if tr is not None:
            tr.append(
                TraceEvent(
                    "followup", f"tag {policy.tag!r} exhausted → {followup.value}"
                )
            )
        if followup is FollowupKind.DEFAULT and not is_fallback:
            # Paper §3.4 (followup × topology_tolerance interaction): when a
            # tag with `topology_tolerance: same` falls back to the default
            # tag, other controllers may manage the scheduling BUT execution
            # stays restricted to the designated controller's zone.
            sticky_zone = zone_override
            for block in policy.blocks:
                if (
                    block.controller is not None
                    and block.controller.topology_tolerance
                    is TopologyTolerance.SAME
                ):
                    designated = cluster.controllers.get(block.controller.label)
                    if designated is not None:
                        sticky_zone = designated.zone
                        if tr is not None:
                            tr.append(
                                TraceEvent(
                                    "followup",
                                    f"tolerance=same → default restricted to "
                                    f"zone {sticky_zone!r}",
                                )
                            )
                        break
            default_policy = script.default
            if default_policy is not None and default_policy.tag != policy.tag:
                return self._evaluate_tag(
                    invocation,
                    default_policy,
                    script,
                    cluster,
                    decision,
                    tr,
                    is_fallback=True,
                    zone_override=sticky_zone,
                    entry_zone=entry_zone,
                )
            if tr is not None:
                tr.append(
                    TraceEvent("followup", "no usable default tag: fail")
                )
            decision.failed_by_policy = True
        else:
            decision.failed_by_policy = True
        decision.outcome = Outcome.FAILED
        return decision

    # -- block evaluation ------------------------------------------------------

    def _evaluate_block(
        self,
        invocation: Invocation,
        block: Block,
        block_index: int,
        cluster: ClusterState,
        decision: ScheduleDecision,
        tr: Optional[List[TraceEvent]],
        *,
        zone_override: Optional[str] = None,
        entry_zone: Optional[str] = None,
    ) -> Optional[Tuple[str, str]]:
        if block.controller is None:
            # No controller clause: the gateway tries the available
            # controllers starting at the round-robin cursor. If one
            # controller's view has no valid worker, control returns to the
            # gateway, which passes the invocation to the next controller
            # (paper §5.4.1: the isolated policy "returns control to Nginx,
            # which passes the invocation to a different controller").
            # With an entry zone, only that zone's controllers take part
            # (mirrors the compiled path exactly — same lists, same cursor
            # arithmetic, same RNG consumption).
            if entry_zone is None:
                controllers = [
                    c for c in cluster.controllers.values() if c.available
                ]
            else:
                controllers = [
                    c for c in cluster.controllers.values()
                    if c.available and c.zone == entry_zone
                ]
            if not controllers:
                if tr is not None:
                    tr.append(
                        TraceEvent(
                            "controller",
                            f"block[{block_index}]: no available controller",
                        )
                    )
                return None
            start = self._controller_cursor
            self._controller_cursor += 1
            for offset in range(len(controllers)):
                controller = controllers[(start + offset) % len(controllers)]
                if tr is not None:
                    tr.append(
                        TraceEvent(
                            "controller",
                            f"block[{block_index}]: gateway → {controller.name!r}",
                        )
                    )
                placed = self._evaluate_block_on(
                    invocation, block, controller, zone_override, cluster, tr
                )
                if placed is not None:
                    # The scheduling block ran unrestricted (modulo any
                    # followup sticky zone) — record *its* constraint, not a
                    # stale value from an earlier failed block.
                    decision.zone_restriction = zone_override
                    return placed
            return None

        controller, zone_restriction, note = self._resolve_controller(
            block, cluster, entry_zone
        )
        if tr is not None:
            tr.append(TraceEvent("controller", f"block[{block_index}]: {note}"))
        if controller is None:
            return None
        zone_restriction = zone_restriction or zone_override
        decision.zone_restriction = zone_restriction
        return self._evaluate_block_on(
            invocation, block, controller, zone_restriction, cluster, tr
        )

    def _evaluate_block_on(
        self,
        invocation: Invocation,
        block: Block,
        controller: ControllerState,
        zone_restriction: Optional[str],
        cluster: ClusterState,
        tr: Optional[List[TraceEvent]],
    ) -> Optional[Tuple[str, str]]:
        views = distribution_view(
            cluster,
            controller.zone,
            self.distribution,
            controller_name=controller.name,
            zone_restriction=zone_restriction,
        )
        view_map: Dict[str, WorkerView] = {v.worker.name: v for v in views}

        candidates = self._expand_block_candidates(
            invocation, block, views, view_map
        )
        for worker, spec in candidates:
            view = view_map.get(worker.name)
            if view is None:
                if tr is not None:
                    tr.append(
                        TraceEvent(
                            "candidate",
                            f"{worker.name}: outside controller "
                            f"{controller.name!r}'s distribution view",
                        )
                    )
                continue
            reason = constraint_reason(worker, spec)
            if reason is None and view.saturated:
                reason = (
                    f"controller entitlement saturated "
                    f"({worker.inflight}/{view.slot_cap} slots)"
                )
            if reason is None:
                if tr is not None:
                    tr.append(
                        TraceEvent(
                            "candidate",
                            f"{worker.name}: VALID (zone={worker.zone}, "
                            f"inflight={worker.inflight}/{worker.capacity_slots})",
                        )
                    )
                return controller.name, worker.name
            if tr is not None:
                tr.append(
                    TraceEvent("candidate", f"{worker.name}: invalid — {reason}")
                )
        return None

    def _resolve_controller(
        self,
        block: Block,
        cluster: ClusterState,
        entry_zone: Optional[str] = None,
    ) -> Tuple[Optional[ControllerState], Optional[str], str]:
        """Return (controller, zone_restriction, trace note)."""
        if block.controller is None:
            ctl = self._round_robin_controller(cluster)
            if ctl is None:
                return None, None, "no available controller in deployment"
            return ctl, None, f"no controller clause → round-robin pick {ctl.name!r}"

        clause = block.controller
        assert clause is not None
        tol = clause.topology_tolerance
        designated = cluster.controllers.get(clause.label)
        if designated is not None and designated.available:
            # Mirrors the compiled path: federated entry evaluation pins
            # tolerance none/same candidates to the designated home zone.
            if entry_zone is not None and tol is not TopologyTolerance.ALL:
                return (
                    designated,
                    designated.zone,
                    f"designated controller {clause.label!r} available "
                    f"(tolerance={tol.value} → workers pinned to zone "
                    f"{designated.zone!r})",
                )
            return designated, None, f"designated controller {clause.label!r} available"

        # Designated controller missing/unavailable → topology_tolerance.
        designated_zone = designated.zone if designated is not None else None
        if tol is TopologyTolerance.NONE:
            return (
                None,
                None,
                f"controller {clause.label!r} unavailable, tolerance=none → block invalid",
            )
        alternative = self._round_robin_controller(cluster)
        if alternative is None:
            return None, None, "no alternative controller available"
        if tol is TopologyTolerance.SAME:
            if designated_zone is None:
                return (
                    None,
                    None,
                    f"controller {clause.label!r} unknown and tolerance=same → "
                    f"cannot resolve its zone, block invalid",
                )
            return (
                alternative,
                designated_zone,
                f"controller {clause.label!r} unavailable, tolerance=same → "
                f"{alternative.name!r} restricted to zone {designated_zone!r}",
            )
        return (
            alternative,
            None,
            f"controller {clause.label!r} unavailable, tolerance=all → "
            f"{alternative.name!r}",
        )

    def _round_robin_controller(
        self, cluster: ClusterState
    ) -> Optional[ControllerState]:
        controllers = [c for c in cluster.controllers.values() if c.available]
        if not controllers:
            return None
        ctl = controllers[self._controller_cursor % len(controllers)]
        self._controller_cursor += 1
        return ctl

    # -- candidate expansion ----------------------------------------------------

    def _expand_block_candidates(
        self,
        invocation: Invocation,
        block: Block,
        views: Sequence[WorkerView],
        view_map: Dict[str, WorkerView],
    ):
        """Yield (worker, resolved ConstraintSpec) in trial order.

        Orderings are consumed lazily (:func:`iter_ordered`): a random
        strategy draws one candidate at a time, so stopping at the first
        valid worker consumes exactly as many RNG draws as candidates
        tried — the contract the compiled paths mirror.
        """
        if not block.uses_sets:
            # Explicit wrk list: the block-level strategy orders the list.
            strategy = block.strategy or Strategy.BEST_FIRST
            if strategy is Strategy.WARM_FIRST:
                items = _warm_item_order(
                    list(block.workers), view_map, invocation.hash
                )
            else:
                items = iter_ordered(
                    list(block.workers),
                    strategy,
                    rng=self._rng,
                    function_hash=invocation.hash,
                )
            for item in items:
                assert isinstance(item, WorkerRef)
                view = view_map.get(item.label)
                if view is None:
                    # Unknown label ⇒ treated as unreachable: emit a stub so the
                    # trace shows why it was skipped.
                    ghost = WorkerState(name=item.label, reachable=False)
                    yield ghost, resolve_constraints(item, block)
                    continue
                yield view.worker, resolve_constraints(item, block)
            return

        # Set list: block-level strategy orders the *set items*; each set's
        # inner strategy orders its members. Distribution-view tiering
        # (local-first) is preserved within each set expansion.
        strategy = block.strategy or Strategy.BEST_FIRST
        if strategy is Strategy.WARM_FIRST:
            set_items = _interp_warm_set_order(
                list(block.workers), views, invocation.hash
            )
        else:
            set_items = iter_ordered(
                list(block.workers),
                strategy,
                rng=self._rng,
                function_hash=invocation.hash,
            )
        for item in set_items:
            assert isinstance(item, WorkerSet)
            members = [v for v in views if v.worker.in_set(item.label)]
            local = [v.worker for v in members if v.local]
            foreign = [v.worker for v in members if not v.local]
            inner = item.strategy or Strategy.PLATFORM  # the platform default
            spec = resolve_constraints(item, block)
            if inner is Strategy.WARM_FIRST:
                for worker in _warm_worker_order(local, invocation.hash):
                    yield worker, spec
                for worker in _warm_worker_order(foreign, invocation.hash):
                    yield worker, spec
                continue
            for worker in iter_ordered(
                local, inner, rng=self._rng, function_hash=invocation.hash
            ):
                yield worker, spec
            for worker in iter_ordered(
                foreign, inner, rng=self._rng, function_hash=invocation.hash
            ):
                yield worker, spec
