"""Reachability, satisfiability, and starvation analysis of compiled plans.

The analyzer evaluates a :class:`~repro_torch.core.tapp.compile.CompiledScript`
against a topology snapshot and proves, per (tag × entry zone), using only
facts that cannot change within a topology epoch:

* **reachability** — whether the tag's plan (its own blocks plus the
  ``followup: default`` chain) reaches at least one statically-valid
  worker, reporting blocks that are dead under every resolvable
  controller;
* **satisfiability** — contradictory constraint conjunctions detected per
  worker item (affinity ∧ anti-affinity over the same functions, admission
  limits of zero) and items whose ``BlockIndex`` static survivor set is
  empty;
* **starvation bounds** — per tag, the maximum number of concurrent
  admissions the statically-valid candidate set can absorb before every
  candidate saturates. The bound combines the per-item invalidate ceilings
  (``overload`` → capacity, ``max_concurrent_invocations`` → the limit,
  ``capacity_used`` → the smallest admission count that trips the runtime
  percentage signal) with the per-controller entitlement caps the
  distribution policy grants, so a bound of 0 is a *proof* that no
  sequence of admissions ever places the tag.

Federated deployments are analyzed per entry zone with the engine's
tolerance none/same pinning applied; a per-entry-zone verdict folds in the
zones the federation would forward to (:func:`forward_targets`), so
"unplaceable from zone Z" accounts for cross-zone forwarding and is never
a false alarm for a script that legitimately relies on it.

Everything here is *sound in one direction*: affinity residues are
dynamic (they depend on what is running where), so a non-contradictory
affinity clause never lowers a bound — bounds are upper bounds (flagged
``exact=False``) and a zero bound therefore remains a proof.

The analyzer reuses the scheduler's epoch-cached view entries and block
indexes (:func:`cached_view_entry` / :meth:`ItemIndex.static_survivors`),
so running it doubles as a prewarm of the exact structures the compiled
fast path consumes, and its survivor sets are — by construction — the
ones scheduling decisions will see.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.scheduler.gateway import forward_targets
from repro_torch.core.scheduler.state import ClusterState, ControllerState
from repro_torch.core.scheduler.strategy import Strategy
from repro_torch.core.scheduler.topology import DistributionPolicy, cached_view_entry
from repro_torch.core.tapp.ast import (
    CapacityUsed,
    FollowupKind,
    MaxConcurrentInvocations,
    Overload,
    TopologyTolerance,
)
from repro_torch.core.tapp.compile import CompiledBlock, CompiledScript, CompiledTag
from repro_torch.core.tapp.validate import Finding

__all__ = [
    "AnalysisReport",
    "BlockVerdict",
    "FederationView",
    "TagVerdict",
    "UNBOUNDED",
    "analyze_plan",
]

# Admission ceiling of a worker item whose static constraints impose no
# bound (e.g. capacity_used thresholds above 100%, which the runtime
# signal can never reach).
UNBOUNDED = math.inf


# ---------------------------------------------------------------------------
# Public result types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FederationView:
    """Forwarding context for per-entry-zone analysis.

    ``zone_order`` maps each entry zone to its latency-ordered forwarding
    candidates — the same table the federation router consults — so the
    analyzer can fold forward-target zones into each entry zone's verdict.
    """

    zone_order: Mapping[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class BlockVerdict:
    """Static verdict of one workers-block (within one entry-zone scan)."""

    tag: str
    index: int
    live: bool
    # Why the block is dead (None when live).
    reason: Optional[str]
    # Workers this block can select that also have a positive admission
    # ceiling in the owning tag's verdict.
    selectable: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class TagVerdict:
    """Static verdict of one tag evaluated from one entry zone."""

    tag: str
    entry_zone: Optional[str]
    # ≥1 statically-valid candidate somewhere in the chain (incl. forwards).
    reachable: bool
    # Some admission sequence can place the tag (starvation_bound > 0).
    placeable: bool
    # Max concurrent admissions the static candidate set can absorb.
    starvation_bound: int
    # False when an affinity/anti-affinity residue makes the bound an
    # upper bound rather than an exact saturation count.
    exact: bool
    # (worker, absorbable admissions) for every worker with a positive
    # ceiling, merged over the chain and forward targets.
    admissible: Tuple[Tuple[str, int], ...]
    # Per-block verdicts of the *local* (entry-zone) scan, own tag's
    # blocks plus the followup chain's.
    blocks: Tuple[BlockVerdict, ...]

    @property
    def selectable(self) -> Tuple[str, ...]:
        return tuple(name for name, _absorb in self.admissible)


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """Verdicts + findings of one analyzer run over one topology epoch."""

    verdicts: Tuple[TagVerdict, ...]
    findings: Tuple[Finding, ...]
    entry_zones: Tuple[Optional[str], ...]
    topology_epoch: int
    starvation_floor: int

    @property
    def proofs(self) -> Tuple[Finding, ...]:
        """Findings the analyzer *proved* (strict-mode deploy blockers)."""
        return tuple(f for f in self.findings if f.proof)

    @property
    def ok(self) -> bool:
        return not any(f.level == "error" for f in self.findings) and not self.proofs

    def tag(
        self, name: str, entry_zone: Optional[str] = None
    ) -> Optional[TagVerdict]:
        for v in self.verdicts:
            if v.tag == name and v.entry_zone == entry_zone:
                return v
        # Flat callers often pass the zone they are in even though the
        # analysis ran context-free; fall back to the tag's sole verdict.
        matches = [v for v in self.verdicts if v.tag == name]
        if len(matches) == 1:
            return matches[0]
        return None

    def selectable(
        self, name: str, entry_zone: Optional[str] = None
    ) -> Optional[frozenset]:
        """Workers some admission sequence can place ``name`` on, or None
        when the tag/zone was not analyzed (callers must not treat an
        un-analyzed tag as unplaceable)."""
        verdict = self.tag(name, entry_zone)
        if verdict is None:
            return None
        return frozenset(verdict.selectable)

    def summary(self) -> str:
        placeable = sum(1 for v in self.verdicts if v.placeable)
        return (
            f"analysis @epoch {self.topology_epoch}: "
            f"{placeable}/{len(self.verdicts)} tag×zone verdicts placeable, "
            f"{len(self.proofs)} unplaceability proofs, "
            f"{len(self.findings)} findings"
        )

    def verdict(self) -> str:
        """Human-readable report of every verdict and finding."""
        zones = [z if z is not None else "-" for z in self.entry_zones]
        lines = [
            f"policy analysis @epoch {self.topology_epoch} "
            f"(entry zones: {', '.join(zones)})"
        ]
        for v in self.verdicts:
            entry = "" if v.entry_zone is None else f" [entry={v.entry_zone}]"
            if v.placeable:
                kind = "bound" if v.exact else "bound ≤"
                detail = (
                    f"placeable, admission {kind} {v.starvation_bound} "
                    f"across {len(v.admissible)} worker(s)"
                )
            elif v.reachable:
                detail = (
                    "UNPLACEABLE — statically-valid candidates exist but "
                    "every admission ceiling is provably zero"
                )
            else:
                detail = "UNPLACEABLE — no statically-valid candidate"
            lines.append(f"  tag {v.tag!r}{entry}: {detail}")
            for b in v.blocks:
                owner = "" if b.tag == v.tag else f" (via tag {b.tag!r})"
                if b.live:
                    sel = ", ".join(b.selectable) if b.selectable else "-"
                    lines.append(
                        f"    block[{b.index}]{owner}: live, selectable: {sel}"
                    )
                else:
                    lines.append(
                        f"    block[{b.index}]{owner}: dead — {b.reason}"
                    )
        if self.findings:
            lines.append("findings:")
            lines.extend(f"  {f}" for f in self.findings)
        else:
            lines.append("no findings")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Admission ceilings (the satisfiability core)
# ---------------------------------------------------------------------------


def _capacity_used_ceiling(percent: float, slots: int) -> float:
    """Smallest admission count that trips the capacity_used signal.

    Mirrors the watcher's bookkeeping exactly: after ``k`` admissions on
    an otherwise idle worker, ``capacity_used_pct`` reads ``100*k/slots``
    while ``0 < k < slots`` and ``100.0`` otherwise, and the constraint
    invalidates at ``pct >= percent``.
    """
    if percent <= 0 or slots <= 0:
        return 0.0
    if percent > 100.0:
        return UNBOUNDED  # the signal caps at 100: threshold unreachable
    base = math.ceil(slots * percent / 100.0)
    for k in (base - 1, base, base + 1):
        if k < 1:
            continue
        if k >= slots:
            return float(slots)  # pct reads 100.0 ≥ percent
        if 100.0 * k / slots >= percent:
            return float(k)
    return float(slots)


def _invalidate_ceiling(condition, worker) -> float:
    """Admissions an idle worker absorbs before the condition invalidates."""
    if isinstance(condition, MaxConcurrentInvocations):
        return float(max(0, condition.limit))
    if isinstance(condition, CapacityUsed):
        return _capacity_used_ceiling(condition.percent, worker.capacity_slots)
    if isinstance(condition, Overload):
        return float(max(0, worker.capacity_slots))
    return UNBOUNDED  # unknown conditions: no static bound (stay sound)


def _spec_contradictions(spec) -> Tuple[str, ...]:
    """Why a constraint conjunction can never admit anything (if so)."""
    notes: List[str] = []
    aff = spec.affinity.functions if spec.affinity is not None else ()
    anti = spec.anti_affinity.functions if spec.anti_affinity is not None else ()
    overlap = sorted(set(aff) & set(anti))
    if overlap:
        shown = ", ".join(repr(f) for f in overlap)
        notes.append(
            f"affinity and anti-affinity both name {shown}: the item is "
            f"invalid whenever they run and starves them when they don't"
        )
    cond = spec.invalidate
    if isinstance(cond, MaxConcurrentInvocations) and cond.limit <= 0:
        notes.append(
            f"max_concurrent_invocations {cond.limit} admits nothing"
        )
    if isinstance(cond, CapacityUsed) and cond.percent <= 0:
        notes.append(f"capacity_used {cond.percent:g}% admits nothing")
    return tuple(notes)


# ---------------------------------------------------------------------------
# Per-(tag × entry zone) scans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ItemScan:
    tag: str
    block: int
    item: int
    contradictions: Tuple[str, ...]
    dynamic_affinity: bool
    survivors: frozenset  # statically-valid worker names
    positive: frozenset   # survivors with a positive admission ceiling


@dataclasses.dataclass
class _BlockScan:
    tag: str
    index: int
    live: bool
    reason: Optional[str]
    items: List[_ItemScan]
    survivors: frozenset


@dataclasses.dataclass
class _BlockEnt:
    """One chain block's admission resources, in evaluation order.

    The runtime consumes these *sequentially*: a later block only sees a
    worker after every earlier block went invalid for it, its inflight
    count carrying over (load signals are per worker, not per block) and
    its per-(controller, worker) entitlement ledger already drawn down.
    """

    ctls: Tuple[str, ...]
    # worker name -> [max dynamic ceiling over covering items,
    #                 {controller -> entitlement cap for this worker}]
    cover: Dict[str, list]


@dataclasses.dataclass
class _TagScan:
    entry_zone: Optional[str]
    # Chain blocks in evaluation order (the fold `_merge_bound` walks).
    entitlements: List[_BlockEnt]
    blocks: List[_BlockScan]
    exact: bool


def _chain(
    plan: CompiledScript, ctag: CompiledTag, cluster: ClusterState,
    entry_zone: Optional[str],
) -> List[Tuple[CompiledTag, Optional[str]]]:
    """The (tag, zone_override) evaluation chain the engine walks.

    The initial zone override *is* the entry zone; a ``followup: default``
    re-enters the default tag once, with the ``topology_tolerance: same``
    sticky-zone pinning applied (first sticky label present in the
    cluster wins, availability notwithstanding — engine semantics).
    """
    links = [(ctag, entry_zone)]
    if (
        ctag.followup is FollowupKind.DEFAULT
        and plan.default is not None
        and plan.default.tag != ctag.tag
    ):
        sticky = entry_zone
        for label in ctag.sticky_same_labels:
            designated = cluster.controllers.get(label)
            if designated is not None:
                sticky = designated.zone
                break
        links.append((plan.default, sticky))
    return links


def _block_contexts(
    cblock: CompiledBlock,
    cluster: ClusterState,
    zone_override: Optional[str],
    entry_zone: Optional[str],
) -> Tuple[List[Tuple[ControllerState, Optional[str]]], Optional[str]]:
    """Every (controller, zone restriction) the block may evaluate under.

    Mirrors ``TappEngine._c_block`` / ``_c_resolve_controller``, unioned
    over round-robin cursor states: the gateway cursor advances per
    decision, so over a request sequence every available alternative is
    eventually tried — the union is exactly the reachable context set.
    Returns ``([], reason)`` when the block is dead under every cursor.
    """
    clause = cblock.controller
    if clause is None:
        ctls = [c for c in cluster.controllers.values() if c.available]
        if entry_zone is not None:
            ctls = [c for c in ctls if c.zone == entry_zone]
        if not ctls:
            where = (
                f" in entry zone {entry_zone!r}"
                if entry_zone is not None
                else ""
            )
            return [], f"no available controller{where}"
        return [(c, zone_override) for c in ctls], None

    tol = clause.topology_tolerance
    designated = cluster.controllers.get(clause.label)
    if designated is not None and designated.available:
        if entry_zone is not None and tol is not TopologyTolerance.ALL:
            # Federated evaluation pins tolerance none/same candidates to
            # the designated controller's home zone.
            return [(designated, designated.zone)], None
        return [(designated, zone_override)], None

    if tol is TopologyTolerance.NONE:
        return [], (
            f"designated controller {clause.label!r} is unavailable and "
            f"tolerance=none forbids alternatives"
        )
    alternatives = [c for c in cluster.controllers.values() if c.available]
    if not alternatives:
        return [], (
            f"designated controller {clause.label!r} is unavailable and no "
            f"alternative controller is available"
        )
    if tol is TopologyTolerance.SAME:
        if designated is None:
            return [], (
                f"designated controller {clause.label!r} is unknown and "
                f"tolerance=same cannot resolve its zone"
            )
        return [(c, designated.zone) for c in alternatives], None
    return [(c, zone_override) for c in alternatives], None


def _scan_tag(
    plan: CompiledScript,
    ctag: CompiledTag,
    cluster: ClusterState,
    distribution: DistributionPolicy,
    entry_zone: Optional[str],
) -> _TagScan:
    """One entry zone's static scan of a tag's full evaluation chain."""
    entitlements: List[_BlockEnt] = []
    blocks: List[_BlockScan] = []
    exact = True
    for tag_c, zone_override in _chain(plan, ctag, cluster, entry_zone):
        if (
            len(tag_c.enumerated) > 1
            and tag_c.strategy is not Strategy.BEST_FIRST
        ):
            # The block-selection strategy may reorder blocks between
            # invocations; the fold assumes source order, so the bound
            # is an upper bound rather than an exact saturation count.
            exact = False
        for cblock in tag_c.blocks:
            contexts, dead = _block_contexts(
                cblock, cluster, zone_override, entry_zone
            )
            items = cblock.sets if cblock.uses_sets else cblock.wrks
            item_scans: List[_ItemScan] = []
            block_survivors: Set[str] = set()
            cover: Dict[str, list] = {}
            for j, item in enumerate(items):
                contradictions = _spec_contradictions(item.spec)
                dynamic_affinity = not contradictions and (
                    item.spec.affinity is not None
                    or item.spec.anti_affinity is not None
                )
                if dynamic_affinity:
                    # Affinity residues are load-dependent: ceilings stay
                    # upper bounds, never proofs of positive capacity.
                    exact = False
                survivors: Set[str] = set()
                positive: Set[str] = set()
                for ctl, restriction in contexts:
                    entry = cached_view_entry(
                        cluster,
                        ctl.zone,
                        distribution,
                        controller_name=ctl.name,
                        zone_restriction=restriction,
                    )
                    bindex = entry.block_index(cblock)
                    if cblock.uses_sets:
                        cands = bindex.sets[j].static_survivors()
                    else:
                        idx = bindex.wrk
                        # One shared index per wrk block: position == item.
                        if (idx.static_mask >> j) & 1:
                            cands = [(j, idx.workers[j], idx._sat_caps[j])]
                        else:
                            cands = []
                    for _pos, worker, sat_cap in cands:
                        survivors.add(worker.name)
                        ceiling = (
                            0.0
                            if contradictions
                            else _invalidate_ceiling(
                                item.spec.invalidate, worker
                            )
                        )
                        slot = cover.setdefault(worker.name, [0.0, {}])
                        if ceiling > slot[0]:
                            slot[0] = ceiling
                        if ceiling > 0.0 and sat_cap > 0:
                            ents = slot[1]
                            if sat_cap > ents.get(ctl.name, 0):
                                ents[ctl.name] = sat_cap
                            positive.add(worker.name)
                block_survivors |= survivors
                item_scans.append(
                    _ItemScan(
                        tag=tag_c.tag,
                        block=cblock.index,
                        item=j,
                        contradictions=contradictions,
                        dynamic_affinity=dynamic_affinity,
                        survivors=frozenset(survivors),
                        positive=frozenset(positive),
                    )
                )
            live = dead is None and bool(block_survivors)
            if dead is None and not live:
                dead = (
                    "no statically-valid candidate under any resolvable "
                    "controller"
                )
            blocks.append(
                _BlockScan(
                    tag=tag_c.tag,
                    index=cblock.index,
                    live=live,
                    reason=dead,
                    items=item_scans,
                    survivors=frozenset(block_survivors),
                )
            )
            if cover:
                entitlements.append(
                    _BlockEnt(
                        ctls=tuple(ctl.name for ctl, _r in contexts),
                        cover=cover,
                    )
                )
    return _TagScan(
        entry_zone=entry_zone,
        entitlements=entitlements,
        blocks=blocks,
        exact=exact,
    )


def _merge_bound(
    scans: Sequence[_TagScan],
) -> Tuple[int, Tuple[Tuple[str, int], ...], bool, bool]:
    """Fold scans into (bound, admissible workers, exact, reachable).

    ``scans`` arrive in evaluation order (the entry zone's local chain,
    then each forward target), and each scan's blocks are in chain
    order; the fold concatenates them and replays the runtime's
    sequential draw-down per worker: a block absorbs admissions while
    its dynamic ceiling exceeds the worker's carried-over inflight count
    AND one of its controllers has per-(controller, worker) entitlement
    left — the ledger is shared across blocks, so an earlier block's
    admissions spend the entitlements later blocks would use.

    When a multi-controller block precedes a block with a different-but-
    overlapping controller set, *which* controller each admission spends
    depends on the round-robin cursor; the fold then spends soonest-dying
    controllers first (an upper bound) and drops the ``exact`` flag. A
    zero bound is order-robust either way: if no block can absorb the
    first admission, no spending order can, so unplaceability proofs
    hold regardless.

    Saturation is order-independent *across workers* (ceilings and
    entitlements are per worker — affinity, the one cross-worker
    coupling, already clears ``exact``), so the tag bound is the plain
    per-worker sum.
    """
    exact = all(scan.exact for scan in scans)
    blocks: List[_BlockEnt] = [
        ent for scan in scans for ent in scan.entitlements
    ]
    for i, ent in enumerate(blocks):
        if len(set(ent.ctls)) <= 1:
            continue
        here = set(ent.ctls)
        for later in blocks[i + 1:]:
            there = set(later.ctls)
            if here & there and here != there:
                exact = False
    # Last fold position each controller is usable at, for the
    # spend-soonest-dying-first allocation.
    last_use: Dict[str, int] = {}
    for i, ent in enumerate(blocks):
        for ctl in ent.ctls:
            last_use[ctl] = i
    workers = sorted({w for ent in blocks for w in ent.cover})
    admissible: List[Tuple[str, int]] = []
    total = 0
    for name in workers:
        absorbed = 0
        spent: Dict[str, int] = {}
        for ent in blocks:
            slot = ent.cover.get(name)
            if slot is None:
                continue
            ceiling, caps = slot
            room = ceiling - absorbed
            if room <= 0:
                continue
            for ctl in sorted(caps, key=lambda c: last_use[c]):
                spare = caps[ctl] - spent.get(ctl, 0)
                if spare <= 0:
                    continue
                take = spare if room == UNBOUNDED else int(min(spare, room))
                if take <= 0:
                    continue
                spent[ctl] = spent.get(ctl, 0) + take
                absorbed += take
                room -= take
                if room <= 0:
                    break
        if absorbed > 0:
            admissible.append((name, absorbed))
            total += absorbed
    return total, tuple(admissible), exact, bool(workers)


# ---------------------------------------------------------------------------
# The analyzer entry point
# ---------------------------------------------------------------------------


def analyze_plan(
    plan: CompiledScript,
    cluster: ClusterState,
    distribution: DistributionPolicy,
    *,
    entry_zones: Sequence[Optional[str]] = (None,),
    starvation_floor: int = 1,
    federation: Optional[FederationView] = None,
    tags: Optional[Sequence[str]] = None,
) -> AnalysisReport:
    """Statically verify a compiled plan against a topology snapshot.

    ``entry_zones`` is ``(None,)`` for a flat platform (context-free
    evaluation) or the federation's zone names; with a ``federation``
    view, each entry zone's verdict folds in its forward-target zones so
    proofs hold under the full routing pipeline. ``starvation_floor``
    flags tags whose (positive) admission bound is below it.
    """
    zone_list: Tuple[Optional[str], ...] = tuple(entry_zones) or (None,)
    if tags is None:
        names = list(plan.tags)
    else:
        names = [t for t in tags if t in plan.tags]
    known_zones = {z for z in zone_list if z is not None}
    scans: Dict[Tuple[str, Optional[str]], _TagScan] = {}

    def scan_of(tag_name: str, zone: Optional[str]) -> _TagScan:
        key = (tag_name, zone)
        hit = scans.get(key)
        if hit is None:
            hit = scans[key] = _scan_tag(
                plan, plan.tags[tag_name], cluster, distribution, zone
            )
        return hit

    verdicts: List[TagVerdict] = []
    findings: List[Finding] = []
    seen_findings: Set[Tuple[str, str, str]] = set()

    def emit(
        level: str, where: str, message: str, category: str, proof: bool = False
    ) -> None:
        key = (where, message, category)
        if key in seen_findings:
            return
        seen_findings.add(key)
        findings.append(
            Finding(level, where, message, category=category, proof=proof)
        )

    for tag_name in names:
        local_scans: List[_TagScan] = []
        for zone in zone_list:
            scan = scan_of(tag_name, zone)
            local_scans.append(scan)
            group = [scan]
            if federation is not None and zone is not None:
                order = tuple(federation.zone_order.get(zone, ()))
                for target in forward_targets(
                    plan.source, tag_name, cluster, zone, order
                ):
                    if target in known_zones and target != zone:
                        group.append(scan_of(tag_name, target))
            total, admissible, exact, reachable = _merge_bound(group)
            selectable = {name for name, _absorb in admissible}
            verdicts.append(
                TagVerdict(
                    tag=tag_name,
                    entry_zone=zone,
                    reachable=reachable,
                    placeable=total > 0,
                    starvation_bound=total,
                    exact=exact,
                    admissible=admissible,
                    blocks=tuple(
                        BlockVerdict(
                            tag=b.tag,
                            index=b.index,
                            live=b.live,
                            reason=b.reason,
                            selectable=tuple(
                                sorted(b.survivors & selectable)
                            ),
                        )
                        for b in scan.blocks
                    ),
                )
            )
            where = f"tag:{tag_name}"
            entry = "" if zone is None else f" from entry zone {zone!r}"
            if total == 0:
                if reachable:
                    why = (
                        "statically-valid candidates exist but every "
                        "admission ceiling is provably zero"
                    )
                else:
                    why = "no block reaches a statically-valid worker"
                emit(
                    "warning",
                    where,
                    f"statically unplaceable{entry}: {why}; every request "
                    f"will be rejected by policy",
                    "reachability",
                    proof=True,
                )
            elif total < starvation_floor:
                kind = "" if exact else " (upper bound)"
                emit(
                    "warning",
                    where,
                    f"admission bound {total}{kind}{entry} is below the "
                    f"declared starvation floor {starvation_floor}",
                    "starvation",
                )

        # Block/item findings describe the *plan*, so they fire only when
        # the defect holds from every analyzed entry zone, and only for
        # the tag's own blocks (the followup chain's blocks are reported
        # under their owning tag).
        own_indexes = {
            b.index for b in local_scans[0].blocks if b.tag == tag_name
        }
        for bi in sorted(own_indexes):
            per_zone = [
                next(b for b in s.blocks if b.tag == tag_name and b.index == bi)
                for s in local_scans
            ]
            bwhere = f"tag:{tag_name}.block[{bi}]"
            if all(not b.live for b in per_zone):
                emit(
                    "warning",
                    bwhere,
                    f"statically dead: {per_zone[0].reason}",
                    "reachability",
                )
                block_dead = True
            else:
                block_dead = False
            for j in range(len(per_zone[0].items)):
                zone_items = [b.items[j] for b in per_zone]
                item = zone_items[0]
                iwhere = f"{bwhere}.workers[{j}]"
                if item.contradictions:
                    emit(
                        "warning",
                        iwhere,
                        "constraint conjunction is unsatisfiable: "
                        + "; ".join(item.contradictions),
                        "satisfiability",
                    )
                    continue
                if block_dead:
                    continue  # the block-level finding already covers it
                if all(not i.survivors for i in zone_items):
                    emit(
                        "warning",
                        iwhere,
                        "empty static survivor set: no worker can ever "
                        "match this item",
                        "satisfiability",
                    )
                elif all(not i.positive for i in zone_items):
                    emit(
                        "warning",
                        iwhere,
                        "every statically-valid candidate of this item has "
                        "a zero admission ceiling",
                        "satisfiability",
                    )

    return AnalysisReport(
        verdicts=tuple(verdicts),
        findings=tuple(findings),
        entry_zones=zone_list,
        topology_epoch=cluster.topology_epoch,
        starvation_floor=starvation_floor,
    )
