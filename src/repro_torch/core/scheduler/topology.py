"""Topology-based worker distribution policies (paper §4.4).

At deployment time, DevOps pick the access policy all controllers follow
when reaching for workers inside/outside their zone:

* ``default``   — every controller may use every worker, but each worker's
  capacity is *split* evenly among controllers (the original OpenWhisk
  resource model), with co-located workers prioritised (our extension's
  behaviour in §5.4.1).
* ``min_memory`` — foreign controllers get only a *minimal fraction* of a
  worker's resources (one invocation slot, OpenWhisk's 256MB analogue).
  Workers whose zone hosts no controller fall back to ``default`` splitting.
* ``isolated``  — controllers may only use co-located workers.
* ``shared``    — co-located workers first at full capacity; foreign
  workers only after the local ones are exhausted.

The policy is expressed as a *view*: the ordered list of workers a
controller may consider, each with the effective slot capacity that
controller may occupy. The scheduling engine evaluates tAPP policies
against this view, so distribution policies compose with every strategy
and invalidate condition.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.state import ClusterState, WorkerState
from repro_torch.core.scheduler.strategy import coprime_order_cached, randbelow


class DistributionPolicy(enum.Enum):
    DEFAULT = "default"
    MIN_MEMORY = "min_memory"
    ISOLATED = "isolated"
    SHARED = "shared"

    @classmethod
    def parse(cls, text: str) -> "DistributionPolicy":
        try:
            return cls(text.strip())
        except ValueError:
            raise ValueError(
                f"unknown distribution policy {text!r}; expected one of "
                f"{[p.value for p in cls]}"
            ) from None


@dataclasses.dataclass(frozen=True)
class WorkerView:
    """A controller's entitlement on one worker under a distribution policy.

    ``slot_cap`` bounds how many of the worker's concurrent slots this
    controller may occupy. ``tier`` orders candidates: tier 0 (local) is
    always tried before tier 1 (foreign); ``shared`` additionally requires
    tier-0 exhaustion before tier 1 becomes eligible, which is exactly the
    invalidation cascade, so the engine needs no special case.
    """

    worker: WorkerState
    local: bool
    slot_cap: int
    controller: str = ""

    @property
    def tier(self) -> int:
        return 0 if self.local else 1

    @property
    def saturated(self) -> bool:
        """This controller's entitlement on the worker is used up.

        The entitlement is consumed by *this controller's* admissions (the
        paper's per-controller resource reservation); global load is handled
        separately by the tAPP invalidate conditions.
        """
        own = self.worker.inflight_for(self.controller)
        return own >= min(self.slot_cap, self.worker.capacity_slots)


def distribution_view(
    cluster: ClusterState,
    controller_zone: str,
    policy: DistributionPolicy,
    *,
    controller_name: str = "",
    zone_restriction: Optional[str] = None,
) -> List[WorkerView]:
    """The ordered worker view of a controller in ``controller_zone``.

    ``zone_restriction`` implements ``topology_tolerance: same``: when set,
    only workers of that zone are visible regardless of the distribution
    policy tiering (the tolerance is a *function*-level constraint and takes
    precedence over deployment-level resource sharing).
    """
    n_controllers = max(1, len(cluster.controllers))
    views: List[WorkerView] = []
    if zone_restriction is not None:
        # Zone-restricted views scan only that zone's members (same
        # insertion order as filtering the full worker dict), so a
        # zone-local rebuild costs O(zone workers), not O(cluster).
        source = cluster.workers_by_zone(zone_restriction)
    else:
        source = cluster.workers.values()
    for worker in source:
        if zone_restriction is not None and worker.zone != zone_restriction:
            continue
        local = worker.zone == controller_zone
        view = _entitlement(cluster, worker, local, policy, n_controllers)
        if view is not None:
            views.append(
                WorkerView(
                    worker=view.worker,
                    local=view.local,
                    slot_cap=view.slot_cap,
                    controller=controller_name,
                )
            )
    # Stable order: local tier first, then foreign; within a tier, workers
    # the failure detector marks SUSPECT sort after healthy peers (they
    # stay placeable — last resort, not excluded); preserve insertion
    # order otherwise so best_first means "order of appearance"
    # deterministically. SUSPECT transitions are structural (epoch bump),
    # so the cached view's order is always current, and the sort is
    # stable, so a suspect-free cluster orders bit-identically to before.
    views.sort(key=lambda v: (v.tier, v.worker.suspect))
    return views


def _entitlement(
    cluster: ClusterState,
    worker: WorkerState,
    local: bool,
    policy: DistributionPolicy,
    n_controllers: int,
) -> Optional[WorkerView]:
    cap = worker.capacity_slots
    if policy is DistributionPolicy.DEFAULT:
        # Capacity split evenly among all controllers (racing access).
        split = max(1, cap // n_controllers)
        return WorkerView(worker=worker, local=local, slot_cap=split)
    if policy is DistributionPolicy.MIN_MEMORY:
        if local:
            return WorkerView(worker=worker, local=True, slot_cap=cap)
        # Foreign controllers: minimal fraction (one invocation slot). When
        # the worker's zone hosts no controller at all, fall back to the
        # default splitting (paper §4.4).
        if not cluster.controllers_in_zone(worker.zone):
            split = max(1, cap // n_controllers)
            return WorkerView(worker=worker, local=False, slot_cap=split)
        return WorkerView(worker=worker, local=False, slot_cap=1)
    if policy is DistributionPolicy.ISOLATED:
        if local:
            return WorkerView(worker=worker, local=True, slot_cap=cap)
        return None
    if policy is DistributionPolicy.SHARED:
        # Full capacity everywhere; tier ordering enforces local-first and
        # foreign workers are only reached after locals invalidate.
        return WorkerView(worker=worker, local=local, slot_cap=cap)
    raise ValueError(f"unknown distribution policy {policy!r}")


def views_by_name(views: Sequence[WorkerView]) -> Dict[str, WorkerView]:
    return {v.worker.name: v for v in views}


# ---------------------------------------------------------------------------
# Epoch-cached views (the compiled fast path)
# ---------------------------------------------------------------------------


class ViewCacheEntry:
    """A memoized distribution view plus derived lookup structures.

    The entry holds *live* :class:`WorkerState` references, so volatile
    load signals (inflight, capacity_used_pct) are always fresh; only the
    view's *shape* — membership, zoning, tiering, slot caps — is frozen,
    which is exactly what ``ClusterState.topology_epoch`` versions.
    Health/reachability are also read live (the invalidate predicates see
    them through the worker reference), though the watcher conservatively
    bumps the epoch on those transitions as well.
    Set-member expansions are resolved lazily per set label and retain the
    view's local-tier-first candidate order.
    """

    __slots__ = ("views", "by_name", "_set_members", "_block_indexes")

    def __init__(self, views: List[WorkerView]) -> None:
        self.views = views
        self.by_name: Dict[str, WorkerView] = {v.worker.name: v for v in views}
        self._set_members: Dict = {}
        self._block_indexes: Dict = {}

    def set_members(self, label):
        """(local views, foreign views) matching a tAPP set label."""
        hit = self._set_members.get(label)
        if hit is None:
            members = [v for v in self.views if v.worker.in_set(label)]
            hit = (
                [v for v in members if v.local],
                [v for v in members if not v.local],
            )
            self._set_members[label] = hit
        return hit

    def block_index(self, cblock) -> "BlockIndex":
        """The candidate index of one compiled block under this view.

        Built once per (view entry × compiled block) — i.e. at
        ``topology_epoch`` granularity, since entries die with the epoch —
        and keyed by block identity (compiled blocks are identity-hashed).
        """
        hit = self._block_indexes.get(cblock)
        if hit is None:
            hit = BlockIndex(self, cblock)
            self._block_indexes[cblock] = hit
        return hit


# ---------------------------------------------------------------------------
# Candidate indexes (the O(1)-per-decision layer)
# ---------------------------------------------------------------------------
#
# A BlockIndex materializes, per (view entry × compiled block), everything
# about candidate selection that is *epoch-static*: which workers are in
# play at all (view membership, set membership, zone restriction,
# reachability/health — the static half of the constraint split), and the
# orders the strategies try them in (best_first = canonical position
# order; platform = co-prime orders materialized per function hash).
# On top sits one *availability bitmask* per worker item: bit i is set
# iff candidate i currently passes its item's dynamic constraint residue
# AND the controller's entitlement on it is unsaturated. The mask is
# maintained incrementally — the admission ledger logs each touched
# worker on ClusterState.note_worker_load, and refresh() re-derives only
# that worker's bits — so a scheduling decision is "first set bit in
# precomputed order" and a fully saturated cluster answers in O(1)
# without rescanning a single invalid candidate.

_CHUNK = 64  # platform-order chunk width (one int AND skips 64 candidates)
# Per-index bound on materialized platform orders (one per distinct
# function hash). A FaaS population can have unbounded function
# cardinality within one topology epoch; past the cap the dict is
# cleared and orders re-materialize on demand (they are pure functions
# of (index shape, fhash), so eviction never affects decisions).
_PLATFORM_ORDER_CACHE = 512


def _draw_first_avail(arr: List[int], avail: int, rng) -> Optional[int]:
    """First available position of one tier in lazy-Fisher–Yates order.

    Draw-for-draw identical to iterating
    :func:`~repro_torch.core.scheduler.strategy.iter_random` over the tier and
    rejecting unavailable candidates — which is exactly what the
    interpreter and the traced compiled path do — so RNG streams stay in
    lockstep across all evaluation paths. ``arr`` is the index's reusable
    scratch permutation; the swap trail is undone before returning, so
    the scratch stays canonical without an O(n) copy per decision.
    """
    n = len(arr)
    if n == 0:
        return None
    getrandbits = rng.getrandbits
    found: Optional[int] = None
    swaps: List[Tuple[int, int]] = []
    for i in range(n - 1, 0, -1):
        j = randbelow(getrandbits, i + 1)
        if j != i:
            arr[i], arr[j] = arr[j], arr[i]
            swaps.append((i, j))
        p = arr[i]
        if (avail >> p) & 1:
            found = p
            break
    else:
        p = arr[0]
        if (avail >> p) & 1:
            found = p
    for i, j in reversed(swaps):
        arr[i], arr[j] = arr[j], arr[i]
    return found


# Monotonic ItemIndex serial source; itertools.count.__next__ is atomic
# in CPython, so concurrent index builds never share a serial.
_ITEM_INDEX_SERIAL = itertools.count()


class ItemIndex:
    """Pre-filtered, pre-ordered candidates of one worker item.

    Positions are canonical trial order: for a ``wrk`` list, the item
    positions in block source order; for a ``set`` item, the view's
    members local tier first (insertion order within a tier) — so
    ``best_first`` is literally "lowest set bit of the availability
    mask". Statically-invalid candidates (ghost labels, unreachable or
    — for ``overload`` — unhealthy workers) are excluded from
    ``static_mask`` at build time and can never turn available within
    the epoch.
    """

    __slots__ = (
        "serial",
        "workers",
        "views",
        "dyns",
        "n",
        "n_local",
        "static_mask",
        "avail",
        "_static_positions",
        "_by_worker",
        "_zones",
        "_synced",
        "_synced_total",
        "_platform_chunks",
        "_scratch_local",
        "_scratch_foreign",
        "_sat_ctls",
        "_sat_caps",
        "_replay_limit",
        "_bits",
        "_single_zone",
        "_warm_masks",
        "_warm_synced",
        "_warm_positions",
        "_warm_by_worker",
        "local_mask",
    )

    def __init__(self, candidates, n_local: int) -> None:
        # candidates: sequence of (worker|None, view|None, static_fn, dyn_fn)
        # Process-unique monotonic id: external caches (the batch
        # router's mask planes) key on it instead of id(self), which a
        # later index could legally re-use after this one is collected.
        self.serial = next(_ITEM_INDEX_SERIAL)
        self.n = len(candidates)
        self.n_local = n_local
        # Local-tier bit mask (wrk lists are untiered: every position is
        # "local"); the warm-first pick partitions within each tier.
        self.local_mask = (1 << n_local) - 1
        self.workers = [c[0] for c in candidates]
        self.views = [c[1] for c in candidates]
        self.dyns = [c[3] for c in candidates]
        # Flattened WorkerView.saturated inputs: the controller key into
        # worker.inflight_by and min(slot_cap, capacity_slots). Both are
        # epoch-static (capacity changes are structural → the entry, and
        # this index with it, dies at the epoch bump), so the per-event
        # bit re-derivation pays one dict.get instead of two property
        # calls through the view.
        self._sat_ctls = [
            v.controller if v is not None else "" for v in self.views
        ]
        self._sat_caps = [
            min(v.slot_cap, v.worker.capacity_slots) if v is not None else 0
            for v in self.views
        ]
        static_mask = 0
        static_positions: List[int] = []
        by_worker: Dict[str, List[int]] = {}
        zones: List[str] = []
        for pos, (worker, _view, static_fn, _dyn) in enumerate(candidates):
            if worker is None or static_fn(worker):
                continue
            static_mask |= 1 << pos
            static_positions.append(pos)
            by_worker.setdefault(worker.name, []).append(pos)
            if worker.zone not in zones:
                zones.append(worker.zone)
        self.static_mask = static_mask
        self._static_positions = static_positions
        self._by_worker = {k: tuple(v) for k, v in by_worker.items()}
        # Replay cutoff: more pending events than candidate workers makes
        # a full recompute cheaper than replay (precomputed — refresh
        # runs once per decision).
        self._replay_limit = max(1, len(self._by_worker))
        # Per-position bit masks: at 1024 candidates the avail mask is a
        # 1024-bit int, so `1 << pos` and the read-modify-write both
        # allocate. Precomputing the masks and skipping the write when
        # the bit already has the right value keeps the per-event
        # re-derivation flat in candidate count (bits rarely flip).
        self._bits = [1 << pos for pos in range(self.n)]
        # Load-log shards this index's candidates span; refresh replays
        # only these, so foreign-zone churn never costs a replayed event.
        self._zones: Tuple[str, ...] = tuple(zones)
        self._single_zone = len(zones) == 1
        # Dynamic bits are computed on the first refresh (an index is
        # built for a whole block at once, but an item may first be
        # *reached* many decisions — and many ledger events — later).
        # Cursor: the zone shard's seq (single-zone index) or the merged
        # journal's seq (multi-zone); None until the first refresh.
        self._synced = None
        self._synced_total = -1
        self._platform_chunks: Dict[int, Tuple] = {}
        self._scratch_local: Optional[List[int]] = None
        self._scratch_foreign: Optional[List[int]] = None
        self.avail = 0
        # Warm bitmasks, one per function hash, over ALL non-None
        # positions (not just static survivors): the interpreter's
        # warm-first partition orders the raw candidate list before
        # validity is tried, so the mask must agree on every position.
        # Extra bits are harmless to picks (they AND with avail).
        # Maintained incrementally against the cluster's warm journal.
        self._warm_masks: Dict[int, int] = {}
        self._warm_synced = 0
        warm_positions = [
            pos for pos, c in enumerate(candidates) if c[0] is not None
        ]
        self._warm_positions = warm_positions
        warm_by: Dict[str, List[int]] = {}
        for pos in warm_positions:
            warm_by.setdefault(self.workers[pos].name, []).append(pos)
        self._warm_by_worker = {k: tuple(v) for k, v in warm_by.items()}

    def static_survivors(self):
        """``(position, worker, saturation cap)`` of every static survivor.

        The saturation cap is ``min(view.slot_cap, capacity_slots)`` — the
        exact per-controller entitlement the availability mask saturates
        against — so static analyzers can bound admissions without
        re-deriving the distribution policy. Read-only view over
        epoch-static state; never triggers a dynamic refresh.
        """
        workers = self.workers
        caps = self._sat_caps
        return [(pos, workers[pos], caps[pos]) for pos in self._static_positions]

    # -- availability maintenance ------------------------------------------

    def _recompute(self, positions) -> None:
        avail = self.avail
        workers = self.workers
        dyns = self.dyns
        ctls = self._sat_ctls
        caps = self._sat_caps
        bits = self._bits
        for pos in positions:
            worker = workers[pos]
            bit = bits[pos]
            if (
                dyns[pos](worker)
                or worker.inflight_by.get(ctls[pos], 0) >= caps[pos]
            ):
                if avail & bit:
                    avail &= ~bit
            elif not avail & bit:
                avail |= bit
        self.avail = avail

    def refresh(self, cluster: ClusterState) -> int:
        """Bring the availability mask up to date with the load log.

        O(events since last refresh): a single-zone index replays its
        zone's shard (foreign churn costs it nothing), a multi-zone
        index replays the cluster's merged journal (never an O(zones)
        shard-cursor scan). Replayed events are deduplicated per touched
        worker before any bit re-derivation — a churn window that
        hammers one worker costs one ``_recompute``, not one per event.
        A decision on an otherwise idle index is a single integer
        comparison.
        """
        total = cluster._load_total
        if total == self._synced_total:
            return self.avail
        if self._single_zone:
            zone = self._zones[0]
            shard = cluster.load_shards.get(zone)
            # Capture trimmed before log (writers advance trimmed, then
            # swap in a fresh list): a torn read across a concurrent
            # compaction can only look over-trimmed, which lands on the
            # full-recompute branch instead of replaying a wrong window.
            if shard is not None:
                trimmed = shard.trimmed
                log = shard.log
                seq = trimmed + len(log)
            else:
                trimmed = seq = 0
                log = ()
            synced = self._synced
            if synced is None:
                # First use: derive all dynamic bits from live state.
                self._recompute(self._static_positions)
            elif seq != synced:
                if (
                    shard is None
                    or synced < trimmed
                    or seq - synced >= self._replay_limit
                ):
                    # Compacted past our cursor, or more events than
                    # candidates: a full recompute is cheaper than replay.
                    self._recompute(self._static_positions)
                else:
                    self._replay_window(log, synced - trimmed)
            self._synced = seq
            self._synced_total = total
            return self.avail
        # Multi-zone candidates: replay the cluster's merged journal
        # (all zones interleaved, seq == _load_total) from our last
        # synced total — O(events since last sync) regardless of how
        # many zones exist. Foreign-worker names simply miss in
        # _by_worker. Scanning per-zone shards here instead would cost
        # O(zones) cursor checks per decision even on an idle cluster.
        if self._synced is None:
            self._recompute(self._static_positions)
            self._synced = total
            self._synced_total = total
            return self.avail
        journal = cluster._load_journal
        old = self._synced_total
        # Same trimmed-then-log capture order as the single-zone path:
        # racing a journal compaction degrades to a recompute, never a
        # mis-sliced replay window.
        trimmed = journal.trimmed
        log = journal.log
        if old < trimmed or total - old >= self._replay_limit:
            # Compacted past our cursor, or more events than candidates:
            # a full recompute is cheaper than replay.
            self._recompute(self._static_positions)
        else:
            self._replay_window(log, old - trimmed)
        self._synced_total = total
        return self.avail

    def _replay_window(self, log: List[str], start: int) -> None:
        by = self._by_worker
        end = len(log)
        if end - start <= 4:
            # Tiny window — the admission ledger's admit/complete pairs
            # put the same name in consecutive events, so a running
            # last-name check dedups without allocating a slice + set,
            # and the bit re-derivation is inlined (this path runs once
            # per churned decision; the _recompute call chain is
            # measurable at that rate).
            workers = self.workers
            dyns = self.dyns
            ctls = self._sat_ctls
            caps = self._sat_caps
            bits = self._bits
            avail = self.avail
            prev = None
            for i in range(start, end):
                name = log[i]
                if name != prev:
                    prev = name
                    positions = by.get(name)
                    if positions is not None:
                        for pos in positions:
                            worker = workers[pos]
                            bit = bits[pos]
                            if (
                                dyns[pos](worker)
                                or worker.inflight_by.get(ctls[pos], 0)
                                >= caps[pos]
                            ):
                                if avail & bit:
                                    avail &= ~bit
                            elif not avail & bit:
                                avail |= bit
            self.avail = avail
            return
        # Satellite: dedup the window before re-deriving bits — each
        # distinct touched worker costs one _recompute regardless of how
        # many ledger events it produced.
        for name in set(log[start:]):
            positions = by.get(name)
            if positions is not None:
                self._recompute(positions)

    # -- strategy picks -----------------------------------------------------

    def pick_platform(self, avail: int, fhash: int) -> Optional[int]:
        """First available position in co-prime order, chunk-skipped."""
        chunks = self._platform_chunks.get(fhash)
        if chunks is None:
            chunks = self._build_platform_chunks(fhash)
        for mask, seg in chunks:
            if not (avail & mask):
                continue
            for p in seg:
                if (avail >> p) & 1:
                    return p
        return None

    def _build_platform_chunks(self, fhash: int) -> Tuple:
        """Materialize the per-tier co-prime order over static survivors.

        The permutation is taken over the *full* tier length (the
        interpreter hashes into the unfiltered candidate list) and then
        filtered, so survivor order matches the reference exactly.
        """
        n_local = self.n_local
        n_foreign = self.n - n_local
        smask = self.static_mask
        order = [
            p for p in coprime_order_cached(n_local, fhash) if (smask >> p) & 1
        ]
        order.extend(
            n_local + p
            for p in coprime_order_cached(n_foreign, fhash)
            if (smask >> (n_local + p)) & 1
        )
        chunks = []
        for k in range(0, len(order), _CHUNK):
            seg = tuple(order[k:k + _CHUNK])
            mask = 0
            for p in seg:
                mask |= 1 << p
            chunks.append((mask, seg))
        result = tuple(chunks)
        if len(self._platform_chunks) >= _PLATFORM_ORDER_CACHE:
            self._platform_chunks.clear()
        self._platform_chunks[fhash] = result
        return result

    def pick_random(self, avail: int, rng) -> Optional[int]:
        """First available position in lazy random order, local tier first.

        Consumes RNG draws even when ``avail`` is empty — the reference
        paths draw through the whole tier before moving on, and the
        streams must stay identical.
        """
        local = self._scratch_local
        if local is None:
            local = self._scratch_local = list(range(self.n_local))
            self._scratch_foreign = list(range(self.n_local, self.n))
        pos = _draw_first_avail(local, avail, rng)
        if pos is None:
            pos = _draw_first_avail(self._scratch_foreign, avail, rng)
        return pos

    # -- warm bitmasks (warm-first strategy) --------------------------------

    def _warm_recompute(self, fhash: int) -> int:
        """Derive one function's warm mask from live worker pool counts."""
        mask = 0
        workers = self.workers
        bits = self._bits
        for pos in self._warm_positions:
            if workers[pos].warm_idle.get(fhash, 0) > 0:
                mask |= bits[pos]
        self._warm_masks[fhash] = mask
        return mask

    def _warm_replay(self, log, start: int) -> None:
        by = self._warm_by_worker
        masks = self._warm_masks
        workers = self.workers
        bits = self._bits
        for i in range(start, len(log)):
            name, fh = log[i]
            cur = masks.get(fh)
            if cur is None:
                # Untracked function: its mask is fully recomputed on
                # first request, so the event needs no replay.
                continue
            positions = by.get(name)
            if positions is None:
                continue
            for pos in positions:
                if workers[pos].warm_idle.get(fh, 0) > 0:
                    cur |= bits[pos]
                else:
                    cur &= ~bits[pos]
            masks[fh] = cur

    def warm_mask(self, cluster: ClusterState, fhash: int) -> int:
        """Bit i set iff candidate i holds an IDLE warm instance of
        ``fhash``'s function.

        Incremental like :meth:`refresh`: replays the cluster's merged
        warm journal (``(name, fhash)`` events, emitted only on 0<->1
        pool-count flips) from the last synced cursor; over-trimmed or
        oversized windows fall back to a per-tracked-function recompute.
        With no lifecycle armed the journal never moves and every mask
        is the cached 0 — one dict hit per decision.
        """
        total = cluster._warm_total
        masks = self._warm_masks
        if total != self._warm_synced:
            journal = cluster._warm_journal
            # Same trimmed-then-log capture order as refresh(): a torn
            # read across compaction looks over-trimmed and recomputes.
            trimmed = journal.trimmed
            log = journal.log
            synced = self._warm_synced
            if masks:
                if synced < trimmed or total - synced >= self._replay_limit:
                    for fh in list(masks):
                        self._warm_recompute(fh)
                else:
                    self._warm_replay(log, synced - trimmed)
            self._warm_synced = total
        mask = masks.get(fhash)
        if mask is None:
            if len(masks) >= _PLATFORM_ORDER_CACHE:
                masks.clear()
            mask = self._warm_recompute(fhash)
        return mask

    def has_warm(self, cluster: ClusterState, fhash: int) -> bool:
        """Any candidate (valid or not) holds a warm instance — the
        set-item ordering key of a block-level ``warm-first``."""
        return self.warm_mask(cluster, fhash) != 0

    def platform_order(self, fhash: int) -> List[int]:
        """The flat per-fhash co-prime trial order over static survivors.

        The batch router stacks these into the ``select_first_available``
        kernel's int32 order planes; scanning the flat list position by
        position is exactly what :meth:`pick_platform` does (its chunking
        is only a skip optimization), so a kernel pick over this order is
        bit-identical to the scalar pick.
        """
        chunks = self._platform_chunks.get(fhash)
        if chunks is None:
            chunks = self._build_platform_chunks(fhash)
        order: List[int] = []
        for _mask, seg in chunks:
            order.extend(seg)
        return order


class BlockIndex:
    """Per-(view × compiled block) candidate indexes.

    ``wrk`` holds the single :class:`ItemIndex` of a wrk-list block
    (positions = item positions); ``sets`` holds one per set item
    (positions = that set's members, local tier first).
    """

    __slots__ = ("wrk", "sets")

    def __init__(self, entry: ViewCacheEntry, cblock) -> None:
        if cblock.uses_sets:
            self.wrk = None
            self.sets = tuple(
                _set_item_index(entry, item) for item in cblock.sets
            )
        else:
            self.wrk = _wrk_item_index(entry, cblock.wrks)
            self.sets = ()


def _wrk_item_index(entry: ViewCacheEntry, wrks) -> ItemIndex:
    candidates = []
    for item in wrks:
        view = entry.by_name.get(item.label)
        if view is None:
            # Ghost label, or filtered out by the zone restriction:
            # statically invalid for the whole epoch.
            candidates.append((None, None, None, None))
        else:
            candidates.append(
                (view.worker, view, item.static_invalid, item.dyn_invalid)
            )
    # wrk lists are untiered: strategies order the item list as a whole.
    return ItemIndex(candidates, n_local=len(candidates))


def _set_item_index(entry: ViewCacheEntry, item) -> ItemIndex:
    local, foreign = entry.set_members(item.label)
    static_fn = item.static_invalid
    dyn_fn = item.dyn_invalid
    candidates = [(v.worker, v, static_fn, dyn_fn) for v in local]
    candidates.extend((v.worker, v, static_fn, dyn_fn) for v in foreign)
    return ItemIndex(candidates, n_local=len(local))


def cached_view_entry(
    cluster: ClusterState,
    controller_zone: str,
    policy: DistributionPolicy,
    *,
    controller_name: str = "",
    zone_restriction: Optional[str] = None,
) -> ViewCacheEntry:
    """Memoized :func:`distribution_view` keyed by ``(controller, policy,
    zone_restriction)``; the cache lives on the cluster snapshot and is
    cleared whenever ``topology_epoch`` bumps, so inflight-counter churn
    (admissions/completions) never causes a rebuild."""
    key = (controller_zone, controller_name, policy, zone_restriction)
    entry = cluster.view_cache.get(key)
    if entry is None:
        entry = ViewCacheEntry(
            distribution_view(
                cluster,
                controller_zone,
                policy,
                controller_name=controller_name,
                zone_restriction=zone_restriction,
            )
        )
        cluster.view_cache[key] = entry
    return entry
