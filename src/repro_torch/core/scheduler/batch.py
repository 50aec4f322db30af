"""Vectorized mask-plane batch routing (the ``route_batch`` kernel path).

:meth:`TappEngine.schedule_batch` historically looped ``schedule()`` —
per invocation it re-walked the compiled cascade, re-scanned platform
orders, and re-built a ``ScheduleDecision`` from scratch. This module
replaces that loop for the common case with three layers that together
make a batch decision a couple of dict hits:

* **Mask-plane kernel picks.** Batch items are grouped by the
  ``ItemIndex`` they route through (one index per compiled block × view
  entry × worker item — the "compiled block × strategy" grouping of a
  batch). For ``platform``-strategy picks, the group's distinct function
  hashes are stacked into one int32 ``[m, L]`` order plane, the index's
  availability bitmask is viewed as uint64 words, and
  :func:`repro_torch.kernels.ops.select_first_available` resolves "first set
  bit in order" for every row at once. Planes are keyed by
  ``(index, avail)`` so they self-invalidate the moment an admission
  flips any candidate bit. ``backend="numpy"`` uses the reference
  kernel in :mod:`repro_torch.kernels.ref`; ``backend="torch"`` runs the
  identical computation as torch tensor ops (``REPRO_BATCH_BACKEND`` overrides).

* **Zero-draw cascade solving.** The solver mirrors the compiled
  engine's evaluation (`_c_tag`/`_c_block`/`_c_pick`) exactly, but never
  touches the RNG: every point where the reference path *would* draw —
  ``random`` over two or more blocks, set items, or tier members —
  raises :class:`_NeedsScalar` and the item falls back to a plain
  ``engine.schedule()`` call. A ``random`` ordering over zero or one
  candidates consumes zero draws in every reference path, so such items
  stay vectorizable and the RNG stream is bit-identical either way.
  Round-robin cursor bumps are tracked virtually (the solver never
  mutates engine state), and the solved outcome is memoized by
  ``cursor mod lcm(site lengths)`` — sound because the evaluation path
  is a deterministic function of the cursor's residues at the
  controller-list sites it visits.

* **Intra-batch admission correction.** Outcome records are valid only
  under an unchanged ``(topology_epoch, load total, warm seq)`` token
  (the warm-event sequence is part of the token because a lifecycle
  janitor expiry changes warm-first outcomes *without* a load event). When an
  ``on_decision`` callback admits a placement mid-batch (the platform
  does, for every scheduled item), the token moves: cached outcomes and
  planes are dropped and the remaining items are solved freshly against
  the synced availability masks with scalar picks — capacity consumed by
  earlier items in the same batch is respected, and results stay
  bit-identical to a sequence of ``schedule()`` calls with interleaved
  admissions.

Placements, traces (the batch path only runs untraced), RNG streams,
cursor movement, and every ``ScheduleDecision`` field are bit-identical
to the sequential loop; ``tests/test_batch_vectorized.py`` property-tests
this under saturation, churn, epoch bumps, and mixed strategies.
"""
from __future__ import annotations

from math import lcm
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.state import ClusterState, ControllerState
from repro_torch.core.scheduler.strategy import coprime_order_cached
from repro_torch.core.scheduler.topology import ItemIndex, cached_view_entry
from repro_torch.core.tapp.ast import (
    DEFAULT_TAG,
    FollowupKind,
    Strategy,
    TopologyTolerance,
)

__all__ = ["BatchRouter"]

# Cache bounds: both caches are cleared wholesale at the cap (entries are
# cheap to rebuild and correctness never depends on retention).
_OUTCOME_CACHE_LIMIT = 4096
_PLANE_CACHE_LIMIT = 1024
# Residue records kept per (tag, zone, fhash) before the list is reset;
# also bounds the modulus a record may memoize under.
_RESIDUE_LIMIT = 128


class _NeedsScalar(Exception):
    """The cascade would consume RNG draws → route this item scalar."""


class _Ctx:
    """Mutable solve context: virtual cursor + modulus + zone restriction."""

    __slots__ = ("cur", "mod", "zr")

    def __init__(self, cursor: int) -> None:
        self.cur = cursor
        self.mod = 1
        self.zr: Optional[str] = None


class _Record:
    """One memoized cascade outcome, keyed by cursor residue.

    ``proto is None`` marks a cascade that aborted to the scalar path
    (it would draw RNG under this residue); otherwise ``proto`` is the
    pre-built ``ScheduleDecision.__dict__`` the replay copies (a fresh
    trace list is spliced in per decision), and ``delta`` is the cursor
    advance the cascade consumed.
    """

    __slots__ = ("modulus", "residue", "delta", "proto")

    def __init__(self, modulus: int, residue: int) -> None:
        self.modulus = modulus
        self.residue = residue
        self.delta = 0
        self.proto: Optional[dict] = None


class BatchRouter:
    """Vectorized batch evaluator bolted onto one :class:`TappEngine`.

    Owns the outcome and mask-plane caches; reads the engine's cursor,
    RNG (only through scalar fallbacks), distribution policy, and
    compiled plan. Not thread-safe, exactly like the engine it serves.
    """

    def __init__(self, engine, *, backend: str = "numpy") -> None:
        if backend not in ("numpy", "torch"):
            raise ValueError(
                f"unknown batch backend {backend!r}; expected 'numpy' or 'torch'"
            )
        self._engine = engine
        self._backend = backend
        self._select = None  # kernels.ops.select_first_available, lazy
        self._np = None
        self._decision_cls = None  # ScheduleDecision / outcomes, lazy
        self._scheduled_outcome = None
        self._failed_outcome = None
        self._plan = None
        self._token: Tuple[int, int, int] = (-1, -1, -1)
        self._churn = False
        # (tag, hash, proto) of the last zero-delta replay, for the
        # identical-run fast path in route_batch; None when the last
        # item solved scalar, failed statically, or moved the cursor.
        self._reuse: Optional[Tuple] = None
        # (id(ctag), entry_zone, fhash) → list of _Record (residue-keyed).
        self._outcomes: Dict[Tuple, List[_Record]] = {}
        # (ItemIndex.serial, avail int) → {fhash: pick or -1}. The
        # serial is process-unique and monotonic, so a collected index
        # whose id() gets re-used can never serve another index's plane.
        self._planes: Dict[Tuple, Dict[int, int]] = {}
        self._batch_hashes: Tuple[int, ...] = ()

    # -- public entry --------------------------------------------------------

    def route_batch(
        self,
        invocations: Sequence,
        script,
        plan,
        cluster: ClusterState,
        entry_zone: Optional[str],
        on_decision,
    ) -> List:
        if self._decision_cls is None:
            from repro_torch.core.scheduler.engine import Outcome, ScheduleDecision

            self._decision_cls = ScheduleDecision
            self._scheduled_outcome = Outcome.SCHEDULED
            self._failed_outcome = Outcome.FAILED
        if plan is not self._plan:
            # New compiled plan: ctag identities are stale (ids may be
            # reused across plan objects), drop everything.
            self._outcomes.clear()
            self._planes.clear()
            self._plan = plan
        seen = {}
        for inv in invocations:
            seen.setdefault(inv.hash, None)
        self._batch_hashes = tuple(seen)
        self._churn = False
        self._sync_token(cluster)

        decisions = []
        append = decisions.append
        decide = self._decide
        cls = self._decision_cls
        engine = self._engine
        # Run-of-identical-items fast path: consecutive items with the
        # same (tag, hash) — the dominant batch shape — scan the cached
        # residue records directly, skipping tag dispatch, cache-key
        # construction, and the outcome-cache lookup per item.
        reuse_tag = reuse_hash = reuse_records = None
        epoch, load, warm = self._token
        for inv in invocations:
            if (
                cluster.topology_epoch != epoch
                or cluster._load_total != load
                or cluster._warm_total != warm
            ):
                # State moved mid-batch (on_decision admissions, epoch
                # bumps, warm-pool flips): drop memoized outcomes and
                # planes, re-solve the rest against the synced masks
                # with scalar picks.
                epoch = cluster.topology_epoch
                load = cluster._load_total
                warm = cluster._warm_total
                self._outcomes.clear()
                self._planes.clear()
                self._token = (epoch, load, warm)
                self._churn = True
                reuse_records = None
            decision = None
            if (
                reuse_records is not None
                and inv.hash == reuse_hash
                and inv.tag == reuse_tag
            ):
                cursor = engine._controller_cursor
                for rec in reuse_records:
                    if cursor % rec.modulus == rec.residue:
                        proto = rec.proto
                        if proto is None:
                            break  # scalar marker → full dispatch
                        if rec.delta:
                            engine._controller_cursor = cursor + rec.delta
                        fields = proto.copy()
                        fields["trace"] = []
                        decision = cls.__new__(cls)
                        decision.__dict__ = fields
                        break
            if decision is None:
                decision = decide(inv, script, plan, cluster, entry_zone)
                reuse = self._reuse
                if reuse is not None:
                    reuse_tag, reuse_hash, reuse_records = reuse
                else:
                    reuse_records = None
            if on_decision is not None:
                on_decision(inv, decision)
            append(decision)
        return decisions

    def _sync_token(self, cluster: ClusterState) -> None:
        token = (
            cluster.topology_epoch, cluster._load_total, cluster._warm_total
        )
        if token != self._token:
            self._outcomes.clear()
            self._planes.clear()
            self._token = token

    # -- per-item dispatch ---------------------------------------------------

    def _decide(self, inv, script, plan, cluster, entry_zone):
        self._reuse = None
        ctag = plan.tags.get(inv.tag or DEFAULT_TAG)
        if ctag is None:
            ctag = plan.default
            if ctag is None:
                return self._decision_cls(
                    outcome=self._failed_outcome, failed_by_policy=True
                )
        engine = self._engine
        cursor = engine._controller_cursor
        key = (id(ctag), entry_zone, inv.hash)
        records = self._outcomes.get(key)
        rec = None
        if records is not None:
            for cand in records:
                if cursor % cand.modulus == cand.residue:
                    rec = cand
                    break
        if rec is None:
            rec = self._solve(
                inv.hash, ctag, plan, cluster, entry_zone, cursor
            )
            if records is None:
                if len(self._outcomes) >= _OUTCOME_CACHE_LIMIT:
                    self._outcomes.clear()
                records = self._outcomes[key] = []
            elif len(records) >= _RESIDUE_LIMIT:
                del records[:]
            records.append(rec)
        self._reuse = (inv.tag, inv.hash, records)
        proto = rec.proto
        if proto is None:
            return engine.schedule(inv, script, cluster, entry_zone=entry_zone)
        if rec.delta:
            engine._controller_cursor = cursor + rec.delta
        # Replay: splat the memoized decision dict onto a bare instance
        # (the dataclass __init__ is ~half the per-item budget); the
        # trace list must be fresh per decision.
        cls = self._decision_cls
        decision = cls.__new__(cls)
        fields = proto.copy()
        fields["trace"] = []
        decision.__dict__ = fields
        return decision

    # -- the zero-draw cascade solver ---------------------------------------

    def _solve(
        self,
        fhash: int,
        ctag,
        plan,
        cluster: ClusterState,
        entry_zone: Optional[str],
        cursor: int,
    ) -> _Record:
        ctx = _Ctx(cursor)
        try:
            tag, used, controller, worker, failed = self._solve_tag(
                fhash, ctag, plan, cluster, ctx,
                is_fallback=False, zone_override=entry_zone,
                entry_zone=entry_zone,
            )
        except _NeedsScalar:
            return _Record(ctx.mod, cursor % ctx.mod)  # scalar marker
        rec = _Record(ctx.mod, cursor % ctx.mod)
        rec.delta = ctx.cur - cursor
        rec.proto = {
            "outcome": (
                self._scheduled_outcome
                if worker is not None
                else self._failed_outcome
            ),
            "worker": worker,
            "controller": controller,
            "tag": tag,
            "used_default_fallback": used,
            "zone_restriction": ctx.zr,
            "failed_by_policy": failed,
        }
        return rec

    def _solve_tag(
        self,
        fhash: int,
        ctag,
        plan,
        cluster: ClusterState,
        ctx: _Ctx,
        *,
        is_fallback: bool,
        zone_override: Optional[str],
        entry_zone: Optional[str],
    ):
        for _block_index, cblock in self._ordered(
            ctag.enumerated, ctag.strategy, fhash
        ):
            placed = self._solve_block(
                fhash, cblock, cluster, ctx, zone_override, entry_zone
            )
            if placed is not None:
                return ctag.tag, is_fallback, placed[0], placed[1], False
        if ctag.followup is FollowupKind.DEFAULT and not is_fallback:
            sticky = zone_override
            for label in ctag.sticky_same_labels:
                designated = cluster.controllers.get(label)
                if designated is not None:
                    sticky = designated.zone
                    break
            default_tag = plan.default
            if default_tag is not None and default_tag.tag != ctag.tag:
                return self._solve_tag(
                    fhash, default_tag, plan, cluster, ctx,
                    is_fallback=True, zone_override=sticky,
                    entry_zone=entry_zone,
                )
        return ctag.tag, is_fallback, None, None, True

    def _ordered(self, items, strategy: Strategy, fhash: int):
        if strategy is Strategy.BEST_FIRST or not items:
            return items
        if strategy is Strategy.PLATFORM:
            return [items[i] for i in coprime_order_cached(len(items), fhash)]
        if strategy is Strategy.WARM_FIRST:
            # Tag-level warm-first is a validation error; every reference
            # path degrades it to best_first, so mirror that here.
            return items
        if len(items) >= 2:
            raise _NeedsScalar  # random over ≥2 items draws
        return items  # random over one item: zero draws, identity order

    def _solve_block(
        self,
        fhash: int,
        cblock,
        cluster: ClusterState,
        ctx: _Ctx,
        zone_override: Optional[str],
        entry_zone: Optional[str],
    ) -> Optional[Tuple[str, str]]:
        if cblock.controller is None:
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
                return None
            n = len(controllers)
            start = ctx.cur
            ctx.cur += 1
            ctx.mod = lcm(ctx.mod, n)
            for offset in range(n):
                controller = controllers[(start + offset) % n]
                placed = self._solve_block_on(
                    fhash, cblock, controller, zone_override, cluster
                )
                if placed is not None:
                    ctx.zr = zone_override
                    return placed
            return None

        controller, zone_restriction = self._solve_controller(
            cblock, cluster, ctx, entry_zone
        )
        if controller is None:
            return None
        effective = zone_restriction or zone_override
        ctx.zr = effective
        return self._solve_block_on(
            fhash, cblock, controller, effective, cluster
        )

    def _solve_controller(
        self,
        cblock,
        cluster: ClusterState,
        ctx: _Ctx,
        entry_zone: Optional[str],
    ) -> Tuple[Optional[ControllerState], Optional[str]]:
        clause = cblock.controller
        tol = clause.topology_tolerance
        designated = cluster.controllers.get(clause.label)
        if designated is not None and designated.available:
            if entry_zone is not None and tol is not TopologyTolerance.ALL:
                return designated, designated.zone
            return designated, None
        designated_zone = designated.zone if designated is not None else None
        if tol is TopologyTolerance.NONE:
            return None, None
        controllers = [c for c in cluster.controllers.values() if c.available]
        if not controllers:
            return None, None
        n = len(controllers)
        alternative = controllers[ctx.cur % n]
        ctx.cur += 1
        ctx.mod = lcm(ctx.mod, n)
        if tol is TopologyTolerance.SAME:
            if designated_zone is None:
                # The bump above already happened (mirrors the reference
                # path, which consumes the round-robin pick before
                # discovering the zone is unresolvable).
                return None, None
            return alternative, designated_zone
        return alternative, None

    def _solve_block_on(
        self,
        fhash: int,
        cblock,
        controller: ControllerState,
        zone_restriction: Optional[str],
        cluster: ClusterState,
    ) -> Optional[Tuple[str, str]]:
        engine = self._engine
        entry = cached_view_entry(
            cluster,
            controller.zone,
            engine.distribution,
            controller_name=controller.name,
            zone_restriction=zone_restriction,
        )
        bindex = entry.block_index(cblock)
        if not cblock.uses_sets:
            idx = bindex.wrk
            pos = self._solve_pick(idx, cblock.strategy, fhash, cluster)
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
            # Stable warm partition over set items — same ordering (and
            # zero draws) as the scalar paths.
            item_order = sorted(
                range(n_items),
                key=lambda i: not indexes[i].has_warm(cluster, fhash),
            )
        else:
            raise _NeedsScalar  # random over ≥2 set items draws
        for ipos in item_order:
            pos = self._solve_pick(
                indexes[ipos], sets[ipos].strategy, fhash, cluster
            )
            if pos is not None:
                idx = indexes[ipos]
                return controller.name, idx.workers[pos].name
        return None

    def _solve_pick(
        self,
        idx: ItemIndex,
        strategy: Strategy,
        fhash: int,
        cluster: ClusterState,
    ) -> Optional[int]:
        avail = idx.refresh(cluster)
        if strategy is Strategy.RANDOM:
            n_local = idx.n_local
            n_foreign = idx.n - n_local
            if n_local >= 2 or n_foreign >= 2:
                raise _NeedsScalar  # a ≥2 tier draws even when saturated
            # ≤1-element tiers: pick_random degenerates to checking the
            # single position per tier, local first, zero draws.
            if n_local == 1 and avail & 1:
                return 0
            if n_foreign == 1 and (avail >> n_local) & 1:
                return n_local
            return None
        if not avail:
            return None
        if strategy is Strategy.PLATFORM:
            return self._pick_platform_vec(idx, avail, fhash)
        if strategy is Strategy.WARM_FIRST:
            # Pure bit ops, mirroring the scalar engine's pick: warm
            # locals, cold locals, warm foreigns, cold foreigns.
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
        return (avail & -avail).bit_length() - 1  # BEST_FIRST

    # -- mask-plane kernel picks --------------------------------------------

    def _pick_platform_vec(
        self, idx: ItemIndex, avail: int, fhash: int
    ) -> Optional[int]:
        if self._churn:
            # Admission-corrected remainder of the batch: avail moves
            # per item, so plane reuse is nil — scalar chunk scan wins.
            return idx.pick_platform(avail, fhash)
        key = (idx.serial, avail)
        plane = self._planes.get(key)
        if plane is None:
            if len(self._planes) >= _PLANE_CACHE_LIMIT:
                self._planes.clear()
            plane = self._kernel_picks(idx, avail, self._batch_hashes)
            self._planes[key] = plane
        pick = plane.get(fhash)
        if pick is None:
            # A hash outside the current batch group (cache carried over
            # from an earlier batch): resolve its row alone.
            pick = self._kernel_picks(idx, avail, (fhash,))[fhash]
            plane[fhash] = pick
        return pick if pick >= 0 else None

    def _kernel_picks(
        self, idx: ItemIndex, avail: int, hashes: Tuple[int, ...]
    ) -> Dict[int, int]:
        """Resolve the whole hash group's platform picks in one kernel call.

        Stacks each hash's co-prime trial order into an int32 ``[m, L]``
        plane (-1 padded), views the availability mask as uint64 words,
        and lets :func:`select_first_available` take "first set bit in
        order" for every row at once — bit-identical to the scalar
        ``pick_platform`` scan over the same flat order.
        """
        np = self._np
        select = self._select
        if select is None:
            import numpy
            from repro_torch.kernels.ops import select_first_available

            np = self._np = numpy
            select = self._select = select_first_available
        orders = [idx.platform_order(h) for h in hashes]
        width = max(len(o) for o in orders)
        if width == 0:
            return {h: -1 for h in hashes}
        plane = np.full((len(hashes), width), -1, dtype=np.int32)
        for row, order in enumerate(orders):
            plane[row, : len(order)] = order
        nwords = max(1, (idx.n + 63) >> 6)
        # Explicit little-endian dtype: the bytes are produced
        # little-endian, so a native-endian view would byte-swap the
        # mask words on a big-endian host.
        words = np.frombuffer(
            avail.to_bytes(nwords * 8, "little"), dtype="<u8"
        )
        picks = select(words, plane, backend=self._backend)
        return {h: int(p) for h, p in zip(hashes, picks)}
