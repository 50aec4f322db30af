"""The constraint layer: one predicate pipeline for worker validity.

This module replaces the original ``invalidate.py`` (the hardcoded
three-predicate special case of paper §3.3) with a composable predicate
IR. A tAPP worker item now carries a resolved :class:`ConstraintSpec` —
its invalidate condition plus optional affinity / anti-affinity clauses
(arXiv:2407.14572 semantics) — and both execution paths evaluate it
through this module:

* the **interpreter** calls :func:`constraint_reason` per candidate
  (reason strings double as trace output);
* the **compiled fast path** (:mod:`repro_torch.core.tapp.compile`) lowers the
  spec once at script-compile time via :func:`compile_spec` into a flat
  pre-resolved closure, so per-decision cost stays O(candidates tried)
  regardless of how many constraint kinds a script stacks (the
  *Archipelago* flat-cost requirement).

Adding a constraint kind = one predicate dataclass with ``violated`` /
``reason`` / ``lower`` + a case in :func:`_predicate_of` — no engine or
compiler changes.

Resolution order of every clause applied to a worker item (paper §3.3,
extended): per-``wrk``/per-``set`` clause ▸ enclosing block clause ▸
platform default (``overload`` for invalidate; no affinity constraints).
All constraints share the *preliminary* condition: an unreachable worker
is always invalid.

Affinity semantics (documented in :mod:`repro_torch.core.tapp.ast`): the
predicates read ``WorkerState.running_functions``, the live per-worker
multiset of admitted function executions fed by the controller runtime.
``affinity`` requires every listed function present; ``anti-affinity``
forbids any listed function present.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple, Union

from repro_torch.core.scheduler.state import WorkerState
from repro_torch.core.tapp.ast import (
    Affinity,
    AntiAffinity,
    CapacityUsed,
    Invalidate,
    MaxConcurrentInvocations,
    Overload,
)

# ``invalid(worker) -> bool``; takes anything WorkerState-shaped.
InvalidFn = Callable[[object], bool]

DEFAULT_INVALIDATE: Invalidate = Overload()


# ---------------------------------------------------------------------------
# Legacy invalidate API (paper §3.3) — thin shims over the predicate IR
# ---------------------------------------------------------------------------


def resolve_invalidate(
    item_level: Optional[Invalidate],
    block_level: Optional[Invalidate],
) -> Invalidate:
    """Inner condition overrides outer; fall back to the platform default."""
    if item_level is not None:
        return item_level
    if block_level is not None:
        return block_level
    return DEFAULT_INVALIDATE


def is_invalid(worker: WorkerState, condition: Invalidate) -> bool:
    """True iff the worker cannot host the execution under ``condition``."""
    if not worker.reachable:
        return True
    return _predicate_of(condition).violated(worker)


def invalid_reason(worker: WorkerState, condition: Invalidate) -> Optional[str]:
    """Human-readable reason the worker is invalid, or None if valid."""
    if not worker.reachable:
        return "unreachable"
    return _predicate_of(condition).reason(worker)


def compile_invalidate(condition: Invalidate) -> InvalidFn:
    """Pre-bind an invalidate condition to a branch-free predicate.

    Matches :func:`is_invalid` exactly, including the preliminary
    unreachability condition (paper §3.3), but resolves the condition type
    once at compile time instead of per candidate.
    """
    if isinstance(condition, Overload):
        def invalid(w) -> bool:
            return (
                (not w.reachable)
                or (not w.healthy)
                or w.inflight >= w.capacity_slots
            )
        return invalid
    if isinstance(condition, CapacityUsed):
        threshold = condition.percent

        def invalid(w) -> bool:
            return (not w.reachable) or w.capacity_used_pct >= threshold
        return invalid
    if isinstance(condition, MaxConcurrentInvocations):
        limit = condition.limit

        def invalid(w) -> bool:
            return (not w.reachable) or (w.inflight + w.queued) >= limit
        return invalid
    raise TypeError(f"unknown invalidate condition {condition!r}")


# ---------------------------------------------------------------------------
# ConstraintSpec: the fully resolved constraint set of one worker item
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Everything that can invalidate a worker for one tAPP worker item."""

    invalidate: Invalidate = dataclasses.field(default_factory=Overload)
    affinity: Optional[Affinity] = None
    anti_affinity: Optional[AntiAffinity] = None

    @property
    def plain(self) -> bool:
        """No affinity clauses — the paper's original constraint set."""
        return self.affinity is None and self.anti_affinity is None

    def describe(self) -> str:
        parts = [self.invalidate.describe()]
        if self.affinity is not None:
            parts.append(self.affinity.describe())
        if self.anti_affinity is not None:
            parts.append(self.anti_affinity.describe())
        return "; ".join(parts)


def resolve_constraints(item, block) -> ConstraintSpec:
    """Resolve the effective spec of a worker item inside its block.

    ``item``/``block`` are any objects with ``invalidate`` / ``affinity`` /
    ``anti_affinity`` attributes (:class:`~repro_torch.core.tapp.ast.WorkerRef`,
    :class:`~repro_torch.core.tapp.ast.WorkerSet`, and
    :class:`~repro_torch.core.tapp.ast.Block`). Each clause resolves
    independently: item-level overrides block-level; invalidate falls back
    to the platform default, affinity clauses to "unconstrained".
    """
    return ConstraintSpec(
        invalidate=resolve_invalidate(item.invalidate, block.invalidate),
        affinity=item.affinity if item.affinity is not None else block.affinity,
        anti_affinity=(
            item.anti_affinity
            if item.anti_affinity is not None
            else block.anti_affinity
        ),
    )


# ---------------------------------------------------------------------------
# Predicate IR
# ---------------------------------------------------------------------------
#
# A predicate states one *requirement* for a worker to be valid. The engine
# never evaluates these nodes directly on the hot path — `lower()` returns a
# pre-resolved closure, and `compile_spec` below fuses the common shapes into
# flat single-call closures — but the IR is the semantic definition every
# evaluation path must agree with, and the extension point for future
# constraint kinds (cost, latency-SLO, ...).


@dataclasses.dataclass(frozen=True)
class Reachable:
    """The preliminary condition: every policy requires reachability."""

    def violated(self, w: WorkerState) -> bool:
        return not w.reachable

    def reason(self, w: WorkerState) -> Optional[str]:
        return None if w.reachable else "unreachable"

    def lower(self) -> InvalidFn:
        return lambda w: not w.reachable


@dataclasses.dataclass(frozen=True)
class NotOverloaded:
    def violated(self, w: WorkerState) -> bool:
        return (not w.healthy) or w.inflight >= w.capacity_slots

    def reason(self, w: WorkerState) -> Optional[str]:
        if not w.healthy:
            return "unhealthy"
        if w.inflight >= w.capacity_slots:
            return f"slots exhausted ({w.inflight}/{w.capacity_slots})"
        return None

    def lower(self) -> InvalidFn:
        return lambda w: (not w.healthy) or w.inflight >= w.capacity_slots


@dataclasses.dataclass(frozen=True)
class CapacityBelow:
    percent: float

    def violated(self, w: WorkerState) -> bool:
        return w.capacity_used_pct >= self.percent

    def reason(self, w: WorkerState) -> Optional[str]:
        if w.capacity_used_pct >= self.percent:
            return (
                f"capacity_used {w.capacity_used_pct:.0f}% >= "
                f"{self.percent:.0f}%"
            )
        return None

    def lower(self) -> InvalidFn:
        threshold = self.percent
        return lambda w: w.capacity_used_pct >= threshold


@dataclasses.dataclass(frozen=True)
class ConcurrencyBelow:
    limit: int

    def violated(self, w: WorkerState) -> bool:
        return w.concurrent >= self.limit

    def reason(self, w: WorkerState) -> Optional[str]:
        if w.concurrent >= self.limit:
            return f"concurrent {w.concurrent} >= {self.limit}"
        return None

    def lower(self) -> InvalidFn:
        limit = self.limit
        return lambda w: (w.inflight + w.queued) >= limit


@dataclasses.dataclass(frozen=True)
class RunningAll:
    """Affinity: every listed function must be running on the worker."""

    functions: Tuple[str, ...]

    def violated(self, w: WorkerState) -> bool:
        rf = w.running_functions
        return any(rf.get(fn, 0) <= 0 for fn in self.functions)

    def reason(self, w: WorkerState) -> Optional[str]:
        rf = w.running_functions
        for fn in self.functions:
            if rf.get(fn, 0) <= 0:
                return f"affinity: requires {fn!r} running"
        return None

    def lower(self) -> InvalidFn:
        if len(self.functions) == 1:
            (fn,) = self.functions
            return lambda w: w.running_functions.get(fn, 0) <= 0
        fns = self.functions
        return lambda w: any(w.running_functions.get(f, 0) <= 0 for f in fns)


@dataclasses.dataclass(frozen=True)
class RunningNone:
    """Anti-affinity: no listed function may be running on the worker."""

    functions: Tuple[str, ...]

    def violated(self, w: WorkerState) -> bool:
        rf = w.running_functions
        return any(rf.get(fn, 0) > 0 for fn in self.functions)

    def reason(self, w: WorkerState) -> Optional[str]:
        rf = w.running_functions
        for fn in self.functions:
            count = rf.get(fn, 0)
            if count > 0:
                return f"anti-affinity: {fn!r} running ({count}x)"
        return None

    def lower(self) -> InvalidFn:
        if len(self.functions) == 1:
            (fn,) = self.functions
            return lambda w: w.running_functions.get(fn, 0) > 0
        fns = self.functions
        return lambda w: any(w.running_functions.get(f, 0) > 0 for f in fns)


@dataclasses.dataclass(frozen=True)
class Conjunction:
    """All requirements must hold; violated if ANY member is violated.

    Members are evaluated in order — reason strings report the first
    violation, matching the short-circuit order of the lowered closure.
    """

    predicates: Tuple["Predicate", ...]

    def violated(self, w: WorkerState) -> bool:
        return any(p.violated(w) for p in self.predicates)

    def reason(self, w: WorkerState) -> Optional[str]:
        for p in self.predicates:
            r = p.reason(w)
            if r is not None:
                return r
        return None

    def lower(self) -> InvalidFn:
        fns = tuple(p.lower() for p in self.predicates)
        if len(fns) == 1:
            return fns[0]
        if len(fns) == 2:
            a, b = fns
            return lambda w: a(w) or b(w)
        if len(fns) == 3:
            a, b, c = fns
            return lambda w: a(w) or b(w) or c(w)
        return lambda w: any(f(w) for f in fns)


Predicate = Union[
    Reachable,
    NotOverloaded,
    CapacityBelow,
    ConcurrencyBelow,
    RunningAll,
    RunningNone,
    Conjunction,
]


@functools.lru_cache(maxsize=1024)
def _predicate_of(condition: Invalidate) -> Predicate:
    # Memoized: conditions are frozen AST nodes, and the interpreter asks
    # per candidate — real deployments see a bounded set of conditions.
    if isinstance(condition, Overload):
        return NotOverloaded()
    if isinstance(condition, CapacityUsed):
        return CapacityBelow(condition.percent)
    if isinstance(condition, MaxConcurrentInvocations):
        return ConcurrencyBelow(condition.limit)
    raise TypeError(f"unknown invalidate condition {condition!r}")


@functools.lru_cache(maxsize=1024)
def spec_predicate(spec: ConstraintSpec) -> Conjunction:
    """The IR form of a resolved spec: reachability ∧ invalidate ∧ affinity."""
    predicates: list = [Reachable(), _predicate_of(spec.invalidate)]
    if spec.affinity is not None:
        predicates.append(RunningAll(spec.affinity.functions))
    if spec.anti_affinity is not None:
        predicates.append(RunningNone(spec.anti_affinity.functions))
    return Conjunction(tuple(predicates))


# ---------------------------------------------------------------------------
# Evaluation entry points (shared by interpreter + compiled paths)
# ---------------------------------------------------------------------------


def spec_violated(worker: WorkerState, spec: ConstraintSpec) -> bool:
    """Reference evaluation (un-lowered); equals ``compile_spec(spec)(w)``."""
    return spec_predicate(spec).violated(worker)


def constraint_reason(worker: WorkerState, spec: ConstraintSpec) -> Optional[str]:
    """First violated requirement as a human-readable reason, else None.

    Conjunction member order matches the lowered closure's short-circuit
    order (reachability ▸ invalidate ▸ affinity ▸ anti-affinity), so trace
    output and hot-path validity always agree.
    """
    return spec_predicate(spec).reason(worker)


def split_spec(spec: ConstraintSpec) -> Tuple[InvalidFn, InvalidFn]:
    """Split a resolved spec into ``(static_invalid, dynamic_invalid)``.

    The index layer's contract: ``compile_spec(spec)(w) ==
    static_invalid(w) or dynamic_invalid(w)`` for every worker state.

    *Static* means stable within one ``ClusterState.topology_epoch``:
    reachability and health transitions always bump the epoch (the
    watcher treats them as structural), so an index built per epoch may
    evaluate them once at build time. *Dynamic* is the volatile residue —
    slot counters, load percentages, and the running-function multiset —
    i.e. exactly the fields the admission ledger mutates per decision
    without bumping the epoch. Note the split follows the predicate
    semantics: only ``overload`` consults health; ``capacity_used`` and
    ``max_concurrent_invocations`` have reachability as their sole
    static requirement (paper §3.3).
    """
    invalidate = spec.invalidate
    if isinstance(invalidate, Overload):
        def static_invalid(w) -> bool:
            return (not w.reachable) or (not w.healthy)

        def base_dynamic(w) -> bool:
            return w.inflight >= w.capacity_slots
    elif isinstance(invalidate, CapacityUsed):
        threshold = invalidate.percent

        def static_invalid(w) -> bool:
            return not w.reachable

        def base_dynamic(w) -> bool:
            return w.capacity_used_pct >= threshold
    elif isinstance(invalidate, MaxConcurrentInvocations):
        limit = invalidate.limit

        def static_invalid(w) -> bool:
            return not w.reachable

        def base_dynamic(w) -> bool:
            return (w.inflight + w.queued) >= limit
    else:
        raise TypeError(f"unknown invalidate condition {invalidate!r}")

    if spec.plain:
        return static_invalid, base_dynamic

    aff = spec.affinity.functions if spec.affinity is not None else None
    anti = (
        spec.anti_affinity.functions if spec.anti_affinity is not None else None
    )

    def dynamic_invalid(w) -> bool:
        if base_dynamic(w):
            return True
        rf = w.running_functions
        if aff is not None and any(rf.get(f, 0) <= 0 for f in aff):
            return True
        return anti is not None and any(rf.get(f, 0) > 0 for f in anti)

    return static_invalid, dynamic_invalid


def compile_spec(spec: ConstraintSpec) -> InvalidFn:
    """Lower a resolved spec to one flat pre-resolved closure.

    Plain specs (no affinity clauses) keep the exact single-lambda shape of
    the original compiled fast path; specs with affinity clauses pay one
    extra fused check reading ``running_functions``. Either way the closure
    is resolved once at script-compile time — per-decision cost does not
    grow with the number of constraint kinds in the language.
    """
    base = compile_invalidate(spec.invalidate)
    if spec.plain:
        return base
    aff = spec.affinity.functions if spec.affinity is not None else None
    anti = spec.anti_affinity.functions if spec.anti_affinity is not None else None

    if aff is not None and len(aff) == 1 and anti is None:
        (fa,) = aff

        def invalid(w) -> bool:
            return base(w) or w.running_functions.get(fa, 0) <= 0
        return invalid
    if anti is not None and len(anti) == 1 and aff is None:
        (fn,) = anti

        def invalid(w) -> bool:
            return base(w) or w.running_functions.get(fn, 0) > 0
        return invalid

    def invalid(w) -> bool:
        if base(w):
            return True
        rf = w.running_functions
        if aff is not None and any(rf.get(f, 0) <= 0 for f in aff):
            return True
        return anti is not None and any(rf.get(f, 0) > 0 for f in anti)
    return invalid
