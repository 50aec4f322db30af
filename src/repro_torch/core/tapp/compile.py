"""Script compilation: lower a parsed :class:`TappScript` to execution plans.

The interpreter in :mod:`repro_torch.core.scheduler.engine` re-derives, on every
scheduling decision, facts that are pure functions of the script text:
effective strategies/followups, the wrk-vs-set shape of each block, the
resolved constraint set of each worker item (item ▸ block ▸ platform
default — invalidate condition plus affinity / anti-affinity clauses),
and the ``topology_tolerance: same`` sticky-zone scan performed on
followup. Compilation hoists all of that to script-load time, so the
per-decision cost is amortized-O(candidates tried):

* each tag becomes a :class:`CompiledTag` with its effective strategy,
  effective followup, and the ordered sticky-zone label table;
* each block becomes a :class:`CompiledBlock` pre-split into either a
  wrk-list (:class:`CompiledWrk`) or a set-list (:class:`CompiledSet`),
  with the block-level strategy defaulted;
* each worker item carries its resolved
  :class:`~repro_torch.core.scheduler.constraints.ConstraintSpec` AND a
  pre-bound ``invalid(worker) -> bool`` closure lowered by the constraint
  layer (:func:`~repro_torch.core.scheduler.constraints.compile_spec`),
  eliminating per-candidate dispatch no matter how many constraint kinds
  the item stacks.

Compilation is semantics-preserving by construction: the compiled
evaluator (``TappEngine`` with ``compiled=True``) produces bit-identical
placements and traces to the interpreter under a fixed RNG seed — this is
property-tested in ``tests/test_scheduler_compile.py``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional, Tuple

if TYPE_CHECKING:  # the constraint layer lives scheduler-side; importing it
    # at module scope would close a cycle (scheduler.constraints needs
    # tapp.ast, whose package init loads this module). Lowering happens at
    # script-compile time, when everything is loaded — see _constraints().
    from repro_torch.core.scheduler.constraints import ConstraintSpec, InvalidFn

from repro_torch.core.tapp.ast import (
    DEFAULT_TAG,
    Block,
    ControllerClause,
    FollowupKind,
    Invalidate,
    OnOverload,
    Strategy,
    TagPolicy,
    TappScript,
    TopologyTolerance,
    WorkerRef,
    WorkerSet,
)

__all__ = [
    "CompiledBlock",
    "CompiledScript",
    "CompiledSet",
    "CompiledTag",
    "CompiledWrk",
    "compile_invalidate",
    "compile_script",
]


def _constraints():
    from repro_torch.core.scheduler import constraints

    return constraints


def compile_invalidate(condition: Invalidate) -> "InvalidFn":
    """Pre-bind an invalidate condition (re-export of the constraint layer)."""
    return _constraints().compile_invalidate(condition)


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledWrk:
    """A ``wrk: label`` item with its constraints resolved and pre-bound.

    ``invalid`` is the fused closure (reachability ∧ invalidate ∧
    affinity); ``static_invalid`` / ``dyn_invalid`` are its epoch-static
    vs. volatile halves (:func:`~repro_torch.core.scheduler.constraints.split_spec`)
    consumed by the per-epoch candidate indexes. Identity-hashed
    (``eq=False``): compiled items key the per-view index caches, so
    hashing must be O(1) on the decision hot path.
    """

    label: str
    spec: ConstraintSpec
    invalid: InvalidFn
    static_invalid: InvalidFn
    dyn_invalid: InvalidFn

    @property
    def condition(self) -> Invalidate:
        """The resolved invalidate condition (legacy accessor)."""
        return self.spec.invalidate


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledSet:
    """A ``set: label`` item with strategy + constraints pre-resolved."""

    label: Optional[str]
    strategy: Strategy  # inner member-selection strategy (platform default)
    spec: ConstraintSpec
    invalid: InvalidFn
    static_invalid: InvalidFn
    dyn_invalid: InvalidFn

    @property
    def condition(self) -> Invalidate:
        """The resolved invalidate condition (legacy accessor)."""
        return self.spec.invalidate


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledBlock:
    """One workers-block, pre-split by shape with strategy defaulted.

    Identity-hashed (``eq=False``): the epoch-cached view entries key
    their :class:`~repro_torch.core.scheduler.topology.BlockIndex` caches by
    the block object itself.
    """

    index: int  # position in the tag's source order (trace identity)
    controller: Optional[ControllerClause]
    strategy: Strategy  # effective block-level item strategy
    uses_sets: bool
    wrks: Tuple[CompiledWrk, ...] = ()
    sets: Tuple[CompiledSet, ...] = ()
    priority: int = 0  # load-shedding priority (PR 9); unset lowers to 0


@dataclasses.dataclass(frozen=True)
class CompiledTag:
    """Per-tag execution plan."""

    tag: str
    strategy: Strategy          # effective block-selection strategy
    followup: FollowupKind      # effective followup (default tag → fail)
    blocks: Tuple[CompiledBlock, ...]
    # Base ordering fed to the block-selection strategy: (index, block)
    # pairs in source order, mirroring the interpreter's enumerate().
    enumerated: Tuple[Tuple[int, CompiledBlock], ...]
    # topology_tolerance:same sticky-zone table (paper §3.4): controller
    # labels, in block source order, whose zone pins a followup-to-default
    # evaluation. The first label present in the live cluster wins.
    sticky_same_labels: Tuple[str, ...]
    # Overload layer (PR 9): tag-wide shedding priority (max over block
    # priorities) and the brownout escape hatch, if declared.
    priority: int = 0
    on_overload: Optional[OnOverload] = None


@dataclasses.dataclass(frozen=True)
class CompiledScript:
    """A fully lowered tAPP script, keyed for O(1) tag dispatch."""

    source: TappScript
    tags: Dict[str, CompiledTag]
    default: Optional[CompiledTag]


def _compile_block(index: int, block: Block) -> CompiledBlock:
    layer = _constraints()
    strategy = block.strategy or Strategy.BEST_FIRST
    if block.uses_sets:
        sets = tuple(
            CompiledSet(
                label=item.label,
                strategy=item.strategy or Strategy.PLATFORM,
                spec=(spec := layer.resolve_constraints(item, block)),
                invalid=layer.compile_spec(spec),
                static_invalid=(halves := layer.split_spec(spec))[0],
                dyn_invalid=halves[1],
            )
            for item in block.workers
            if isinstance(item, WorkerSet)
        )
        return CompiledBlock(
            index=index,
            controller=block.controller,
            strategy=strategy,
            uses_sets=True,
            sets=sets,
            priority=block.priority or 0,
        )
    wrks = tuple(
        CompiledWrk(
            label=item.label,
            spec=(spec := layer.resolve_constraints(item, block)),
            invalid=layer.compile_spec(spec),
            static_invalid=(halves := layer.split_spec(spec))[0],
            dyn_invalid=halves[1],
        )
        for item in block.workers
        if isinstance(item, WorkerRef)
    )
    return CompiledBlock(
        index=index,
        controller=block.controller,
        strategy=strategy,
        uses_sets=False,
        wrks=wrks,
        priority=block.priority or 0,
    )


def _compile_tag(policy: TagPolicy) -> CompiledTag:
    blocks = tuple(
        _compile_block(i, b) for i, b in enumerate(policy.blocks)
    )
    sticky = tuple(
        b.controller.label
        for b in policy.blocks
        if b.controller is not None
        and b.controller.topology_tolerance is TopologyTolerance.SAME
    )
    return CompiledTag(
        tag=policy.tag,
        strategy=policy.effective_strategy,
        followup=policy.effective_followup,
        blocks=blocks,
        enumerated=tuple(enumerate(blocks)),
        sticky_same_labels=sticky,
        priority=max((b.priority for b in blocks), default=0),
        on_overload=policy.on_overload,
    )


def compile_script(script: TappScript) -> CompiledScript:
    """Lower a parsed script into per-tag execution plans."""
    tags = {t.tag: _compile_tag(t) for t in script.tags}
    return CompiledScript(
        source=script, tags=tags, default=tags.get(DEFAULT_TAG)
    )
