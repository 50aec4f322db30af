"""Typed AST for the tAPP language (Fig. 4 of the paper).

Grammar (paper, Fig. 4)::

    app        ::= tag*
    tag        ::= policy_tag : block+  strategy?  followup?
    block      ::= controller?  workers  strategy?  constraint*
    controller ::= controller: label  (topology_tolerance: all|same|none)?
    workers    ::= workers: (wrk: label  constraint*)+
                 | workers: (set: label?  strategy?  constraint*)+
    strategy   ::= strategy: random | platform | best_first | warm-first
    constraint ::= invalidate | affinity | anti-affinity
    invalidate ::= invalidate: capacity_used n% | max_concurrent_invocations n | overload
    affinity   ::= affinity: fn (, fn)*            -- all must be running there
    anti-affinity ::= anti-affinity: fn (, fn)*    -- none may be running there
    followup   ::= followup: default | fail

The ``affinity``/``anti-affinity`` clauses are the constraint-layer-v2
extension (the authors' follow-up, arXiv:2407.14572): they constrain *what
else is running* on a worker, evaluated against the live per-worker
running-function multiset. At most one of each clause per level; item-level
clauses override block-level ones (same resolution rule as ``invalidate``).

The special ``default`` tag is the policy for untagged functions and the target of
``followup: default``; its own followup is always ``fail`` (paper §3.3).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple, Union

DEFAULT_TAG = "default"


class Strategy(enum.Enum):
    """Item-selection strategy at tag, block, or worker-set level.

    ``WARM_FIRST`` (the warm-pool extension, ROADMAP item 1) orders
    candidates that hold an IDLE warm instance of the invoked function
    ahead of cold ones — a stable partition of the canonical best-first
    order, consuming zero RNG draws. With no lifecycle armed every
    worker is cold, so it degenerates to ``BEST_FIRST`` exactly.
    Valid at block and set-item level only (a tag-level warm-first is a
    validation error: tag strategies order *blocks*, which have no
    single warmth).
    """

    RANDOM = "random"
    PLATFORM = "platform"
    BEST_FIRST = "best_first"
    WARM_FIRST = "warm_first"

    @classmethod
    def parse(cls, text: str) -> "Strategy":
        try:
            return cls(text.strip())
        except ValueError:
            raise ValueError(
                f"unknown strategy {text!r}; expected one of "
                f"{[s.value for s in cls]}"
            ) from None


class TopologyTolerance(enum.Enum):
    """Failure tolerance of a ``controller`` clause (paper §3.3)."""

    ALL = "all"    # any alternative controller, any zone of workers (default)
    SAME = "same"  # alternative controller OK, workers must stay in the zone
    NONE = "none"  # no forwarding at all

    @classmethod
    def parse(cls, text: str) -> "TopologyTolerance":
        try:
            return cls(text.strip())
        except ValueError:
            raise ValueError(
                f"unknown topology_tolerance {text!r}; expected one of "
                f"{[t.value for t in cls]}"
            ) from None


class FollowupKind(enum.Enum):
    FAIL = "fail"
    DEFAULT = "default"

    @classmethod
    def parse(cls, text: str) -> "FollowupKind":
        try:
            return cls(text.strip())
        except ValueError:
            raise ValueError(
                f"unknown followup {text!r}; expected one of "
                f"{[f.value for f in cls]}"
            ) from None


class OnOverload(enum.Enum):
    """Tag-level brownout escape hatch (``on-overload:``, PR 9).

    Under sustained saturation (the platform's brownout signal), the tag
    either re-routes through a pre-compiled degraded plan —
    ``relax-affinity`` drops affinity/anti-affinity clauses,
    ``any-zone`` additionally widens designated controllers'
    ``topology_tolerance`` to ``all`` — or is shed immediately
    (``reject``) instead of queueing. Without the clause the tag is
    untouched by brownouts.
    """

    RELAX_AFFINITY = "relax-affinity"
    ANY_ZONE = "any-zone"
    REJECT = "reject"

    @classmethod
    def parse(cls, text: str) -> "OnOverload":
        try:
            return cls(text.strip())
        except ValueError:
            raise ValueError(
                f"unknown on-overload {text!r}; expected one of "
                f"{[o.value for o in cls]}"
            ) from None


# ---------------------------------------------------------------------------
# Invalidate conditions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Overload:
    """Worker lacks computational resources (platform health signal)."""

    def describe(self) -> str:
        return "overload"


@dataclasses.dataclass(frozen=True)
class CapacityUsed:
    """Worker reached a threshold percentage of capacity (CPU/HBM load)."""

    percent: float

    def __post_init__(self) -> None:
        if not (0.0 < self.percent <= 100.0):
            raise ValueError(
                f"capacity_used must be in (0, 100]; got {self.percent}"
            )

    def describe(self) -> str:
        pct = self.percent
        return f"capacity_used {int(pct) if pct == int(pct) else pct}%"


@dataclasses.dataclass(frozen=True)
class MaxConcurrentInvocations:
    """Worker reached a threshold of buffered concurrent invocations."""

    limit: int

    def __post_init__(self) -> None:
        if self.limit < 1:
            raise ValueError(
                f"max_concurrent_invocations must be >= 1; got {self.limit}"
            )

    def describe(self) -> str:
        return f"max_concurrent_invocations {self.limit}"


Invalidate = Union[Overload, CapacityUsed, MaxConcurrentInvocations]


# ---------------------------------------------------------------------------
# Affinity constraints (constraint layer v2; arXiv:2407.14572 semantics)
# ---------------------------------------------------------------------------


def _check_function_list(kind: str, functions: Tuple[str, ...]) -> None:
    if not functions:
        raise ValueError(f"{kind} requires at least one function name")
    for fn in functions:
        if not isinstance(fn, str) or not fn.strip():
            raise ValueError(f"{kind} function names must be non-empty strings")
    if len(set(functions)) != len(functions):
        raise ValueError(f"duplicate function in {kind} list: {functions}")


@dataclasses.dataclass(frozen=True)
class Affinity:
    """``affinity: <fn, ...>`` — co-location requirement.

    A worker is valid only if **every** listed function currently has at
    least one running (admitted) instance on it. Affinity gates on the live
    per-worker multiset, so a function listed here that is running nowhere
    makes the clause unsatisfiable — scripts should pair it with a fallback
    block or ``followup`` for bootstrap.
    """

    functions: Tuple[str, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "functions", tuple(self.functions))
        _check_function_list("affinity", self.functions)

    def describe(self) -> str:
        return "affinity " + ", ".join(self.functions)


@dataclasses.dataclass(frozen=True)
class AntiAffinity:
    """``anti-affinity: <fn, ...>`` — interference avoidance.

    A worker is invalid if **any** listed function currently has a running
    (admitted) instance on it. Listing a function's own name yields spread
    semantics: no two instances co-locate while alternatives exist.
    """

    functions: Tuple[str, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "functions", tuple(self.functions))
        _check_function_list("anti-affinity", self.functions)

    def describe(self) -> str:
        return "anti-affinity " + ", ".join(self.functions)


def affinity_from_value(kind: str, value) -> Tuple[str, ...]:
    """Parse an affinity function list from YAML: list form or comma string."""
    if isinstance(value, str):
        names = [part.strip() for part in value.split(",")]
    elif isinstance(value, (list, tuple)):
        names = [str(part).strip() for part in value]
    else:
        raise ValueError(
            f"{kind} expects a function list (e.g. '[fnA, fnB]' or "
            f"'fnA, fnB'); got {type(value).__name__}"
        )
    if any(not n for n in names):
        raise ValueError(f"{kind} contains an empty function name")
    return tuple(names)


# ---------------------------------------------------------------------------
# Worker items
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkerRef:
    """``wrk: label`` — one specific worker label (a singleton logical topology)."""

    label: str
    invalidate: Optional[Invalidate] = None
    affinity: Optional[Affinity] = None
    anti_affinity: Optional[AntiAffinity] = None


@dataclasses.dataclass(frozen=True)
class WorkerSet:
    """``set: label`` — a dynamically-populated set of workers.

    ``label is None`` (blank set) selects *all* workers visible to the
    controller. Sets may carry their own inner selection strategy and
    constraint clauses (paper §3.3; affinity extension).
    """

    label: Optional[str] = None
    strategy: Optional[Strategy] = None
    invalidate: Optional[Invalidate] = None
    affinity: Optional[Affinity] = None
    anti_affinity: Optional[AntiAffinity] = None


WorkerItem = Union[WorkerRef, WorkerSet]


# ---------------------------------------------------------------------------
# Blocks / tags / scripts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ControllerClause:
    label: str
    topology_tolerance: TopologyTolerance = TopologyTolerance.ALL


@dataclasses.dataclass(frozen=True)
class Block:
    """One workers-block of a policy tag."""

    workers: Tuple[WorkerItem, ...]
    controller: Optional[ControllerClause] = None
    strategy: Optional[Strategy] = None
    invalidate: Optional[Invalidate] = None
    affinity: Optional[Affinity] = None
    anti_affinity: Optional[AntiAffinity] = None
    # Load-shedding priority (PR 9): when an admission queue is full the
    # lowest-priority entrant is shed. A tag's priority is the max over
    # its blocks; unset means 0 (shed first).
    priority: Optional[int] = None

    def __post_init__(self) -> None:
        if not self.workers:
            raise ValueError("a block must list at least one workers item")
        kinds = {type(w) for w in self.workers}
        if kinds == {WorkerRef, WorkerSet}:
            # The grammar separates wrk-lists from set-lists; mixing is invalid.
            raise ValueError("a workers list cannot mix 'wrk' and 'set' items")
        if self.priority is not None and (
            not isinstance(self.priority, int) or self.priority < 0
        ):
            raise ValueError(
                f"priority must be a non-negative integer; got "
                f"{self.priority!r}"
            )

    @property
    def uses_sets(self) -> bool:
        return bool(self.workers) and isinstance(self.workers[0], WorkerSet)


@dataclasses.dataclass(frozen=True)
class TagPolicy:
    """The full policy attached to one policy tag."""

    tag: str
    blocks: Tuple[Block, ...]
    strategy: Optional[Strategy] = None  # block-selection strategy
    followup: Optional[FollowupKind] = None
    # Brownout escape hatch (PR 9): what the platform may do with this
    # tag's requests under sustained saturation. None means never degrade.
    on_overload: Optional[OnOverload] = None

    def __post_init__(self) -> None:
        if not self.blocks:
            raise ValueError(f"tag {self.tag!r} must define at least one block")

    @property
    def effective_strategy(self) -> Strategy:
        # best_first is the default block-selection policy (paper §3.3).
        return self.strategy or Strategy.BEST_FIRST

    @property
    def effective_followup(self) -> FollowupKind:
        if self.tag == DEFAULT_TAG:
            # "the followup value of the default tag is always set to fail"
            return FollowupKind.FAIL
        return self.followup or FollowupKind.DEFAULT


@dataclasses.dataclass(frozen=True)
class TappScript:
    """A parsed tAPP script: an ordered collection of tag policies."""

    tags: Tuple[TagPolicy, ...]
    source: Optional[str] = None  # original YAML text, for provenance
    version: int = 0              # bumped by the watcher on live reload

    def __post_init__(self) -> None:
        seen = set()
        for t in self.tags:
            if t.tag in seen:
                raise ValueError(f"duplicate policy tag {t.tag!r}")
            seen.add(t.tag)

    def get(self, tag: str) -> Optional[TagPolicy]:
        for t in self.tags:
            if t.tag == tag:
                return t
        return None

    @property
    def default(self) -> Optional[TagPolicy]:
        return self.get(DEFAULT_TAG)

    def tag_names(self) -> Sequence[str]:
        return [t.tag for t in self.tags]


def invalidate_from_text(text: str) -> Invalidate:
    """Parse an invalidate condition from its textual form.

    Accepted forms: ``overload``, ``capacity_used 50%``,
    ``max_concurrent_invocations 100``.
    """
    text = str(text).strip()
    if text == "overload":
        return Overload()
    if text.startswith("capacity_used"):
        rest = text[len("capacity_used"):].strip()
        if rest.endswith("%"):
            rest = rest[:-1].strip()
        if not rest:
            raise ValueError("capacity_used requires a percentage, e.g. 'capacity_used 50%'")
        try:
            return CapacityUsed(float(rest))
        except ValueError as e:
            raise ValueError(f"bad capacity_used value {rest!r}") from e
    if text.startswith("max_concurrent_invocations"):
        rest = text[len("max_concurrent_invocations"):].strip()
        if not rest:
            raise ValueError(
                "max_concurrent_invocations requires a count, e.g. "
                "'max_concurrent_invocations 100'"
            )
        try:
            return MaxConcurrentInvocations(int(rest))
        except ValueError as e:
            raise ValueError(f"bad max_concurrent_invocations value {rest!r}") from e
    raise ValueError(
        f"unknown invalidate condition {text!r}; expected 'overload', "
        f"'capacity_used n%', or 'max_concurrent_invocations n'"
    )
