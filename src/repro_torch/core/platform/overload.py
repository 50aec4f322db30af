"""Overload-resilience layer (PR 9): admission queues, load shedding,
circuit breakers, and brownout degradation.

The scheduler through PR 8 decides *where* a function runs but has no
story for *when the cluster cannot run it*: a saturated ``ItemIndex``
answers "unplaced" in O(1) and the request is simply lost, and a slow
or partitioned remote zone is re-probed on every federated forward.
This module supplies the four missing mechanisms, all **opt-in** and
off by default — with no :class:`OverloadSpec` configured, placements,
traces, RNG streams, cursors, and ledger counters are bit-identical to
the pre-overload platform (property-tested):

* :class:`QueueSpec` / :class:`AdmissionQueue` — a bounded per-zone
  admission queue with a FIFO or EDF (earliest-deadline-first)
  discipline. An ``invoke`` that finds no capacity enqueues instead of
  failing; ledger completions drain the queue through the existing
  O(1) index path. Entries whose deadline passed are counted as
  ``deadline_exceeded`` and never placed.
* priority load shedding — when a queue is full, the lowest-priority
  entrant is shed (tAPP blocks carry a ``priority:`` clause; a tag's
  priority is the max over its blocks).
* :class:`BreakerSpec` / :class:`CircuitBreaker` — a closed → open →
  half-open breaker keyed by (source, target) zone on the federated
  forwarding path, fed by forward failures and RTT-budget violations,
  so a dead or saturated zone stops consuming forward attempts until
  a half-open probe succeeds. Cooldown is measured in suppressed
  attempts (not wall time) so behaviour stays deterministic.
* :class:`BrownoutSpec` / :class:`BrownoutController` +
  :func:`degrade_script` — under sustained saturation (queue depth at
  or above a high-water mark for N consecutive observations), tags
  that opt in via ``on-overload:`` re-route through a pre-compiled
  degraded plan (soft constraints dropped; tolerance widened for
  ``any-zone``), reverting at the low-water mark. The degraded plan is
  compiled and statically verified at ``apply_policy`` time like the
  primary plan, so a brownout can never swap in a plan with
  proven-unplaceable tags.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tapp.ast import (
    Block,
    ControllerClause,
    OnOverload,
    TagPolicy,
    TappScript,
    TopologyTolerance,
    WorkerRef,
    WorkerSet,
)

__all__ = [
    "AdmissionQueue",
    "BreakerSpec",
    "BrownoutController",
    "BrownoutSpec",
    "CircuitBreaker",
    "OverloadSpec",
    "QueueEntry",
    "QueueSpec",
    "degrade_script",
]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QueueSpec:
    """Bounded deadline-aware admission queue configuration (per zone).

    ``deadline`` bounds how long an entry may wait before it is counted
    as ``deadline_exceeded`` (None: entries never expire); ``discipline``
    picks the drain order: ``fifo`` (arrival order) or ``edf``
    (earliest absolute deadline first; deadline-less entries last).
    """

    depth: int = 64
    deadline: Optional[float] = None
    discipline: str = "fifo"

    def __post_init__(self) -> None:
        if self.depth <= 0:
            raise ValueError(f"queue depth must be positive, got {self.depth}")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(
                f"queue deadline must be positive, got {self.deadline}"
            )
        if self.discipline not in ("fifo", "edf"):
            raise ValueError(
                f"unknown queue discipline {self.discipline!r}; "
                f"expected 'fifo' or 'edf'"
            )


@dataclasses.dataclass(frozen=True)
class BreakerSpec:
    """Per-(source, target)-zone circuit breaker on forwarding.

    ``failure_threshold`` consecutive forward failures open the circuit;
    while open, every ``probe_interval``-th suppressed attempt is let
    through as a half-open probe (deterministic: cooldown is counted in
    suppressed attempts, not wall time). ``rtt_budget`` (seconds)
    additionally counts a *successful* forward whose hop RTT exceeds
    the budget as a failure — the slow-zone feed.
    """

    failure_threshold: int = 3
    probe_interval: int = 8
    rtt_budget: Optional[float] = None

    def __post_init__(self) -> None:
        if self.failure_threshold <= 0:
            raise ValueError(
                f"failure_threshold must be positive, got "
                f"{self.failure_threshold}"
            )
        if self.probe_interval <= 0:
            raise ValueError(
                f"probe_interval must be positive, got {self.probe_interval}"
            )
        if self.rtt_budget is not None and self.rtt_budget <= 0:
            raise ValueError(
                f"rtt_budget must be positive, got {self.rtt_budget}"
            )


@dataclasses.dataclass(frozen=True)
class BrownoutSpec:
    """Hysteresis band for brownout degradation.

    Brownout activates after queue depth has been observed at or above
    ``high_water`` for ``sustain`` consecutive observations, and
    deactivates the first time depth falls to ``low_water`` or below.
    Between the marks the current state holds (hysteresis).
    """

    high_water: int = 8
    low_water: int = 2
    sustain: int = 3

    def __post_init__(self) -> None:
        if self.high_water <= 0:
            raise ValueError(
                f"high_water must be positive, got {self.high_water}"
            )
        if self.low_water < 0:
            raise ValueError(
                f"low_water must be non-negative, got {self.low_water}"
            )
        if self.low_water >= self.high_water:
            raise ValueError(
                f"low_water ({self.low_water}) must be below high_water "
                f"({self.high_water})"
            )
        if self.sustain <= 0:
            raise ValueError(f"sustain must be positive, got {self.sustain}")


@dataclasses.dataclass(frozen=True)
class OverloadSpec:
    """Umbrella opt-in: any combination of queue / breaker / brownout.

    Brownout requires a queue (its signal is queue depth).
    """

    queue: Optional[QueueSpec] = None
    breaker: Optional[BreakerSpec] = None
    brownout: Optional[BrownoutSpec] = None

    def __post_init__(self) -> None:
        if self.brownout is not None and self.queue is None:
            raise ValueError(
                "brownout requires a queue (its saturation signal is "
                "queue depth); set OverloadSpec.queue too"
            )


# ---------------------------------------------------------------------------
# Admission queue
# ---------------------------------------------------------------------------


class QueueEntry:
    """One queued (unplaced) invocation awaiting capacity."""

    __slots__ = ("placement", "priority", "enqueued_at", "deadline", "seq")

    def __init__(self, placement, priority: int, enqueued_at: Optional[float],
                 deadline: Optional[float], seq: int) -> None:
        self.placement = placement
        self.priority = priority
        self.enqueued_at = enqueued_at
        self.deadline = deadline  # absolute; None = never expires
        self.seq = seq


class AdmissionQueue:
    """A bounded deadline-aware queue of unplaced invocations.

    Depth is small and bounded (``QueueSpec.depth``), so linear scans
    are cheap and keep the implementation obviously correct; the hot
    invoke path never touches this class unless routing already failed.
    """

    def __init__(self, spec: QueueSpec) -> None:
        self.spec = spec
        self._entries: List[QueueEntry] = []
        self._seq = 0
        self._lock = threading.Lock()
        # Counters (monotonic).
        self.queued_total = 0
        self.shed = 0
        self.deadline_exceeded = 0
        self.drained = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def depth(self) -> int:
        return len(self._entries)

    def offer(
        self, placement, priority: int, now: Optional[float]
    ) -> Tuple[str, Optional[QueueEntry]]:
        """Enqueue a placement, shedding the lowest-priority entrant if
        full. Returns ``("queued", entry)`` when the newcomer got a
        slot, or ``("shed", victim_entry)`` — the victim is the
        newcomer itself unless a lower-priority queued entry was
        evicted to make room."""
        deadline = None
        if self.spec.deadline is not None and now is not None:
            deadline = now + self.spec.deadline
        with self._lock:
            self._seq += 1
            entry = QueueEntry(placement, priority, now, deadline, self._seq)
            if len(self._entries) < self.spec.depth:
                self._entries.append(entry)
                self.queued_total += 1
                return "queued", entry
            # Full: shed the lowest-priority entrant. Ties break toward
            # the youngest queued entry (preserves FIFO fairness among
            # equals); the newcomer loses ties against incumbents.
            victim = min(self._entries, key=lambda e: (e.priority, -e.seq))
            if victim.priority >= priority:
                self.shed += 1
                return "shed", entry
            self._entries.remove(victim)
            self._entries.append(entry)
            self.queued_total += 1
            self.shed += 1
            return "shed", victim

    def expire(self, now: Optional[float]) -> List[QueueEntry]:
        """Remove (and count) every entry whose deadline has passed."""
        if now is None:
            return []
        with self._lock:
            expired = [
                e for e in self._entries
                if e.deadline is not None and e.deadline < now
            ]
            if expired:
                self._entries = [
                    e for e in self._entries if e not in expired
                ]
                self.deadline_exceeded += len(expired)
        return expired

    def head(self) -> Optional[QueueEntry]:
        """The entry the discipline would drain next (not removed)."""
        with self._lock:
            if not self._entries:
                return None
            if self.spec.discipline == "edf":
                return min(
                    self._entries,
                    key=lambda e: (
                        e.deadline if e.deadline is not None else float("inf"),
                        e.seq,
                    ),
                )
            return self._entries[0]

    def remove(self, entry: QueueEntry, *, drained: bool) -> bool:
        """Take one entry out (drain success, or external cancellation)."""
        with self._lock:
            try:
                self._entries.remove(entry)
            except ValueError:
                return False
            if drained:
                self.drained += 1
            return True

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "depth": len(self._entries),
                "queued_total": self.queued_total,
                "shed": self.shed,
                "deadline_exceeded": self.deadline_exceeded,
                "drained": self.drained,
            }


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


class _BreakerState:
    __slots__ = ("failures", "open", "suppressed", "probing")

    def __init__(self) -> None:
        self.failures = 0
        self.open = False
        self.suppressed = 0
        self.probing = False


class CircuitBreaker:
    """Closed → open → half-open breaker keyed by (source, target) zone.

    Deterministic by construction: the open-state cooldown is counted
    in *suppressed attempts* rather than wall time — while open, every
    ``probe_interval``-th suppressed attempt is let through as a
    half-open probe. A probe success closes the circuit; a probe
    failure restarts the cooldown.
    """

    def __init__(self, spec: BreakerSpec) -> None:
        self.spec = spec
        self._states: Dict[Tuple[str, str], _BreakerState] = {}
        self._lock = threading.Lock()

    def _state(self, source: str, target: str) -> _BreakerState:
        key = (source, target)
        state = self._states.get(key)
        if state is None:
            state = self._states[key] = _BreakerState()
        return state

    def allow(self, source: str, target: str) -> bool:
        """May ``source`` attempt a forward to ``target`` right now?"""
        with self._lock:
            state = self._states.get((source, target))
            if state is None or not state.open:
                return True
            state.suppressed += 1
            if state.suppressed % self.spec.probe_interval == 0:
                state.probing = True
                return True  # half-open probe
            return False

    def record_success(
        self, source: str, target: str, *, rtt: Optional[float] = None
    ) -> None:
        """A forward to ``target`` succeeded. An RTT above the budget
        still counts as a failure (the slow-zone feed)."""
        if (self.spec.rtt_budget is not None and rtt is not None
                and rtt > self.spec.rtt_budget):
            self.record_failure(source, target)
            return
        with self._lock:
            state = self._states.get((source, target))
            if state is None:
                return
            state.failures = 0
            state.open = False
            state.suppressed = 0
            state.probing = False

    def record_failure(self, source: str, target: str) -> None:
        with self._lock:
            state = self._state(source, target)
            if state.open:
                # Probe failed (or a straggler attempt): restart cooldown.
                state.suppressed = 0
                state.probing = False
                return
            state.failures += 1
            if state.failures >= self.spec.failure_threshold:
                state.open = True
                state.suppressed = 0

    def is_open(self, source: str, target: str) -> bool:
        with self._lock:
            state = self._states.get((source, target))
            return state is not None and state.open

    def open_circuits(self) -> Tuple[Tuple[str, str], ...]:
        with self._lock:
            return tuple(sorted(
                key for key, state in self._states.items() if state.open
            ))

    def snapshot(self) -> Dict[Tuple[str, str], Dict[str, int]]:
        with self._lock:
            return {
                key: {
                    "failures": state.failures,
                    "open": int(state.open),
                    "suppressed": state.suppressed,
                }
                for key, state in self._states.items()
            }


# ---------------------------------------------------------------------------
# Brownout
# ---------------------------------------------------------------------------


class BrownoutController:
    """Hysteresis tracker turning queue depth into a brownout bit."""

    def __init__(self, spec: BrownoutSpec) -> None:
        self.spec = spec
        self.active = False
        self.activations = 0
        self._above = 0

    def observe(self, depth: int) -> bool:
        """Feed one queue-depth observation; returns the brownout bit."""
        if depth >= self.spec.high_water:
            self._above += 1
            if not self.active and self._above >= self.spec.sustain:
                self.active = True
                self.activations += 1
        elif depth <= self.spec.low_water:
            self._above = 0
            self.active = False
        # Between the marks: hold state, but a dip below high_water
        # breaks the activation streak.
        elif not self.active:
            self._above = 0
        return self.active


def _degrade_item(item):
    if isinstance(item, WorkerRef):
        if item.affinity is None and item.anti_affinity is None:
            return item
        return dataclasses.replace(item, affinity=None, anti_affinity=None)
    if isinstance(item, WorkerSet):
        if item.affinity is None and item.anti_affinity is None:
            return item
        return dataclasses.replace(item, affinity=None, anti_affinity=None)
    return item


def _degrade_block(block: Block, mode: OnOverload) -> Block:
    controller = block.controller
    if (mode is OnOverload.ANY_ZONE and controller is not None
            and controller.topology_tolerance is not TopologyTolerance.ALL):
        controller = ControllerClause(
            label=controller.label,
            topology_tolerance=TopologyTolerance.ALL,
        )
    return dataclasses.replace(
        block,
        controller=controller,
        affinity=None,
        anti_affinity=None,
        workers=tuple(_degrade_item(item) for item in block.workers),
    )


def _degrade_tag(tag: TagPolicy) -> TagPolicy:
    mode = tag.on_overload
    if mode is None or mode is OnOverload.REJECT:
        # REJECT is handled at admission time (immediate shed under
        # brownout); the plan itself is unchanged.
        return tag
    return dataclasses.replace(
        tag,
        blocks=tuple(_degrade_block(block, mode) for block in tag.blocks),
    )


def degrade_script(script: TappScript) -> Optional[TappScript]:
    """The pre-compiled brownout plan: soft constraints dropped.

    For every tag with ``on-overload: relax-affinity``, affinity /
    anti-affinity clauses are removed (block- and item-level);
    ``any-zone`` additionally widens designated controllers'
    ``topology_tolerance`` to ``all`` so federated forwarding may
    escape the home zone. Tags without an ``on-overload`` clause (and
    ``reject`` tags) pass through untouched. Returns ``None`` when no
    tag opts into a degraded *plan* — then there is nothing to
    pre-compile or verify.
    """
    if not any(
        tag.on_overload in (OnOverload.RELAX_AFFINITY, OnOverload.ANY_ZONE)
        for tag in script.tags
    ):
        return None
    return dataclasses.replace(
        script,
        tags=tuple(_degrade_tag(tag) for tag in script.tags),
    )
