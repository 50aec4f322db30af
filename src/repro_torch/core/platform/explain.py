"""Typed scheduling explanations built from the engine's trace machinery.

``TappPlatform.explain`` evaluates an invocation with tracing on and
lifts the flat :class:`~repro_torch.core.scheduler.engine.TraceEvent` stream
into a structured report: per-block controller resolution notes and
per-worker candidate verdicts (valid, or the first violated constraint),
plus the tag/followup narration. The trace strings stay the single
source of truth — this module only parses the shapes the engine and the
vanilla baseline emit, so interpreter, compiled, and vanilla paths all
explain identically.

``TappFederation.explain`` stacks one of these reports per zone the
request visited: the entry zone's zone-local pass, then each forwarding
hop with the RTT the network model charged it — the
:class:`FederationExplainReport` per-zone forwarding hop report.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scheduler.engine import (
    Invocation,
    ScheduleDecision,
    TraceEvent,
)

_BLOCK_RE = re.compile(r"^block\[(\d+)\]: (.*)$", re.S)


@dataclasses.dataclass(frozen=True)
class CandidateReport:
    """One worker's verdict inside one block evaluation."""

    worker: str
    valid: bool
    reason: Optional[str]  # first violated constraint; None when valid
    detail: str            # the raw trace detail
    # True when the static analyzer proved the active policy can never
    # place this invocation's tag on the worker — the rejection is a
    # property of the (policy × topology), not of current load.
    inevitable: bool = False
    # Warm-pool verdict (PR 10): does this worker hold an idle warm
    # instance of the invocation's function right now? None when the
    # lifecycle layer is unarmed (no warm/cold distinction exists).
    warm: Optional[bool] = None

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        verdict = "valid" if self.valid else f"rejected — {self.reason}"
        if self.inevitable:
            verdict += " (statically inevitable)"
        if self.warm is not None:
            verdict += " [warm]" if self.warm else " [cold]"
        return f"{self.worker}: {verdict}"


@dataclasses.dataclass(frozen=True)
class BlockReport:
    """One scheduling block's evaluation: controller resolution + verdicts."""

    index: Optional[int]   # block index in the tag (None: vanilla baseline)
    controller_notes: Tuple[str, ...]
    candidates: Tuple[CandidateReport, ...]

    @property
    def rejected(self) -> Tuple[CandidateReport, ...]:
        return tuple(c for c in self.candidates if not c.valid)


@dataclasses.dataclass(frozen=True)
class ExplainReport:
    """The full structured answer to "why did/didn't this schedule?"."""

    invocation: Invocation
    scheduled: bool
    worker: Optional[str]
    controller: Optional[str]
    tag: Optional[str]
    used_default_fallback: bool
    zone_restriction: Optional[str]
    failed_by_policy: bool
    blocks: Tuple[BlockReport, ...]
    notes: Tuple[str, ...]          # tag / followup narration, in order
    trace: Tuple[TraceEvent, ...]   # the raw events, for provenance
    # Failure-detector / partition narration (PR 6): why the platform
    # layer overrode or annotated this decision (e.g. a designated
    # placement severed by an inter-zone partition).
    failure_notes: Tuple[str, ...] = ()
    # Workers whose rejections the static analyzer proved inevitable
    # (PR 8): the active policy can never place this tag on them, under
    # any load — distinct from dynamic (load-dependent) rejections.
    inevitable_workers: Tuple[str, ...] = ()

    def rejections(self) -> Dict[str, str]:
        """worker → last rejection reason across every block evaluated."""
        out: Dict[str, str] = {}
        for block in self.blocks:
            for candidate in block.candidates:
                if not candidate.valid and candidate.reason is not None:
                    out[candidate.worker] = candidate.reason
        return out

    def render(self) -> str:
        """Human-readable summary (the structured sibling of `explain()`)."""
        head = (
            f"{self.invocation.function!r} tag={self.invocation.tag!r} → "
            + (
                f"worker={self.worker} controller={self.controller}"
                if self.scheduled
                else "NOT SCHEDULED"
                + (" (failed by policy)" if self.failed_by_policy else "")
            )
        )
        lines = [head]
        if self.inevitable_workers:
            lines.append(
                "  ! statically inevitable rejections: "
                + ", ".join(self.inevitable_workers)
            )
        for note in self.failure_notes:
            lines.append(f"  ! {note}")
        for note in self.notes:
            lines.append(f"  · {note}")
        for block in self.blocks:
            label = "block" if block.index is None else f"block[{block.index}]"
            for note in block.controller_notes:
                lines.append(f"  {label}: {note}")
            for candidate in block.candidates:
                lines.append(f"    {candidate}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class ZoneHopReport:
    """One zone's view of a federated evaluation.

    The first hop is always the entry zone's zone-local pass
    (``forwarded=False``, ``rtt=0``); subsequent hops are forwarding
    attempts in the order the federation tried them, each carrying the
    inter-zone RTT the network model charged for the hop.
    """

    zone: str
    rtt: float
    forwarded: bool
    report: ExplainReport

    @property
    def scheduled(self) -> bool:
        return self.report.scheduled


@dataclasses.dataclass(frozen=True)
class FederationExplainReport:
    """Why a federated invocation landed where it did, hop by hop."""

    invocation: Invocation
    entry_zone: str
    scheduled: bool
    worker: Optional[str]
    controller: Optional[str]
    placement_zone: Optional[str]
    forward_rtt: float               # total RTT charged across hops
    hops: Tuple[ZoneHopReport, ...]
    # Zones the entry zone could not reach when this report was built
    # (inter-zone partitions + all-workers-DEAD zones); the forwarding
    # walk skipped them (PR 6).
    unreachable_zones: Tuple[str, ...] = ()
    # Overload layer (PR 9): the entry zone's admission-queue state line
    # (None when the queue layer is off) and the (source, target) circuit
    # breakers currently open — an open breaker suppresses the forwarding
    # walk down to its half-open probe rate.
    overload_note: Optional[str] = None
    open_circuits: Tuple[Tuple[str, str], ...] = ()

    @property
    def forwarded(self) -> bool:
        """Did the request leave its entry zone (placement or attempts)?"""
        return self.placement_zone not in (None, self.entry_zone) or any(
            h.forwarded for h in self.hops
        )

    def rejections(self) -> Dict[str, str]:
        """worker → last rejection reason across every zone evaluated."""
        out: Dict[str, str] = {}
        for hop in self.hops:
            out.update(hop.report.rejections())
        return out

    def render(self) -> str:
        head = (
            f"{self.invocation.function!r} tag={self.invocation.tag!r} "
            f"entry={self.entry_zone!r} → "
            + (
                f"worker={self.worker} controller={self.controller} "
                f"zone={self.placement_zone}"
                + (
                    f" (forwarded, +{self.forward_rtt * 1e3:.1f}ms)"
                    if self.forwarded else ""
                )
                if self.scheduled
                else "NOT SCHEDULED"
            )
        )
        lines = [head]
        if self.unreachable_zones:
            lines.append(
                "  ! unreachable zones: "
                + ", ".join(repr(z) for z in self.unreachable_zones)
            )
        if self.open_circuits:
            lines.append(
                "  ! open circuits: "
                + ", ".join(f"{s!r}→{t!r}" for s, t in self.open_circuits)
            )
        if self.overload_note is not None:
            lines.append(f"  {self.overload_note}")
        for hop in self.hops:
            label = (
                f"zone {hop.zone!r} (entry pass)"
                if not hop.forwarded
                else f"zone {hop.zone!r} (forwarded, +{hop.rtt * 1e3:.1f}ms)"
            )
            lines.append(f"-- {label} --")
            lines.extend("  " + line for line in hop.report.render().splitlines())
        return "\n".join(lines)


def annotate_inevitable(
    report: ExplainReport, selectable: frozenset
) -> ExplainReport:
    """Mark rejected candidates outside the statically-selectable set.

    ``selectable`` is the analyzer's verdict for the invocation's
    resolved tag (workers some admission sequence can place it on); a
    rejected candidate outside it is statically inevitable — no load
    state would have changed the outcome.
    """
    blocks: List[BlockReport] = []
    doomed: set = set()
    changed = False
    for block in report.blocks:
        candidates = []
        for c in block.candidates:
            if not c.valid and c.worker not in selectable:
                candidates.append(dataclasses.replace(c, inevitable=True))
                doomed.add(c.worker)
                changed = True
            else:
                candidates.append(c)
        blocks.append(dataclasses.replace(block, candidates=tuple(candidates)))
    if not changed:
        return report
    return dataclasses.replace(
        report,
        blocks=tuple(blocks),
        inevitable_workers=tuple(sorted(doomed)),
    )


def annotate_warmth(report: ExplainReport, is_warm) -> ExplainReport:
    """Stamp every candidate's warm/cold verdict (armed platforms only).

    ``is_warm`` maps a worker name to whether it holds an idle warm
    instance of the report's function — the same ``warm_idle`` signal
    the ``warm-first`` strategy ranks by, so the report shows exactly
    the ordering evidence the scheduler saw.
    """
    blocks: List[BlockReport] = []
    changed = False
    for block in report.blocks:
        candidates = []
        for c in block.candidates:
            candidates.append(
                dataclasses.replace(c, warm=bool(is_warm(c.worker)))
            )
            changed = True
        blocks.append(dataclasses.replace(block, candidates=tuple(candidates)))
    if not changed:
        return report
    return dataclasses.replace(report, blocks=tuple(blocks))


def _parse_candidate(detail: str) -> CandidateReport:
    worker, _, rest = detail.partition(": ")
    if rest.startswith("VALID"):
        return CandidateReport(worker=worker, valid=True, reason=None,
                               detail=detail)
    reason = rest
    if reason.startswith("invalid — "):
        reason = reason[len("invalid — "):]
    return CandidateReport(worker=worker, valid=False, reason=reason,
                           detail=detail)


def build_explain_report(
    invocation: Invocation, decision: ScheduleDecision
) -> ExplainReport:
    """Lift a traced decision into the typed per-block/per-worker report."""
    blocks: List[BlockReport] = []
    notes: List[str] = []
    cur_index: Optional[int] = None
    cur_notes: List[str] = []
    cur_candidates: List[CandidateReport] = []
    started = False

    def flush() -> None:
        nonlocal cur_notes, cur_candidates, started
        if started:
            blocks.append(
                BlockReport(
                    index=cur_index,
                    controller_notes=tuple(cur_notes),
                    candidates=tuple(cur_candidates),
                )
            )
        cur_notes, cur_candidates, started = [], [], False

    for event in decision.trace:
        if event.kind == "controller":
            match = _BLOCK_RE.match(event.detail)
            index = int(match.group(1)) if match else None
            note = match.group(2) if match else event.detail
            # A controller event opens a new block report unless it is a
            # continuation of the same block (the gateway retrying the next
            # round-robin controller inside one controller-less block).
            if started and index != cur_index:
                flush()
            started = True
            cur_index = index
            cur_notes.append(note)
        elif event.kind == "candidate":
            started = True
            if ": " in event.detail:
                cur_candidates.append(_parse_candidate(event.detail))
            else:
                # Worker-less narration ("no workers") — a block note, not
                # a pseudo-worker rejection.
                cur_notes.append(event.detail)
        else:  # "tag" | "followup"
            flush()
            cur_index = None
            notes.append(event.detail)
    flush()

    return ExplainReport(
        invocation=invocation,
        scheduled=decision.scheduled,
        worker=decision.worker,
        controller=decision.controller,
        tag=decision.tag,
        used_default_fallback=decision.used_default_fallback,
        zone_restriction=decision.zone_restriction,
        failed_by_policy=decision.failed_by_policy,
        blocks=tuple(blocks),
        notes=tuple(notes),
        trace=tuple(decision.trace),
    )
