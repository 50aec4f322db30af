"""Semantic validation of parsed tAPP scripts.

Validation is split from parsing so the watcher can re-validate scripts
against the *live* topology (unknown controller labels, unknown worker
labels, empty sets) and surface warnings without rejecting the script —
the paper's semantics treats unknown/unreachable workers as invalidated,
not as parse errors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.tapp.ast import (
    DEFAULT_TAG,
    FollowupKind,
    Strategy,
    TagPolicy,
    TappScript,
    WorkerRef,
    WorkerSet,
)


def _affinity_conflicts(item, block) -> Sequence[str]:
    """Functions required present AND absent by the *effective* constraints.

    Effective clauses follow the same item ▸ block resolution rule the
    engine applies, so a conflict here means the worker item can never be
    valid while either function runs — almost certainly a script bug.
    """
    affinity = item.affinity if item.affinity is not None else block.affinity
    anti = (
        item.anti_affinity
        if item.anti_affinity is not None
        else block.anti_affinity
    )
    if affinity is None or anti is None:
        return ()
    return sorted(set(affinity.functions) & set(anti.functions))


@dataclasses.dataclass(frozen=True)
class Finding:
    level: str  # "error" | "warning"
    where: str
    message: str
    # What kind of rule produced the finding: "structure" (grammar-level
    # invariants), "topology" (references that match nothing in the live
    # deployment), "constraint" (unsatisfiable constraint combinations),
    # or one of the static-analysis categories "reachability" /
    # "satisfiability" / "starvation" produced by
    # :mod:`repro_torch.core.analysis`. The platform's strict policy mode
    # promotes non-structure warnings to rejections; plain validation
    # treats all warnings as advisory.
    category: str = "structure"
    # True when the finding is a *proof* (the analyzer established the
    # property holds under every admissible execution, not just a lint
    # heuristic). Strict policy mode treats proofs as deploy blockers.
    proof: bool = False

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        mark = "/proof" if self.proof else ""
        return f"[{self.level}{mark}] {self.where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    findings: tuple

    @property
    def errors(self) -> Sequence[Finding]:
        return [f for f in self.findings if f.level == "error"]

    @property
    def warnings(self) -> Sequence[Finding]:
        return [f for f in self.findings if f.level == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_on_error(self) -> None:
        if self.errors:
            raise TappValidationError(self)


class TappValidationError(ValueError):
    def __init__(self, report: ValidationReport) -> None:
        self.report = report
        msgs = "; ".join(str(f) for f in report.errors)
        super().__init__(f"tAPP validation failed: {msgs}")


def validate_script(
    script: TappScript,
    *,
    known_controllers: Optional[Sequence[str]] = None,
    known_worker_labels: Optional[Sequence[str]] = None,
    known_set_labels: Optional[Sequence[str]] = None,
) -> ValidationReport:
    """Validate a script, optionally against a live topology snapshot.

    Structural rules (always errors):
      * ``followup: default`` on the default tag itself (the paper pins the
        default tag's followup to ``fail``);
      * ``strategy: warm-first`` at tag level — block selection has no
        single warmth to rank by (the engine degrades it to best_first,
        so the script never does what it says);
      * a non-default tag with ``followup: default`` (explicit or implied)
        while the script has no default tag → warning (the scheduler will
        treat the missing default as ``fail``).
    Topology rules (warnings, since membership is dynamic):
      * controller labels not present in the deployment;
      * wrk/set labels that match nothing right now.
    Dead-code lints (structure warnings — valid scripts, likely mistakes):
      * the same wrk label or set label listed twice in one block (the
        duplicate item can never be selected before its twin invalidates,
        so it is almost always a copy-paste slip);
      * worker sets declared in the deployment but referenced by no block
        (dead deployment metadata, or a typo in the script) — suppressed
        when any block uses the blank set, which reaches every set member;
      * block-level ``warm-first`` on a set list whose every set declares
        its own (non-warm-first) inner strategy: the block strategy only
        orders the *sets* and member ordering never sees warm-first.
    """
    findings: List[Finding] = []

    for tag in script.tags:
        where = f"tag:{tag.tag}"
        if tag.tag == DEFAULT_TAG and tag.followup is FollowupKind.DEFAULT:
            findings.append(
                Finding(
                    "error",
                    where,
                    "the default tag cannot use 'followup: default' "
                    "(it is always 'fail')",
                )
            )
        if tag.strategy is Strategy.WARM_FIRST:
            findings.append(
                Finding(
                    "error",
                    where,
                    "strategy 'warm-first' ranks workers by warm-instance "
                    "availability; at tag level it would order blocks, "
                    "which have no single warmth — declare it on a block "
                    "or worker set instead",
                )
            )
        if (
            tag.tag != DEFAULT_TAG
            and tag.effective_followup is FollowupKind.DEFAULT
            and script.default is None
        ):
            findings.append(
                Finding(
                    "warning",
                    where,
                    "followup resolves to 'default' but the script defines no "
                    "default tag; scheduling will fail when the tag is exhausted",
                )
            )
        findings.extend(_validate_tag_topology(
            tag,
            known_controllers=known_controllers,
            known_worker_labels=known_worker_labels,
            known_set_labels=known_set_labels,
        ))

    findings.extend(_lint_unreferenced_sets(script, known_set_labels))
    return ValidationReport(findings=tuple(findings))


def _lint_unreferenced_sets(
    script: TappScript, known_set_labels: Optional[Sequence[str]]
) -> List[Finding]:
    """Declared worker sets no block references (dead deployment metadata)."""
    if known_set_labels is None:
        return []
    referenced = set()
    for tag in script.tags:
        for block in tag.blocks:
            for item in block.workers:
                if isinstance(item, WorkerSet):
                    if item.label is None:
                        # The blank set selects every worker, so every
                        # declared set is (implicitly) in play.
                        return []
                    referenced.add(item.label)
    unused = sorted(set(known_set_labels) - referenced)
    if not unused:
        return []
    return [
        Finding(
            "warning",
            "script",
            f"worker sets {unused} are declared in the deployment but "
            f"referenced by no block",
        )
    ]


def _lint_duplicate_items(block, where: str) -> List[Finding]:
    """The same wrk/set label listed more than once within one block."""
    findings: List[Finding] = []
    wrk_labels: List[str] = []
    set_labels: List[Optional[str]] = []
    for item in block.workers:
        if isinstance(item, WorkerRef):
            wrk_labels.append(item.label)
        elif isinstance(item, WorkerSet):
            set_labels.append(item.label)
    for label in sorted({w for w in wrk_labels if wrk_labels.count(w) > 1}):
        findings.append(
            Finding(
                "warning",
                where,
                f"worker {label!r} is listed {wrk_labels.count(label)} times "
                f"in this block; the duplicates are dead items",
            )
        )
    dup_sets = {s for s in set_labels if set_labels.count(s) > 1}
    for label in sorted(dup_sets, key=lambda s: (s is None, s)):
        shown = "the blank set" if label is None else f"set {label!r}"
        findings.append(
            Finding(
                "warning",
                where,
                f"{shown} is listed {set_labels.count(label)} times in this "
                f"block; the duplicate members are dead items",
            )
        )
    return findings


def _validate_tag_topology(
    tag: TagPolicy,
    *,
    known_controllers: Optional[Sequence[str]],
    known_worker_labels: Optional[Sequence[str]],
    known_set_labels: Optional[Sequence[str]],
) -> List[Finding]:
    findings: List[Finding] = []
    for bi, block in enumerate(tag.blocks):
        where = f"tag:{tag.tag}.block[{bi}]"
        findings.extend(_lint_duplicate_items(block, where))
        if (
            block.strategy is Strategy.WARM_FIRST
            and block.uses_sets
            and all(
                isinstance(item, WorkerSet)
                and item.strategy is not None
                and item.strategy is not Strategy.WARM_FIRST
                for item in block.workers
            )
        ):
            findings.append(
                Finding(
                    "warning",
                    where,
                    "block-level 'warm-first' on a set list only orders the "
                    "sets; every set here declares its own inner strategy, "
                    "so member ordering never sees warm-first — declare "
                    "'strategy: warm-first' on the sets to try warm members "
                    "first",
                )
            )
        if (
            block.controller is not None
            and known_controllers is not None
            and block.controller.label not in known_controllers
        ):
            findings.append(
                Finding(
                    "warning",
                    where,
                    f"controller {block.controller.label!r} is not present in "
                    f"the current deployment",
                    category="topology",
                )
            )
        for wi, item in enumerate(block.workers):
            iwhere = f"{where}.workers[{wi}]"
            conflicts = _affinity_conflicts(item, block)
            if conflicts:
                findings.append(
                    Finding(
                        "warning",
                        iwhere,
                        f"functions {conflicts} appear in both the effective "
                        f"affinity and anti-affinity lists; the item is "
                        f"unsatisfiable whenever they run",
                        category="constraint",
                    )
                )
            if isinstance(item, WorkerRef):
                if (
                    known_worker_labels is not None
                    and item.label not in known_worker_labels
                ):
                    findings.append(
                        Finding(
                            "warning",
                            iwhere,
                            f"worker label {item.label!r} matches no live worker",
                            category="topology",
                        )
                    )
            elif isinstance(item, WorkerSet):
                if (
                    item.label is not None
                    and known_set_labels is not None
                    and item.label not in known_set_labels
                ):
                    findings.append(
                        Finding(
                            "warning",
                            iwhere,
                            f"worker set {item.label!r} currently has no members",
                            category="topology",
                        )
                    )
    return findings
