"""Policy lifecycle types: dry-run reports, versioned handles, errors.

The platform treats a tAPP script like a deployment artifact: it is
parsed, **dry-run against the live topology** (unknown controllers /
worker labels / set labels, contradictory affinity lists), compiled,
**statically analyzed** (reachability / satisfiability / starvation, the
questions of arXiv:2407.14159 answered at apply time by
:mod:`repro_torch.core.analysis`), and only then atomically swapped in — with a
bounded history so ``rollback`` can restore the previous policy
bit-for-bit. The findings surface *before* the script starts steering
live traffic; strict mode additionally treats analyzer *proofs* (tags no
admission sequence can ever place) as deploy blockers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.analysis import AnalysisReport
from repro_torch.core.tapp.ast import TappScript
from repro_torch.core.tapp.validate import Finding, ValidationReport


class PolicyError(ValueError):
    """A policy could not be applied / rolled back."""

    def __init__(self, message: str, findings: Sequence[Finding] = ()) -> None:
        self.findings = tuple(findings)
        if self.findings:
            detail = "; ".join(str(f) for f in self.findings)
            message = f"{message}: {detail}"
        super().__init__(message)


# Render order: grammar-level first, then live-topology checks, then the
# static-analysis categories (unknown categories sort last, in input order).
_CATEGORY_ORDER = (
    "structure",
    "topology",
    "constraint",
    "reachability",
    "satisfiability",
    "starvation",
)


@dataclasses.dataclass(frozen=True)
class PolicyDryRun:
    """What applying a script *would* do, checked against live topology."""

    report: ValidationReport
    # Topology snapshot the script was checked against (for the record).
    known_zones: Tuple[str, ...]
    known_sets: Tuple[str, ...]
    known_controllers: Tuple[str, ...]
    # Static plan analysis (reachability/satisfiability/starvation); None
    # when the script could not be lowered (the interpreter path accepts
    # scripts the compiler cannot — lowering failures never reject there).
    analysis: Optional[AnalysisReport] = None
    # Analysis of the brownout-degraded plan (PR 9): scripts declaring
    # ``on-overload: relax-affinity|any-zone`` pre-compile a degraded
    # variant that live traffic may be re-routed through under sustained
    # saturation, so it is verified at apply time exactly like the
    # primary plan — a brownout can never swap in a proven-unplaceable
    # policy. None when no tag opts in.
    degraded_analysis: Optional[AnalysisReport] = None

    @property
    def findings(self) -> Tuple[Finding, ...]:
        found = tuple(self.report.findings)
        if self.analysis is not None:
            found += tuple(self.analysis.findings)
        if self.degraded_analysis is not None:
            found += tuple(
                dataclasses.replace(f, where=f"on-overload:{f.where}")
                for f in self.degraded_analysis.findings
            )
        return found

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.level == "error")

    @property
    def warnings(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.level == "warning")

    @property
    def topology_findings(self) -> Tuple[Finding, ...]:
        """References that match nothing in the live deployment."""
        return self._category("topology")

    @property
    def constraint_findings(self) -> Tuple[Finding, ...]:
        """Unsatisfiable constraint combinations (affinity ∩ anti-affinity)."""
        return self._category("constraint")

    @property
    def reachability_findings(self) -> Tuple[Finding, ...]:
        """Dead blocks / unplaceable tags proven by the static analyzer."""
        return self._category("reachability")

    @property
    def satisfiability_findings(self) -> Tuple[Finding, ...]:
        """Per-item contradictions and empty static survivor sets."""
        return self._category("satisfiability")

    @property
    def starvation_findings(self) -> Tuple[Finding, ...]:
        """Tags whose static admission bound undercuts the declared floor."""
        return self._category("starvation")

    @property
    def proofs(self) -> Tuple[Finding, ...]:
        """Analyzer-proved findings (strict-mode deploy blockers)."""
        return tuple(f for f in self.findings if f.proof)

    def _category(self, category: str) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.category == category)

    @property
    def ok(self) -> bool:
        """No structural errors (lenient mode: warnings are advisory)."""
        return not self.errors

    def ok_strict(self) -> bool:
        """No errors, no topology/constraint findings, no analyzer proofs.

        Strict mode treats a dangling reference — or a *proof* that a tag
        can never be placed — as a deploy blocker rather than a runtime
        no-match: the right default for production rollouts where set
        membership is not expected to be in flux.
        """
        return (
            self.ok
            and not self.topology_findings
            and not self.constraint_findings
            and not self.proofs
        )

    def blocking(self, *, strict: bool) -> Tuple[Finding, ...]:
        """The findings that reject the apply under the given mode."""
        if strict:
            return tuple(
                self.errors
                + self.topology_findings
                + self.constraint_findings
                + self.proofs
            )
        return self.errors

    def raise_for(self, *, strict: bool) -> None:
        blocking = self.blocking(strict=strict)
        if blocking:
            raise PolicyError("policy rejected by dry-run", blocking)

    def render(self) -> str:
        """Findings grouped by category, every line carrying its tag/block.

        Finding ``where`` strings are already structured
        (``tag:<tag>.block[<i>].workers[<j>]``), so grouping by category
        makes the output actionable without reading the script
        side-by-side.
        """
        lines = [
            f"dry-run against zones={list(self.known_zones)} "
            f"sets={list(self.known_sets)} "
            f"controllers={list(self.known_controllers)}"
        ]
        findings = self.findings
        if not findings:
            lines.append("no findings")
        else:
            groups: Dict[str, List[Finding]] = {}
            for f in findings:
                groups.setdefault(f.category, []).append(f)
            ordered = [c for c in _CATEGORY_ORDER if c in groups]
            ordered.extend(c for c in groups if c not in _CATEGORY_ORDER)
            for category in ordered:
                lines.append(f"{category}:")
                lines.extend(f"  {f}" for f in groups[category])
        if self.analysis is not None:
            lines.append(self.analysis.summary())
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class PolicyHandle:
    """One applied policy version (what ``rollback`` restores)."""

    version: int               # the watcher's script version when published
    script: TappScript         # the published (version-stamped) script
    source: Optional[str]      # YAML text when applied from text
    dry_run: PolicyDryRun      # the report the apply was gated on

    @property
    def tag_names(self) -> Tuple[str, ...]:
        return tuple(t.tag for t in self.script.tags)
