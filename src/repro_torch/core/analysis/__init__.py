"""Static policy verification over compiled tAPP plans.

Answers the reachability/satisfiability questions of arXiv:2407.14159
statically, at ``apply_policy`` time, using only the epoch-static halves
of the constraint split (:func:`repro_torch.core.scheduler.constraints.split_spec`)
evaluated against a :class:`~repro_torch.core.scheduler.state.ClusterState`
topology snapshot.
"""
from repro_torch.core.analysis.verifier import (
    AnalysisReport,
    BlockVerdict,
    FederationView,
    TagVerdict,
    UNBOUNDED,
    analyze_plan,
)

__all__ = [
    "AnalysisReport",
    "BlockVerdict",
    "FederationView",
    "TagVerdict",
    "UNBOUNDED",
    "analyze_plan",
]
