"""Topology-aware function-execution scheduler (the paper's control plane).

The curated public surface of the scheduling layer. Application code
should normally sit one level higher, on
:class:`repro_torch.core.platform.TappPlatform`, which owns the wiring of
watcher + gateway + controller runtime; the names exported here are the
building blocks (state, engine, constraint layer, topology views) that
the platform composes and tests exercise directly.

Legacy constraint helpers (``is_invalid``, ``invalid_reason``,
``resolve_invalidate``) predate the composable constraint layer; they
remain importable via a module-level ``__getattr__`` that emits a
``DeprecationWarning`` — use :mod:`repro_torch.core.scheduler.constraints`
(``resolve_constraints`` / ``constraint_reason`` / ``compile_spec``).
"""
import warnings as _warnings

from repro_torch.core.scheduler.constraints import (
    DEFAULT_INVALIDATE,
    ConstraintSpec,
    compile_spec,
    constraint_reason,
    resolve_constraints,
    spec_predicate,
    spec_violated,
    split_spec,
)
from repro_torch.core.scheduler.controller import Admission, AdmissionError, ControllerRuntime
from repro_torch.core.scheduler.engine import (
    Invocation,
    Outcome,
    ScheduleDecision,
    TappEngine,
    TraceEvent,
)
from repro_torch.core.scheduler.gateway import (
    Gateway,
    GatewayStats,
    ZoneGateway,
    forward_targets,
)
from repro_torch.core.scheduler.state import (
    ClusterState,
    ControllerState,
    WorkerState,
    make_cluster,
)
from repro_torch.core.scheduler.strategy import (
    coprime_order,
    coprime_order_cached,
    iter_ordered,
    iter_random,
    order_candidates,
    stable_hash,
)
from repro_torch.core.scheduler.topology import (
    BlockIndex,
    DistributionPolicy,
    ItemIndex,
    ViewCacheEntry,
    WorkerView,
    cached_view_entry,
    distribution_view,
)
from repro_torch.core.scheduler.vanilla import VanillaScheduler
from repro_torch.core.scheduler.watcher import Watcher

__all__ = [
    "Admission",
    "AdmissionError",
    "BlockIndex",
    "ClusterState",
    "ConstraintSpec",
    "ControllerRuntime",
    "ControllerState",
    "DEFAULT_INVALIDATE",
    "DistributionPolicy",
    "Gateway",
    "GatewayStats",
    "Invocation",
    "ItemIndex",
    "Outcome",
    "ScheduleDecision",
    "TappEngine",
    "TraceEvent",
    "VanillaScheduler",
    "ViewCacheEntry",
    "Watcher",
    "WorkerState",
    "WorkerView",
    "ZoneGateway",
    "cached_view_entry",
    "compile_spec",
    "constraint_reason",
    "coprime_order",
    "coprime_order_cached",
    "distribution_view",
    "forward_targets",
    "iter_ordered",
    "iter_random",
    "make_cluster",
    "order_candidates",
    "resolve_constraints",
    "spec_predicate",
    "spec_violated",
    "split_spec",
    "stable_hash",
]

# Legacy shims kept importable (with a deprecation signal) for one more
# release cycle; deliberately NOT in __all__.
_DEPRECATED = ("is_invalid", "invalid_reason", "resolve_invalidate")


def __getattr__(name: str):
    if name in _DEPRECATED:
        _warnings.warn(
            f"repro_torch.core.scheduler.{name} is deprecated; use the constraint "
            f"layer (repro_torch.core.scheduler.constraints: resolve_constraints / "
            f"constraint_reason / compile_spec) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.core.scheduler import constraints

        return getattr(constraints, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
