"""The Platform API: the paper's tAPP platform behind one typed façade.

>>> from repro_torch.core.platform import ClusterSpec, ControllerSpec, TappPlatform, WorkerSpec
>>> platform = TappPlatform(ClusterSpec(
...     controllers=(ControllerSpec("EdgeCtl", zone="edge"),),
...     workers=(WorkerSpec("w0", zone="edge", sets=("edge", "any")),),
... ))
>>> platform.apply_policy("- default:\\n  - workers:\\n    - set:\\n")
... # doctest: +SKIP
>>> placement = platform.invoke("my_fn")  # doctest: +SKIP
>>> placement.complete()                  # doctest: +SKIP

Multi-zone deployments federate per-zone entrypoints over the same core
(see the README "Federation" section):

>>> from repro_torch.core.platform import FederationSpec, TappFederation
>>> federation = TappFederation(FederationSpec.of({  # doctest: +SKIP
...     "edge": ClusterSpec(...), "cloud": ClusterSpec(...),
... }))
>>> federation.invoke("my_fn", entry_zone="edge")    # doctest: +SKIP
"""
from repro_torch.core.platform.explain import (
    BlockReport,
    CandidateReport,
    ExplainReport,
    FederationExplainReport,
    ZoneHopReport,
    build_explain_report,
)
from repro_torch.core.platform.facade import (
    Placement,
    PlatformCore,
    PlatformStats,
    TappPlatform,
    UnknownWorkerError,
)
from repro_torch.core.platform.faults import (
    ChaosSpec,
    FaultEvent,
    FaultInjector,
)
from repro_torch.core.platform.lifecycle import (
    InstancePool,
    InstanceState,
    LegacyWarmCache,
    LifecycleManager,
    LifecycleSpec,
)
from repro_torch.core.platform.federation import (
    FederatedPlacement,
    FederationStats,
    ForwardHop,
    TappFederation,
    ZoneStats,
)
from repro_torch.core.platform.overload import (
    AdmissionQueue,
    BreakerSpec,
    BrownoutController,
    BrownoutSpec,
    CircuitBreaker,
    OverloadSpec,
    QueueSpec,
    degrade_script,
)
from repro_torch.core.platform.policy import (
    PolicyDryRun,
    PolicyError,
    PolicyHandle,
)
from repro_torch.core.platform.specs import (
    ClusterSpec,
    ControllerSpec,
    FederationSpec,
    RetryPolicy,
    WorkerSpec,
)
from repro_torch.core.scheduler.state import HealthState
from repro_torch.core.scheduler.watcher import HealthTransition, LeaseConfig

__all__ = [
    "AdmissionQueue",
    "BlockReport",
    "BreakerSpec",
    "BrownoutController",
    "BrownoutSpec",
    "CandidateReport",
    "ChaosSpec",
    "CircuitBreaker",
    "ClusterSpec",
    "ControllerSpec",
    "ExplainReport",
    "FaultEvent",
    "FaultInjector",
    "FederatedPlacement",
    "FederationExplainReport",
    "FederationSpec",
    "FederationStats",
    "ForwardHop",
    "HealthState",
    "HealthTransition",
    "InstancePool",
    "InstanceState",
    "LeaseConfig",
    "LegacyWarmCache",
    "LifecycleManager",
    "LifecycleSpec",
    "OverloadSpec",
    "Placement",
    "PlatformCore",
    "PlatformStats",
    "PolicyDryRun",
    "PolicyError",
    "PolicyHandle",
    "QueueSpec",
    "RetryPolicy",
    "TappFederation",
    "TappPlatform",
    "UnknownWorkerError",
    "WorkerSpec",
    "ZoneHopReport",
    "ZoneStats",
    "build_explain_report",
]
