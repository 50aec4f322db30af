"""Discrete-event simulation of serverless scheduling (paper §5 evaluation)."""
from repro_torch.core.sim.core import (
    FunctionProfile,
    NetworkModel,
    RequestRecord,
    SimConfig,
    SimResult,
    Simulation,
    WorkloadSpec,
    gateway_scheduler,
    vanilla_scheduler,
)

__all__ = [
    "FunctionProfile",
    "NetworkModel",
    "RequestRecord",
    "SimConfig",
    "SimResult",
    "Simulation",
    "WorkloadSpec",
    "gateway_scheduler",
    "vanilla_scheduler",
]
