"""The paper's primary contribution: the tAPP language (``repro_torch.core.tapp``),
the topology-aware scheduler (``repro_torch.core.scheduler``), and the evaluation
simulator (``repro_torch.core.sim``).

The data plane that these schedule — models, kernels, sharding, serving —
lives in the sibling subpackages of :mod:`repro`.
"""
from repro_torch.core import platform, scheduler, sim, tapp

__all__ = ["platform", "scheduler", "sim", "tapp"]
