"""The paper's primary contribution: the tAPP language (``repro_torch.core.tapp``)
and the topology-aware scheduler (``repro_torch.core.scheduler``), copied file
for file from the JAX package's control plane. The evaluation simulator is
not part of the serving path and is not copied.

The data plane that these schedule — models, kernels, serving — lives in
the sibling subpackages of :mod:`repro_torch`.
"""
from repro_torch.core import platform, scheduler, tapp

__all__ = ["platform", "scheduler", "tapp"]
