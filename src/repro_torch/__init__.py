"""PyTorch/CUDA port of the tAPP-scheduled serving system.

A package of its own beside :mod:`repro` (the JAX reference): the
control plane is a copy of ``repro.core`` under :mod:`repro_torch.core`,
the data plane (models, serving runtime, launcher) is rewritten in
PyTorch, and every Pallas kernel on the ported path is a CUDA kernel
written by hand for Hopper (:mod:`repro_torch.kernels`). Nothing here
imports JAX or the JAX package.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
