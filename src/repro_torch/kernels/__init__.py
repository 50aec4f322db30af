"""Kernels of the port: hand-written CUDA for Hopper plus their plain
PyTorch versions (:mod:`repro_torch.kernels.ref`)."""

from typing import Dict

import torch

#: The kernel modules, each counting its wrapper's launches in ``launches``.
KERNELS = ("flash_attention", "gmm", "ssd_scan", "mamba_step")


def _modules():
    from repro_torch.kernels import flash_attention, gmm, mamba_step, ssd_scan

    return {"flash_attention": flash_attention, "gmm": gmm, "ssd_scan": ssd_scan,
            "mamba_step": mamba_step}


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch count in this process, by name (``KERNELS``)."""
    return {name: module.launches for name, module in _modules().items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set each kernel's launch count (``counts`` names every one of ``KERNELS``)."""
    for name, module in _modules().items():
        module.launches = counts[name]


def tracks_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on these tensors. Only then does
    :mod:`repro_torch.kernels.ops` go through a kernel's autograd node (whose
    backward raises); otherwise the node would add host time per call and
    change nothing."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def no_backward(kernel: str) -> NotImplementedError:
    """The error every kernel's autograd node raises from ``backward``.

    None of the Pallas kernels the port replaces has a VJP either; the
    model trains through the plain path (``use_kernels=False``).
    """
    return NotImplementedError(
        f"{kernel} has no backward kernel (nor has the Pallas kernel it ports); "
        "train with use_kernels=False (repro_torch.launch.steps.make_train_step)"
    )
