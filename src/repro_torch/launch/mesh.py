"""Meshes (port of ``repro/launch/mesh.py``).

Single pod: 16×16 = 256 ranks, axes ("data", "model").
Multi-pod:  2×16×16 = 512 ranks, axes ("pod", "data", "model"); the
"pod" axis is an outer data-parallel axis.

The production meshes are for the dry-run: they live over a fake process
group (``torch.testing._internal.distributed.fake_pg``) of 512 ranks in
which this process is rank 0, so a trace on fake tensors sees every
collective without any device or network. A process has one default
process group, so the fake world takes the process (the JAX dry-run fixes
its device count per process the same way).
:func:`make_gpu_mesh` is the card's own one-rank ("data", "model") mesh
over NCCL, built from an in-memory store (no network).

Functions, never module-level constants: importing this module creates
no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

PRODUCTION_SHAPES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks (the counterpart of JAX's
    ``AbstractMesh``): enough for the sharding specs, which read only
    the axes."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, mesh_dim=None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[mesh_dim]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


#: Ranks of the fake world: enough for the multi-pod mesh; a smaller mesh
#: takes its first ranks.
FAKE_WORLD = 512
_FAKE_MESHES: Dict[Tuple, DeviceMesh] = {}


def _fake_world() -> None:
    """Make the default process group a fake one of ``FAKE_WORLD`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is already running; the "
                "dry-run's fake meshes need a process of their own"
            )
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=FAKE_WORLD)


def make_fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of the first ``prod(shape)`` fake ranks (this process is rank 0).

    One mesh per (shape, axes), made once: DTensor caches its plans by mesh
    equality, so a second mesh equal to the first would reuse the first's
    process groups.
    """
    key = (tuple(shape), tuple(axes))
    if key not in _FAKE_MESHES:
        _fake_world()
        n = math.prod(shape)
        if n > FAKE_WORLD:
            raise ValueError(f"a fake mesh of {n} ranks exceeds the fake world of {FAKE_WORLD}")
        _FAKE_MESHES[key] = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                       mesh_dim_names=tuple(axes))
    return _FAKE_MESHES[key]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape, axes = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    return make_fake_mesh(shape, axes)


def make_debug_mesh(shape: Tuple[int, ...] = (1, 1), axes=("data", "model")) -> DeviceMesh:
    """A mesh over the running default process group (gloo in the CPU
    tests; ``prod(shape)`` must equal its world size)."""
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs an initialised process group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_gpu_mesh() -> DeviceMesh:
    """The card's one-rank ("data", "model") mesh of shape (1, 1) over NCCL.

    The process group is built from an in-memory ``HashStore`` (rank 0 of
    1), so no address or port is needed. Raises without a card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("make_gpu_mesh needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    torch.cuda.set_device(0)
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise RuntimeError("make_gpu_mesh needs a process without another process group")
    return DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """All batch-parallel axes (the 'pod' axis is outer data parallelism)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
