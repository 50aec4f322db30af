"""Quickstart on the PyTorch port: the paper's contribution, then real replicas.

The control plane of ``examples/quickstart.py`` on the port's copy of it
(``repro_torch.core.platform``): a two-zone serverless deployment
declared as a ``ClusterSpec``, a tAPP policy applied through the
platform's apply/dry-run lifecycle, and tagged invocations through the
invoke→admit→complete flow. Then the same policy engine places real
inference requests on two PyTorch model replicas (smollm-135m's smoke
config at 2 layers), whose prefill attention runs the port's CUDA
flash-attention kernel (``use_kernels=True``).

Run on the card:  PYTHONPATH=src python examples/quickstart_torch.py
On the CPU:       PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Without ``--device cpu`` it needs a CUDA device and stops if there is none.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import smoke_config
from repro_torch.core.platform import (
    ClusterSpec,
    ControllerSpec,
    TappPlatform,
    WorkerSpec,
)
from repro_torch.core.scheduler.topology import DistributionPolicy
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.models.lm import tree_map
from repro_torch.runtime.serve_engine import Replica, ServingEngine

SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- critical:
  - controller: EdgeCtl
    workers:
    - set: edge
    strategy: random
    topology_tolerance: none
  followup: fail
"""

SPEC = ClusterSpec(
    controllers=(
        ControllerSpec("EdgeCtl", zone="edge"),
        ControllerSpec("CloudCtl", zone="cloud"),
    ),
    workers=(
        WorkerSpec("w-edge", zone="edge", sets=("edge", "any")),
        WorkerSpec("w-cloud", zone="cloud", sets=("cloud", "any")),
    ),
)


def control_plane_demo() -> dict:
    """Returns the placements ((tag, worker, controller) per invocation)
    and the ``explain`` text."""
    print("== control plane: one platform, one policy lifecycle ==")
    platform = TappPlatform(SPEC, distribution=DistributionPolicy.SHARED)

    # Policies are deployment artifacts: validated + dry-run against the
    # live topology, compiled, then atomically swapped (rollback-able).
    handle = platform.apply_policy(SCRIPT, strict=True)
    print(f"policy v{handle.version} active, tags={list(handle.tag_names)}")

    placements = []
    for tag in ("critical", None):
        placement = platform.invoke("my_fn", tag=tag)
        print(f"tag={tag!r:>12} → worker={placement.worker} "
              f"(controller={placement.controller})")
        placements.append((tag, placement.worker, placement.controller))
        placement.complete()  # retire the running-function ticket

    # Observability is typed: explain() probes without admitting.
    explain = platform.explain("my_fn", tag="critical").render()
    print(explain)
    print(platform.stats())
    return {"placements": placements, "explain": explain}


def demo_config():
    """smollm-135m's smoke config at 2 layers, prefill attention on the
    flash kernel (``use_kernels``, as ``repro_torch.launch.serve`` sets it)."""
    return dataclasses.replace(smoke_config("smollm_135m"), n_layers=2, use_kernels=True)


def data_plane_demo(device="cuda", *, cfg=None, params=None):
    """Two replicas, one per zone, behind the policy; a critical and a
    normal request of 5 tokens each. ``params`` (the port's layout, e.g.
    from :mod:`repro_torch.convert`) default to random weights from a
    seeded ``torch.Generator``. Returns (engine, critical, normal)."""
    print("\n== data plane: tAPP-scheduled serving ==")
    dev = resolve_device(device)
    cfg = cfg or demo_config()
    model = Model(cfg)
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    params = model.cast_params(tree_map(lambda t: t.to(dev), params))
    if cfg.use_kernels and dev.type == "cuda":
        from repro_torch.kernels import flash_attention

        flash_attention.build()  # before the engine runs, so no tick waits for nvcc
    engine = ServingEngine(tapp_script=SCRIPT)
    engine.add_controller("EdgeCtl", zone="edge")
    engine.add_controller("CloudCtl", zone="cloud")
    engine.add_replica(Replica("w-edge", cfg, params, zone="edge",
                               sets=["edge"], slots=2, max_len=32))
    engine.add_replica(Replica("w-cloud", cfg, params, zone="cloud",
                               sets=["cloud"], slots=2, max_len=32))

    critical = engine.submit("smollm-135m", [1, 2, 3], tag="critical",
                             max_new_tokens=5)
    normal = engine.submit("smollm-135m", [4, 5, 6], max_new_tokens=5)
    engine.run_until_done()
    print(f"critical request → replica {critical.replica}, "
          f"tokens {critical.output}")
    print(f"normal   request → replica {normal.replica}, "
          f"tokens {normal.output}")
    print(f"({cfg.compute_dtype} on {dev}, use_kernels={cfg.use_kernels})")
    return engine, critical, normal


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no CUDA device: stop before the demos
    control = control_plane_demo()
    return control, data_plane_demo(args.device)


if __name__ == "__main__":
    main()
