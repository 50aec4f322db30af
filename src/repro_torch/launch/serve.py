"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Builds a zoned replica deployment, loads a tAPP script (file or default),
submits a synthetic request mix, and reports placement + latency stats,
as ``repro/launch/serve.py`` does. :func:`serve` is the function behind
the CLI, and ``chip_smoke.py`` calls it at full width.

One intended difference from the JAX launcher: :func:`serve` sets
``use_kernels=True`` unless told otherwise, so on a GPU prefill
attention runs the hand-written CUDA flash-attention kernel and the MoE
expert FFN (prefill and decode) the hand-written grouped-matmul kernel
(the JAX launcher leaves ``use_kernels`` at its default, False). Mamba
layers serve as in the JAX package whatever ``use_kernels`` says: the
prefill scans with the plain ``ssd_chunked`` (it needs the final state,
which the SSD-scan kernel does not return) and decode steps the
recurrence. An enc-dec model (``--arch whisper_small``) runs its encoder
and its decoder's causal prefill through the flash kernel and encodes
``enc_len`` zero frames per request (default ``max_len``). Every kernel
is built before the engine starts, so no build time enters a tick.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.core.scheduler.topology import DistributionPolicy
from repro_torch.device import resolve_device
from repro_torch.models import Model, ModelConfig
from repro_torch.runtime.serve_engine import Replica, Request, ServingEngine

DEFAULT_SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- interactive:
  - workers:
    - set: edge
    strategy: random
    invalidate: capacity_used 75%
  - workers:
    - set: cloud
  followup: default
- batch:
  - controller: CloudCtl
    workers:
    - set: cloud
    topology_tolerance: same
  followup: default
"""

ZONES = ("edge", "cloud")


@dataclasses.dataclass
class ServeResult:
    engine: ServingEngine
    requests: List[Request]
    seconds: float                  # wall time of run_until_done, synchronised
    setup_seconds: float            # params, kernel build, engine construction

    def zones_by_tag(self):
        by_tag = {}
        for r in self.requests:
            if r.state == "done":
                by_tag.setdefault(r.tag or "untagged", []).append(r.replica)
        return {
            tag: (sorted({name.split("-")[0] for name in names}), len(names))
            for tag, names in sorted(by_tag.items())
        }


def default_requests(n: int) -> List[Tuple[List[int], Optional[str]]]:
    """The JAX launcher's request mix: 3-token prompts, tags in turn."""
    tags = ["interactive", "batch", None]
    return [([1 + i % 13, 2, 3], tags[i % 3]) for i in range(n)]


def serve(
    cfg: ModelConfig,
    *,
    device=None,
    requests: Optional[Sequence[Tuple[Sequence[int], Optional[str]]]] = None,
    script: str = DEFAULT_SCRIPT,
    params=None,
    seed: int = 0,
    replicas_per_zone: int = 2,
    slots: int = 4,
    max_len: int = 64,
    enc_len: Optional[int] = None,
    max_new_tokens: int = 8,
    distribution: str = "shared",
    use_kernels: bool = True,
    max_ticks: int = 2000,
) -> ServeResult:
    """Serve ``requests`` (prompt tokens, tag) on a 2-zone deployment.

    ``params`` (the port's layout, e.g. from :mod:`repro_torch.convert`)
    default to random weights drawn from a ``torch.Generator`` seeded
    with ``seed``. All replicas share one copy of the weights, with the
    matmul weights cast to the compute dtype once.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
    model = Model(cfg)
    if params is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
        params = model.init_params(generator, dev)
    params = model.cast_params(params)
    if use_kernels and dev.type == "cuda":
        # Build before the engine runs, so no build time enters a tick.
        from repro_torch.kernels import _build, flash_attention, gmm, ssd_scan

        _build.build_all()  # one nvcc per source, in parallel
        flash_attention.build()
        gmm.build()
        ssd_scan.build()
    if requests is None:
        requests = default_requests(32)

    engine = ServingEngine(
        distribution=DistributionPolicy.parse(distribution),
        tapp_script=script,
        seed=seed,
    )
    engine.add_controller("EdgeCtl", zone="edge")
    engine.add_controller("CloudCtl", zone="cloud")
    for zone in ZONES:
        for i in range(replicas_per_zone):
            engine.add_replica(
                Replica(f"{zone}-{i}", cfg, params, zone=zone, sets=[zone],
                        slots=slots, max_len=max_len, enc_len=enc_len)
            )
    reqs = [
        engine.submit(cfg.name, list(tokens), tag=tag, max_new_tokens=max_new_tokens)
        for tokens, tag in requests
    ]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    engine.run_until_done(max_ticks=max_ticks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return ServeResult(engine=engine, requests=reqs, seconds=t2 - t1, setup_seconds=t1 - t0)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm_135m",
                    help=f"one of {ARCH_IDS}")
    ap.add_argument("--script", default=None, help="tAPP script path")
    ap.add_argument("--replicas-per-zone", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--distribution", default="shared",
                    choices=[p.value for p in DistributionPolicy])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    script = DEFAULT_SCRIPT
    if args.script:
        with open(args.script) as fh:
            script = fh.read()

    smoke = smoke_config(args.arch)
    # two layers, or one whole period of a hybrid's pattern
    cfg = dataclasses.replace(smoke, n_layers=max(2, smoke.period))
    result = serve(
        cfg,
        device=args.device,
        requests=default_requests(args.requests),
        script=script,
        replicas_per_zone=args.replicas_per_zone,
        slots=args.slots,
        max_len=64,
        max_new_tokens=args.max_new_tokens,
        distribution=args.distribution,
    )
    reqs, engine = result.requests, result.engine
    done = [r for r in reqs if r.state == "done"]
    lat = [r.finished_tick - r.submitted_tick for r in done]
    print(f"arch={cfg.name} requests={len(reqs)} done={len(done)}")
    print(f"latency ticks: mean={statistics.fmean(lat):.1f} "
          f"p50={sorted(lat)[len(lat)//2]} max={max(lat)}")
    for tag, (zones, n) in result.zones_by_tag().items():
        print(f"  {tag:>12}: zones={zones} ({n} reqs)")
    print(f"gateway: {engine.gateway.stats}; stragglers flagged: "
          f"{engine.stragglers_flagged}")
    return result


if __name__ == "__main__":
    main()
