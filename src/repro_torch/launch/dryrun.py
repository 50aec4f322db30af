"""Dry-run: trace every (arch × shape × mesh) cell on a fake mesh (port of
``repro/launch/dryrun.py``).

For each cell this proves, without hardware:
  * the sharding config is coherent (the step traces: a placement DTensor
    cannot follow, or an uneven shard, fails here);
  * the program fits (per-device peak of live local storage vs the card's
    memory);
  * and records the roofline inputs (per-device matmul FLOPs, bytes
    written and the collectives each rank issues,
    :mod:`repro_torch.roofline.trace`).

Each cell runs the port's own step at full width and depth under
``FakeTensorMode`` on a fake process group of 256 or 512 ranks
(:func:`repro_torch.launch.mesh.make_production_mesh`), with the params,
optimizer state, batch and caches DTensors placed by
:mod:`repro_torch.sharding.specs`: train is forward, backward and the
AdamW update; prefill and decode run bf16 params, as serving does. All of
it on the plain path (``use_kernels`` False), as in the JAX dry-run. A
fake tensor has no storage and runs no kernel, so a cell touches no device.

A process has one default process group, so the dry-run runs in a process
of its own (the CLI; tests and ``chip_smoke.py`` start one).

Results land in ``build/dryrun/<arch>__<shape>__<mesh>.json``.

Usage::

    python -m repro_torch.launch.dryrun --arch smollm_135m --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all            # every applicable cell
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Dict, Optional, Union

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (
    abstract_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    place,
    sharding_context,
    train_state_shardings,
)
from repro_torch.models.api import SHAPES, Model, ShapeSpec, shape_applicable
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline.analysis import (
    HBM_BYTES,
    model_bytes_min,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline.trace import TraceCounter
from repro_torch.sharding.specs import (
    ShardingPolicy,
    batch_shardings,
    cache_shardings,
    param_shardings,
)

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def capacity_bytes() -> int:
    """The card's memory (``total_memory``) where one is present, else the
    H100 80GB's datasheet capacity."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return HBM_BYTES


def dryrun_cell(
    arch: str,
    shape_name: Union[str, ShapeSpec],
    mesh_kind: str = "single",
    *,
    policy: Optional[ShardingPolicy] = None,
    save: bool = True,
    verbose: bool = True,
    tag: str = "",
    overrides: Optional[Dict] = None,
    opt_cfg: Optional[AdamWConfig] = None,
    mesh=None,
    cfg=None,
) -> Dict:
    """Trace one cell; return its record.

    ``shape_name`` is a key of ``SHAPES`` or a :class:`ShapeSpec`; ``mesh``
    (a ``DeviceMesh``) replaces the production mesh of ``mesh_kind``, which
    then only labels the record; ``cfg`` replaces ``get_config(arch)``
    (``arch`` then only labels it). ``overrides`` patches ModelConfig
    fields (e.g. {"kv_cache_dtype": "int8"}); ``opt_cfg`` is the train
    cells' AdamW (default: float32 moments, no master weights).
    """
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    label = shape.name
    if not shape_applicable(cfg, shape):
        record = {
            "arch": arch, "shape": label, "mesh": mesh_kind,
            "status": "skipped",
            "reason": "long_500k requires sub-quadratic attention (ssm and hybrid families)",
        }
        if verbose:
            _print_record(record)
        if save:
            _save(record, tag)
        return record

    if shape.kind in ("prefill", "decode"):
        # Serving runs bf16 weights (training keeps fp32 masters).
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if cfg.use_kernels:
        raise ValueError("the dry-run traces the plain path (use_kernels=False)")

    t0 = time.time()
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        policy = (policy or ShardingPolicy()).for_mesh(mesh)
        counts = _trace(cfg, shape, mesh, policy, opt_cfg or AdamWConfig())
        t_trace = time.time() - t0
        n_chips = mesh.size()
        terms = roofline_terms(
            counts=counts,
            n_chips=n_chips,
            model_flops_total=model_flops(cfg, shape),
            model_bytes_min=model_bytes_min(cfg, shape, n_chips),
        )
        capacity = capacity_bytes()
        record = {
            "arch": arch,
            "shape": label,
            "mesh": mesh_kind,
            "status": "ok",
            "n_chips": n_chips,
            "mesh_shape": list(mesh.shape),
            "global_batch": shape.global_batch,
            "seq_len": shape.seq_len,
            "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
            "trace_s": round(t_trace, 2),
            "ops_counted": counts.ops,
            "memory": {
                "start_bytes": counts.start_bytes,
                "per_device_bytes": counts.peak_bytes,
                "per_device_gib": round(counts.peak_bytes / 2**30, 3),
                "capacity_bytes": capacity,
                "fits_hbm": bool(counts.peak_bytes <= capacity),
            },
            "roofline": terms.to_json(),
        }
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash --all
        record = {
            "arch": arch, "shape": label, "mesh": mesh_kind,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }

    if verbose:
        _print_record(record)
    if save:
        _save(record, tag)
    return record


# ---------------------------------------------------------------------------
# Per-kind tracing
# ---------------------------------------------------------------------------


def fake_tensors(tree):
    """Fake CPU tensors shaped as ``tree``'s ``meta`` tensors (inside a
    ``FakeTensorMode``)."""
    if isinstance(tree, dict):
        return {k: fake_tensors(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [fake_tensors(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if tree is None:
        return None
    return torch.zeros(tree.shape, dtype=tree.dtype, device="cpu")


def _trace(cfg, shape: ShapeSpec, mesh, policy: ShardingPolicy, opt_cfg: AdamWConfig):
    """The TraceCounts of one step of ``shape.kind``, per device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = Model(cfg)
    counter = TraceCounter()
    with FakeTensorMode():
        if shape.kind == "train":
            state_meta = abstract_train_state(cfg, opt_cfg)
            state_sh = train_state_shardings(cfg, policy, mesh, state_meta)
            batch_meta = model.input_specs(shape)
            state = place(fake_tensors(state_meta), state_sh)
            batch = place(fake_tensors(batch_meta),
                          batch_shardings(cfg, policy, mesh, shape, batch_meta))
            step = make_train_step(cfg, opt_cfg, mesh=mesh, policy=policy,
                                   state_shardings=state_sh)
            counter.track((state, batch))
            with counter:
                step(state, batch)
            return counter.counts()

        params_meta = abstract_train_state(cfg, opt_cfg).params
        params = place(fake_tensors(params_meta), param_shardings(cfg, policy, mesh, params_meta))
        inputs_meta = model.input_specs(shape)
        inputs = place(fake_tensors(inputs_meta),
                       batch_shardings(cfg, policy, mesh, shape, inputs_meta))
        cache_meta = model.cache_specs(shape)
        if cfg.family == "encdec" and shape.kind == "prefill":
            # The port's prefill writes the cross cache in place, so it holds
            # every frame: the shape the JAX prefill returns (it replaces
            # the cross cache it is given).
            from repro_torch.models import encdec

            cache_meta = encdec.init_cache(cfg, shape.global_batch, shape.seq_len,
                                           shape.seq_len, dtype=getattr(torch, cfg.compute_dtype),
                                           device=torch.device("meta"))
        cache = place(fake_tensors(cache_meta), cache_shardings(cfg, policy, mesh, cache_meta))
        counter.track((params, inputs, cache))
        with counter, sharding_context(mesh, policy):
            if shape.kind == "prefill":
                make_prefill_step(cfg)(params, inputs, cache)
            else:
                make_decode_step(cfg)(params, cache, inputs["token"], inputs["position"])
        return counter.counts()


# ---------------------------------------------------------------------------
# Reporting / CLI
# ---------------------------------------------------------------------------


def _print_record(r: Dict) -> None:
    if r["status"] == "ok":
        m = r["memory"]
        t = r["roofline"]
        print(
            f"[ok] {r['arch']:>22} {r['shape']:<12} {r['mesh']:<6} "
            f"mem/dev={m['per_device_gib']:8.3f}GiB fits={m['fits_hbm']} "
            f"compute={t['compute_s']:.4f}s memory={t['memory_s']:.4f}s "
            f"coll={t['collective_s']:.4f}s dom={t['dominant']:<10} "
            f"frac={t['roofline_fraction']:.3f} wire={t['wire_bytes_per_device']:.4g}B "
            f"(trace {r['trace_s']}s)",
            flush=True,
        )
    elif r["status"] == "skipped":
        print(f"[skip] {r['arch']:>22} {r['shape']:<12} {r['mesh']:<6} — {r['reason']}",
              flush=True)
    else:
        print(f"[ERR] {r['arch']:>22} {r['shape']:<12} {r['mesh']:<6} — {r['error']}",
              flush=True)


def _save(record: Dict, tag: str = "") -> None:
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}{suffix}.json"
    (ARTIFACTS / name).write_text(json.dumps(record, indent=2))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--arch", default=None, help="architecture id")
    parser.add_argument("--shape", default=None, choices=list(SHAPES))
    parser.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    parser.add_argument("--all", action="store_true", help="run every cell")
    parser.add_argument("--tag", default="", help="artifact suffix (perf variants)")
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8-quantised KV cache (perf variant)")
    parser.add_argument("--no-tp", action="store_true",
                        help="pure DP/FSDP policy (model axis joins data)")
    parser.add_argument("--fsdp-all", action="store_true",
                        help="FSDP params regardless of model size")
    parser.add_argument("--tp-vocab", action="store_true",
                        help="TP only for vocab (embed table + CE logits)")
    parser.add_argument("--bf16-params", action="store_true",
                        help="bf16 params + f32 master weights (train)")
    parser.add_argument("--moment-int8", action="store_true",
                        help="int8-quantised AdamW moments")
    args = parser.parse_args(argv)

    overrides: Dict = {}
    if args.kv_int8:
        overrides["kv_cache_dtype"] = "int8"
    if args.bf16_params:
        overrides["param_dtype"] = "bfloat16"
    policy = ShardingPolicy(
        tp_enabled=not args.no_tp,
        fsdp_min_params=0 if args.fsdp_all else 2_000_000_000,
        tp_scope="vocab" if args.tp_vocab else "full",
    )
    opt_cfg = AdamWConfig(master_weights=args.bf16_params,
                          moment_dtype="int8" if args.moment_int8 else "f32")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = dryrun_cell(
                    arch, shape, mesh_kind, save=not args.no_save,
                    tag=args.tag, policy=policy, overrides=overrides or None,
                    opt_cfg=opt_cfg,
                )
                if rec["status"] == "error":
                    failures += 1
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
