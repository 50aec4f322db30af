"""Training launcher of the port:
``python -m repro_torch.launch.train --arch <id> [--smoke] [--device cpu] [...]``.

The counterpart of ``repro/launch/train.py``, with its defaults: random
float32 params from a seeded ``torch.Generator``, AdamW with a warmup of
max(5, steps / 20), the synthetic token stream (frames too for enc-dec),
the fault-tolerant loop with a checkpoint every max(10, steps / 4) steps
into ``--ckpt-dir`` (default a new temporary directory). It runs on the
card unless ``--device cpu`` is given, on the plain path (the kernels
have no backward).
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.models import Model
from repro_torch.models.lm import tree_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.train_loop import TrainLoopConfig, TrainReport, run_training


def main(argv=None) -> TrainReport:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    help=f"one of {ARCH_IDS} (aliases accepted)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--moment-dtype", choices=["f32", "int8"], default="f32")
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    opt_cfg = AdamWConfig(
        lr=args.lr, warmup_steps=max(5, args.steps // 20),
        total_steps=args.steps,
        moment_dtype=args.moment_dtype,
        compression=None if args.grad_compression == "none" else "int8",
    )

    params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    n = sum(leaf.numel() for leaf in tree_leaves(params))
    print(f"{cfg.name}: {n/1e6:.2f}M params "
          f"({'smoke' if args.smoke else 'full'} config) on {dev}")

    state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    step_fn = make_train_step(cfg, opt_cfg)
    pipeline = SyntheticTokens(
        DataConfig(
            vocab_size=cfg.vocab_size, global_batch=args.batch,
            seq_len=args.seq,
            frames_dim=cfg.d_model if cfg.family == "encdec" else 0,
        )
    )
    ckpt = Checkpointer(
        args.ckpt_dir or tempfile.mkdtemp(prefix=f"{args.arch}_ckpt_")
    )

    report = run_training(
        step_fn=step_fn, state=state, pipeline=pipeline, checkpointer=ckpt,
        config=TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=max(10, args.steps // 4),
            log_every=max(1, args.steps // 10),
        ),
        device=dev,
        on_metrics=lambda s, m: print(
            f"step {s:>5} loss {float(m['loss']):.4f} "
            f"({m['step_time_s']*1e3:.0f} ms)"
        ),
    )
    print(f"done: loss {report.losses[0]:.4f} → {report.losses[-1]:.4f}; "
          f"restarts={report.restarts}")
    return report


if __name__ == "__main__":
    main()
