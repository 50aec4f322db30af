"""End-to-end training on the PyTorch port: smollm-135M for a few hundred steps.

The port of ``examples/train_smollm.py``: config, synthetic token
stream, the fault-tolerant loop with async checkpointing, with the same
flags. ``--preset`` picks the model: ``smoke`` (the CPU-scale config),
``small`` (4 layers, d_model 128, vocab 4096) or ``full`` (the real 135M
config). ``--inject-failure-at N`` raises at step N once, so the loop
restores the latest checkpoint (one every max(10, steps / 5) steps) and
replays the steps after it; before the first checkpoint it goes on from
step 0 with the state it holds, as the JAX example's loop does.

Run on the card:  PYTHONPATH=src python examples/train_smollm_torch.py --steps 300
On the CPU:       PYTHONPATH=src python examples/train_smollm_torch.py --steps 300 --device cpu

Without ``--device cpu`` it needs a CUDA device and stops if there is none.
Training runs the plain path: the port's kernels have no backward.
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.models import Model
from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.train_loop import TrainLoopConfig, TrainReport, run_training


def preset_config(preset: str):
    if preset == "full":
        return get_config("smollm_135m")
    if preset == "small":
        return dataclasses.replace(
            smoke_config("smollm_135m"),
            n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
            d_ff=512, vocab_size=4096,
        )
    return smoke_config("smollm_135m")


def main(argv=None, *, params=None) -> TrainReport:
    """Parse ``argv`` and train; ``params`` (the port's layout, e.g. from
    :mod:`repro_torch.convert`) default to random weights from a seeded
    ``torch.Generator``. Returns the loop's report."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=["smoke", "small", "full"],
                    default="small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--inject-failure-at", type=int, default=None,
                    help="raise at this step once, to demo restart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.preset)
    model = Model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    if params is None:
        params = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    params = tree_map(lambda t: t.to(dev), params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} preset={args.preset} params={n_params/1e6:.1f}M on {dev}")

    state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    step_fn = make_train_step(cfg, opt_cfg)
    pipeline = SyntheticTokens(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch,
                   seq_len=args.seq)
    )
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="smollm_ckpt_")
    checkpointer = Checkpointer(ckpt_dir, keep_last=3)

    def log(step, metrics):
        print(
            f"step {step:>5}  loss {float(metrics['loss']):.4f}  "
            f"lr {float(metrics['lr']):.2e}  "
            f"gnorm {float(metrics['grad_norm']):.3f}  "
            f"{metrics['step_time_s']*1e3:.0f} ms"
        )

    t0 = time.time()
    report = run_training(
        step_fn=step_fn,
        state=state,
        pipeline=pipeline,
        checkpointer=checkpointer,
        config=TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=max(10, args.steps // 5),
            log_every=max(1, args.steps // 20),
            inject_failure_at=args.inject_failure_at,
        ),
        device=dev,
        on_metrics=log,
    )
    wall = time.time() - t0
    first = sum(report.losses[:10]) / max(1, len(report.losses[:10]))
    last = sum(report.losses[-10:]) / max(1, len(report.losses[-10:]))
    print(
        f"\ndone: {report.steps_run} steps in {wall:.1f}s "
        f"({wall / max(1, report.steps_run) * 1e3:.0f} ms/step)\n"
        f"loss {first:.4f} → {last:.4f}   restarts={report.restarts} "
        f"stragglers={report.straggler_steps}\n"
        f"checkpoints in {ckpt_dir} (latest step {checkpointer.latest_step()})"
    )
    return report


if __name__ == "__main__":
    main()
