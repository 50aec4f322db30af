#!/usr/bin/env python3
"""Step time, peak memory and losses of the port's train step, for A/B runs on one GPU.

    python3 tools/port_train_ab.py SRC LABEL [STEPS]

Imports ``repro_torch`` from the source tree ``SRC`` (e.g. ``src``, or
the ``src`` of an older commit unpacked with ``git archive``) and trains
smollm-135m at full width and depth as ``chip_smoke.py``'s ``[train]``
does: float32 params, bf16 compute, ``remat="full"``, AdamW (lr 1e-3,
warmup 5), random weights from seed 0, B=8 x S=4096 tokens of the seeded
data stream, deterministic algorithms on. Runs STEPS steps (default 6)
and prints each step's loss (exact), its wall time ended by
``torch.cuda.synchronize()``, the median of the steps after the first,
the allocator's peak over the steps (absolute, and above what the state
held before them) and a checksum of the final params. Two trees whose
steps are bit-identical print the same losses and checksum. No profiler
runs in the process. Compare trees only within one machine session, in
turns (A, B, B, A).
"""
import dataclasses
import os
import statistics
import sys
import time


def main(src: str, label: str, steps: int = 6) -> None:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, src)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models import Model
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    if not torch.cuda.is_available():
        raise SystemExit("port_train_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = dataclasses.replace(get_config("smollm_135m"), compute_dtype="bfloat16",
                              param_dtype="float32", remat="full", use_kernels=False)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    params = Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
    state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    del params
    pipeline = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, global_batch=8,
                                          seq_len=4096, seed=0))
    step_fn = make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(steps):
        batch = make_global_batch(pipeline, i, "cuda")
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    checksum = sum(float(leaf.double().sum()) for leaf in tree_leaves(state.params))
    print(f"[train_ab] {label} ({src}): losses {[repr(x) for x in losses]}")
    print(f"[train_ab] {label}: step ms {[round(w * 1e3, 2) for w in walls]}, median of the "
          f"last {steps - 1} {statistics.median(walls[1:]) * 1e3:.2f} ms; peak "
          f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above the "
          f"{base / 2**20:.1f} MiB held before the steps); param checksum {checksum!r}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:4]))
