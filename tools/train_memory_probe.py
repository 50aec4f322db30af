#!/usr/bin/env python3
"""Peak device memory of the port's train step: the allocator against the ops.

    python3 tools/train_memory_probe.py [BATCH SEQ [DETERMINISTIC]]

On one GPU: smollm-135m at full width and depth (f32 params, bf16
compute, ``remat="full"``, random weights from seed 0), one train step on
BATCH x SEQ seeded tokens (default 8 x 4096, ``chip_smoke.py``'s
``[train]`` shape) after two warm steps; DETERMINISTIC=1 turns on
deterministic algorithms, as ``chip_smoke.py``'s ``[train]`` and
``[shard]`` do. Prints

* the allocator's peak (``torch.cuda.max_memory_allocated``) of a step;
* the op-level peak of the same step: the largest sum of live storages
  of op outputs and inputs (``repro_torch.roofline.trace.TraceCounter``
  on real tensors), which is what the dry-run counts on fake tensors;
* the ops whose call raised the allocator's peak above what was held
  before them plus their outputs: allocations inside a kernel, which no
  op-level count can see, largest first.
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(batch: int, seq: int, deterministic: int = 0) -> None:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.roofline.trace import TraceCounter

    class InsideOps(TorchDispatchMode):
        """Per op: the allocator's peak during the call above what is
        allocated after it."""

        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            torch.cuda.reset_peak_memory_stats()
            out = func(*args, **(kwargs or {}))
            after = torch.cuda.memory_allocated()
            inside = torch.cuda.max_memory_allocated() - after
            shapes = [tuple(a.shape) for a in tree_flatten(args)[0]
                      if isinstance(a, torch.Tensor)][:3]
            self.rows.append((inside, str(func), shapes, after))
            return out

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(bool(deterministic), warn_only=True)
    print(torch.cuda.get_device_name(0), torch.__version__,
          f"B={batch} S={seq} deterministic={bool(deterministic)}")
    cfg = dataclasses.replace(get_config("smollm_135m"), compute_dtype="bfloat16",
                              param_dtype="float32", remat="full")
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(batch, seq)),
        dtype=torch.int32, device="cuda")
    params = Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(0), "cuda")
    state = TrainState(params=params, opt=adamw_init(opt, params))
    del params
    step = make_train_step(cfg, opt)
    for _ in range(2):
        state, _ = step(state, {"tokens": tokens})
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    new, _ = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    allocator = torch.cuda.max_memory_allocated()
    del new
    counter = TraceCounter()
    counter.track((state, tokens))
    with counter:
        new, _ = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    del new
    ops = counter.counts().peak_bytes
    print(f"allocator peak {allocator} bytes ({allocator / 2**30:.3f} GiB; "
          f"{base} held before the step); op-level peak {ops} bytes "
          f"({ops / 2**30:.3f} GiB); difference {allocator - ops} bytes")

    inside = InsideOps()
    with inside:
        new, _ = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    seen = set()
    print("allocations inside ops (bytes above the op's end, op, input shapes, "
          "allocated after):")
    for row in sorted(inside.rows, key=lambda r: -r[0]):
        if row[1] in seen or row[0] <= 0:
            continue
        seen.add(row[1])
        print(f"  {row[0]} {row[1]} {row[2]} {row[3]}")
        if len(seen) == 10:
            break
    top = max(inside.rows, key=lambda r: r[0] + r[3])
    print(f"the step's highest point: {top[0] + top[3]} bytes, in {top[1]} {top[2]}")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]] or [8, 4096]
    main(*args)
