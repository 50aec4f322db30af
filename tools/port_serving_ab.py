#!/usr/bin/env python3
"""Host wall of the PyTorch port's serving model path, for A/B runs on one GPU.

    python3 tools/port_serving_ab.py SRC LABEL

Imports ``repro_torch`` from the source tree ``SRC`` (e.g. ``src``, or
the ``src`` of an older commit unpacked with ``git archive``), builds
smollm-135m at full width and depth (random weights from seed 0, bf16
compute, ``use_kernels=True``, one 4-slot cache of 1024), and prints the
median and the least wall time of a prefill of 512 tokens (20 calls)
and of a 4-slot decode tick (50 calls), each ended by
``torch.cuda.synchronize()``. No profiler runs in the process. Compare
two trees only within one machine session, in turns (A, B, B, A).
"""
import dataclasses
import statistics
import sys
import time


def main(src: str, label: str) -> None:
    sys.path.insert(0, src)
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, flash_attention
    from repro_torch.models import Model
    from repro_torch.models.lm import tree_map

    if not torch.cuda.is_available():
        raise SystemExit("port_serving_ab: needs a CUDA device")
    _build.build_all()
    flash_attention.build()
    cfg = dataclasses.replace(get_config("smollm_135m"), compute_dtype="bfloat16",
                              use_kernels=True)
    model = Model(cfg)
    params = model.cast_params(
        model.init_params(torch.Generator(device="cuda").manual_seed(0), "cuda"))
    cache = model.init_cache(4, 1024, device="cuda")
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 512)), device="cuda")
    slot = tree_map(lambda leaf: leaf[:, :1], cache)
    token = torch.zeros((4,), dtype=torch.int32, device="cuda")
    position = torch.full((4,), 600, dtype=torch.int32, device="cuda")

    def wall(fn, n):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out), min(out)

    with torch.no_grad():
        prefill = wall(lambda: model.prefill(params, {"tokens": prompt}, slot), 20)
        decode = wall(lambda: model.decode(params, cache, token, position), 50)
    print(f"{label}: prefill S=512 median {prefill[0]:.2f} ms (min {prefill[1]:.2f}); "
          f"decode tick median {decode[0]:.2f} ms (min {decode[1]:.2f})")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
