#!/usr/bin/env python3
"""Kernel and float32-path device times of the port, for A/B runs on one GPU.

    python3 tools/port_f32_ab.py SRC LABEL

Imports ``repro_torch`` from the source tree ``SRC`` (e.g. ``src``, or
the ``src`` of an older commit unpacked with ``git archive``), builds its
kernels, and prints, from ``torch.profiler`` (device time per call, as
``chip_smoke.py``'s ``_time_ms`` takes it):

- ``[ab-kernel]``: the flash-attention kernel at ``chip_smoke.py``'s
  shapes (``MAIN_SHAPES`` causal, ``NONCAUSAL_SHAPES``) and the grouped
  matmul at its ``GMM_SHAPES``, each in bf16 and float32, inputs from
  seed 0;
- ``[ab-path]``: the device-busy ms, kernel launches and the flash and
  gmm shares of one profiled float32 prefill and decode tick of
  phi3.5-MoE at full width and 2 layers (prefill S=512, a 4-slot tick at
  position 600, cache 1024) and of whisper-small at full width and depth
  (1500 zero frames and 224 prompt tokens, a 4-slot tick at position 447,
  cache 448), ``use_kernels=True``, random weights from seed 0.

The shapes and helpers come from this checkout's ``chip_smoke.py``. Run
two trees in one machine session, in turns (A, B, B, A), and compare
within it.
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernels(cs):
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gmm import gmm_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(sh, True) for sh in cs.MAIN_SHAPES] + [(sh, False) for sh in cs.NONCAUSAL_SHAPES]
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for (b, s, h, kvh, d), causal in shapes:
            q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
            device_ms, call_ms = cs._time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal))
            print(f"[ab-kernel] flash B={b} S={s} H={h} KV={kvh} D={d} "
                  f"{'causal' if causal else 'non-causal'} {dtype_name}: device us "
                  f"{device_ms * 1e3 if device_ms else None} call us {call_ms * 1e3:.2f}")
        for (e, c, k_, n) in cs.GMM_SHAPES:
            x = torch.randn((e, c, k_), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((e, k_, n), generator=gen, device="cuda") * k_ ** -0.5).to(dtype)
            device_ms, call_ms = cs._time_ms(lambda: gmm_cuda(x, w), iters=20)
            print(f"[ab-kernel] gmm E={e} C={c} K={k_} N={n} {dtype_name}: device us "
                  f"{device_ms * 1e3 if device_ms else None} call us {call_ms * 1e3:.2f}")
            del x, w
        torch.cuda.empty_cache()


def path(cs, label, cfg, prompt_len, position, max_len, enc_len=0):
    import numpy as np
    import torch

    from repro_torch.models import Model
    from repro_torch.models.lm import tree_map

    model = Model(cfg)
    params = model.cast_params(
        model.init_params(torch.Generator(device="cuda").manual_seed(0), "cuda"))
    cache = model.init_cache(4, max_len, enc_len=enc_len, device="cuda")
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, prompt_len)), device="cuda")
    batch = {"tokens": prompt}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, enc_len, cfg.d_model), device="cuda")
    slot = tree_map(lambda leaf: leaf[:, :1], cache)
    tokens = torch.zeros((4,), dtype=torch.int32, device="cuda")
    positions = torch.full((4,), position, dtype=torch.int32, device="cuda")
    steps = {f"prefill S={prompt_len}": lambda: model.prefill(params, batch, slot),
             f"decode tick (4 slots at {position})": lambda: model.decode(
                 params, cache, tokens, positions)}
    with torch.no_grad():
        for name, fn in steps.items():
            fn()
            _, busy_ms, n, by_name, _ = cs._profile(fn)
            flash_ms = sum(us for kernel, us in by_name if "flash_fwd" in kernel) / 1e3
            gmm_ms = sum(us for kernel, us in by_name if "gmm" in kernel) / 1e3
            print(f"[ab-path] {label} float32 {name}: device busy {busy_ms:.3f} ms, {n} kernel "
                  f"launches; flash {flash_ms:.3f} ms, gmm {gmm_ms:.3f} ms")
    del params, cache, model
    torch.cuda.empty_cache()


def main(src: str, label: str) -> None:
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("port_f32_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[ab] {label} ({src}): kernels built from {_build.CSRC}")
    _build.build_all()
    kernels(cs)
    phi = dataclasses.replace(get_config("phi3_5_moe_42b"), compute_dtype="float32",
                              n_layers=2, use_kernels=True)
    path(cs, f"{label} phi3.5-MoE 2L", phi, 512, 600, 1024)
    whisper = dataclasses.replace(get_config("whisper_small"), compute_dtype="float32",
                                  use_kernels=True)
    path(cs, f"{label} whisper-small 12+12L", whisper, cs.WHISPER_PROMPT[1],
         cs.WHISPER_MAX_LEN - 1, cs.WHISPER_MAX_LEN, enc_len=cs.WHISPER_ENC_LEN)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
