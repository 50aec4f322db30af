#!/usr/bin/env python3
"""End-to-end serving numbers of the port's engine, for A/B runs on one GPU.

    python3 tools/port_engine_ab.py SRC LABEL [ARCH ...]

Imports ``repro_torch`` from the source tree ``SRC`` (e.g. ``src``, or
the ``src`` of an older commit unpacked with ``git archive``) and serves,
for each ``ARCH`` (default: all four), ``chip_smoke.py``'s serving path
as its ``run_path`` does: 32 seeded requests, 16 new tokens each, 2 zones
x 2 replicas x 4 slots, bf16, ``use_kernels=True``, random weights from
seed 0 (phi3.5-MoE at ``MOE_DEPTH`` layers, whisper-small with its 1500
frames a request and a decoder cache of 448). One ``[ab-serve]`` line per
arch: tokens/s and seconds of the run, the median decode tick over the
replicas' ticks (each replica's first excluded), the prefill median, the
device-memory peak of the call (setup included, after a reset) and a
checksum of every request's greedy tokens, so two trees can be seen to
emit the same tokens. No profiler runs. Compare two trees only on one
machine in one command, in turns (A, B, B, A).
"""
import dataclasses
import hashlib
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b", "whisper_small")


def serve_arch(cs, arch):
    import torch

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), compute_dtype="bfloat16")
    kw, prompt = {}, (64, 512)
    if arch == "phi3_5_moe_42b":
        cfg = dataclasses.replace(cfg, n_layers=cs.MOE_DEPTH)
    if arch == "whisper_small":
        prompt = cs.WHISPER_PROMPT
        kw = dict(max_len=cs.WHISPER_MAX_LEN, enc_len=cs.WHISPER_ENC_LEN)
    requests = cs._requests(cfg, lo=prompt[0], hi=prompt[1])
    torch.cuda.reset_peak_memory_stats()
    result = cs._serve(cfg, requests, use_kernels=True, **kw)
    peak = torch.cuda.max_memory_allocated()
    reqs, engine = result.requests, result.engine
    if not all(r.state == "done" for r in reqs):
        raise SystemExit(f"port_engine_ab: {arch} left requests undone")
    tokens = sum(len(r.output) for r in reqs)
    ticks = [t for rep in engine.replicas.values() for t in rep.tick_times[1:]]
    prefills = [sec for rep in engine.replicas.values() for _, sec in rep.prefill_times]
    digest = hashlib.sha256(repr([list(r.output) for r in reqs]).encode()).hexdigest()[:12]
    line = (f"{cfg.name} {cfg.n_layers}L: tokens/s {tokens / result.seconds:.1f} "
            f"({tokens} tokens in {result.seconds:.3f} s, {engine.tick} ticks); decode tick "
            f"median {statistics.median(ticks) * 1e3:.2f} ms over {len(ticks)}; prefill median "
            f"{statistics.median(prefills) * 1e3:.2f} ms; peak {peak / 2**20:.1f} MiB; "
            f"tokens {digest}")
    del result, engine, reqs
    cs._free()
    return line


def main(src: str, label: str, archs) -> None:
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(1, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_engine_ab: needs a CUDA device")
    import chip_smoke as cs

    for arch in archs:
        print(f"[ab-serve] {label} {serve_arch(cs, arch)}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 3 or any(a not in ARCHS for a in sys.argv[3:]):
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2], sys.argv[3:] or ARCHS)
