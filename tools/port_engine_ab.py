#!/usr/bin/env python3
"""End-to-end serving numbers of the port's engine, for A/B runs on one GPU.

    python3 tools/port_engine_ab.py SRC LABEL [CASE ...]

Imports ``repro_torch`` from the source tree ``SRC`` (e.g. ``src``, or
the ``src`` of an older commit unpacked with ``git archive``) and runs
each ``CASE`` (default: all five). An arch serves ``chip_smoke.py``'s
serving path as its ``run_path`` does: 32 seeded requests, 16 new tokens
each, 2 zones x 2 replicas x 4 slots, bf16, ``use_kernels=True``, random
weights from seed 0 (phi3.5-MoE at ``MOE_DEPTH`` layers, whisper-small
with its 1500 frames a request and a decoder cache of 448). ``topology``
runs ``chip_smoke.py``'s case study (``topology_case``: smollm-135m at
full width, bf16, kernels on; replica setup included in its seconds).
One ``[ab-serve]`` line per case: tokens/s and seconds of the run, the
median decode tick over the replicas' ticks (each replica's first
excluded), the prefill median split into first sights (a prompt length
new to its replica: on the card an eager prefill and a capture) and
repeats (a replay), with their counts, the device-memory peak of the call
(setup included, after a reset) and a checksum of every request's greedy
tokens, so two trees can be seen to emit the same tokens. No profiler
runs. Compare two trees only on one machine in one command, in turns
(A, B, B, A).
"""
import dataclasses
import hashlib
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b", "whisper_small")
CASES = ARCHS + ("topology",)


def _median_ms(seconds):
    return f"{statistics.median(seconds) * 1e3:.2f}" if seconds else "-"


def _report(name, seconds, replicas, requests, ticks_total, peak):
    """The ``[ab-serve]`` line of one case."""
    tokens = sum(len(r.output) for r in requests)
    ticks = [t for rep in replicas for t in rep.tick_times[1:]]
    first, repeat = [], []
    for rep in replicas:
        seen = set()
        for length, sec in rep.prefill_times:
            (repeat if length in seen else first).append(sec)
            seen.add(length)
    digest = hashlib.sha256(repr([list(r.output) for r in requests]).encode()).hexdigest()[:12]
    return (f"{name}: tokens/s {tokens / seconds:.1f} ({tokens} tokens in {seconds:.3f} s, "
            f"{ticks_total} ticks); decode tick median {_median_ms(ticks)} ms over {len(ticks)}; "
            f"prefill median {_median_ms(first + repeat)} ms, first sight {_median_ms(first)} "
            f"ms over {len(first)}, repeat {_median_ms(repeat)} ms over {len(repeat)}; peak "
            f"{peak / 2**20:.1f} MiB; tokens {digest}")


def topology(cs):
    import time

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("smollm_135m"), compute_dtype="bfloat16",
                              use_kernels=True)
    model = Model(cfg)
    params = model.cast_params(
        model.init_params(torch.Generator(device=dev).manual_seed(cs.SEED), dev))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, engines = cs.topology_case(cs.port_topology_api(), cfg, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    replicas = [rep for e in engines for rep in e.replicas.values()]
    requests = [r for e in engines for r in e.done]
    line = _report(f"topology {cfg.name} {cfg.n_layers}L", seconds, replicas, requests,
                   sum(e.tick for e in engines), peak)
    del engines, replicas, requests, params
    cs._free()
    return line


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
    line = _report(f"{cfg.name} {cfg.n_layers}L", result.seconds,
                   list(engine.replicas.values()), reqs, engine.tick, peak)
    del result, engine, reqs
    cs._free()
    return line


def main(src: str, label: str, cases) -> None:
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(1, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_engine_ab: needs a CUDA device")
    import chip_smoke as cs

    for case in cases:
        line = topology(cs) if case == "topology" else serve_arch(cs, case)
        print(f"[ab-serve] {label} {line}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 3 or any(a not in CASES for a in sys.argv[3:]):
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2], sys.argv[3:] or CASES)
