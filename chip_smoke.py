#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (and so exits non-zero, printing no result)
when it fails:

1. the card's name and power limit, the torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN, so float32 means float32;
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) into ``build/``, printing each
   instantiation's registers and spills; flash attention, gmm's wgmma and
   3xTF32 kernels and the SSD scan's three kernels must not spill, and
   the kernels that multiply on the tensor cores must hold tensor-core
   instructions in their SASS (``HGMMA`` for wgmma, ``HMMA`` for mma.sync;
   ``cuobjdump -sass``): both flash kernels, both gmm kernels of the
   Hopper design, the scan's two product kernels;
3. hold the flash-attention kernel (bf16 and float32, both on the tensor
   cores: float32 in 3xTF32) against its plain PyTorch version
   (``attention_ref``) at the serving paths' prefill shapes (smollm's,
   [topology]'s prompts of 1-3 tokens included, and phi3.5-MoE's, the
   CLI's at head_dim 16, and ragged S at head dims 16 and 32;
   whisper-small's encoder, non-causal at S=1500), and time the kernel,
   the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it) beside the least time an H100 could take for
   the same work (float32: as 3xTF32 on the tensor cores, with the
   CUDA-core figure beside it); a profiled call shows which kernel ran
   for each dtype, with inputs 16-byte aligned and not; and at
   granite-4.0-h's attention (GQA 32/8, D=128, softmax scale 1/128 given
   to the kernel) against SDPA and ``attention_ref`` with that scale;
4. the same for the grouped-matmul kernel against ``gmm_ref`` at the MoE
   path's shapes (E=16, C of 8, 16 and 80, gate/up and down projections),
   the CLI's (E=4, K/N of 64/128, C=8) with C of 136 and 264, and two
   ragged shapes, with ``torch.bmm`` as the yardstick; a profiled call
   shows which kernel ran (inputs TMA can address: bf16 the wgmma kernel,
   float32 the 3xTF32 one; the others the first design's); then the MoE
   path's calls with the dispatch's offsets at phi's widths (decode with
   6 of 16 experts reached, prefill at C=80 and 152 with all reached) on
   a buffer zeroed past each expert's pairs, held to ``gmm_ref`` and bit
   for bit to the call without offsets, both timed in turns, the offsets
   call against the reached experts' bound (the ``kernels`` line's gmm
   row is the decode call's);
5. the same for the SSD scan against ``ssd_scan_ref`` with B and C in
   bf16 and in float32, at mamba2-2.7b's loss-path shape (B=2, S=4096,
   80 heads of 64, N=128, chunk 256), a ragged tail, S < chunk, and the
   JAX tests' shapes (G=2 included), with the device time of each of its
   three kernels; no single PyTorch call computes the scan, so it has no
   yardstick; then the fused Mamba-2 decode step (``[kernel] mamba_step``)
   against ``mamba_step_ref`` at granite-4.0-h's, mamba2-2.7b's and the
   CLI's widths in both dtypes, timed over states that do not fit in L2,
   beside its bytes' bound, with each of its two kernels' time;
6. the CLI, ``python -m repro_torch.launch.serve --arch <id>`` at its
   defaults (``--device cuda``, ``use_kernels=True``, the smoke configs:
   2 layers, head_dim 16) for smollm-135m, phi3.5-MoE, mamba2-2.7b and
   whisper-small: every request done, with the kernels' launch counts
   checked;
7. path 1: serve smollm-135m at full width (30 layers, d_model 576, 9
   heads, 3 KV heads, vocab 49152; random weights from a seed) through the
   port's tAPP-routed ``ServingEngine``: 2 zones x 2 replicas x 4 slots,
   32 requests of 64-512 prompt tokens and 16 new tokens each, bf16,
   ``use_kernels=True``; every request done with its 16 tokens, inside the
   vocabulary; every prefill must go through the flash kernel, by its
   launch count; each replica decodes through its CUDA graph
   (``repro_torch.runtime.compiled``; a replay adds its graph's launches
   to the counts) and prefills through its CUDA graphs, one per prompt
   length (``CompiledPrefill``), every prefill one capture or one replay;
   a profiled prefill, eager and as a graph replay, and decode tick,
   through the graph and eager, whose device-busy times [dryrun] reads;
   then the same requests in float32 with ``use_kernels`` on and off,
   which must give identical greedy tokens and placements (the on run's
   launches are checked as the main path's and reported as the path's
   ``/f32`` entry). Graph against eager decode and prefill is held by the
   ``gpu`` cases of ``tests/test_torch_graphs.py`` and
   ``tests/test_torch_prefill_graphs.py``; serving times by ``servebench/``;
8. path 2: the same for phi3.5-MoE at full width (d_model 4096, 32 heads,
   8 KV heads, head_dim 128, 16 experts top-2, d_ff 6400, vocab 32064)
   with its depth cut from 32 to 8 layers to fit one card: flash launches
   must be 8 per prefill and grouped-matmul launches 3 x 8 per prefill
   and per decode step (the profiled graph replay must show 24 gmm
   kernels); the float32 on/off run is at 2 layers;
9. path 3: mamba2-2.7b at full width and depth (64 layers, d_model 2560,
   80 SSD heads of 64, N=128, vocab 50280): (a) served as paths 1-2 are,
   where the scan kernel may not launch (serving prefill scans with the
   plain ``ssd_chunked``, as in the JAX package) and each decode step
   launches the fused Mamba-2 step once per layer (64; the profiled
   replay must show its two kernels a layer); (b) ``Model.loss`` on
   2 x 4096 seeded tokens with ``use_kernels`` on and off, in bf16 and
   float32: 64 SSD-scan launches per kernel call, |loss on - loss off| <
   2e-3 in float32 and a stated relative bound in bf16, and one profiled
   bf16 kernel call;
10. path 4: whisper-small at full width and depth (12 encoder and 12
   decoder layers, d_model 768, 12 heads of 64, vocab 51865) served as
   paths 1-2 are, each request encoding 1500 zero frames (one 30 s
   window) into a cross cache of 1500 with a decoder cache of 448, 8-224
   prompt tokens: flash launches must be 24 per prefill (12 encoder
   layers non-causal, 12 decoder layers causal); the float32 on/off run
   is at full depth;
11. ``[sim]``: the paper's §5.2 tests on the port's simulator
   (``repro_torch.core.sim.scenarios.run_benchmark``, on the card's host:
   no kernel may launch), every test under the default policy and tagged
   tAPP with its users started together (so ``invoke_batch`` reaches the
   batch router's select op), under ``REPRO_BATCH_BACKEND`` = numpy and
   torch: every run's records must be identical under the two backends
   (``tests/test_torch_sim.py`` holds them to the JAX simulator and
   ``tests/test_sim.py`` checks the paper's claims on them);
12. ``[topology]``: the paper's case study (``examples/serve_topology.py``)
   on smollm-135m at full width and depth (30 layers, bf16,
   ``use_kernels=True``): controllers LocalCtl_1/LocalCtl_2 (edge) and
   CloudCtl, replicas W_1/W_2 (edge, internal) and W_3/W_4 (cloud) of 2
   slots (the straggler flag off: it reads wall times, and the runs are
   compared); the three request classes, W_3 removed mid-service,
   ``apply_policy(FLIPPED)`` then ``rollback()``, the anti-affinity spread
   with ``explain().render()`` and ``rejections()``, and a two-zone
   federation (E_1, C_1) with a ``repro_torch.core.sim.NetworkModel`` of
   40 ms RTT. Checks: ``critical`` only on edge replicas; ML on W_3/W_4
   before the flip, on the edge after it, on the cloud after the
   rollback; every request done after the failure (which hit W_3's
   requests); the spread on three replicas; the federated critical
   request on E_1 with ``forwards`` >= 1 and ``cross_zone_rtt`` equal to
   the sum of its 40 ms hops; flash launches = 30 x prefills (phase 3
   holds the kernel to ``attention_ref`` at these 1-3 token prompts);
   every live replica prefills through its ``CompiledPrefill``. The whole
   scenario again in float32 with ``use_kernels`` on (under
   ``REPRO_BATCH_BACKEND=torch``) and off (numpy) must give identical
   placements, tokens, ticks, explain text, rejections and stats
   (``tests/test_torch_topology.py`` holds it to the JAX engine at 2
   layers on the CPU, and the select op to the backend asked for);
13. ``[examples]``: the port's user-facing examples on the card:
   ``examples/quickstart_torch.py`` at its defaults (the control plane's
   placements; two requests on two replicas of smollm-135m's smoke config
   at 2 layers with ``use_kernels``, on the replicas the policy names,
   with 2 layers x 2 prefills of flash launches), then
   ``examples/train_smollm_torch.py --preset small --steps 30
   --inject-failure-at 15`` (no kernel): the loss falls, one restart from
   the step-10 checkpoint, and the replayed steps 11-14 repeat their
   losses exactly;
14. ``[train]``: the training path (``repro_torch.launch.steps`` and
   ``runtime.train_loop``, no kernel) on smollm-135m at full width and
   depth, B=8 x S=4096, float32 params, bf16 compute, ``remat="full"``,
   20 steps with an async checkpoint every 10 into a temporary directory
   and a failure injected at step 15: the loss must fall, the loop must
   restart exactly once (from step 10) and roll back never, and the
   replayed steps 11-14 must give the first pass's losses exactly
   (deterministic algorithms on); then 3 steps with int8 moments and
   int8 gradient compression, and 3 steps of whisper-small at full width
   (B=8, 448 tokens and 448 frames): finite losses, changed params. No
   kernel may launch. ``[time]`` lines give each path's seconds;
15. ``[shard]``: [train]'s model, optimizer, seed and data stream as a
   sharded train step on the card's one-rank ("data", "model") NCCL mesh
   (``make_gpu_mesh``, ``init_sharded_train_state``): every param and
   moment a DTensor, 5 steps through ``run_training`` with the state's and
   the batch's shardings; each loss must equal [train]'s at the same step
   to 1e-6 relative (the line says whether to the bit), with the step ms,
   tokens/s and peak memory beside [train]'s. No kernel may launch;
16. ``[dryrun]``: a process started before [train] (``--dryrun-child``,
   the CPU only: a fake process group, fake tensors) traces [shard]'s
   cell on a fake (1, 1) mesh, whose predicted per-device peak must lie
   within 15% of [shard]'s measured one; counts the four timed steps
   (smollm's prefill at S=512 and decode tick, mamba2's loss at B=2 x
   S=4096, smollm's train step) and the prefills of paths 2-4 on the
   plain path at their shapes, whose H100 bound (datasheet peaks) must
   not exceed their measured device-busy time (a prefill's eager and
   graph busy both); and traces one production cell per family on the fake meshes
   (smollm-135m train_4k single, phi3.5-MoE decode_32k single, mamba2
   long_500k multi), each "ok", the train cell with collective wire > 0.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--kernels-only`` stops after phase 5.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

#: NVIDIA H100 SXM data sheet, dense: bf16 and TF32 tensor cores, float32 on
#: the CUDA cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: The device kernel a call in each dtype runs (torch.profiler's name):
#: flash always; gmm where TMA can address the inputs, else the first
#: design's ``simt::gmm_kernel``.
FLASH_KERNELS = {"bfloat16": "flash_fwd_bf16_kernel", "float32": "flash_fwd_3xtf32_kernel"}
GMM_KERNELS = {"bfloat16": "gmm_wgmma_kernel", "float32": "gmm_3xtf32_kernel"}

MAIN_SHAPES = [  # (B, S, H, KV, D): smollm's prefill shapes, D=128, phi3.5-MoE's S=512,
    # the CLI's (smoke configs: 4 heads, 2 KV heads, head_dim 16, 3-token
    # prompts), a ragged S at the small head dims, and [topology]'s smollm
    # prompts of 1-3 tokens (less than one tile)
    (1, 3, 4, 2, 16),
    (1, 1, 9, 3, 64),
    (1, 2, 9, 3, 64),
    (1, 3, 9, 3, 64),
    (1, 77, 4, 2, 16),
    (1, 77, 4, 2, 32),
    (1, 128, 9, 3, 64),
    (1, 200, 9, 3, 64),
    (1, 512, 9, 3, 64),
    (1, 256, 8, 2, 128),
    (1, 512, 32, 8, 128),
]
NONCAUSAL_SHAPES = [(1, 1500, 12, 12, 64)]  # whisper-small's encoder: 1500 frames, no mask
REPORT_SHAPE = ((1, 512, 9, 3, 64), "bfloat16")  # the line's numbers

GMM_SHAPES = [  # (E, C, K, N): the MoE path's (decode C=8 at 4 slots, prefill C=80
    # at S=512) for gate/up and down; the CLI's phi (4 experts, d_model 64,
    # d_ff 128: C=8) with C past 80 and past wgmma's N limit of 256; two
    # ragged shapes: K=100 rows are 16-byte multiples in float32 but not in
    # bf16, K=99 rows in neither
    *[(16, c, k, n) for c in (8, 16, 80) for k, n in ((4096, 6400), (6400, 4096))],
    *[(4, c, k, n) for c in (8, 136, 264) for k, n in ((64, 128), (128, 64))],
    (3, 5, 100, 72),
    (3, 5, 99, 72),
]
#: The MoE path's calls with the dispatch's offsets at phi3.5-MoE's widths
#: (16 experts, gate/up 4096 -> 6400 and down 6400 -> 4096), on a buffer
#: zeroed past each expert's pairs: (name, C, pairs per expert). A decode
#: step's 4 slots x top 2 reach 6 experts; rag's prompts (S = 512 and 960)
#: reach every one.
GMM_SKIP_CASES = [
    ("decode", 8, [0, 2, 0, 0, 1, 0, 1, 0, 0, 0, 1, 0, 0, 2, 0, 1]),
    ("prefill-512", 80, [64] * 16),
    ("prefill-960", 152, [120] * 16),
]
GMM_SKIP_TURNS = 2  # turns of (without, with, with, without) offsets
GMM_REPORT_SHAPE = ("decode", (16, 8, 4096, 6400), "bfloat16")  # the call launched most
MOE_DEPTH = 8  # phi3.5-MoE's 32 layers cut to 8: 32 would need ~84 GB of bf16 weights

SSD_SHAPES = [  # (B, H, S, P, G, N, chunk)
    (2, 80, 4096, 64, 1, 128, 256),   # mamba2-2.7b's loss path (train_4k's S, batch cut to 2)
    (1, 80, 1000, 64, 1, 128, 256),   # a ragged last chunk
    (1, 80, 100, 64, 1, 128, 100),    # S < chunk: the chunk becomes S
    (2, 4, 128, 16, 1, 32, 32),       # tests/test_kernels.py's shapes
    (1, 2, 64, 8, 2, 16, 16),
]
SSD_REPORT_SHAPE = ((2, 80, 4096, 64, 1, 128, 256), "bfloat16")  # the loss path's, in bf16
#: Float32 accuracy on both sides (the kernel's 3xTF32 products keep ~float32;
#: bf16 B/C are exact), sums in another order: the reference's own tolerance
#: (tests/test_kernels.py).
SSD_TOL = 1e-4
#: The scan's kernels, in launch order (the first two only where nc > 1).
SSD_STAGES = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
#: The scan's kernels that multiply on the tensor cores.
SSD_MMA_STAGES = ("ssd_chunk_state_kernel", "ssd_chunk_scan_kernel")
MAMBA_SHAPES = [  # (B, H, P, N, G, W): one fused Mamba-2 decode step
    (8, 128, 64, 128, 1, 4),   # granite-4.0-h-small's mixer, 8 slots (granite-decode-poisson)
    (4, 80, 64, 128, 1, 4),    # mamba2-2.7b's, path 3's 4 slots
    (4, 16, 8, 16, 1, 4),      # the CLI's mamba2 smoke config
]
MAMBA_REPORT_SHAPE = ((8, 128, 64, 128, 1, 4), "bfloat16")
#: State copies the timing cycles through, so that each call finds its state
#: in device memory and not in the 50 MB L2 (granite's is 33.5 MB a layer).
MAMBA_COPIES = 4
#: The kernel's two device kernels (torch.profiler's names).
MAMBA_KERNELS = ("mamba_state_kernel", "mamba_norm_kernel")
LOSS_BATCH, LOSS_SEQ = 2, 4096  # train_4k's S; global batch cut from 256 to 2
LOSS_F32_TOL = 2e-3             # |loss on - loss off|, as tests/test_kernels.py:172
#: |loss on - loss off| / loss in bf16: each layer's output is rounded to
#: bf16 (2^-8 relative) after sums taken in another order, so single
#: elements may differ by an ulp; averaged over 8190 tokens the loss
#: moves far less than 1%.
LOSS_BF16_RTOL = 1e-2

WHISPER_ENC_LEN = 1500    # frames of one 30 s window (Whisper's max_source_positions)
WHISPER_MAX_LEN = 448     # Whisper's max_target_positions: the decoder cache
WHISPER_PROMPT = (8, 224)  # decoder-prompt tokens (Whisper's previous-text prompt <= 224)

TRAIN_BATCH, TRAIN_SEQ = 8, 4096  # train_4k's S; global batch cut from 256 to 8
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 20, 10, 15
#: The steps a restart from the step-10 checkpoint replays before step 15.
TRAIN_REPLAYED = tuple(range(TRAIN_CKPT_EVERY + 1, TRAIN_FAIL_AT))

#: [examples]: examples/train_smollm_torch.py's steps and failure. It saves a
#: checkpoint every max(10, steps // 5) = 10 steps, so the restart replays 11-14.
EXAMPLE_STEPS, EXAMPLE_FAIL_AT = 30, 15
EXAMPLE_TRAIN_ARGS = ("--preset", "small", "--steps", str(EXAMPLE_STEPS),
                      "--inject-failure-at", str(EXAMPLE_FAIL_AT))
EXAMPLE_REPLAYED = tuple(range(11, EXAMPLE_FAIL_AT))

SERVE_SLOTS, SERVE_MAX_LEN = 4, 1024  # each replica's slots and cache length
BREAKDOWN = (512, 600)                # the timed prefill's prompt, the decode tick's position

SHARD_STEPS = 5          # [shard]: steps of the sharded train loop
SHARD_LOSS_RTOL = 1e-6   # its losses against [train]'s at the same steps
#: [dryrun]: the dry-run's per-device bytes of [shard]'s cell against its measured peak.
MEMORY_RTOL = 0.15
#: [dryrun]: one production cell per family, traced on the fake meshes.
DRYRUN_CELLS = (("smollm_135m", "train_4k", "single"),
                ("phi3_5_moe_42b", "decode_32k", "single"),
                ("mamba2_2_7b", "long_500k", "multi"))
DRYRUN_TIMEOUT_S = 420
#: [dryrun]: the prefills of paths 2-4 counted beside smollm's, as their
#: [breakdown]s time them: {arch: (prompt, cache length, frames, config changes)}.
PREFILL_BOUNDS = {
    "phi3_5_moe_42b": (BREAKDOWN[0], SERVE_MAX_LEN, None, {"n_layers": MOE_DEPTH}),
    "mamba2_2_7b": (BREAKDOWN[0], SERVE_MAX_LEN, None, {}),
    "whisper_small": (WHISPER_PROMPT[1], WHISPER_MAX_LEN, WHISPER_ENC_LEN, {}),
}

#: Device-busy ms of the steps the script profiles, for [dryrun]'s bounds
#: (and [train]'s losses, step time and peak, for [shard]): filled by the
#: breakdowns of paths 1-4, path 3's loss and [train].
TIMED = {}


def check(ok: bool, what: str) -> None:
    """Fail the phase (and the script) unless ``ok``; unlike ``assert``, not removed by -O."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _time_ms(fn, iters: int = 50, warmup: int = 5, by_name=None, attempts: int = 3):
    """(device ms, call ms) per call of ``fn``.

    Device ms: the summed GPU time of every kernel ``fn`` launched, from
    ``torch.profiler``: one profiled call counts the events a call makes,
    then ``iters`` profiled calls must show ``iters`` times as many (an
    event the profiler dropped would make the mean too small). Where they
    do not, the pair is taken again, up to ``attempts`` times, and each
    miss is printed with the counts; None if no attempt was complete (or
    the profiler recorded no device time).
    Call ms: CUDA events around back-to-back calls, which is the larger
    of the device time and the host's launch overhead.
    ``by_name``, where given a dict, receives device ms per call by kernel
    name (only where the device ms is not None).
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    device_ms = None
    for attempt in range(1, attempts + 1):
        one = _profiled_device_events(fn, 1)
        events = _profiled_device_events(fn, iters)
        device_us = sum(e.time_range.elapsed_us() for e in events)
        if one and len(events) == len(one) * iters and device_us > 0:
            device_ms = device_us / 1e3 / iters
            break
        print(f"[profiler] attempt {attempt}: one call showed {len(one)} device event(s), "
              f"{iters} calls {len(events)} (kernels {_names_and_counts(one)} in one call)")
    if by_name is not None and device_ms is not None:
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return device_ms, call_ms


def _profiled_device_events(fn, calls):
    """The device events of ``calls`` calls of ``fn`` under one profiler session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _device_events(prof)


def _names_and_counts(events):
    out = {}
    for e in events:
        out[e.name[:40]] = out.get(e.name[:40], 0) + 1
    return out


def _reset_counts() -> None:
    from repro_torch.kernels import KERNELS, set_launch_counts

    set_launch_counts(dict.fromkeys(KERNELS, 0))


def _counts():
    from repro_torch.kernels import launch_counts

    return launch_counts()


def _device_events(prof):
    """The profiler's events that ran on the card (kernels, copies, memsets)."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_kernel_names(fn, attempts: int = 3):
    """Names of the device kernels one profiled call of ``fn`` ran (the
    profiler may drop a call's events, so up to ``attempts`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = set()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in _device_events(prof)}
        if names:
            break
    return names


def _bound_ms(nbytes, flops, dtype_name):
    """(least H100 ms, "bytes" or "operations", float32 CUDA-core ms or
    None): the larger of the bytes at the HBM rate and the operations at
    the peak of the input type. float32 operations are counted as 3xTF32,
    three TF32 tensor-core products each, the fewest that keep float32
    accuracy; the third number is the same operations on the CUDA cores
    (the bound the first float32 designs were held to)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    f32_ms = None
    if dtype_name == "float32":
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
        f32_ms = max(t_bytes, flops / PEAK_FLOPS["float32"] * 1e3)
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), f32_ms


def _attention_bound_ms(b, s, t, h, kvh, d, dtype_name, causal=True):
    """Least H100 time (``_bound_ms``): each input read once, the output
    written once, and the FLOPs of the score pairs the mask keeps."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * (2 * b * s * h * d + 2 * b * t * kvh * d)
    pairs = sum(min(t, row + 1) for row in range(s)) if causal else s * t
    return _bound_ms(nbytes, 4 * b * h * d * pairs, dtype_name)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(p.name for p in paths.values()))
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line \
                    or "smem" in line or "arning" in line:
                print(f"[build] {name}: {line.strip()}")
    # Every flash instantiation keeps S, P and O in registers, every gmm
    # instantiation of the Hopper design its accumulators, and the scan's
    # kernels their fragments (ptxas -v). A library loaded from build/ is
    # checked by the log kept beside it.
    for name, only in (("flash_attention", ("",)),
                       ("gmm", tuple(GMM_KERNELS.values())), ("ssd_scan", ("",))):
        log = _build.build_logs.get(name)
        check(log is not None, f"{name}: no ptxas log, so its spills cannot be checked "
              f"(delete {paths[name]} to rebuild it)")
        for part in only:
            spills = {fn: n for fn, n in _spills_by_function(log).items() if part in fn}
            check(bool(spills) and not any(spills.values()),
                  f"{name} spills registers ({spills} bytes per function)")
            print(f"[build] {name}: {len(spills)} {part or 'kernel'} instantiation(s), no spills")
    # The kernels that multiply on the tensor cores: wgmma (HGMMA) in gmm's
    # bf16 kernel and the scan's two product kernels, mma.sync (HMMA) in both
    # flash kernels, gmm's float32 kernel and the scan's C·Bᵀ.
    for name, kernels, op in (("flash_attention", tuple(FLASH_KERNELS.values()), "HMMA"),
                              ("gmm", (GMM_KERNELS["bfloat16"],), "HGMMA"),
                              ("gmm", (GMM_KERNELS["float32"],), "HMMA")):
        counts = _sass_op_counts(paths[name], op)
        for kernel in kernels:
            found = {fn: n for fn, n in counts.items() if kernel in fn}
            check(bool(found) and all(found.values()),
                  f"{name}: {kernel} has no tensor-core {op} in its SASS ({found})")
            print(f"[build] {name}: {kernel}: {op} in SASS per instantiation "
                  + ", ".join(f"{_template_args(fn)} {n}" for fn, n in sorted(found.items())))
    counts = {op: _sass_op_counts(paths["ssd_scan"], op) for op in ("HMMA", "HGMMA")}
    for stage in SSD_MMA_STAGES:
        fns = sorted(fn for fn in counts["HMMA"] if stage in fn)
        mma = {fn: (counts["HMMA"][fn], counts["HGMMA"].get(fn, 0)) for fn in fns}
        check(len(mma) == 2 and all(sum(n) for n in mma.values()),
              f"ssd_scan: {stage} has no tensor-core HMMA/HGMMA in its SASS ({mma})")
        print(f"[build] ssd_scan: {stage}: tensor-core instructions in SASS per instantiation "
              + ", ".join(f"{'bf16' if 'bfloat16' in fn else 'f32'} B/C: HMMA {n[0]}, HGMMA {n[1]}"
                          for fn, n in mma.items()))


def _template_args(fn):
    """``<64, true>`` of a demangled kernel name (the whole name if it has none)."""
    m = re.search(r"<[^()]*>", fn)
    return m[0] if m else fn


def _cuobjdump():
    """The CUDA toolkit's ``cuobjdump`` (beside nvcc), else Triton's copy."""
    import importlib.util

    from repro_torch.kernels import _build

    candidates = [os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(os.path.join(os.path.dirname(spec.origin),
                                       "backends", "nvidia", "bin", "cuobjdump"))
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError(f"chip_smoke: no cuobjdump (looked at {candidates})")


def _sass_op_counts(lib_path, opcode):
    """{demangled kernel name: SASS instructions starting with ``opcode``}
    of every kernel in a built library (``cuobjdump -sass``)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, current = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = _demangle(m[1])
            out[current] = 0
        elif current is not None and re.search(r"\*/\s+(@!?U?P\w+\s+)?" + opcode + r"\b", line):
            out[current] += 1
    return out


def _demangle(name):
    """The kernel's C++ name (the mangled one where ``c++filt`` is missing:
    it holds the same kernel and type names)."""
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name


def _spills_by_function(log):
    """{entry function: spill store + load bytes} from an ``nvcc -Xptxas -v`` log."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            out[current] = out.get(current, 0) + int(m[1]) + int(m[2])
    return out


def phase_kernel_check():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    shapes = [(shape, True) for shape in MAIN_SHAPES] + [(shape, False) for shape in NONCAUSAL_SHAPES]
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for (b, s, h, kvh, d), causal in shapes:
            q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
            out = flash_attention_cuda(q, k, v, causal=causal)
            expect = attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(out.shape == expect.shape and out.dtype == dtype, "kernel output shape/dtype")
            check(bool(torch.isfinite(out.float()).all()), "non-finite kernel output")
            err = float((out.float() - expect.float()).abs().max())
            tol = TOL[dtype_name]
            ok = bool(torch.allclose(out.float(), expect.float(), rtol=tol, atol=tol))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            times = {
                "ms": _time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal)),
                "plain_ms": _time_ms(lambda: attention_ref(q, k, v, causal=causal)),
                "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)),
            }
            bound_ms, bound_by, f32_bound_ms = _attention_bound_ms(b, s, s, h, kvh, d, dtype_name,
                                                                   causal)
            row = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                       f32_cuda_core_bound_ms=f32_bound_ms)
            for key, (device_ms, call_ms) in times.items():
                # Device time where the profiler saw the card, else the call time.
                row[key] = device_ms if device_ms is not None else call_ms
                row[key.replace("ms", "call_ms")] = call_ms
            rows[((b, s, h, kvh, d), dtype_name)] = row
            print(f"[kernel] flash_attention B={b} S={s} H={h} KV={kvh} D={d} {dtype_name}"
                  f"{'' if causal else ' non-causal'}: "
                  f"max_abs_err={err:.3e} (tol {tol:g}) | device us: "
                  f"kernel={row['ms'] * 1e3:.2f} plain={row['plain_ms'] * 1e3:.2f} "
                  f"sdpa={row['library_ms'] * 1e3:.2f} bound={bound_ms * 1e3:.3f} ({bound_by}"
                  + (f"; float32 CUDA cores {f32_bound_ms * 1e3:.3f}" if f32_bound_ms else "")
                  + f") | per call us: kernel={row['call_ms'] * 1e3:.2f} "
                  f"plain={row['plain_call_ms'] * 1e3:.2f} sdpa={row['library_call_ms'] * 1e3:.2f}"
                  + ("" if all(t[0] is not None for t in times.values())
                     else " | profiler saw no (or not every) device event: device columns are call times"))
            check(ok, f"flash_attention disagrees with attention_ref: {err} > {tol}")
    _flash_routes(gen)
    _flash_scaled(gen)
    return rows


#: granite-4.0-h's attention: GQA 32/8 at D=128, softmax scale 1/128 (its
#: attention_multiplier) in place of 1/sqrt(128), over a 256-token prompt.
SCALED_SHAPE, SCALE = (1, 256, 32, 8, 128), 1.0 / 128


def _flash_scaled(gen):
    """The kernel with a softmax scale given (granite's), against SDPA with the
    same scale and against attention_ref, in both dtypes; the default scale
    would read another output."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import attention_ref

    b, s, h, kvh, d = SCALED_SHAPE
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
        out = flash_attention_cuda(q, k, v, causal=True, scale=SCALE).float()
        sdpa = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True, scale=SCALE,
            enable_gqa=True).transpose(1, 2).float()
        ref = attention_ref(q, k, v, causal=True, scale=SCALE).float()
        default = flash_attention_cuda(q, k, v, causal=True).float()
        torch.cuda.synchronize()
        tol = TOL[dtype_name]
        err_sdpa = float((out - sdpa).abs().max())
        err_ref = float((out - ref).abs().max())
        moved = float((default - sdpa).abs().max())
        print(f"[kernel] flash_attention B={b} S={s} H={h} KV={kvh} D={d} {dtype_name} "
              f"scale=1/128: max_abs_err vs sdpa {err_sdpa:.3e}, vs attention_ref "
              f"{err_ref:.3e} (tol {tol:g}); the default scale differs by {moved:.3e}")
        check(err_sdpa <= tol and err_ref <= tol,
              f"flash_attention with scale 1/128 disagrees: {err_sdpa}, {err_ref} > {tol}")
        check(moved > tol, "flash_attention's scale argument changed nothing")


def _misaligned(t):
    """A copy of ``t`` whose storage starts one element past a 16-byte
    boundary (the same values, the same strides)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _flash_routes(gen):
    """Which kernel each dtype's call ran (a profiled call), with inputs
    16-byte aligned (cp.async loads) and not (element-wise loads), held to
    attention_ref at TOL: smollm's S=200, D=64."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import attention_ref

    b, s, h, kvh, d = 1, 200, 9, 3, 64
    for dtype_name, kernel in FLASH_KERNELS.items():
        dtype = getattr(torch, dtype_name)
        qkv = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]
        for aligned in (True, False):
            q, k, v = qkv if aligned else [_misaligned(x) for x in qkv]
            check(aligned == (q.data_ptr() % 16 == 0), "flash route: alignment not as meant")
            names = _device_kernel_names(lambda: flash_attention_cuda(q, k, v, causal=True))
            ran = [nm for nm in names if "flash" in nm]
            vec = f"<{d}, {'true' if aligned else 'false'}>"
            check(len(ran) == 1 and kernel in ran[0] and vec in ran[0],
                  f"flash {dtype_name} {'aligned' if aligned else 'unaligned'} ran "
                  f"{sorted(names)}; expected {kernel}{vec}")
            err = float((flash_attention_cuda(q, k, v, causal=True).float()
                         - attention_ref(q, k, v, causal=True).float()).abs().max())
            check(err <= TOL[dtype_name],
                  f"flash {dtype_name} aligned={aligned}: {err} > {TOL[dtype_name]}")
            print(f"[kernel] flash_attention B={b} S={s} H={h} KV={kvh} D={d} {dtype_name} "
                  f"{'16-byte aligned' if aligned else 'unaligned'}: ran {ran[0][:90]}; "
                  f"max_abs_err={err:.3e}")


def _gmm_bound_ms(e, c, k, n, dtype_name, reached=None):
    """Least H100 time (``_bound_ms``): x and w of the ``reached`` experts
    (all by default) read once, the whole output written once, and
    2*reached*C*K*N operations."""
    elem = 2 if dtype_name == "bfloat16" else 4
    r = e if reached is None else reached
    nbytes = elem * (r * c * k + r * k * n + e * c * n)
    return _bound_ms(nbytes, 2 * r * c * k * n, dtype_name)


def phase_gmm_check():
    import torch

    from repro_torch.kernels.gmm import gmm_cuda
    from repro_torch.kernels.ref import gmm_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for (e, c, k, n) in GMM_SHAPES:
            x = torch.randn((e, c, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((e, k, n), generator=gen, device="cuda") * k ** -0.5).to(dtype)
            out = gmm_cuda(x, w)
            expect = gmm_ref(x, w)
            torch.cuda.synchronize()
            check(tuple(out.shape) == (e, c, n) and out.dtype == dtype, "gmm output shape/dtype")
            check(bool(torch.isfinite(out.float()).all()), "non-finite gmm output")
            err = float((out.float() - expect.float()).abs().max())
            tol = TOL[dtype_name]
            ok = bool(torch.allclose(out.float(), expect.float(), rtol=tol, atol=tol))
            del expect
            times = {
                "ms": _time_ms(lambda: gmm_cuda(x, w), iters=20),
                "plain_ms": _time_ms(lambda: gmm_ref(x, w), iters=20),
                "library_ms": _time_ms(lambda: torch.bmm(x, w), iters=20),
            }
            bound_ms, bound_by, f32_bound_ms = _gmm_bound_ms(e, c, k, n, dtype_name)
            row = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                       f32_cuda_core_bound_ms=f32_bound_ms)
            for key, (device_ms, call_ms) in times.items():
                row[key] = device_ms if device_ms is not None else call_ms
                row[key.replace("ms", "call_ms")] = call_ms
            rows[((e, c, k, n), dtype_name)] = row
            print(f"[kernel] gmm E={e} C={c} K={k} N={n} {dtype_name}: "
                  f"max_abs_err={err:.3e} (tol {tol:g}) | device us: "
                  f"kernel={row['ms'] * 1e3:.2f} plain={row['plain_ms'] * 1e3:.2f} "
                  f"bmm={row['library_ms'] * 1e3:.2f} bound={bound_ms * 1e3:.3f} ({bound_by}"
                  + (f"; float32 CUDA cores {f32_bound_ms * 1e3:.3f}" if f32_bound_ms else "")
                  + f"; {bound_ms / row['ms']:.3f} of it) | per call us: "
                  f"kernel={row['call_ms'] * 1e3:.2f} "
                  f"plain={row['plain_call_ms'] * 1e3:.2f} bmm={row['library_call_ms'] * 1e3:.2f}"
                  + ("" if all(t[0] is not None for t in times.values())
                     else " | profiler saw no (or not every) device event: device columns are call times"))
            check(ok, f"gmm disagrees with gmm_ref at {(e, c, k, n)} {dtype_name}: {err} > {tol}")
            # Inputs whose strides TMA can address (16-byte multiples) run the
            # Hopper design (bf16 wgmma, float32 3xTF32); the others the first
            # design's kernel.
            names = _device_kernel_names(lambda: gmm_cuda(x, w))
            per16 = 16 // x.element_size()
            expect = (GMM_KERNELS[dtype_name] if k % per16 == 0 and n % per16 == 0
                      else "simt")
            ran = [nm for nm in names if "gmm" in nm]
            check(len(ran) == 1 and expect in ran[0],
                  f"gmm at {(e, c, k, n)} {dtype_name} ran {sorted(names)}; expected {expect}")
            print(f"[kernel] gmm E={e} C={c} K={k} N={n} {dtype_name}: ran {ran[0][:72]}")
            del x, w
    for dtype_name in ("bfloat16", "float32"):
        for name, c, counts in GMM_SKIP_CASES:
            for k, n in ((4096, 6400), (6400, 4096)):
                rows[(name, (len(counts), c, k, n), dtype_name)] = _gmm_skip_case(
                    gen, name, c, counts, k, n, dtype_name)
    return rows


def _gmm_skip_case(gen, name, c, counts, k, n, dtype_name):
    """gmm with the dispatch's ``offsets`` on a buffer zeroed past each
    expert's pairs: held to ``gmm_ref`` and, bit for bit, to the call
    without offsets; both timed in turns. Returns its row: the offsets
    call against the reached experts' bound, the call without offsets as
    ``all_ms``."""
    import itertools

    import torch

    from repro_torch.kernels.gmm import gmm_cuda
    from repro_torch.kernels.ref import gmm_ref

    dtype = getattr(torch, dtype_name)
    e, reached = len(counts), sum(1 for m in counts if m)
    offsets = torch.tensor([0, *itertools.accumulate(counts)], dtype=torch.int64, device="cuda")
    live = torch.tensor(counts, device="cuda")[:, None] > torch.arange(c, device="cuda")
    x = torch.randn((e, c, k), generator=gen, device="cuda").to(dtype)
    x = torch.where(live[..., None], x, torch.zeros((), dtype=dtype, device="cuda"))
    w = (torch.randn((e, k, n), generator=gen, device="cuda") * k ** -0.5).to(dtype)
    out = gmm_cuda(x, w, offsets)
    expect = gmm_ref(x, w)
    torch.cuda.synchronize()
    err = float((out.float() - expect.float()).abs().max())
    tol = TOL[dtype_name]
    check(bool(torch.allclose(out.float(), expect.float(), rtol=tol, atol=tol)),
          f"gmm with offsets ({name}) disagrees with gmm_ref at {(e, c, k, n)} {dtype_name}: "
          f"{err} > {tol}")
    check(torch.equal(out, gmm_cuda(x, w)),
          f"gmm with offsets ({name}) at {(e, c, k, n)} {dtype_name} differs from the call "
          "without them")
    del expect
    calls = {"skip": lambda: gmm_cuda(x, w, offsets), "all": lambda: gmm_cuda(x, w)}
    turns = {"skip": [], "all": []}
    for i in range(2 * GMM_SKIP_TURNS):  # all, skip, skip, all, ...
        for call in (("all", "skip") if i % 2 == 0 else ("skip", "all")):
            turns[call].append(_time_ms(calls[call], iters=20))
    # Device ms where the profiler saw every event of every turn, else call ms.
    device = all(t[0] is not None for ts in turns.values() for t in ts)
    ms = {call: [t[0] if device else t[1] for t in ts] for call, ts in turns.items()}
    bound_ms, bound_by, f32_bound_ms = _gmm_bound_ms(e, c, k, n, dtype_name, reached)
    row = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
               f32_cuda_core_bound_ms=f32_bound_ms, reached=reached,
               ms=statistics.median(ms["skip"]),
               call_ms=statistics.median(t[1] for t in turns["skip"]),
               all_ms=statistics.median(ms["all"]),
               all_call_ms=statistics.median(t[1] for t in turns["all"]))
    us = {call: "/".join(f"{t * 1e3:.2f}" for t in v) for call, v in ms.items()}
    print(f"[kernel] gmm with offsets, {name}: E={e} C={c} K={k} N={n} {dtype_name}, "
          f"{reached} of {e} experts reached: max_abs_err={err:.3e} (tol {tol:g}), bit for bit "
          f"the call without offsets | {'device' if device else 'per call'} us in turns: "
          f"with offsets {us['skip']}, without {us['all']}; medians "
          f"{row['ms'] * 1e3:.2f} / {row['all_ms'] * 1e3:.2f} "
          f"({row['ms'] / row['all_ms'] - 1:+.2%}) | bound of the reached experts "
          f"{bound_ms * 1e3:.3f} ({bound_by}; {bound_ms / row['ms']:.3f} of it)")
    return row


def _ssd_bound_ms(b, h, s, p, g, n, chunk, bc_dtype_name):
    """Least H100 time for the scan: each input read once and y written once,
    against the operations these inputs need in the arithmetic the kernel
    runs. The products: per (b, g, chunk) C·Bᵀ on its causal pairs, per
    (b, h, chunk) the masked product on them, C·stateᵀ where the state is
    not zero (every chunk but the first) and the state update where a later
    chunk reads it (every chunk but the last). Each is counted at the
    fewest tensor-core passes the function needs, whatever the kernel runs:
    3xTF32 (three TF32 passes) where both operands are float32; two where
    one operand is bf16 (exact in TF32): the state update with bf16 B, and
    C·stateᵀ with bf16 C (exp(cum) scales its rows after the product); and
    C·Bᵀ with bf16 B and C as one bf16 pass. Returns (ms, "bytes" or
    "operations", the operations bound at the float32 CUDA-core peak, in
    ms: the one this kernel's first design was held to)."""
    esize = 2 if bc_dtype_name == "bfloat16" else 4
    bf16 = bc_dtype_name == "bfloat16"
    nbytes = 4 * 2 * b * h * s * p + 4 * b * h * s + 2 * b * g * s * n * esize
    cb_flops = masked_flops = carried_flops = state_flops = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        cb_flops += 2 * pairs * b * g * n
        masked_flops += 2 * pairs * b * h * p
        carried_flops += 2 * b * h * q * n * p * (c0 > 0)
        state_flops += 2 * b * h * q * n * p * (c0 + chunk < s)
    t_ops = ((cb_flops / PEAK_FLOPS["bfloat16"] if bf16 else 3 * cb_flops / PEAK_FLOPS["tf32"])
             + (3 * masked_flops + (2 if bf16 else 3) * (carried_flops + state_flops))
             / PEAK_FLOPS["tf32"]) * 1e3
    t_f32 = (cb_flops + masked_flops + carried_flops + state_flops) / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_f32


def _ssd_inputs(gen, b, h, s, p, g, n, bc_dtype):
    """The kernel layout with the model's ranges: dt in [0.001, 0.2], A in [-16, -1]."""
    import math

    import torch

    x = torch.randn((b, h, s, p), generator=gen, device="cuda")
    lo, hi = math.log(1e-3), math.log(0.2)
    dt = torch.exp(torch.rand((b, h, s), generator=gen, device="cuda") * (hi - lo) + lo)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    bm = torch.randn((b, g, s, n), generator=gen, device="cuda").to(bc_dtype)
    cm = torch.randn((b, g, s, n), generator=gen, device="cuda").to(bc_dtype)
    return x * dt[..., None], (dt * a[None, :, None])[:, :, None, :], bm, cm


def phase_ssd_check():
    import torch

    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        for (b, h, s, p, g, n, chunk) in SSD_SHAPES:
            xdt, da, bm, cm = _ssd_inputs(gen, b, h, s, p, g, n, getattr(torch, dtype_name))
            out = ssd_scan_cuda(xdt, da, bm, cm, chunk=chunk)
            expect = ssd_scan_ref(xdt, da, bm, cm, chunk=chunk)
            torch.cuda.synchronize()
            check(tuple(out.shape) == (b, h, s, p) and out.dtype == torch.float32,
                  "ssd_scan output shape/dtype")
            check(bool(torch.isfinite(out).all()), "non-finite ssd_scan output")
            err = float((out - expect).abs().max())
            ok = bool(torch.allclose(out, expect, rtol=SSD_TOL, atol=SSD_TOL))
            del expect
            stages = {}
            times = {
                "ms": _time_ms(lambda: ssd_scan_cuda(xdt, da, bm, cm, chunk=chunk), iters=20,
                               by_name=stages),
                "plain_ms": _time_ms(lambda: ssd_scan_ref(xdt, da, bm, cm, chunk=chunk),
                                     iters=5, warmup=2),
            }
            bound_ms, bound_by, f32_bound_ms = _ssd_bound_ms(b, h, s, p, g, n, chunk, dtype_name)
            # None where the profiler saw no event; 0 for a stage that did not run (nc = 1).
            stage_ms = ({st: sum(v for k, v in stages.items() if st in k) for st in SSD_STAGES}
                        if stages else None)
            row = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                       f32_cuda_core_bound_ms=f32_bound_ms, stage_ms=stage_ms,
                       library_ms=None, library_call_ms=None)
            for key, (device_ms, call_ms) in times.items():
                row[key] = device_ms if device_ms is not None else call_ms
                row[key.replace("ms", "call_ms")] = call_ms
            rows[((b, h, s, p, g, n, chunk), dtype_name)] = row
            print(f"[kernel] ssd_scan B={b} H={h} S={s} P={p} G={g} N={n} chunk={chunk} "
                  f"B/C {dtype_name}: max_abs_err={err:.3e} (tol {SSD_TOL:g}) | device us: "
                  f"kernel={row['ms'] * 1e3:.2f} plain={row['plain_ms'] * 1e3:.2f} "
                  f"library=none bound={bound_ms * 1e3:.3f} ({bound_by}; float32 CUDA cores "
                  f"{f32_bound_ms * 1e3:.3f}) | stages us: "
                  + (" + ".join(f"{st.replace('_kernel', '')}={v * 1e3:.2f}"
                                for st, v in stage_ms.items())
                     if stages else "not seen by the profiler")
                  + f" | per call us: kernel={row['call_ms'] * 1e3:.2f} "
                  f"plain={row['plain_call_ms'] * 1e3:.2f}"
                  + ("" if all(t[0] is not None for t in times.values())
                     else " | profiler saw no (or not every) device event: device columns are call times"))
            check(ok, f"ssd_scan disagrees with ssd_scan_ref at {(b, h, s, p, g, n, chunk)} "
                      f"{dtype_name}: {err} > {SSD_TOL}")
            del xdt, da, bm, cm, out
    return rows


def _mamba_inputs(gen, b, h, p, n, g, w, dtype, copies=1):
    """A decode step's projections in ``dtype``, ``copies`` float32 (window,
    state) pairs and the layer's float32 leaves, at the model's ranges."""
    import torch

    di, cd = h * p, h * p + 2 * g * n

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    caches = [(r(b, w - 1, cd), r(b, h, p, n)) for _ in range(copies)]
    return ((r(b, di).to(dtype), r(b, cd).to(dtype), (r(b, h) - 2).to(dtype)), caches,
            (r(w, cd) / w ** 0.5, r(cd) * 0.1, r(h) * 0.5, r(h), 1 + 0.1 * r(h),
             1 + 0.1 * r(di)))


def _mamba_bound_ms(b, h, p, n, g, w, dtype_name):
    """(least H100 ms, bytes): every input read once and every output written
    once; the float32 state and window are both. The FLOPs (~10 a state
    element) are nothing beside the bytes."""
    esize = 2 if dtype_name == "bfloat16" else 4
    di, cd = h * p, h * p + 2 * g * n
    nbytes = (2 * 4 * b * h * p * n + 2 * 4 * b * (w - 1) * cd        # state, window
              + esize * b * (2 * di + cd + h)                            # z, xbc, dt_raw, out
              + 4 * (w * cd + cd + 3 * h + di))                          # the layer's leaves
    return nbytes / PEAK_BYTES_PER_S * 1e3, nbytes


def phase_mamba_check():
    """[kernel] mamba_step: the fused Mamba-2 decode step against
    ``mamba_step_ref`` (the plain ops of ``apply_mamba_step``) at granite's,
    mamba2-2.7b's and the CLI's widths, in bf16 and float32: the output
    (float32 to 1e-5 of its scale, bf16 to one ulp beside 1e-5 of its
    scale), the state (1e-5 of its scale) and the rolled window (exactly);
    then both timed over ``MAMBA_COPIES`` states, beside the bytes' bound."""
    import torch

    from repro_torch.kernels.mamba_step import mamba_step_cuda
    from repro_torch.kernels.ref import mamba_step_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for shape in MAMBA_SHAPES:
            b, h, p, n, g, w = shape
            proj, caches, leaves = _mamba_inputs(gen, b, h, p, n, g, w, dtype, MAMBA_COPIES)
            conv, state = caches[0]
            mine = (conv.clone(), state.clone())
            out = mamba_step_cuda(*proj, *mine, *leaves, groups=g, eps=1e-5)
            expect = mamba_step_ref(*proj, conv, state, *leaves, groups=g, eps=1e-5)
            torch.cuda.synchronize()
            err = float((out.float() - expect.float()).abs().max())
            state_err = float((mine[1] - state).abs().max())
            ok_state = state_err <= 1e-5 * float(state.abs().max())
            if dtype_name == "bfloat16":
                # One bf16 spacing at max(|a|, |e|), beside 1e-5 of the output's
                # scale: where y nearly cancels, the float32 sums' order moves it
                # by more than its own bf16 spacing.
                a, e = out.float(), expect.float()
                top = torch.maximum(a.abs(), e.abs()).clamp_min(2.0 ** -126)
                ulp = 2.0 ** (torch.floor(torch.log2(top)) - 7)
                excess = float(((a - e).abs() / (ulp + 1e-5 * float(e.abs().max()))).max())
                big = e.abs() >= 1e-3 * float(e.abs().max())
                ulps = float(((a - e).abs() / ulp)[big].max())
                ok_out = excess <= 1.0
                what = (f"{ulps:.2f} bf16 ulps where |out| >= 1e-3 of its scale, "
                        f"{excess:.2f} of the allowance")
            else:
                ok_out = err <= 1e-5 * float(expect.abs().max())
                what = f"{err / float(expect.abs().max()):.2e} of its scale"
            window_equal = torch.equal(mine[0], conv)
            del mine, out, expect
            turn = [0]

            def call(fn):
                def one():
                    c, st = caches[turn[0] % MAMBA_COPIES]
                    turn[0] += 1
                    fn(*proj, c, st, *leaves, groups=g, eps=1e-5)
                return one

            parts = {}
            times = {"ms": _time_ms(call(mamba_step_cuda), iters=40, by_name=parts),
                     "plain_ms": _time_ms(call(mamba_step_ref), iters=10, warmup=2)}
            bound_ms, nbytes = _mamba_bound_ms(b, h, p, n, g, w, dtype_name)
            row = dict(max_abs_err=err, state_max_abs_err=state_err, bound_ms=bound_ms,
                       bound_by="bytes", library_ms=None, library_call_ms=None,
                       kernel_ms={k: sum(v for name, v in parts.items() if k in name)
                                  for k in MAMBA_KERNELS} if parts else None)
            for key, (device_ms, call_ms) in times.items():
                row[key] = device_ms if device_ms is not None else call_ms
                row[key.replace("ms", "call_ms")] = call_ms
            rows[(shape, dtype_name)] = row
            print(f"[kernel] mamba_step B={b} H={h} P={p} N={n} G={g} W={w} {dtype_name}: "
                  f"max_abs_err={err:.3e} ({what}), state {state_err:.3e}, window "
                  f"{'equal' if window_equal else 'DIFFERENT'} | device us: "
                  f"kernel={row['ms'] * 1e3:.2f}"
                  + (" (" + " + ".join(f"{k.replace('_kernel', '')} {v * 1e3:.2f}"
                                       for k, v in row["kernel_ms"].items()) + ")"
                     if row["kernel_ms"] else "")
                  + f" plain={row['plain_ms'] * 1e3:.2f} library=none bound="
                  f"{bound_ms * 1e3:.3f} (bytes, {nbytes / 1e6:.2f} MB): kernel at "
                  f"{bound_ms / row['ms'] * 100:.1f}% of the bound | per call us: "
                  f"kernel={row['call_ms'] * 1e3:.2f} plain={row['plain_call_ms'] * 1e3:.2f}"
                  + ("" if all(t[0] is not None for t in times.values())
                     else " | profiler saw no (or not every) device event: device columns are call times"))
            check(ok_out and ok_state and window_equal,
                  f"mamba_step disagrees with mamba_step_ref at {shape} {dtype_name}: output "
                  f"{what}, state {state_err}, window equal {window_equal}")
            del proj, caches, leaves
    return rows


def _requests(cfg, n=32, lo=64, hi=512):
    import numpy as np

    rng = np.random.default_rng(SEED)
    tags = ["interactive", "batch", None]
    out = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        out.append((rng.integers(0, cfg.vocab_size, size=length).tolist(), tags[i % 3]))
    return out


def _serve(cfg, requests, max_len=SERVE_MAX_LEN, **kw):
    from repro_torch.launch.serve import serve

    return serve(cfg, device="cuda", requests=requests, seed=SEED,
                 replicas_per_zone=2, slots=SERVE_SLOTS, max_len=max_len, max_new_tokens=16,
                 **kw)


def _flash_per_prefill(cfg):
    """Flash launches per prefill: one per attention layer, the enc-dec
    encoder's (non-causal) included."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + cfg.n_layers
    return cfg.n_periods * sum(mixer == "attn" for mixer, _ in cfg.layer_pattern())


def _ffn_matmuls(cfg):
    """Grouped-matmul launches per token batch: MoE layers x products per FFN."""
    per_ffn = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return per_ffn * cfg.n_periods * sum(ffn == "moe" for _, ffn in cfg.layer_pattern())


def _prefill_graphs(replicas, what):
    """(lengths captured, replays, MiB of the graphs' pools) summed over
    ``replicas``: each live one must prefill through its CompiledPrefill,
    a failed one must have dropped it."""
    from repro_torch.runtime.compiled import CompiledPrefill

    captures = replays = pool = 0
    for rep in replicas:
        prefill = rep._prefill_b1
        if not rep.alive:
            check(prefill is None, f"{what}: failed replica {rep.name} kept {prefill}")
            continue
        check(isinstance(prefill, CompiledPrefill),
              f"{what}: replica {rep.name} prefills through {prefill}, not CUDA graphs")
        captures += prefill.captures
        replays += prefill.replays
        pool += prefill.pool_bytes()
    return captures, replays, pool / 2**20


def _mamba_layers(cfg):
    """Fused Mamba-2 decode steps a decode step: one per Mamba-2 layer."""
    return cfg.n_periods * sum(mixer == "mamba" for mixer, _ in cfg.layer_pattern())


def _check_serving_launches(cfg, result, launches):
    """Every prefill launched flash once per attention layer, every token
    batch (prefill or decode step) gmm once per expert product, every
    decode step the fused Mamba-2 step once per Mamba-2 layer, and no scan
    ran. Returns (prefills, decode steps, attention layers, gmm per batch)."""
    engine, reqs = result.engine, result.requests
    prefills = [pt for rep in engine.replicas.values() for pt in rep.prefill_times]
    decode_steps = sum(len(rep.tick_times) for rep in engine.replicas.values())
    check(len(prefills) == len(reqs), f"{len(prefills)} prefills for {len(reqs)} requests")
    attn_layers = _flash_per_prefill(cfg)
    check(launches["flash_attention"] == attn_layers * len(prefills),
          f"flash_attention launches {launches['flash_attention']} != "
          f"{attn_layers} x {len(prefills)} prefills")
    # Serving never reaches the scan kernel: prefill scans with the plain
    # ssd_chunked (the kernel returns no final state), decode steps.
    check(launches["ssd_scan"] == 0, f"ssd_scan launches {launches['ssd_scan']} while serving")
    check(launches["mamba_step"] == _mamba_layers(cfg) * decode_steps,
          f"mamba_step launches {launches['mamba_step']} != {_mamba_layers(cfg)} Mamba-2 "
          f"layers x {decode_steps} decode steps")
    per_batch = _ffn_matmuls(cfg)
    check(launches["gmm"] == per_batch * (len(prefills) + decode_steps),
          f"gmm launches {launches['gmm']} != {per_batch} x ({len(prefills)} prefills "
          f"+ {decode_steps} decode steps)")
    return prefills, decode_steps, attn_layers, per_batch


CLI_ARCHS = ("smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b", "whisper_small")


def phase_cli():
    """``python -m repro_torch.launch.serve --arch <id>`` at its defaults
    (``--device cuda``, ``use_kernels=True``, the smoke configs at head_dim
    16, 2 layers), for a dense, an MoE, a Mamba-2 and an enc-dec model: every request
    must be done, through the kernels by their launch counts. Returns
    {path: launches}."""
    from repro_torch.launch import serve as serve_mod

    paths = {}
    for arch in CLI_ARCHS:
        _reset_counts()
        result = serve_mod.main(["--arch", arch])
        launches = _counts()
        rep = next(iter(result.engine.replicas.values()))
        reqs = result.requests
        check(rep.device.type == "cuda", f"the CLI served {arch} on {rep.device}")
        check(all(r.state == "done" for r in reqs), f"CLI {arch}: states {[r.state for r in reqs]}")
        prefills, *_ = _check_serving_launches(rep.cfg, result, launches)
        captures, replays, _ = _prefill_graphs(result.engine.replicas.values(),
                                               f"[cli] {arch}")
        check(captures + replays == len(prefills),
              f"[cli] {arch}: {captures} captures + {replays} replays != {len(prefills)} prefills")
        print(f"[cli] python -m repro_torch.launch.serve --arch {arch}: {len(reqs)} requests "
              f"done on {rep.device}, head_dim {rep.cfg.head_dim}; launches {launches}; "
              f"prefill graphs: {captures} lengths captured, {replays} replays")
        paths[f"cli/{arch}"] = launches
        del result, rep
        _free()
    return paths


def phase_main_path(cfg, requests, **serve_kw):
    """Serve ``requests``; returns (result, {kernel: launches in this run})."""
    _reset_counts()
    result = _serve(cfg, requests, use_kernels=True, **serve_kw)
    launches = _counts()
    reqs, engine = result.requests, result.engine
    check(all(r.state == "done" for r in reqs), f"states {[r.state for r in reqs]}")
    check(all(len(r.output) == 16 for r in reqs), "a request did not get 16 tokens")
    check(all(0 <= tok < cfg.vocab_size for r in reqs for tok in r.output),
          "a token outside the vocabulary")
    prefills, decode_steps, attn_layers, per_batch = _check_serving_launches(
        cfg, result, launches)
    moe = (f" experts={cfg.moe_experts} top{cfg.moe_top_k} d_ff={cfg.d_ff}"
           if cfg.moe_experts else "")
    ssm = (f" d_inner={cfg.d_inner} ssd_heads={cfg.ssm_nheads}x{cfg.ssm_headdim} "
           f"N={cfg.ssm_state} chunk={cfg.ssm_chunk}" if cfg.ssm_state else "")
    if cfg.family == "encdec":
        rep0 = next(iter(engine.replicas.values()))
        ssm = (f" encoder={cfg.encoder_layers}L frames={rep0.enc_len} "
               f"decoder cache={rep0.max_len}")
    print(f"[serve] {cfg.name} {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} head_dim={cfg.head_dim}{moe}{ssm} vocab={cfg.vocab_size} "
          f"{cfg.compute_dtype} use_kernels=True: {len(reqs)} requests done, {engine.tick} ticks")
    for tag, (zones, n) in result.zones_by_tag().items():
        print(f"[serve]   {tag:>12}: zones={zones} ({n} reqs)")
    print(f"[serve] flash_attention launches={launches['flash_attention']} = "
          f"{attn_layers} x {len(prefills)} prefills; gmm launches={launches['gmm']} = "
          f"{per_batch} x ({len(prefills)} prefills + {decode_steps} decode steps); "
          f"ssd_scan launches={launches['ssd_scan']}; mamba_step launches="
          f"{launches['mamba_step']} = {_mamba_layers(cfg)} x {decode_steps} decode steps")
    captures, replays, pool_mib = _prefill_graphs(engine.replicas.values(), "[serve]")
    check(captures + replays == len(prefills),
          f"[serve] {captures} captures + {replays} replays != {len(prefills)} prefills")
    print(f"[serve] prefill graphs: {captures} lengths captured (each first sight eager, then "
          f"captured), {replays} replays, over {len(engine.replicas)} replicas; pools "
          f"{pool_mib:.1f} MiB in all")
    return result, launches


def _profile(fn, attempts: int = 3, expect=None):
    """(wall ms, device-busy ms, kernel launches, device us by kernel name,
    largest first, launches by kernel name) of one profiled ``fn()``.

    The profiler may drop a run's device events (PERF.md): a run in which
    it saw none, or in which ``expect`` (a predicate of the launches by
    name) does not hold, is taken again, up to ``attempts`` times, each
    miss printed; then the phase fails. A busy time is never read from a
    run that showed no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = _device_events(prof)
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        by_name, counts = {}, {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            counts[e.name] = counts.get(e.name, 0) + 1
        if kernels and busy_us > 0 and (expect is None or expect(counts)):
            return (wall_ms, busy_us / 1e3, len(kernels),
                    sorted(by_name.items(), key=lambda kv: -kv[1]), counts)
        print(f"[profiler] attempt {attempt}: {len(kernels)} device event(s) "
              f"({_names_and_counts(kernels)})")
    raise RuntimeError(f"chip_smoke: no complete profile of {fn} in {attempts} attempts")


def _gmm_launches(counts):
    return sum(n for name, n in counts.items() if "gmm" in name)


def _mamba_kernels(counts):
    """The fused Mamba-2 step's device kernels (two a call) by the profiler's names."""
    return sum(n for name, n in counts.items() if any(k in name for k in MAMBA_KERNELS))


def phase_breakdown(cfg, result, prompt_len=BREAKDOWN[0], position=BREAKDOWN[1]):
    """One prefill (S=``prompt_len``) and one decode tick (every slot at
    ``position``), each profiled once after a warm call: its device-busy
    time and kernels. An enc-dec prefill also encodes the replica's
    ``enc_len`` zero frames. The prefill runs eagerly into a slot
    (``model.prefill``), then as the engine runs it (``rep._prefill_b1``:
    a replay of the replica's CUDA graph for that length, which also zeroes
    the scratch cache and copies the logits out; the warm call captures it
    if the length is new); its profiled replay must show flash once per
    attention layer and gmm once per expert product. The decode tick is the
    step the engine runs (``rep._decode``: the replica's CUDA graph), then
    the eager ``model.decode`` beside it; both must show the grouped-matmul
    kernel once per expert product (24 for phi3.5-MoE at 8 layers) and the
    fused Mamba-2 step's two kernels once per Mamba-2 layer. ``TIMED``
    keeps each step's device-busy ms (the graphs' as ``"prefill/graph"``
    and ``"decode"``, the eager tick's as ``"decode/eager"``)."""
    import numpy as np
    import torch

    from repro_torch.models.lm import tree_map
    from repro_torch.runtime.compiled import CompiledDecode

    rep = next(iter(result.engine.replicas.values()))
    check(isinstance(rep._decode, CompiledDecode),
          f"{cfg.name}: the replica decodes through {rep._decode}, not a CUDA graph")
    prompt = torch.as_tensor(
        np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=(1, prompt_len)),
        device=rep.device)
    batch = {"tokens": prompt}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, rep.enc_len, cfg.d_model), device=rep.device)
    slot_cache = tree_map(lambda leaf: leaf[:, :1], rep.cache)
    tokens = torch.zeros((rep.slots,), dtype=torch.int32, device=rep.device)
    positions = torch.full((rep.slots,), position, dtype=torch.int32, device=rep.device)
    per_batch = _ffn_matmuls(cfg)
    tick = f"decode tick ({rep.slots} slots)"
    steps = {
        (f"prefill S={prompt_len}", "prefill"):
            lambda: rep.model.prefill(rep.params, batch, slot_cache),
        (f"prefill S={prompt_len}, CUDA graph", "prefill/graph"):
            lambda: rep._prefill_b1(prompt),
        (f"{tick}, CUDA graph", "decode"):
            lambda: rep._decode(rep.params, rep.cache, tokens, positions),
        (f"{tick}, eager", "decode/eager"):
            lambda: rep.model.decode(rep.params, rep.cache, tokens, positions),
    }
    expects = {
        "prefill/graph": lambda counts: (
            _gmm_launches(counts) == per_batch
            and sum(n for k, n in counts.items() if "flash_fwd" in k) == _flash_per_prefill(cfg)),
        "decode": lambda counts: (_gmm_launches(counts) == per_batch
                                  and _mamba_kernels(counts) == 2 * _mamba_layers(cfg)),
        "decode/eager": lambda counts: (_gmm_launches(counts) == per_batch
                                        and _mamba_kernels(counts) == 2 * _mamba_layers(cfg)),
    }
    for (name, kind), fn in steps.items():
        fn()  # warm
        _, busy_ms, n, by_name, counts = _profile(fn, expect=expects.get(kind))
        TIMED[(cfg.name, kind)] = {"busy_ms": busy_ms}
        flash_ms = sum(us for kernel, us in by_name if "flash_fwd" in kernel) / 1e3
        gmm_ms = sum(us for kernel, us in by_name if "gmm" in kernel) / 1e3
        print(f"[breakdown] {cfg.name} {cfg.n_layers}L {name}: device busy {busy_ms:.2f} ms, "
              f"{n} kernel launches; flash_attention {flash_ms:.2f} ms; gmm {gmm_ms:.2f} ms "
              f"({_gmm_launches(counts)} launches); top: "
              + "; ".join(f"{k[:60]} {v / 1e3:.2f} ms" for k, v in by_name[:4]))


def phase_f32_parity(cfg, requests, **serve_kw):
    """The same requests in float32 with ``use_kernels`` on and off: equal
    placements and greedy tokens. Returns the kernel-on run's {kernel:
    launches}, checked as the main path's are (the off run launches none)."""
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    runs, launches = {}, None
    for use_kernels in (True, False):
        _reset_counts()
        result = _serve(f32, requests, use_kernels=use_kernels, **serve_kw)
        counts = _counts()
        check(all(r.state == "done" for r in result.requests), "f32 run left requests undone")
        if use_kernels:
            _check_serving_launches(f32, result, counts)
            launches = counts
        else:
            check(not any(counts.values()), f"f32 use_kernels=False launched {counts}")
        runs[use_kernels] = [(r.replica, list(r.output)) for r in result.requests]
        print(f"[f32] {f32.name} {f32.n_layers}L use_kernels={use_kernels}: "
              f"{len(result.requests)} requests done; launches {counts}")
        del result
        _free()
    same_place = all(a[0] == b[0] for a, b in zip(runs[True], runs[False]))
    same_tokens = all(a[1] == b[1] for a, b in zip(runs[True], runs[False]))
    print(f"[f32] placements identical: {same_place}; greedy tokens identical: {same_tokens}")
    check(same_place and same_tokens, "use_kernels on/off disagree in float32")
    return launches


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def run_path(key, cfg, parity_cfg, prompt=(64, 512), breakdown=BREAKDOWN, **serve_kw):
    """Paths 1, 2 and 4 (and 3a without parity_cfg): serve requests of
    ``prompt`` tokens, profile a prefill and a decode tick (``breakdown``:
    prompt length, decode position), f32 on/off parity.
    Returns {key: launches, key/f32: the float32 kernel-on run's}."""
    requests = _requests(cfg, lo=prompt[0], hi=prompt[1])
    result, launches = phase_main_path(cfg, requests, **serve_kw)
    phase_breakdown(cfg, result, *breakdown)
    del result
    _free()
    paths = {key: launches}
    if parity_cfg is not None:
        paths[f"{key}/f32"] = phase_f32_parity(parity_cfg, requests, **serve_kw)
        _free()
    return paths


def phase_loss(cfg):
    """Path 3(b): ``Model.loss`` on LOSS_BATCH x LOSS_SEQ seeded tokens.

    bf16 then float32, each with ``use_kernels`` on and off; the counts
    are reset before and read after these four calls. Then one profiled
    bf16 kernel call. Returns the launches of the four calls.
    """
    import math

    import numpy as np
    import torch

    from repro_torch.models import Model

    tokens = torch.as_tensor(
        np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=(LOSS_BATCH, LOSS_SEQ)),
        device="cuda")
    batch = {"tokens": tokens}
    params = Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    per_call = cfg.n_periods * sum(mixer == "mamba" for mixer, _ in cfg.layer_pattern())
    losses = {}
    _reset_counts()
    for dtype_name in ("bfloat16", "float32"):
        dcfg = dataclasses.replace(cfg, compute_dtype=dtype_name)
        cast = Model(dcfg).cast_params(params)
        for use_kernels in (True, False):
            model = Model(dataclasses.replace(dcfg, use_kernels=use_kernels))
            before = _counts()["ssd_scan"]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                total, parts = model.loss(cast, batch)
            value = float(total)
            seconds = time.perf_counter() - t0
            launched = _counts()["ssd_scan"] - before
            peak = torch.cuda.max_memory_allocated()
            check(math.isfinite(value), f"loss is {value}")
            check(launched == (per_call if use_kernels else 0),
                  f"ssd_scan launches {launched} in one loss call (use_kernels={use_kernels}), "
                  f"expected {per_call if use_kernels else 0}")
            losses[(dtype_name, use_kernels)] = value
            print(f"[loss] {cfg.name} {cfg.n_layers}L B={LOSS_BATCH} S={LOSS_SEQ} {dtype_name} "
                  f"use_kernels={use_kernels}: loss {value:.6f} (ce {float(parts['ce']):.6f}) "
                  f"in {seconds * 1e3:.2f} ms, ssd_scan launches {launched}, "
                  f"peak {peak / 2**20:.1f} MiB")
        del cast
        _free()
    launches = _counts()
    d32 = abs(losses[("float32", True)] - losses[("float32", False)])
    d16 = abs(losses[("bfloat16", True)] - losses[("bfloat16", False)])
    r16 = d16 / abs(losses[("bfloat16", False)])
    print(f"[loss] float32 |on - off| = {d32:.3e} (limit {LOSS_F32_TOL:g}); bf16 |on - off| = "
          f"{d16:.3e}, relative {r16:.3e} (limit {LOSS_BF16_RTOL:g}); bf16 vs float32 "
          f"(kernel on) {abs(losses[('bfloat16', True)] - losses[('float32', True)]):.3e}")
    check(d32 < LOSS_F32_TOL, f"float32 loss with and without the kernel: {d32} >= {LOSS_F32_TOL}")
    check(r16 < LOSS_BF16_RTOL, f"bf16 loss with and without the kernel: {r16} >= {LOSS_BF16_RTOL}")

    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16", use_kernels=True)
    cast = Model(bcfg).cast_params(params)
    model = Model(bcfg)

    def one_call():
        with torch.no_grad():
            model.loss(cast, batch)

    one_call()  # warm
    _, busy_ms, n, by_name, _ = _profile(one_call)
    TIMED[(cfg.name, "loss")] = {"busy_ms": busy_ms}
    ssd_ms = sum(us for name, us in by_name if any(st in name for st in SSD_STAGES)) / 1e3
    print(f"[breakdown] {cfg.name} {cfg.n_layers}L loss B={LOSS_BATCH} S={LOSS_SEQ} bf16 "
          f"use_kernels=True: device busy {busy_ms:.2f} ms, {n} kernel launches; ssd_scan "
          f"{ssd_ms:.2f} ms "
          f"({ssd_ms / busy_ms if busy_ms else float('nan'):.3f} of busy: "
          + " + ".join(f"{st.replace('_kernel', '')} "
                       f"{sum(us for name, us in by_name if st in name) / 1e3:.2f}"
                       for st in SSD_STAGES)
          + "); top: "
          + "; ".join(f"{k[:60]} {v / 1e3:.2f} ms" for k, v in by_name[:4]))
    del cast, params
    _free()
    return launches


# ---------------------------------------------------------------------------
# [sim]: the paper's §5.2 tests on the port's simulator, the card's host
# ---------------------------------------------------------------------------

SIM_RUNS = (("default", False), ("shared", True))   # (scheduler, tagged) of each test


def phase_sim():
    """[sim]: every §5.2 test, its users started together, under both batch
    backends; the records must be equal and no kernel may launch. Returns
    {kernel: launches} of its runs."""
    from repro_torch.core.sim import scenarios

    _reset_counts()
    records, saved = {}, dict(scenarios.WORKLOADS)
    try:
        for test in saved:
            scenarios.WORKLOADS[test] = dataclasses.replace(saved[test], ramp_up=0.0)
        for backend in ("numpy", "torch"):
            with _batch_backend(backend):
                records[backend] = {
                    (test, sched): [dataclasses.asdict(r) for r in scenarios.run_benchmark(
                        test, scheduler=sched, tagged=tagged)[1].records]
                    for test in saved for sched, tagged in SIM_RUNS}
    finally:
        scenarios.WORKLOADS.update(saved)
    launches = _counts()
    check(not any(launches.values()), f"[sim] the simulator launched kernels: {launches}")
    differ = [k for k in records["numpy"] if records["numpy"][k] != records["torch"][k]]
    check(not differ, f"[sim] records differ between the numpy and torch backends: {differ}")
    n = sum(len(v) for v in records["numpy"].values())
    print(f"[sim] records identical under numpy and torch: {len(records['numpy'])} runs, "
          f"{n} requests")
    return launches


# ---------------------------------------------------------------------------
# [topology]: the paper's case study on replicas of smollm-135m on the card
# ---------------------------------------------------------------------------

#: examples/serve_topology.py's policy: three request classes over edge and
#: cloud replicas (``critical`` pinned to the edge, ``machine_learning``
#: to the cloud with zone-tolerant fallback, untagged work local first).
CASE_STUDY_SCRIPT = """
- critical:
  - controller: LocalCtl_1
    workers:
    - set: edge
    strategy: random
    topology_tolerance: none
  followup: fail
- machine_learning:
  - controller: CloudCtl
    workers:
    - set: cloud
    topology_tolerance: same
  followup: default
- default:
  - controller: LocalCtl_1
    workers:
    - set: internal
      strategy: random
    - set: cloud
      strategy: random
    strategy: best_first
  - controller: LocalCtl_2
    workers:
    - set: internal
      strategy: random
    - set: cloud
      strategy: random
    strategy: best_first
  strategy: random
"""

#: The live policy apply: the ML class flipped to the edge.
FLIPPED = CASE_STUDY_SCRIPT.replace(
    "- controller: CloudCtl\n    workers:\n    - set: cloud",
    "- controller: LocalCtl_1\n    workers:\n    - set: edge",
)

#: The constraint layer's spread: ``spread`` requests avoid replicas that
#: already serve the model, and spill to any replica once all do.
SPREAD_SCRIPT = CASE_STUDY_SCRIPT + """
- spread:
  - workers:
    - set:
    strategy: best_first
    invalidate: capacity_used 75%
    anti-affinity: [smollm-135m]
  - workers:
    - set:
  followup: default
"""

#: The federation's policy: ``critical`` work pinned to the edge (forwarded
#: there from any entrypoint, never placed outside it), everything else
#: zone-local first with cross-zone spill.
FEDERATION_SCRIPT = """
- critical:
  - controller: EdgeCtl
    workers:
    - set: edge
    topology_tolerance: none
  followup: fail
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
"""

TOPOLOGY_RTT = 0.040     # the federation's edge-cloud round trip (s)
TOPOLOGY_MAX_LEN = 32    # each replica's cache length, as in the example
#: The engines' straggler flag reads decode-tick wall times, so a slow tick
#: on a loaded host would move a replica's load and with it the stats that
#: runs are compared on; no step of the case study relies on it (the
#: example leaves it at 4.0), so it is off.
TOPOLOGY_STRAGGLER_FACTOR = float("inf")
#: (compute dtype, use_kernels, REPRO_BATCH_BACKEND) of each [topology] run:
#: the float32 runs, which must agree, are compared across the backends.
TOPOLOGY_RUNS = (("bfloat16", True, "numpy"), ("float32", True, "torch"),
                 ("float32", False, "numpy"))
EDGE, CLOUD = {"W_1", "W_2"}, {"W_3", "W_4"}


@contextlib.contextmanager
def _batch_backend(backend):
    """``REPRO_BATCH_BACKEND`` set to ``backend`` in the block (engines read
    it when they are built), restored after it."""
    saved = os.environ.get("REPRO_BATCH_BACKEND")
    os.environ["REPRO_BATCH_BACKEND"] = backend
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("REPRO_BATCH_BACKEND", None)
        else:
            os.environ["REPRO_BATCH_BACKEND"] = saved


def port_topology_api():
    """The classes :func:`topology_case` drives, from the port."""
    from repro_torch.core.platform import ClusterSpec, ControllerSpec, FederationSpec
    from repro_torch.core.scheduler.topology import DistributionPolicy
    from repro_torch.core.sim import NetworkModel
    from repro_torch.runtime.serve_engine import Replica, ServingEngine

    return {"ClusterSpec": ClusterSpec, "ControllerSpec": ControllerSpec,
            "FederationSpec": FederationSpec, "DistributionPolicy": DistributionPolicy,
            "NetworkModel": NetworkModel, "Replica": Replica, "ServingEngine": ServingEngine}


def _outcome(reqs):
    return [(r.replica, list(r.output), r.finished_tick, r.state) for r in reqs]


def topology_case(api, cfg, params):
    """The steps of ``examples/serve_topology.py`` on ``api``'s engine.

    ``api`` maps the names of :func:`port_topology_api` to classes (the
    port's, or the JAX package's in ``tests/test_torch_topology.py``).
    Returns what each step observed, as plain values, and the two engines.
    """
    ServingEngine, Replica = api["ServingEngine"], api["Replica"]
    shared = api["DistributionPolicy"].SHARED
    model = cfg.name
    out = {}

    engine = ServingEngine(distribution=shared, tapp_script=CASE_STUDY_SCRIPT,
                           straggler_factor=TOPOLOGY_STRAGGLER_FACTOR)
    engine.add_controller("LocalCtl_1", zone="edge")
    engine.add_controller("LocalCtl_2", zone="edge")
    engine.add_controller("CloudCtl", zone="cloud")
    for name, zone, sets in (("W_1", "edge", ["edge", "internal"]),
                             ("W_2", "edge", ["edge", "internal"]),
                             ("W_3", "cloud", ["cloud"]), ("W_4", "cloud", ["cloud"])):
        engine.add_replica(Replica(name, cfg, params, zone=zone, sets=sets, slots=2,
                                   max_len=TOPOLOGY_MAX_LEN))

    # The three request classes.
    classes = {label: [engine.submit(model, [1, 2, 3], tag=tag, max_new_tokens=3)
                       for _ in range(3)]
               for tag, label in (("critical", "critical"), ("machine_learning", "ml"),
                                  (None, "generic"))}
    engine.run_until_done()
    out["classes"] = {label: _outcome(reqs) for label, reqs in classes.items()}

    # The cloud replica W_3 lost mid-service: its requests re-route.
    ml = [engine.submit(model, [7, 8], tag="machine_learning", max_new_tokens=6)
          for _ in range(4)]
    engine.step_once()
    out["running_at_failure"] = sorted(r.replica for r in ml if r.replica is not None)
    engine.remove_replica("W_3")
    engine.run_until_done()
    out["failure"] = _outcome(ml)

    # Live policy apply (ML flipped to the edge), then rollback.
    for step, apply in (("flip", lambda: engine.platform.apply_policy(FLIPPED)),
                        ("rollback", engine.platform.rollback)):
        version = apply().version
        reqs = [engine.submit(model, [9], tag="machine_learning", max_new_tokens=3)
                for _ in range(3)]
        engine.run_until_done()
        out[step] = (version, _outcome(reqs))

    # Anti-affinity spread and the typed explain() report.
    engine.platform.apply_policy(SPREAD_SCRIPT)
    spread = [engine.submit(model, [4, 2], tag="spread", max_new_tokens=8) for _ in range(3)]
    engine.step_once()
    out["spread_placed"] = [r.replica for r in spread]
    report = engine.platform.explain(model, tag="spread", model_id=model)
    out["explain"] = report.render()
    out["rejections"] = report.rejections()
    engine.run_until_done()
    out["spread"] = _outcome(spread)
    out["stats"] = dataclasses.asdict(engine.platform.stats())

    # Federation: edge and cloud entrypoints, forwarding priced at TOPOLOGY_RTT.
    spec = api["FederationSpec"].of(
        {"edge": api["ClusterSpec"](controllers=(api["ControllerSpec"]("EdgeCtl"),)),
         "cloud": api["ClusterSpec"](controllers=(api["ControllerSpec"]("CloudCtl"),))},
        network=api["NetworkModel"](rtt={("edge", "cloud"): TOPOLOGY_RTT}, bandwidth={}),
        default_entry="edge",
    )
    fed = ServingEngine(distribution=shared, federation=spec,
                        straggler_factor=TOPOLOGY_STRAGGLER_FACTOR)
    fed.platform.apply_policy(FEDERATION_SCRIPT)
    for name, zone in (("E_1", "edge"), ("C_1", "cloud")):
        fed.add_replica(Replica(name, cfg, params, zone=zone, sets=[zone], slots=1,
                                max_len=TOPOLOGY_MAX_LEN))
    placements = []
    invoke_batch = fed.platform.invoke_batch

    def recording(*args, **kwargs):  # keeps each placement, for its hops
        placed = invoke_batch(*args, **kwargs)
        placements.extend(placed)
        return placed

    fed.platform.invoke_batch = recording
    crit = fed.submit(model, [1, 2], tag="critical", entry_zone="cloud", max_new_tokens=3)
    generic = [fed.submit(model, [3 + i], entry_zone="edge", max_new_tokens=3)
               for i in range(2)]
    fed.run_until_done()
    out["fed_critical"] = _outcome([crit])
    out["fed_generic"] = _outcome(generic)
    out["fed_explain"] = fed.platform.explain(model, tag="critical", entry_zone="cloud",
                                             model_id=model).render()
    out["fed_stats"] = dataclasses.asdict(fed.platform.stats())
    out["fed_hops"] = [(h.from_zone, h.to_zone, h.rtt, h.scheduled)
                       for p in placements for h in p.hops]
    return out, (engine, fed)


def _check_topology(run):
    """The case study's placements, as the example narrates them."""
    def replicas(outcome):
        return {replica for replica, *_ in outcome}

    for step in ("failure", "spread", "fed_critical", "fed_generic"):
        check(all(state == "done" for *_, state in run[step]), f"[topology] {step}: not all done")
    check(all(state == "done" for reqs in run["classes"].values() for *_, state in reqs),
          "[topology] a request class left requests undone")
    check(replicas(run["classes"]["critical"]) <= EDGE,
          f"[topology] critical off the edge: {run['classes']['critical']}")
    check(replicas(run["classes"]["ml"]) <= CLOUD,
          f"[topology] ML off the cloud before the flip: {run['classes']['ml']}")
    check("W_3" in run["running_at_failure"], "[topology] W_3 held no request when it was lost")
    check(replicas(run["failure"]) <= CLOUD - {"W_3"},
          f"[topology] ML after W_3's loss: {run['failure']}")
    check(replicas(run["flip"][1]) <= EDGE, f"[topology] ML after the flip: {run['flip']}")
    check(replicas(run["rollback"][1]) <= CLOUD - {"W_3"},
          f"[topology] ML after the rollback: {run['rollback']}")
    check(len(set(run["spread_placed"])) == 3, f"[topology] spread: {run['spread_placed']}")
    check(bool(run["rejections"]) and "anti-affinity" in run["explain"],
          "[topology] explain() shows no anti-affinity rejection")
    check(replicas(run["fed_critical"]) == {"E_1"},
          f"[topology] the federated critical request: {run['fed_critical']}")
    charged = 0.0
    for _, _, rtt, _ in run["fed_hops"]:
        charged += rtt
    stats = run["fed_stats"]
    check(stats["forwards"] >= 1 and stats["cross_zone_rtt"] == charged
          and all(rtt == TOPOLOGY_RTT for _, _, rtt, _ in run["fed_hops"]),
          f"[topology] forwards {stats['forwards']}, cross_zone_rtt {stats['cross_zone_rtt']} "
          f"against hops {run['fed_hops']}")


def phase_topology():
    """[topology]: the paper's case study (examples/serve_topology.py) on
    smollm-135m at full width and depth, bf16 on the flash kernel, then
    float32 with ``use_kernels`` on and off, under the batch backends of
    ``TOPOLOGY_RUNS``. Returns {"topology": the bf16 run's {kernel:
    launches}, "topology/f32": the float32 kernel-on run's}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    dev = torch.device("cuda")
    runs, launches = {}, {}
    for dtype, use_kernels, backend in TOPOLOGY_RUNS:
        cfg = dataclasses.replace(get_config("smollm_135m"), compute_dtype=dtype,
                                  use_kernels=use_kernels)
        model = Model(cfg)
        params = model.cast_params(
            model.init_params(torch.Generator(device=dev).manual_seed(SEED), dev))
        _reset_counts()
        with _batch_backend(backend):
            run, (engine, fed) = topology_case(port_topology_api(), cfg, params)
        counts = _counts()
        reps = list(engine.replicas.values()) + list(fed.replicas.values())
        prefills = sum(len(rep.prefill_times) for rep in reps)
        check(all(rep.device.type == "cuda" for rep in reps), "[topology] a replica off the card")
        flash = cfg.n_layers * prefills if use_kernels else 0
        check(counts == {"flash_attention": flash, "gmm": 0, "ssd_scan": 0, "mamba_step": 0},
              f"[topology] launches {counts}, expected flash_attention {flash} "
              f"= {cfg.n_layers} x {prefills} prefills")
        _check_topology(run)
        captures, replays, _ = _prefill_graphs(reps, "[topology]")
        print(f"[topology] {cfg.name} {cfg.n_layers}L d={cfg.d_model} {dtype} use_kernels="
              f"{use_kernels} REPRO_BATCH_BACKEND={backend}: {prefills} prefills; prefill "
              f"graphs on the live replicas: {captures} lengths captured, {replays} replays; "
              f"launches {counts}")
        if use_kernels:
            launches["topology" if dtype == "bfloat16" else "topology/f32"] = counts
        if dtype == "bfloat16":
            for label_, outcome in run["classes"].items():
                print(f"[topology]   {label_:>8}: replicas {[o[0] for o in outcome]}")
            print(f"[topology]   W_3 lost while serving {run['running_at_failure']}; ML then on "
                  f"{[o[0] for o in run['failure']]}, all done")
            for step in ("flip", "rollback"):
                version, outcome = run[step]
                print(f"[topology]   ML after {step} (policy v{version}): "
                      f"{[o[0] for o in outcome]}")
            print(f"[topology]   spread placements {run['spread_placed']}; rejections "
                  f"{run['rejections']}")
            for line in run["explain"].splitlines():
                print(f"[topology]   | {line}")
            stats = run["fed_stats"]
            print(f"[topology]   federation: critical (entered cloud) on "
                  f"{run['fed_critical'][0][0]}, generic on {[o[0] for o in run['fed_generic']]}; "
                  f"forwards={stats['forwards']} attempts={stats['forward_attempts']} "
                  f"cross_zone_rtt={stats['cross_zone_rtt']!r} s over hops {run['fed_hops']}")
            for line in run["fed_explain"].splitlines():
                print(f"[topology]   | {line}")
        runs[(dtype, use_kernels)] = run
        del engine, fed, reps, params, model
        _free()
    f32_on, f32_off = runs[("float32", True)], runs[("float32", False)]
    differ = sorted(k for k in f32_on if f32_on[k] != f32_off[k])
    check(not differ, f"[topology] float32 use_kernels on/off differ in {differ}")
    place = {k: [o[0] for o in v] for k, v in runs[("bfloat16", True)]["classes"].items()}
    same = place == {k: [o[0] for o in v] for k, v in f32_on["classes"].items()}
    print(f"[topology] float32 use_kernels on (torch backend) and off (numpy backend) identical: "
          f"placements, tokens, ticks, explain text, rejections, stats; bf16 request classes "
          f"placed as float32: {same}")
    return launches


def _load_example(name):
    """``examples/<name>.py`` as a module (``examples`` is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_examples():
    """[examples]: the port's two user-facing examples on the card.
    ``examples/quickstart_torch.py`` at its defaults: the control plane's
    placements, and two requests on two replicas (smollm-135m's smoke
    config at 2 layers, ``use_kernels``), done on the replicas the policy
    names, with 2 layers x 2 prefills of flash launches.
    ``examples/train_smollm_torch.py`` with EXAMPLE_TRAIN_ARGS (no kernel:
    the plain path): the loss falls, one restart, and the replayed steps
    repeat their losses exactly (deterministic algorithms on). Returns
    {path: launches}."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    paths = {}
    quickstart = _load_example("quickstart_torch")
    _reset_counts()
    control, (engine, critical, normal) = quickstart.main([])
    launches = _counts()
    paths["examples/quickstart"] = launches
    check(control["placements"] == [("critical", "w-edge", "EdgeCtl"),
                                    (None, "w-edge", "EdgeCtl")],
          f"quickstart control plane placements {control['placements']}")
    devices = {rep.device.type for rep in engine.replicas.values()}
    cfg = next(iter(engine.replicas.values())).cfg
    check(devices == {"cuda"} and cfg.use_kernels,
          f"quickstart served on {devices}, use_kernels={cfg.use_kernels}")
    # critical: EdgeCtl's edge set, no topology tolerance; the default tag:
    # the platform's strategy over every worker, which picks w-edge first
    # (as on the CPU and in the JAX example).
    for request, replica in ((critical, "w-edge"), (normal, "w-edge")):
        check(request.state == "done" and request.replica == replica
              and len(request.output) == 5
              and all(0 <= t < cfg.vocab_size for t in request.output),
              f"quickstart request {request.tag}: {request.state} on {request.replica}, "
              f"tokens {request.output}")
    prefills = sum(len(rep.prefill_times) for rep in engine.replicas.values())
    check(prefills == 2, f"quickstart ran {prefills} prefills")
    captures, replays, _ = _prefill_graphs(engine.replicas.values(), "[examples] quickstart")
    check(captures + replays == prefills,
          f"quickstart: {captures} captures + {replays} replays != {prefills} prefills")
    want = {"flash_attention": cfg.n_layers * prefills, "gmm": 0, "ssd_scan": 0, "mamba_step": 0}
    check(launches == want, f"quickstart launches {launches}, expected {want}")
    print(f"[examples] examples/quickstart_torch.py: placements {control['placements']}; "
          f"critical on {critical.replica} {critical.output}, default on {normal.replica} "
          f"{normal.output} ({cfg.compute_dtype} on {', '.join(sorted(devices))}); "
          f"launches {launches} = "
          f"{cfg.n_layers} layers x {prefills} prefills of flash")
    del engine, critical, normal
    _free()

    train = _load_example("train_smollm_torch")
    root = tempfile.mkdtemp(prefix="chip_smoke_example_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _reset_counts()
        t0 = time.perf_counter()
        report = train.main([*EXAMPLE_TRAIN_ARGS, "--ckpt-dir", root])
        seconds = time.perf_counter() - t0
        launches = _counts()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    paths["examples/train_smollm"] = launches
    check(report.restarts == 1 and report.rollbacks == 0
          and report.steps == list(range(EXAMPLE_FAIL_AT))
          + list(range(EXAMPLE_REPLAYED[0], EXAMPLE_STEPS)),
          f"train example: {report.restarts} restarts, {report.rollbacks} rollbacks, steps "
          f"{report.steps}")
    first = dict(zip(report.steps[:EXAMPLE_FAIL_AT], report.losses[:EXAMPLE_FAIL_AT]))
    replay = dict(zip(report.steps[EXAMPLE_FAIL_AT:], report.losses[EXAMPLE_FAIL_AT:]))
    diffs = {s: replay[s] - first[s] for s in EXAMPLE_REPLAYED}
    head, tail = np.mean(report.losses[:5]), np.mean(report.losses[-5:])
    check(all(math.isfinite(x) for x in report.losses) and tail < head,
          f"train example loss {head} -> {tail}")
    check(all(d == 0.0 for d in diffs.values()),
          f"train example replayed steps disagree with the first pass: {diffs}")
    check(not any(launches.values()), f"the train example launched kernels: {launches}")
    times = sorted(report.step_times[1:])
    print(f"[examples] examples/train_smollm_torch.py {' '.join(EXAMPLE_TRAIN_ARGS)}: "
          f"{len(report.losses)} steps in {seconds:.1f} s (step median "
          f"{statistics.median(times) * 1e3:.2f} ms), loss mean of the first 5 {head:.6f}, of "
          f"the last 5 {tail:.6f}; restarts={report.restarts}; replayed steps "
          f"{list(EXAMPLE_REPLAYED)}: loss - first pass = {diffs} (required: exactly 0); "
          f"launches {launches}")
    return paths


def _train_run(cfg, opt_cfg, steps, batch, seq, ckpt_dir, **loop_kw):
    """``steps`` steps of the port's fault-tolerant loop from a seeded
    float32 init. Returns (report, initial state, data pipeline)."""
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    params = Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    pipeline = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=batch, seq_len=seq, seed=SEED,
        frames_dim=cfg.d_model if cfg.family == "encdec" else 0))
    report = run_training(
        step_fn=make_train_step(cfg, opt_cfg), state=state, pipeline=pipeline,
        checkpointer=Checkpointer(ckpt_dir), device="cuda",
        config=TrainLoopConfig(total_steps=steps, **loop_kw),
        on_metrics=lambda step, m: print(
            f"[train]   step {step:>2} loss {float(m['loss']):.6f} grad_norm "
            f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3e} "
            f"({m['step_time_s'] * 1e3:.1f} ms)"),
    )
    return report, state, pipeline


def _named_pairs(a, b, prefix=""):
    """(name, (leaf of a, leaf of b)) over two nested dicts of one structure."""
    for key in a:
        if isinstance(a[key], dict):
            yield from _named_pairs(a[key], b[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", (a[key], b[key])


def _train_configs():
    """[train]'s model and optimizer: smollm-135m at full width and depth,
    float32 params, bf16 compute, full remat, the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(get_config("smollm_135m"), compute_dtype="bfloat16",
                              param_dtype="float32", remat="full", use_kernels=False)
    return cfg, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)


def phase_train():
    """The training path on the card (plain path: no kernel launches).
    Returns {path: launches}."""
    import math
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig

    paths = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # Replayed steps must repeat exactly: deterministic algorithms on (an
    # op without a deterministic version warns; the warnings are printed).
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            cfg, opt_cfg = _train_configs()
            print(f"[train] {cfg.name} {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
                  f"B={TRAIN_BATCH} S={TRAIN_SEQ} params {cfg.param_dtype} compute "
                  f"{cfg.compute_dtype} remat={cfg.remat} moments {opt_cfg.moment_dtype}: "
                  f"{TRAIN_STEPS} steps, async checkpoint every {TRAIN_CKPT_EVERY}, "
                  f"failure injected at step {TRAIN_FAIL_AT}")
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            report, state, pipeline = _train_run(
                cfg, opt_cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, os.path.join(root, "main"),
                checkpoint_every=TRAIN_CKPT_EVERY, checkpoint_async=True, log_every=1,
                inject_failure_at=TRAIN_FAIL_AT)
            seconds = time.perf_counter() - t0
            paths["smollm_135m/train"] = _counts()
            peak = torch.cuda.max_memory_allocated()
            first = dict(zip(report.steps[:TRAIN_FAIL_AT], report.losses[:TRAIN_FAIL_AT]))
            replay = dict(zip(report.steps[TRAIN_FAIL_AT:], report.losses[TRAIN_FAIL_AT:]))
            print(f"[train] restarts={report.restarts} rollbacks={report.rollbacks} "
                  f"stragglers={report.straggler_steps} events={report.events}")
            check(report.restarts == 1 and report.rollbacks == 0
                  and report.events == [f"restart at step {TRAIN_FAIL_AT}: RuntimeError: "
                                        f"injected failure at step {TRAIN_FAIL_AT}"],
                  f"train loop: {report.restarts} restarts, {report.rollbacks} rollbacks, "
                  f"events {report.events}")
            check(report.steps == list(range(TRAIN_FAIL_AT))
                  + list(range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS)),
                  f"train loop ran steps {report.steps}")
            check(all(math.isfinite(x) for x in report.losses), "a non-finite training loss")
            head, tail = np.mean(report.losses[:5]), np.mean(report.losses[-5:])
            print(f"[train] loss mean of the first 5 steps {head:.6f}, of the last 5 {tail:.6f}")
            check(tail < head, f"training loss did not fall: {head} -> {tail}")
            diffs = {s: replay[s] - first[s] for s in TRAIN_REPLAYED}
            print(f"[train] replayed steps {list(TRAIN_REPLAYED)} after the restart: loss - "
                  f"first pass = {diffs} (required: exactly 0)")
            check(all(d == 0.0 for d in diffs.values()),
                  f"replayed steps disagree with the first pass: {diffs}")
            check(not any(paths["smollm_135m/train"].values()),
                  f"training launched kernels: {paths['smollm_135m/train']}")
            times = sorted(report.step_times[1:])  # the first step includes warm-up
            step_ms = statistics.median(times) * 1e3
            print(f"[train] step median {step_ms:.2f} ms ({times[0] * 1e3:.2f}-"
                  f"{times[-1] * 1e3:.2f}; first step {report.step_times[0] * 1e3:.2f}), "
                  f"tokens/s {TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3):.1f}, peak memory "
                  f"{peak / 2**20:.1f} MiB, {len(report.losses)} steps in {seconds:.1f} s "
                  f"(checkpoints, restart and restore included)")

            step_fn = make_train_step(cfg, opt_cfg)
            batch = make_global_batch(pipeline, 0, "cuda")
            step_fn(state, batch)  # warm
            _, busy_ms, n, by_name, _ = _profile(lambda: step_fn(state, batch))
            TIMED[(cfg.name, "train")] = {
                "busy_ms": busy_ms, "step_ms": step_ms, "peak": peak,
                "losses": dict(zip(report.steps[:TRAIN_FAIL_AT],
                                   report.losses[:TRAIN_FAIL_AT]))}
            print(f"[breakdown] {cfg.name} train step B={TRAIN_BATCH} S={TRAIN_SEQ}: device busy "
                  f"{busy_ms:.2f} ms, {n} kernel launches; top: "
                  + "; ".join(f"{k[:60]} {v / 1e3:.2f} ms" for k, v in by_name[:4]))
            del state, batch, step_fn, pipeline
            _free()

            int8_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                                   moment_dtype="int8", compression="int8")
            _reset_counts()
            report, state, _ = _train_run(cfg, int8_cfg, 3, TRAIN_BATCH, TRAIN_SEQ,
                                          os.path.join(root, "int8"), checkpoint_every=1000)
            paths["smollm_135m/train_int8"] = _counts()
            print(f"[train] {cfg.name} int8 moments + int8 grad compression, 3 steps: losses "
                  f"{report.losses}, step times ms {[round(t * 1e3, 2) for t in report.step_times]}")
            check(len(report.losses) == 3 and all(math.isfinite(x) for x in report.losses),
                  f"int8 training losses {report.losses}")
            del state
            _free()

            whisper = dataclasses.replace(get_config("whisper_small"), compute_dtype="bfloat16",
                                          use_kernels=False)
            wseq = WHISPER_MAX_LEN
            _reset_counts()
            report, state, _ = _train_run(whisper, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                               total_steps=3),
                                          3, TRAIN_BATCH, wseq, os.path.join(root, "whisper"),
                                          checkpoint_every=1000)
            paths["whisper_small/train"] = _counts()
            final, _, _ = Checkpointer(os.path.join(root, "whisper")).restore(state)
            unchanged = [name for name, (a, b) in _named_pairs(final.params, state.params)
                         if torch.equal(a, b)]
            n_leaves = len(list(tree_leaves(state.params)))
            changed = n_leaves - len(unchanged)
            print(f"[train] {whisper.name} {whisper.encoder_layers}+{whisper.n_layers}L "
                  f"B={TRAIN_BATCH} S={wseq} tokens, {wseq} frames of {whisper.d_model}, "
                  f"remat={whisper.remat}, 3 steps: losses {report.losses}, step times ms "
                  f"{[round(t * 1e3, 2) for t in report.step_times]}; {changed} of {n_leaves} "
                  f"param leaves changed")
            check(len(report.losses) == 3 and all(math.isfinite(x) for x in report.losses),
                  f"whisper training losses {report.losses}")
            # The key biases start at zero and their gradient is zero in exact
            # arithmetic (softmax ignores a shift of a query's scores).
            check(all(name.endswith("/bk") for name in unchanged),
                  f"whisper params unchanged by 3 steps: {unchanged}")
            del state, final
            _free()
            for path in ("smollm_135m/train_int8", "whisper_small/train"):
                check(not any(paths[path].values()), f"{path} launched kernels: {paths[path]}")
        for message in sorted({f"{w.category.__name__}: {w.message}"[:240] for w in caught}):
            print(f"[train] warning: {message}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    return paths


def phase_shard():
    """[shard]: [train]'s model, optimizer, seed and data stream as a sharded
    train step on the card's one-rank ("data", "model") NCCL mesh: the
    state placed by ``init_sharded_train_state`` (every param and moment a
    DTensor), SHARD_STEPS steps through ``run_training`` with the state's
    and the batch's shardings. Each loss must equal [train]'s at the same
    step to SHARD_LOSS_RTOL relative (on one rank every placement
    replicates and the local ops are [train]'s, so bit-identity is
    expected; the line says which holds). Returns (launches, measured
    peak bytes)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_gpu_mesh
    from repro_torch.launch.steps import (
        abstract_train_state,
        init_sharded_train_state,
        make_train_step,
        train_state_shardings,
    )
    from repro_torch.models.lm import tree_leaves
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training
    from repro_torch.sharding.specs import ShardingPolicy, batch_shardings

    cfg, opt_cfg = _train_configs()
    ref = TIMED[(cfg.name, "train")]
    root = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_gpu_mesh()
        policy = ShardingPolicy().for_mesh(mesh)
        shardings = train_state_shardings(cfg, policy, mesh, abstract_train_state(cfg, opt_cfg))
        pipeline = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                              global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                              seed=SEED))
        b_sh = batch_shardings(cfg, policy, mesh, None, pipeline.batch_at(0))
        step = make_train_step(cfg, opt_cfg, mesh=mesh, policy=policy,
                               state_shardings=shardings)
        seen = []  # per step: every param and moment a DTensor, before and after

        def dtensors(state):
            leaves = list(tree_leaves([state.params, state.opt.m, state.opt.v]))
            return len(leaves), all(isinstance(x, DTensor) for x in leaves)

        def step_fn(st, batch):
            new, metrics = step(st, batch)
            seen.append((dtensors(st), dtensors(new),
                         tuple(new.params["embed"]["table"].placements)))
            return new, metrics

        print(f"[shard] {cfg.name} {cfg.n_layers}L on the mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (NCCL, {dist.get_world_size()} "
              f"rank), B={TRAIN_BATCH} S={TRAIN_SEQ}, {SHARD_STEPS} steps")
        _free()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.perf_counter()
        # The state goes to the loop alone: a reference kept here would hold
        # the first state through every step (1.5 GB the loop itself frees).
        report = run_training(
            step_fn=step_fn, device="cuda",
            state=init_sharded_train_state(cfg, opt_cfg, mesh, policy,
                                           torch.Generator(device="cuda").manual_seed(SEED)),
            pipeline=pipeline, checkpointer=Checkpointer(root),
            config=TrainLoopConfig(total_steps=SHARD_STEPS, checkpoint_every=1000, log_every=1),
            batch_shardings=b_sh, state_shardings=shardings,
            on_metrics=lambda s, m: print(f"[shard]   step {s} loss {float(m['loss']):.6f} "
                                          f"({m['step_time_s'] * 1e3:.1f} ms)"))
        seconds = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated() - base
        all_dtensors = all(before[1] and after[1] for before, after, _ in seen)
        print(f"[shard] {seen[0][0][0]} param and moment leaves, DTensors before and after "
              f"every step: {all_dtensors}; placements of the embedding {seen[0][2]}")
        check(all_dtensors, "a param or moment of the sharded state is not a DTensor")
        check(report.steps == list(range(SHARD_STEPS)) and report.restarts == 0,
              f"sharded loop ran steps {report.steps}, restarts {report.restarts}")
        unsharded = [ref["losses"][s] for s in report.steps]
        rel = [abs(a - b) / abs(b) for a, b in zip(report.losses, unsharded)]
        identical = report.losses == unsharded
        print(f"[shard] losses {report.losses}; [train] at the same steps {unsharded}: "
              f"max relative difference {max(rel):.3e} (limit {SHARD_LOSS_RTOL:g}); "
              f"bit-identical: {identical}")
        check(max(rel) <= SHARD_LOSS_RTOL,
              f"sharded losses differ from the unsharded ones: {max(rel)}")
        check(not any(launches.values()), f"the sharded step launched kernels: {launches}")
        times = sorted(report.step_times[1:])
        step_ms = statistics.median(times) * 1e3
        print(f"[shard] step median {step_ms:.2f} ms (unsharded [train] {ref['step_ms']:.2f}), "
              f"tokens/s {TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3):.1f} (unsharded "
              f"{TRAIN_BATCH * TRAIN_SEQ / (ref['step_ms'] / 1e3):.1f}), peak memory "
              f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before "
              f"(unsharded [train] {ref['peak'] / 2**20:.1f} MiB), {len(report.losses)} steps "
              f"in {seconds:.1f} s")
        _free()
        dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    return launches, peak


def dryrun_child() -> int:
    """``chip_smoke.py --dryrun-child``: the dry-run's part of [dryrun], in a
    process of its own (a fake process group of 512 ranks; fake tensors,
    on no device). Prints ``RESULT:`` and a JSON object: [shard]'s cell
    traced on a fake (1, 1) mesh, the counts of the four timed steps on the
    plain path at their shapes (with the other paths' prefills,
    ``PREFILL_BOUNDS``), and the production cells."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import dryrun_cell, fake_tensors
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.steps import TrainState, abstract_train_state, make_train_step
    from repro_torch.models import Model
    from repro_torch.models.api import ShapeSpec
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline.analysis import roofline_terms
    from repro_torch.roofline.trace import count_call

    out = {}
    t_child = t0 = time.perf_counter()
    cfg, opt_cfg = _train_configs()
    out["card"] = dryrun_cell(
        "smollm_135m", ShapeSpec("card_train", "train", TRAIN_SEQ, TRAIN_BATCH), "card",
        cfg=cfg, opt_cfg=opt_cfg, mesh=make_fake_mesh((1, 1), ("data", "model")),
        save=False, verbose=False)
    out["card"]["seconds"] = time.perf_counter() - t0

    def terms(counts):
        t = roofline_terms(counts=counts, n_chips=1, model_flops_total=0.0)
        return {"flops": t.flops_per_device, "flops_by_dtype": t.flops_by_dtype,
                "bytes": t.bytes_per_device, "compute_s": t.compute_s,
                "memory_s": t.memory_s, "bound_s": t.bound_s}

    steps = {}
    t0 = time.perf_counter()
    with FakeTensorMode():
        smollm = dataclasses.replace(get_config("smollm_135m"), compute_dtype="bfloat16")
        model = Model(smollm)
        params = model.cast_params(fake_tensors(abstract_train_state(smollm).params))
        prompt_len, position = BREAKDOWN
        cache1 = fake_tensors(model.cache_specs(ShapeSpec("c", "decode", SERVE_MAX_LEN, 1)))
        prompt = torch.zeros((1, prompt_len), dtype=torch.int64)
        _, c = count_call(lambda: model.prefill(params, {"tokens": prompt}, cache1),
                          track=(params, cache1, prompt))
        steps["prefill"] = terms(c)
        for arch, (s_len, max_len, enc_len, kw) in PREFILL_BOUNDS.items():
            pcfg = dataclasses.replace(get_config(arch), compute_dtype="bfloat16", **kw)
            pmodel = Model(pcfg)
            pparams = pmodel.cast_params(fake_tensors(abstract_train_state(pcfg).params))
            pcache = pmodel.init_cache(1, max_len, enc_len=enc_len or 0, device="cpu")
            pbatch = {"tokens": torch.zeros((1, s_len), dtype=torch.int64)}
            if enc_len:
                pbatch["frames"] = torch.zeros((1, enc_len, pcfg.d_model))
            _, c = count_call(lambda: pmodel.prefill(pparams, pbatch, pcache),
                              track=(pparams, pcache, pbatch))
            steps[f"prefill/{arch}"] = terms(c)
            del pparams, pcache
        cache = fake_tensors(model.cache_specs(
            ShapeSpec("c", "decode", SERVE_MAX_LEN, SERVE_SLOTS)))
        tok = torch.zeros((SERVE_SLOTS,), dtype=torch.int32)
        pos = torch.full((SERVE_SLOTS,), position, dtype=torch.int32)
        _, c = count_call(lambda: model.decode(params, cache, tok, pos),
                          track=(params, cache, tok, pos))
        steps["decode"] = terms(c)
        del params, cache, cache1

        mamba = dataclasses.replace(get_config("mamba2_2_7b"), compute_dtype="bfloat16")
        mmodel = Model(mamba)
        mparams = mmodel.cast_params(fake_tensors(abstract_train_state(mamba).params))
        tokens = torch.zeros((LOSS_BATCH, LOSS_SEQ), dtype=torch.int64)
        with torch.no_grad():
            _, c = count_call(lambda: mmodel.loss(mparams, {"tokens": tokens}),
                              track=(mparams, tokens))
        steps["loss"] = terms(c)
        del mparams

        tparams = fake_tensors(abstract_train_state(cfg, opt_cfg).params)
        state = TrainState(params=tparams, opt=adamw_init(opt_cfg, tparams))
        batch = {"tokens": torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32)}
        _, c = count_call(make_train_step(cfg, opt_cfg), state, batch)
        steps["train"] = terms(c)
    out["steps"] = steps
    out["steps_seconds"] = time.perf_counter() - t0

    cells = []
    for arch, shape, mesh_kind in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun_cell(arch, shape, mesh_kind, save=False, verbose=False)
        rec["seconds"] = time.perf_counter() - t0
        cells.append(rec)
    out["cells"] = cells
    out["seconds"] = time.perf_counter() - t_child
    print("RESULT:" + json.dumps(out))
    return 0


def start_dryrun_child():
    """Start ``dryrun_child`` in a process of its own (it needs the CPU only)."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dryrun-child"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def phase_dryrun(child, shard_peak):
    """[dryrun]: the dry-run and the roofline against the card.

    1. [shard]'s cell traced on a fake (1, 1) mesh: its per-device bytes
       must lie within MEMORY_RTOL of [shard]'s measured peak;
    2. the four timed steps (smollm's prefill at S=512 and decode tick,
       mamba2's loss at B=2 x S=4096, smollm's train step) and the
       prefills of paths 2-4 (``PREFILL_BOUNDS``), counted on the plain
       path at their shapes: FLOPs, bytes written and the H100 bound
       (datasheet peaks, float32 matmuls at the float32 rate as TF32 is
       off), which must not exceed the measured device-busy time (a
       prefill's eager and CUDA-graph busy both);
    3. one production cell per family on the fake meshes: each must end
       "ok", the train cell with collective wire bytes > 0.
    """
    try:
        stdout, stderr = child.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise RuntimeError(f"the dry-run child ran past {DRYRUN_TIMEOUT_S} s")
    check(child.returncode == 0, f"the dry-run child failed ({child.returncode}): "
          f"{stderr[-3000:]}")
    line = next((ln for ln in stdout.splitlines() if ln.startswith("RESULT:")), None)
    check(line is not None, f"the dry-run child printed no result: {stdout[-2000:]}")
    out = json.loads(line[len("RESULT:"):])
    print(f"[dryrun] the dry-run process took {out['seconds']:.1f} s, beside [train] and [shard]")

    card = out["card"]
    check(card["status"] == "ok", f"the dry-run of [shard]'s cell: {card.get('error')}")
    pred = card["memory"]["per_device_bytes"]
    rel = pred / shard_peak - 1.0
    print(f"[dryrun] [shard]'s cell (smollm-135m train B={TRAIN_BATCH} S={TRAIN_SEQ}, fake (1, 1) "
          f"mesh, traced in {card['seconds']:.1f} s): predicted peak {pred / 2**20:.1f} MiB "
          f"({card['memory']['start_bytes'] / 2**20:.1f} MiB of state and batch), measured "
          f"{shard_peak / 2**20:.1f} MiB: {rel:+.2%} (limit {MEMORY_RTOL:.0%})")
    failures = []
    if abs(rel) > MEMORY_RTOL:
        failures.append(f"dry-run memory {pred} vs measured {shard_peak}: {rel:+.2%}")

    prefill = ("prefill", "prefill/graph")
    timed = {
        "prefill": ("smollm-135m", prefill, f"smollm-135m prefill S={BREAKDOWN[0]}"),
        "decode": ("smollm-135m", ("decode",), f"smollm-135m decode tick ({SERVE_SLOTS} slots, "
                                               f"cache {SERVE_MAX_LEN})"),
        "loss": ("mamba2-2.7b", ("loss",), f"mamba2-2.7b loss B={LOSS_BATCH} S={LOSS_SEQ}"),
        "train": ("smollm-135m", ("train",), f"smollm-135m train step B={TRAIN_BATCH} "
                                             f"S={TRAIN_SEQ}"),
        "prefill/phi3_5_moe_42b": ("phi3.5-moe-42b-a6.6b", prefill,
                                   f"phi3.5-MoE {MOE_DEPTH}L prefill S={BREAKDOWN[0]}"),
        "prefill/mamba2_2_7b": ("mamba2-2.7b", prefill, f"mamba2-2.7b prefill S={BREAKDOWN[0]}"),
        "prefill/whisper_small": ("whisper-small", prefill,
                                  f"whisper-small prefill S={WHISPER_PROMPT[1]} "
                                  f"({WHISPER_ENC_LEN} frames)"),
    }
    print(f"[dryrun] {len(timed)} timed steps counted in {out['steps_seconds']:.1f} s")
    for key, (model_name, kinds, label) in timed.items():
        c = out["steps"][key]
        bound_ms = c["bound_s"] * 1e3
        by = "operations" if c["compute_s"] >= c["memory_s"] else "bytes"
        busy = {kind: TIMED[(model_name, kind)]["busy_ms"] for kind in kinds}
        print(f"[dryrun] {label}: {c['flops']:.4g} matmul FLOPs "
              f"({', '.join(f'{k} {v:.4g}' for k, v in sorted(c['flops_by_dtype'].items()))}), "
              f"{c['bytes']:.4g} bytes written; H100 bound {bound_ms:.3f} ms (compute "
              f"{c['compute_s'] * 1e3:.3f}, memory {c['memory_s'] * 1e3:.3f}; bound by {by}), "
              + "; ".join(f"measured device busy ({kind}) {ms:.3f} ms: bound / busy "
                          f"{bound_ms / ms:.4f}" for kind, ms in busy.items()))
        for kind, ms in busy.items():
            if bound_ms > ms:
                failures.append(f"{label} ({kind}): bound {bound_ms} ms above the busy {ms} ms")

    for rec in out["cells"]:
        if rec["status"] != "ok":
            failures.append(f"dry-run cell {rec['arch']} {rec['shape']} {rec['mesh']}: "
                            f"{rec.get('error')} {rec.get('traceback', '')[-1500:]}")
            continue
        t, m = rec["roofline"], rec["memory"]
        print(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']} ({rec['n_chips']} fake ranks, "
              f"traced in {rec['seconds']:.1f} s): {m['per_device_gib']:.3f} GiB per device "
              f"(fits {m['fits_hbm']}), compute {t['compute_s']:.6f} s, memory "
              f"{t['memory_s']:.6f} s, collective {t['collective_s']:.6f} s, dominant "
              f"{t['dominant']}, wire {t['wire_bytes_per_device']:.4g} bytes per device")
        if rec["shape"] == "train_4k" and not t["wire_bytes_per_device"] > 0:
            failures.append(f"{rec['arch']} train: no collective wire")
    check(not failures, "; ".join(failures))


def main(argv) -> int:
    if "--dryrun-child" in argv:
        return dryrun_child()
    only_kernels = "--kernels-only" in argv
    # cuBLAS is deterministic with a fixed workspace (the size PyTorch picks
    # on Hopper), which the train phase's exact replay relies on; it is read
    # when the first cuBLAS handle is made, so before any matmul.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    phase_device()
    phase_build()
    rows = phase_kernel_check()
    gmm_rows = phase_gmm_check()
    _free()
    ssd_rows = phase_ssd_check()
    _free()
    mamba_rows = phase_mamba_check()
    _free()
    paths = {}
    if not only_kernels:
        t_path = time.perf_counter()

        def timed(name):
            nonlocal t_path
            now = time.perf_counter()
            print(f"[time] {name}: {now - t_path:.1f} s")
            t_path = now

        paths.update(phase_cli())
        timed("CLI at its defaults (smollm-135m, phi3.5-MoE, mamba2-2.7b, whisper-small smoke configs)")
        smollm = dataclasses.replace(get_config("smollm_135m"), compute_dtype="bfloat16")
        paths.update(run_path("smollm_135m", smollm, smollm))
        timed("path 1 (smollm-135m)")
        phi = dataclasses.replace(get_config("phi3_5_moe_42b"), compute_dtype="bfloat16",
                                  n_layers=MOE_DEPTH)
        print(f"[serve] {phi.name}: depth cut from "
              f"{get_config('phi3_5_moe_42b').n_layers} to {phi.n_layers} layers "
              f"(reduced: n_layers), every width as published")
        paths.update(run_path("phi3_5_moe_42b", phi, dataclasses.replace(phi, n_layers=2)))
        _free()
        timed("path 2 (phi3.5-MoE)")
        mamba = dataclasses.replace(get_config("mamba2_2_7b"), compute_dtype="bfloat16")
        print(f"[serve] {mamba.name}: full width and depth ({mamba.n_layers} layers)")
        paths.update(run_path("mamba2_2_7b/serve", mamba, None))
        paths["mamba2_2_7b/loss"] = phase_loss(mamba)
        timed("path 3 (mamba2-2.7b)")
        whisper = dataclasses.replace(get_config("whisper_small"), compute_dtype="bfloat16")
        print(f"[serve] {whisper.name}: full width and depth ({whisper.encoder_layers} encoder + "
              f"{whisper.n_layers} decoder layers), {WHISPER_ENC_LEN} frames per request")
        whisper_kw = dict(prompt=WHISPER_PROMPT,
                          breakdown=(WHISPER_PROMPT[1], WHISPER_MAX_LEN - 1),
                          max_len=WHISPER_MAX_LEN, enc_len=WHISPER_ENC_LEN)
        paths.update(run_path("whisper_small", whisper, whisper, **whisper_kw))
        timed("path 4 (whisper-small)")
        paths["sim"] = phase_sim()
        timed("sim (the paper's §5.2 tests on the port's simulator, the card's host)")
        paths.update(phase_topology())
        timed("topology (the paper's case study on smollm-135m at full width)")
        paths.update(phase_examples())
        timed("examples (quickstart_torch.py, train_smollm_torch.py)")
        # The dry-run needs the CPU only: it runs beside [train] and [shard].
        child = start_dryrun_child()
        try:
            paths.update(phase_train())
            timed("train (smollm-135m, int8 moments, whisper-small)")
            paths["smollm_135m/shard"], shard_peak = phase_shard()
            timed("shard (smollm-135m sharded train step on the one-rank mesh)")
            phase_dryrun(child, shard_peak)
            timed("dryrun (memory, bounds, production cells)")
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()

    def launches_of(name):
        if only_kernels:
            return None
        return sum(counts[name] for counts in paths.values())

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    shape, dtype_name = REPORT_SHAPE
    gname, gshape, gdtype = GMM_REPORT_SHAPE
    sshape, sdtype = SSD_REPORT_SHAPE
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": launches_of("flash_attention"),
        "launches_by_path": by_path("flash_attention"),
        **rows[(shape, dtype_name)],
        "shape": {"B": shape[0], "S": shape[1], "H": shape[2], "KV": shape[3],
                  "D": shape[4], "dtype": dtype_name, "causal": True},
        "build_s": _build.build_seconds.get("flash_attention"),
    }, {
        "name": "gmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:25",
        "launches": launches_of("gmm"),
        "launches_by_path": by_path("gmm"),
        **gmm_rows[(gshape, gdtype)],  # the plain and library times: every expert
        **gmm_rows[(gname, gshape, gdtype)],
        "shape": {"E": gshape[0], "C": gshape[1], "K": gshape[2], "N": gshape[3],
                  "dtype": gdtype, "offsets": gname},
        "build_s": _build.build_seconds.get("gmm"),
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:27",
        "launches": launches_of("ssd_scan"),
        "launches_by_path": by_path("ssd_scan"),
        **ssd_rows[(sshape, sdtype)],
        "shape": dict(zip(("B", "H", "S", "P", "G", "N", "chunk"), sshape),
                      bc_dtype=sdtype, dtype="float32"),
        "build_s": _build.build_seconds.get("ssd_scan"),
    }, {
        "name": "mamba_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_step.cu",
        "replaces": None,  # the JAX decode step (ssd_step) is plain jnp
        "launches": launches_of("mamba_step"),
        "launches_by_path": by_path("mamba_step"),
        **mamba_rows[MAMBA_REPORT_SHAPE],
        "shape": dict(zip(("B", "H", "P", "N", "G", "W"), MAMBA_REPORT_SHAPE[0]),
                      dtype=MAMBA_REPORT_SHAPE[1]),
        "build_s": _build.build_seconds.get("mamba_step"),
    }]
    print(json.dumps({"kernels": kernels}))
    if only_kernels:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
