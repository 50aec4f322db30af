"""Fault-tolerant training loop (port of ``repro/runtime/train_loop.py``).

Beyond calling the train step in a loop:
  * checkpoint/restart — resumes from the latest committed checkpoint,
    replaying the step-indexed data pipeline from the same step;
  * periodic + async checkpointing (the step keeps running during I/O);
  * failure handling — a step that raises ``RuntimeError`` (an injected
    failure via ``inject_failure_at``, or a device error) triggers
    restore-and-continue instead of job loss;
  * loss-spike guard — a non-finite loss rolls back to the last
    checkpoint and skips the offending data batch;
  * straggler observability — per-step wall times feed an EMA; steps
    slower than ``straggler_factor``× the EMA are counted.

Every ``RuntimeError`` restarts, as in the reference, and a CUDA fault is
a ``RuntimeError`` in PyTorch too; so :class:`TrainReport` records the
cause of every restart and rollback (``events``) beside the counts, for
callers to check that no restart hid a device fault. Two differences
from the reference, both deliberate: before reading the latest
checkpoint after a failure the loop waits for a save in flight (the
reference may see none and restart from step 0 with the live state),
and the report gives the step of every loss (``steps``), so replayed
steps can be matched with their first run.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import SyntheticTokens, make_global_batch
from repro_torch.models.lm import tree_leaves


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_async: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    max_restarts: int = 3
    # test hook: raise at this step (once) to exercise restart
    inject_failure_at: Optional[int] = None


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_step: int
    restarts: int
    rollbacks: int
    straggler_steps: int
    losses: List[float]
    step_times: List[float]
    steps: List[int]            # the step of each entry of ``losses``
    events: List[str]           # the cause of each restart and rollback, in order


def run_training(
    *,
    step_fn: Callable,                 # (state, batch) -> (state, metrics)
    state: Any,
    pipeline: SyntheticTokens,
    checkpointer: Checkpointer,
    config: TrainLoopConfig,
    device=None,
    batch_shardings: Optional[Dict] = None,
    state_shardings: Optional[Any] = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
) -> TrainReport:
    """Run ``config.total_steps`` steps; batches go to ``device`` (default:
    the device of the state's first leaf), each field on its sharding in
    ``batch_shardings``; a restored state is placed on ``state_shardings``."""
    if device is None:
        device = next(iter(tree_leaves(list(state)))).device
    restarts = 0
    rollbacks = 0
    straggler_steps = 0
    losses: List[float] = []
    step_times: List[float] = []
    steps: List[int] = []
    events: List[str] = []
    ema_time: Optional[float] = None
    failure_armed = config.inject_failure_at is not None

    # Resume if a committed checkpoint exists.
    start_step = 0
    latest = checkpointer.latest_step()
    if latest is not None:
        state, start_step, _ = checkpointer.restore(state, shardings=state_shardings)
        start_step += 1

    step = start_step
    while step < config.total_steps:
        try:
            batch = make_global_batch(pipeline, step, device, shardings=batch_shardings)
            if failure_armed and step == config.inject_failure_at:
                failure_armed = False
                raise RuntimeError(f"injected failure at step {step}")

            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0

            # Loss-spike / NaN guard: roll back and skip the batch.
            if not math.isfinite(loss):
                rollbacks += 1
                events.append(f"rollback at step {step}: loss {loss}")
                checkpointer.wait()
                latest = checkpointer.latest_step()
                if latest is None or rollbacks > config.max_restarts:
                    raise RuntimeError(
                        f"non-finite loss at step {step} and no checkpoint"
                    )
                state, ck_step, _ = checkpointer.restore(state, shardings=state_shardings)
                step = ck_step + 1
                continue

            losses.append(loss)
            step_times.append(dt)
            steps.append(step)
            if ema_time is None:
                ema_time = dt
            else:
                if dt > config.straggler_factor * ema_time:
                    straggler_steps += 1
                ema_time = 0.9 * ema_time + 0.1 * dt

            if on_metrics and step % config.log_every == 0:
                on_metrics(step, {**metrics, "step_time_s": dt})

            if step % config.checkpoint_every == 0 and step > 0:
                checkpointer.save(step, state, blocking=not config.checkpoint_async)
            step += 1

        except RuntimeError as e:
            restarts += 1
            events.append(f"restart at step {step}: {type(e).__name__}: {e}")
            if restarts > config.max_restarts:
                raise
            checkpointer.wait()
            latest = checkpointer.latest_step()
            if latest is None:
                # No checkpoint yet: restart from scratch.
                step = 0
                continue
            state, ck_step, _ = checkpointer.restore(state, shardings=state_shardings)
            step = ck_step + 1

    checkpointer.wait()
    checkpointer.save(config.total_steps - 1, state, blocking=True)
    return TrainReport(
        steps_run=len(losses),
        final_step=step - 1,
        restarts=restarts,
        rollbacks=rollbacks,
        straggler_steps=straggler_steps,
        losses=losses,
        step_times=step_times,
        steps=steps,
        events=events,
    )
