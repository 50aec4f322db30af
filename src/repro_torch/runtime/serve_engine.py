"""tAPP-scheduled serving engine (continuous batching over model replicas).

Port of ``repro/runtime/serve_engine.py``, line for line over the port's
copy of the control plane. The data-plane realisation of the paper's
control plane:

  * a **replica** = one model hosted on a device (a GPU; the host CPU in
    tests), with a fixed number of sequence *slots* and a slot-batched
    cache (KV for attention layers, conv window and SSM state for Mamba
    layers) — the tAPP *worker*. Replicas built from one params dict share
    its tensors;
  * the **gateway** routes each request by its policy tag through the
    tAPP engine against live replica state (slots in use → capacity_used,
    health → overload, residency via worker-set labels = data locality);
  * **continuous batching**: prefill admits a sequence into a free slot,
    as the JAX engine does: the prompt is prefilled into a batch-1
    scratch cache, which is then merged into that slot of the replica's
    cache (on a GPU the prefill is one CUDA graph per prompt length per
    replica, captured at its first sight, the JAX engine's per-length
    ``jax.jit`` of ``model.prefill``; on the CPU the eager prefill);
    every engine tick runs ONE batched decode step per replica across
    all slots, active or not (inactive slots step token 0 at position 0,
    as in the JAX engine; each slot's cache row depends on that slot
    alone, and admission overwrites it); on a GPU that step is one CUDA
    graph per replica, captured when the replica is built
    (:mod:`repro_torch.runtime.compiled`, the JAX engine's
    ``jax.jit(model.decode)``), on the CPU the eager decode;
    an enc-dec replica encodes zero frames of its cross cache's length
    ``enc_len`` (the JAX engine feeds zero frames as long as the prompt
    into a cross cache of ``max_len``, which fails; see ``Replica``);
  * **straggler mitigation**: tick-time EMA per replica; slow replicas
    are reported to the watcher with saturated capacity so tAPP policies
    route around them until they recover (the paper's ``invalidate``
    machinery doing data-plane duty);
  * **failure handling**: a dead replica is marked unreachable; its
    queued work is rescheduled by the same policy evaluation;
  * **spans**: the engine's :class:`~repro_torch.runtime.tracing.Recorder`
    (``engine.recorder``, off unless turned on) splits each step into the
    router, each admission and each replica's decode step, and those into
    host work and the host's wait on the device
    (:mod:`repro_torch.runtime.tracing`).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.platform import (
    FederationSpec,
    TappFederation,
    TappPlatform,
    WorkerSpec,
)
from repro_torch.core.scheduler.controller import ControllerRuntime
from repro_torch.core.scheduler.engine import Invocation
from repro_torch.core.scheduler.gateway import Gateway
from repro_torch.core.scheduler.topology import DistributionPolicy
from repro_torch.core.scheduler.watcher import Watcher
from repro_torch.models.api import Model
from repro_torch.models.lm import tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.moe import ExpertCounter
from repro_torch.runtime.compiled import CompiledPrefill, ScratchPrefill, capture, counted
from repro_torch.runtime.tracing import OFF, QUEUED, Recorder, cache_bytes


@dataclasses.dataclass
class Request:
    request_id: int
    model_id: str
    tokens: np.ndarray                  # prompt [S]
    max_new_tokens: int = 8
    tag: Optional[str] = None
    # Federation entry zone (None: the single gateway / default entry).
    entry_zone: Optional[str] = None
    # lifecycle
    state: str = "queued"               # queued | running | done | failed
    output: List[int] = dataclasses.field(default_factory=list)
    replica: Optional[str] = None
    error: Optional[str] = None
    submitted_tick: int = 0
    finished_tick: int = 0
    # time.perf_counter() at submit, stamped while the engine's recorder is on
    submitted_at: Optional[float] = None


@dataclasses.dataclass
class _SlotState:
    request: Request
    position: int                       # next cache slot to write
    last_token: int
    placement: object                   # the platform Placement ticket


class Replica:
    """One model replica with slot-batched caches."""

    def __init__(
        self,
        name: str,
        cfg: ModelConfig,
        params,
        *,
        zone: str = "default",
        sets: Sequence[str] = (),
        slots: int = 4,
        max_len: int = 128,
        enc_len: Optional[int] = None,
        count_experts: bool = False,
    ) -> None:
        """``enc_len`` (default ``max_len``, the JAX engine's cross-cache
        length) is the number of encoder frames of an enc-dec replica.
        ``count_experts`` arms ``experts``, the count of the experts the
        decode step's MoE calls reach, before the step is captured (a
        replica without MoE layers has nothing to count)."""
        self.name = name
        self.cfg = cfg
        self.model = Model(cfg)
        self.params = params
        self.zone = zone
        self.sets = frozenset(set(sets) | {cfg.name, "any"})
        self.slots = slots
        self.max_len = max_len
        self.enc_len = max_len if enc_len is None else enc_len
        self.device = params["embed"]["table"].device
        self.cache = self.model.init_cache(
            slots, max_len, enc_len=self.enc_len, device=self.device
        )
        self.active: Dict[int, _SlotState] = {}   # slot index -> state
        self.alive = True
        # The engine's recorder once the replica is added to one.
        self.recorder = Recorder()
        self.experts: Optional[ExpertCounter] = (
            ExpertCounter(self.device) if count_experts and cfg.moe_experts else None)
        # The JAX engine jits decode; on the card the counterpart is one
        # CUDA graph, captured here while no slot is active (see
        # runtime/compiled.py: params and cache are bound at capture, so
        # neither is reassigned after this).
        if self.device.type == "cuda":
            self._decode = capture(self)
        elif self.experts is not None:
            self._decode = counted(self.model.decode, self.experts)
        else:
            self._decode = self.model.decode
        # The JAX engine's per-length jit of the batch-1 prefill; on the
        # card one CUDA graph per prompt length (runtime/compiled.py).
        self._prefill_b1 = (CompiledPrefill if self.device.type == "cuda" else ScratchPrefill)(
            self.model, params, max_len, self.enc_len, self.device)
        #: {"kv", "conv", "ssm": bytes} of this replica's cache (all its slots)
        self.cache_bytes = cache_bytes(self.cache)
        # One slot's bytes, which an admission's merge copies.
        self._merge_bytes = sum(cache_bytes(self._prefill_b1.cache).values())
        self.tick_times: List[float] = []
        # (prompt length, seconds) of every prefill, synchronised.
        self.prefill_times: List[Tuple[int, float]] = []

    # -- slot management -----------------------------------------------------------

    def free_slot(self) -> Optional[int]:
        for i in range(self.slots):
            if i not in self.active:
                return i
        return None

    def admit(self, request: Request, placement) -> bool:
        slot = self.free_slot()
        if slot is None or not self.alive:
            return False
        rec = self.recorder
        t0 = time.perf_counter()
        length = len(request.tokens)
        if rec.on and request.submitted_at is not None:
            rec.record(QUEUED, request.submitted_at, t0, replica=self.name,
                       request=request.request_id)
        with (rec.span("replica.admit", replica=self.name, request=request.request_id,
                       info=length) if rec.on else OFF):
            with rec.span("admit.inputs") if rec.on else OFF:
                self._prefill_b1.load(torch.as_tensor(request.tokens[None, :]))
            with rec.span(self._prefill_span(length)) if rec.on else OFF:
                logits, one = self._prefill_b1.run(length)
            # Merge the single-sequence cache into this replica's slot.
            with rec.span("admit.merge", info=self._merge_bytes) if rec.on else OFF:
                tree_map(lambda big, small: big[:, slot].copy_(small[:, 0]), self.cache, one)
            with rec.span("admit.readback") if rec.on else OFF:
                first_token = int(torch.argmax(logits[0, -1]))
        self.prefill_times.append((length, time.perf_counter() - t0))
        self.active[slot] = _SlotState(
            request=request,
            position=length,
            last_token=first_token,
            placement=placement,
        )
        request.state = "running"
        request.replica = self.name
        request.output.append(first_token)
        return True

    def _prefill_span(self, length: int) -> str:
        """``admit.first_sight`` where the prefill of ``length`` is still to
        be captured, else ``admit.replay``."""
        graphs = getattr(self._prefill_b1, "graphs", None)
        return ("admit.first_sight" if graphs is not None and length not in graphs
                else "admit.replay")

    # -- decode tick --------------------------------------------------------------------

    def step(self) -> List[Tuple[Request, object]]:
        """One batched decode step; returns finished (request, placement)."""
        if not self.active or not self.alive:
            return []
        rec = self.recorder
        t0 = time.perf_counter()
        with (rec.span("replica.step", replica=self.name, info=len(self.active))
              if rec.on else OFF):
            with rec.span("decode.inputs") if rec.on else OFF:
                tokens = np.zeros((self.slots,), np.int32)
                positions = np.zeros((self.slots,), np.int32)
                for slot, st in self.active.items():
                    tokens[slot] = st.last_token
                    positions[slot] = st.position
                tokens_in = torch.as_tensor(tokens, device=self.device)
                positions_in = torch.as_tensor(positions, device=self.device)
            with rec.span("decode.replay") if rec.on else OFF:
                logits, self.cache = self._decode(self.params, self.cache, tokens_in,
                                                  positions_in)
            with rec.span("decode.readback") if rec.on else OFF:
                next_tokens = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
            finished: List[Tuple[Request, object]] = []
            with rec.span("decode.commit") if rec.on else OFF:
                for slot in list(self.active):
                    st = self.active[slot]
                    st.position += 1
                    st.last_token = int(next_tokens[slot])
                    st.request.output.append(st.last_token)
                    done = (
                        len(st.request.output) >= st.request.max_new_tokens
                        or st.position >= self.max_len - 1
                    )
                    if done:
                        st.request.state = "done"
                        finished.append((st.request, st.placement))
                        del self.active[slot]
        self.tick_times.append(time.perf_counter() - t0)
        return finished

    def fail(self) -> None:
        """Simulate a replica loss (host/ICI failure). A dead replica never
        steps nor prefills again, so its compiled steps (and the graphs'
        memory) go."""
        self.alive = False
        self._decode = None
        self._prefill_b1 = None

    @property
    def load_fraction(self) -> float:
        return len(self.active) / max(1, self.slots)

    @property
    def decode_launches(self) -> Dict[str, int]:
        """{kernel: launches one replay of the decode graph makes}; empty
        where the decode step is not a captured graph (a CPU replica, or
        one that has failed)."""
        return dict(getattr(self._decode, "launches", {}))


class ServingEngine:
    def __init__(
        self,
        *,
        distribution: DistributionPolicy = DistributionPolicy.SHARED,
        tapp_script: Optional[str] = None,
        straggler_factor: float = 4.0,
        seed: int = 0,
        federation: Optional[FederationSpec] = None,
    ) -> None:
        # A federation spec turns the engine multi-entry: one ZoneGateway
        # per declared zone, requests routed from their submit()-time
        # entry zone and forwarded per the policy's topology_tolerance.
        # Replicas/controllers still register dynamically (the spec's
        # slices may be empty — they declare the zones).
        if federation is not None:
            self.platform: "TappPlatform | TappFederation" = TappFederation(
                federation, distribution=distribution, seed=seed
            )
        else:
            self.platform = TappPlatform(distribution=distribution, seed=seed)
        self.replicas: Dict[str, Replica] = {}
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._ids = itertools.count()
        self.tick = 0
        self.straggler_factor = straggler_factor
        self._ema: Dict[str, float] = {}
        self.stragglers_flagged = 0
        self.recorder = Recorder()
        if tapp_script is not None:
            self.platform.apply_policy(tapp_script)

    # -- platform access (compat: the engine predates the façade) -------------------

    @property
    def watcher(self) -> Watcher:
        return self.platform.watcher

    @property
    def gateway(self) -> Gateway:
        """The single entrypoint — or, on a federation-backed engine, the
        default entry zone's gateway (keeps the compat surface working:
        stats, probes, prewarm all behave per-zone there)."""
        if isinstance(self.platform, TappFederation):
            return self.platform.zone_gateway(self.platform.spec.entry_zone)
        return self.platform.gateway

    @property
    def runtime(self) -> ControllerRuntime:
        return self.platform.runtime

    # -- topology -------------------------------------------------------------------

    def add_controller(self, name: str, zone: str = "default") -> None:
        self.platform.add_controller(name, zone=zone)

    def add_replica(self, replica: Replica) -> None:
        self.replicas[replica.name] = replica
        replica.recorder = self.recorder
        self.platform.add_worker(
            WorkerSpec(
                name=replica.name,
                zone=replica.zone,
                sets=tuple(replica.sets),
                capacity_slots=replica.slots,
                resident_models=(replica.cfg.name,),
            )
        )

    def remove_replica(self, name: str) -> None:
        """Elastic scale-down / failure eviction."""
        replica = self.replicas.get(name)
        if replica is not None:
            replica.fail()
            for st in list(replica.active.values()):
                # Retire the ticket of the lost placement; the requeued
                # request gets a fresh one when it is re-admitted.
                st.placement.complete()
                st.request.state = "queued"
                st.request.replica = None
                st.request.output.clear()
                self.queue.append(st.request)
            replica.active.clear()
        self.platform.remove_worker(name)

    # -- requests ------------------------------------------------------------------------

    def submit(
        self,
        model_id: str,
        tokens: Sequence[int],
        *,
        tag: Optional[str] = None,
        max_new_tokens: int = 8,
        entry_zone: Optional[str] = None,
    ) -> Request:
        if entry_zone is not None and not isinstance(
            self.platform, TappFederation
        ):
            raise ValueError(
                f"entry_zone={entry_zone!r} requires a federation-backed "
                f"engine (pass federation=FederationSpec.of(...))"
            )
        req = Request(
            request_id=next(self._ids),
            model_id=model_id,
            tokens=np.asarray(tokens, np.int32),
            max_new_tokens=max_new_tokens,
            tag=tag,
            entry_zone=entry_zone,
            submitted_tick=self.tick,
            submitted_at=time.perf_counter() if self.recorder.on else None,
        )
        self.queue.append(req)
        return req

    # -- engine loop ----------------------------------------------------------------------

    def step_once(self) -> None:
        rec = self.recorder
        with rec.span("engine.step", info=self.tick + 1) if rec.on else OFF:
            self.tick += 1
            with rec.span("engine.heartbeats") if rec.on else OFF:
                self._heartbeats()
            self._admit_queued()
            finished: List[Tuple[Request, object]] = []
            for replica in self.replicas.values():
                finished += replica.step()
            with rec.span("engine.complete", info=len(finished)) if rec.on else OFF:
                for request, placement in finished:
                    request.finished_tick = self.tick
                    placement.complete()
                    self.done.append(request)
            with rec.span("engine.stragglers") if rec.on else OFF:
                self._flag_stragglers()

    def run_until_done(self, max_ticks: int = 1000) -> None:
        for _ in range(max_ticks):
            if not self.queue and not any(
                r.active for r in self.replicas.values()
            ):
                return
            self.step_once()

    # -- internals ---------------------------------------------------------------------------

    def _heartbeats(self) -> None:
        workers = self.platform.cluster.workers
        for replica in self.replicas.values():
            if replica.name not in workers:
                continue
            self.platform.heartbeat(
                replica.name,
                healthy=replica.alive,
                reachable=replica.alive,
                capacity_used_pct=100.0 * replica.load_fraction,
            )

    def _admit_queued(self) -> None:
        if not self.queue:
            return
        still_queued: List[Request] = []
        requests = list(self.queue)
        invocations = [
            Invocation(
                function=request.model_id,
                tag=request.tag,
                model_id=request.model_id,
                request_id=request.request_id,
            )
            for request in requests
        ]
        pending = iter(requests)

        def _place(placement) -> None:
            request = next(pending)
            placed = False
            if placement.scheduled and placement.worker in self.replicas:
                replica = self.replicas[placement.worker]
                if replica.cfg.name == request.model_id:
                    placed = replica.admit(request, placement)
            if not placed:
                # Retire the unused ticket (no-op when never admitted) so
                # the running-function multiset stays truthful.
                placement.complete()
                request.state = "queued"
                still_queued.append(request)
                # Requests failed by policy (followup: fail) surface as such.
                if placement.failed_by_policy:
                    request.error = "policy-failed"

        # One unified invoke→admit pass per tick: the script version check,
        # plan compilation, and epoch-cached views are shared across the
        # queue, and each placement's admission lands before the next
        # decision is made (so capacity and affinity effects are observed,
        # exactly as the previous request-at-a-time loop did). On a
        # federation, each request enters at its submit()-time zone.
        rec = self.recorder
        with rec.span("engine.route", info=len(invocations)) if rec.on else OFF:
            if isinstance(self.platform, TappFederation):
                self.platform.invoke_batch(
                    invocations,
                    entry_zones=[request.entry_zone for request in requests],
                    on_placement=_place,
                )
            else:
                self.platform.invoke_batch(invocations, on_placement=_place)
        self.queue = still_queued

    def _flag_stragglers(self) -> None:
        for replica in self.replicas.values():
            # Skip the first tick: it includes one-time warm-up (CUDA
            # library initialisation), which would poison the EMA
            # baseline. Kernel builds happen before the engine runs.
            if len(replica.tick_times) < 2:
                continue
            dt = replica.tick_times[-1]
            ema = self._ema.get(replica.name)
            if ema is not None and dt > self.straggler_factor * ema:
                self.stragglers_flagged += 1
                # Route-around: report the replica as saturated until the
                # next healthy heartbeat shows recovered load.
                self.platform.heartbeat(
                    replica.name, capacity_used_pct=100.0
                )
            self._ema[replica.name] = (
                dt if ema is None else 0.9 * ema + 0.1 * dt
            )
