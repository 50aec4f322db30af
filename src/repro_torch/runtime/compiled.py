"""The serving engine's compiled steps: one CUDA graph per replica for its
decode step, and one per prompt length for its batch-1 prefill.

Counterpart of ``repro/runtime/serve_engine.py``'s
``self._decode = jax.jit(self.model.decode)``: JAX traces a replica's
decode step once and replays the compiled program every tick. Here
:class:`CompiledDecode` captures one call of ``model.decode`` into a
``torch.cuda.CUDAGraph`` when the replica is built and replays it every
tick, so a tick costs the host one graph launch instead of one dispatch
per op (smollm-135m's tick is some 2400 kernels).

What the graph binds at capture, and so what must not change after it:

* the params: the graph reads their tensors where they lay at capture,
  so a replica's ``params`` must not be reassigned, nor updated out of
  place, after construction (nothing in the repo does either);
* the cache: every family's decode writes its cache in place, so the
  cache tensors are the graph's own buffers. ``Replica.admit`` merges a
  prefilled sequence into one slot of the same tensors, which the next
  replay reads;
* the step's inputs and output: ``tokens`` and ``positions`` are static
  ``[slots]`` int32 buffers on the card, filled before each replay; the
  logits are the graph's static output, overwritten by the next replay.

The warm-up calls before the capture write every slot (K/V at position
0, the conv window and the SSM state), so :func:`warm_up` zeroes the
whole cache after them; a capture therefore needs a replica on which no
request is active, and the engine captures at construction.

The prefill is the reference's ``jax.jit(lambda p, b, c:
model.prefill(p, b, c))`` into a fresh batch-1 cache, which JAX traces
once per prompt length. :class:`ScratchPrefill` prefills into a batch-1
scratch cache that the replica owns (zeroed first, so it holds what a
fresh cache would), and the engine merges the scratch into the admitted
slot; on the CPU that is the whole route. On the card
:class:`CompiledPrefill` captures it once per prompt length, keyed by
the length alone: the scratch, the ``[1, max_len]`` token buffer (a
graph reads its first S columns), an enc-dec replica's zero frames and
the logits buffer are allocated once, before any capture and outside
the graphs' memory, so no graph binds a slot's address, and a capture
at a new length never touches the slots that are decoding. All of a
replica's prefill graphs share one memory pool, and nothing allocated in
it outlives a replay (each graph copies its logits out to the static
buffer before its temporaries are freed), so the graphs may be replayed
in any order and the pool holds about the largest graph's temporaries,
not their sum (:meth:`CompiledPrefill.pool_bytes`). There is no bound on
the number of graphs, as ``jax.jit``'s cache has none.

Launch counts: a kernel's Python wrapper counts a launch when it runs,
which is at a warm-up, at an eager pass and at a capture, not at a
replay. Building the decode step leaves every count as it found it (the
warm-up is set-up, like a kernel's build, and a capture launches
nothing); a prefill's first sight of a length counts its eager pass,
which is the request's own prefill, and not its capture; each replay
adds the launches its graph holds. A kernel's ``launches`` stays the
number of its launches in the engine's prefills and decode ticks.

A replica whose experts are counted (``Replica(count_experts=True)``)
hands its :class:`~repro_torch.models.layers.moe.ExpertCounter` to the
decode step: the warm-up and the capture run under
:func:`~repro_torch.models.layers.moe.counting`, so the graph holds the
counting kernels, and the counter is zeroed after the capture; each
replay adds the MoE calls the capture made. An unarmed capture holds the
same kernels as before the counter existed. The prefills never count.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import launch_counts, set_launch_counts
from repro_torch.models.layers.moe import ExpertCounter, counting
from repro_torch.models.lm import tree_leaves

#: Eager calls before the capture: they run the lazy set-up of every op
#: (library handles, workspaces, a kernel's shared-memory opt-in) off
#: the graph, as ``torch.cuda.make_graphed_callables`` does.
WARMUP_CALLS = 3


def warm_up(decode: Callable, params, cache, tokens: torch.Tensor, positions: torch.Tensor,
            calls: int = WARMUP_CALLS) -> None:
    """``calls`` calls of ``decode`` on ``cache``, then the whole cache zeroed,
    as :func:`repro_torch.models.api.Model.init_cache` made it. The device's
    own code (nothing here is CUDA's), so the CPU tests run it too."""
    for _ in range(calls):
        decode(params, cache, tokens, positions)
    for leaf in tree_leaves(cache):
        leaf.zero_()


class CompiledDecode:
    """``decode(params, cache, tokens, positions)`` captured once as a CUDA
    graph on ``cache``'s device, called as the function it replaces.

    Errors of the capture and of a replay propagate: there is no return
    to eager dispatch. With ``experts``, the graph counts the experts its
    MoE calls reach (see the module's docstring).
    """

    def __init__(self, decode: Callable, params, cache, slots: int,
                 device: torch.device, experts: Optional[ExpertCounter] = None) -> None:
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.params, self.cache = params, cache
        self.tokens = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.positions = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.experts = experts
        before = launch_counts()
        with (counting(experts) if experts is not None else contextlib.nullcontext(),
              torch.cuda.device(device)):
            self.graph = torch.cuda.CUDAGraph()
            capturing = torch.cuda.graph(self.graph)
            # The warm-up runs on the stream the capture will use (PyTorch's
            # one capture stream), so every stream-keyed resource the step
            # needs, such as a cuBLAS workspace, exists before the capture,
            # and the process holds one such set for all its replicas.
            side, main = capturing.capture_stream, torch.cuda.current_stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                warm_up(decode, params, cache, self.tokens, self.positions)
            main.wait_stream(side)
            captured = launch_counts()
            calls = experts.calls if experts is not None else 0
            with capturing:
                self.logits, _ = decode(params, cache, self.tokens, self.positions)
            #: {kernel: launches one replay makes}
            self.launches = {name: n - captured[name] for name, n in launch_counts().items()}
        set_launch_counts(before)
        #: MoE calls one replay makes, counted when ``experts`` is given
        self.moe_calls = 0
        if experts is not None:
            self.moe_calls = experts.calls - calls
            experts.reset()

    def __call__(self, params, cache, tokens: torch.Tensor, positions: torch.Tensor):
        """One replay on the current stream: (static logits [slots, 1, V], cache)."""
        if params is not self.params or cache is not self.cache:
            raise ValueError("the compiled decode step is bound to the params and the "
                             "cache it was captured with")
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        self.graph.replay()
        set_launch_counts({name: n + self.launches[name] for name, n in launch_counts().items()})
        if self.experts is not None:
            self.experts.calls += self.moe_calls
        return self.logits, self.cache


def capture(replica) -> CompiledDecode:
    """``replica``'s decode step as a :class:`CompiledDecode`, counting the
    experts it reaches into ``replica.experts`` where that is a counter. The
    warm-up before the capture overwrites every slot, so a replica serving
    a request is refused."""
    if replica.active:
        raise RuntimeError(
            f"replica {replica.name} has active slots {sorted(replica.active)}: the "
            "capture's warm-up would overwrite their cache")
    return CompiledDecode(replica.model.decode, replica.params, replica.cache,
                          replica.slots, replica.device, replica.experts)


def counted(decode: Callable, experts: ExpertCounter) -> Callable:
    """The eager ``decode``, counting the experts each call reaches into ``experts``."""
    def call(*args):
        with counting(experts):
            return decode(*args)

    return call


class ScratchPrefill:
    """``model.prefill`` of one prompt into a batch-1 scratch cache, eagerly.

    The JAX engine's ``small_cache``: ``cache`` is made once, zeroed
    before each prefill and overwritten by the next; the caller merges it
    into a slot. An enc-dec prompt is fed zero frames, as the JAX engine
    feeds, but as many as the cross cache holds (``enc_len``): decode's
    unmasked cross attention then reads exactly the encoder's output.
    """

    def __init__(self, model, params, max_len: int, enc_len: int,
                 device: torch.device) -> None:
        self.model, self.params, self.device = model, params, device
        self.cache = model.init_cache(1, max_len, enc_len=enc_len, device=device)
        self.tokens = torch.zeros((1, max_len), dtype=torch.int32, device=device)
        self.frames = (torch.zeros((1, enc_len, model.cfg.d_model), dtype=torch.float32,
                                   device=device)
                       if model.cfg.family == "encdec" else None)
        # unembed's float32 logits of the last position
        self.logits = torch.zeros((1, 1, model.cfg.vocab_size), dtype=torch.float32,
                                  device=device)

    def _prefill(self, length: int) -> None:
        """Zero the scratch, prefill ``self.tokens[:, :length]`` into it,
        copy the logits out."""
        for leaf in tree_leaves(self.cache):
            leaf.zero_()
        batch = {"tokens": self.tokens[:, :length]}
        if self.frames is not None:
            batch["frames"] = self.frames
        logits, _ = self.model.prefill(self.params, batch, self.cache)
        self.logits.copy_(logits)

    def load(self, prompt: torch.Tensor) -> int:
        """The prompt ``[1, S]`` copied into the token buffer; S."""
        length = prompt.shape[1]
        self.tokens[:, :length].copy_(prompt)
        return length

    def run(self, length: int):
        """(logits of the last position [1, 1, V], the scratch cache) of the
        loaded prompt's ``length`` tokens, both overwritten by the next call."""
        self._prefill(length)
        return self.logits, self.cache

    def __call__(self, prompt: torch.Tensor):
        """:meth:`load` then :meth:`run`."""
        return self.run(self.load(prompt))


class CompiledPrefill(ScratchPrefill):
    """:class:`ScratchPrefill` with one CUDA graph per prompt length.

    A length seen for the first time is prefilled eagerly on the capture
    stream (the request's own prefill, and the lazy set-up of that shape
    off the graph), then captured; a later one is one replay. Errors of a
    capture and of a replay propagate: there is no return to eager
    dispatch.
    """

    def __init__(self, model, params, max_len: int, enc_len: int,
                 device: torch.device) -> None:
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        super().__init__(model, params, max_len, enc_len, device)
        self.pool = torch.cuda.graph_pool_handle()
        #: {prompt length: its graph}
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        #: {prompt length: {kernel: launches one replay makes}}
        self.launches: Dict[int, Dict[str, int]] = {}
        self.replays = 0

    @property
    def captures(self) -> int:
        return len(self.graphs)

    def pool_bytes(self) -> int:
        """Device memory the graphs' shared pool holds (its segments)."""
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self.pool))

    def _prefill(self, length: int) -> None:
        graph = self.graphs.get(length)
        if graph is None:
            self._capture(length)
            return
        graph.replay()
        self.replays += 1
        added = self.launches[length]
        set_launch_counts({name: n + added[name] for name, n in launch_counts().items()})

    def _capture(self, length: int) -> None:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            # The decode step's capture stream, whose cuBLAS workspace exists.
            side = torch.cuda.graph(graph, pool=self.pool).capture_stream
            main = torch.cuda.current_stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                super()._prefill(length)
                before = launch_counts()
                # Not ``with torch.cuda.graph(...)``: its synchronize and
                # empty_cache would wait for the slots' decode and hand the
                # allocator's cached blocks back at every new length.
                graph.capture_begin(self.pool)
                try:
                    super()._prefill(length)
                finally:
                    graph.capture_end()
                self.launches[length] = {name: n - before[name]
                                         for name, n in launch_counts().items()}
                set_launch_counts(before)
            main.wait_stream(side)
        self.graphs[length] = graph
