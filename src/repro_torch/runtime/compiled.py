"""The serving engine's compiled decode step: one CUDA graph per replica.

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
  cache tensors are the graph's own buffers. ``Replica.admit`` prefills
  a slot in place, into views of the same tensors, which the next replay
  reads;
* the step's inputs and output: ``tokens`` and ``positions`` are static
  ``[slots]`` int32 buffers on the card, filled before each replay; the
  logits are the graph's static output, overwritten by the next replay.

The warm-up calls before the capture write every slot (K/V at position
0, the conv window and the SSM state), so :func:`warm_up` zeroes the
whole cache after them; a capture therefore needs a replica on which no
request is active, and the engine captures at construction.

Launch counts: a kernel's Python wrapper counts a launch when it runs,
which is at the warm-up and at the capture, not at a replay. Building the
step leaves every count as it found it (the warm-up is set-up, like a
kernel's build, and a capture launches nothing), and each replay adds the
launches its graph holds: a kernel's ``launches`` stays the number of its
launches in the engine's prefills and decode ticks.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import launch_counts, set_launch_counts
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
    to eager dispatch.
    """

    def __init__(self, decode: Callable, params, cache, slots: int,
                 device: torch.device) -> None:
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.params, self.cache = params, cache
        self.tokens = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.positions = torch.zeros((slots,), dtype=torch.int32, device=device)
        before = launch_counts()
        with torch.cuda.device(device):
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
            with capturing:
                self.logits, _ = decode(params, cache, self.tokens, self.positions)
            #: {kernel: launches one replay makes}
            self.launches = {name: n - captured[name] for name, n in launch_counts().items()}
        set_launch_counts(before)

    def __call__(self, params, cache, tokens: torch.Tensor, positions: torch.Tensor):
        """One replay on the current stream: (static logits [slots, 1, V], cache)."""
        if params is not self.params or cache is not self.cache:
            raise ValueError("the compiled decode step is bound to the params and the "
                             "cache it was captured with")
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        self.graph.replay()
        set_launch_counts({name: n + self.launches[name] for name, n in launch_counts().items()})
        return self.logits, self.cache


def capture(replica) -> CompiledDecode:
    """``replica``'s decode step as a :class:`CompiledDecode`. The warm-up
    before the capture overwrites every slot, so a replica serving a
    request is refused."""
    if replica.active:
        raise RuntimeError(
            f"replica {replica.name} has active slots {sorted(replica.active)}: the "
            "capture's warm-up would overwrite their cache")
    return CompiledDecode(replica.model.decode, replica.params, replica.cache,
                          replica.slots, replica.device)
