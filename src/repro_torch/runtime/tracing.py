"""Spans of the serving engine: where a step's host time goes, kept in memory.

One :class:`Recorder` per :class:`~repro_torch.runtime.serve_engine.ServingEngine`
(``engine.recorder``), shared with its replicas. It is off unless an
operator turns it on (``engine.recorder.on = True``); off, a span site
costs one attribute check and enters :data:`OFF`, a shared null context:
no clock read, no profiler range, no allocation.

On, each span site appends a :class:`Span` (name, start and end on
``time.perf_counter()``, its parent span, the replica, the request, a
small ``info``) and enters ``torch.profiler.record_function(name)``, so a
profiler running at the same time shows the span beside the kernels it
launched. The spans, by parent (:data:`SPAN_NAMES`):

* ``engine.step``: one ``ServingEngine.step_once``. Children:
  ``engine.heartbeats``; ``engine.route`` around the router's
  ``invoke_batch`` (``info``: invocations routed), whose ``replica.admit``
  children are the admissions it makes back, so the router's own time is
  the span less its children; each replica's ``replica.step``;
  ``engine.complete``, the finished placements retired (``info``: how
  many); ``engine.stragglers``.
* ``replica.admit`` (``info``: prompt length): ``admit.inputs`` (the
  prompt copied to the device), ``admit.replay`` or, for a prompt length
  the replica has not captured yet, ``admit.first_sight`` (its eager pass
  and capture; on the CPU every prefill is eager and is an
  ``admit.replay``), ``admit.merge`` (the scratch cache copied into the
  slot; ``info``: the bytes it copies), ``admit.readback`` (the first
  token read: the host waits on the device here).
* ``replica.step`` (``info``: active slots): ``decode.inputs`` (the
  token and position arrays and their copies to the device),
  ``decode.replay`` (the decode graph's replay, or the eager decode on the
  CPU), ``decode.readback`` (the next tokens read: the host waits on the
  device here), ``decode.commit`` (the slots' bookkeeping).

A span inherits its parent's replica and request. One more record,
:data:`QUEUED`, is written without a profiler range: a request's wait in
the engine's queue, from its ``submit`` (stamped only while the recorder
is on) to the start of the admission that placed it.

The engine's other counters stay where they were: ``Replica.tick_times``
and ``prefill_times``, ``stragglers_flagged``, the compiled steps'
``launches``, ``captures`` and ``pool_bytes``; ``Replica.cache_bytes``
gives a replica's cache by kind (:func:`cache_bytes`). The MoE layer's count of
the experts a replica's decode step reaches is
:class:`repro_torch.models.layers.moe.ExpertCounter`, armed per replica
(``Replica(count_experts=True)``) before its decode step is captured.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import torch

#: Every span name, each entered as a ``torch.profiler.record_function`` range.
SPAN_NAMES = (
    "engine.step", "engine.heartbeats", "engine.route", "engine.complete",
    "engine.stragglers",
    "replica.admit", "admit.inputs", "admit.first_sight", "admit.replay", "admit.merge",
    "admit.readback",
    "replica.step", "decode.inputs", "decode.replay", "decode.readback", "decode.commit",
)
#: A request's submit to the start of the admission that placed it (no profiler range).
QUEUED = "request.queued"
#: What a span site enters while the recorder is off.
OFF = contextlib.nullcontext()


#: The kinds of state a replica's cache holds (:func:`cache_bytes`).
CACHE_KINDS = ("kv", "conv", "ssm")


def cache_bytes(cache: Dict) -> Dict[str, int]:
    """Bytes of a cache tree by kind: a Mamba-2 layer's ``conv`` window and
    ``ssm`` state, and every other leaf (attention's K and V, an int8
    cache's scales, an enc-dec cross cache) as ``kv``."""
    out = dict.fromkeys(CACHE_KINDS, 0)

    def walk(tree, kind):
        for key, value in tree.items():
            sub = key if key in ("conv", "ssm") else kind
            if isinstance(value, dict):
                walk(value, sub)
            else:
                out[sub] += value.numel() * value.element_size()

    walk(cache, "kv")
    return out


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    t0: float                       # time.perf_counter() seconds
    t1: Optional[float]             # None while the span is open
    parent: Optional[int]           # index of the enclosing span in Recorder.spans
    replica: Optional[str] = None
    request: Optional[int] = None   # Request.request_id
    info: object = None


class Recorder:
    """The engine's spans, in the order they started."""

    def __init__(self) -> None:
        self.on = False
        self.spans: List[Span] = []
        self._open: List[int] = []

    @contextlib.contextmanager
    def span(self, name: str, *, replica: Optional[str] = None,
             request: Optional[int] = None, info: object = None) -> Iterator[Span]:
        """A span inside the innermost open one, inheriting its replica and request."""
        parent = self._open[-1] if self._open else None
        if parent is not None:
            up = self.spans[parent]
            replica = up.replica if replica is None else replica
            request = up.request if request is None else request
        with torch.profiler.record_function(name):
            span = Span(name, time.perf_counter(), None, parent, replica, request, info)
            self._open.append(len(self.spans))
            self.spans.append(span)
            try:
                yield span
            finally:
                span.t1 = time.perf_counter()
                self._open.pop()

    def record(self, name: str, t0: float, t1: float, *, replica: Optional[str] = None,
               request: Optional[int] = None, info: object = None) -> None:
        """An interval measured elsewhere, with no parent and no profiler range."""
        self.spans.append(Span(name, t0, t1, None, replica, request, info))
