"""Per-device counts of one traced call (the port's counterpart of
``repro/roofline/hlo.py``).

The JAX package parses the SPMD-partitioned HLO of a compiled step: every
instruction there is one device's share. Here a ``TorchDispatchMode``
(:class:`TraceCounter`) sits under DTensor and sees the ops each rank runs
on its local shards, whether on real tensors (the card) or on fake ones
(the dry-run, :mod:`repro_torch.launch.dryrun`). It accounts:

  * matmul FLOPs — 2 · (output elements) · K of every ``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, ``addbmm``, ``mv``, ``addmv`` and ``dot``, on
    the local shards, by operand dtype;
  * bytes written — each op's output, views and aliases of an input
    excluded (an in-place op counts what it writes: the source of a
    ``copy_``, ``index_put_`` or ``index_add_``, else its whole output),
    the same write-once proxy for HBM traffic as ``hlo.py``;
  * collectives — each functional collective's kind, result bytes, group
    size and ranks, and its ring wire bytes (factor of
    :data:`repro_torch.roofline.analysis.WIRE_FACTOR`, 0 for a group of one);
  * peak memory — the largest sum of live storages of local tensors during
    the call, counting the tensors registered with :meth:`TraceCounter.track`
    (the step's inputs) and every storage an op creates, each until it is
    freed.

A Python loop over layers runs every layer, so nothing needs a trip
count. DTensor propagates shapes by running each op once more at the
global shape: on fake or ``meta`` tensors while the real ops run on real
ones, or, in a fake run, inside its shape propagation
(``_propagate_tensor_meta``). Those calls are not counted.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline.analysis import WIRE_FACTOR

_aten = torch.ops.aten

#: Matmul ops: (index of the left operand, of the output's K source).
_MATMUL_LHS = {
    _aten.mm.default: 0,
    _aten.bmm.default: 0,
    _aten.mv.default: 0,
    _aten.dot.default: 0,
    _aten.addmm.default: 1,
    _aten.baddbmm.default: 1,
    _aten.addbmm.default: 1,
    _aten.addmv.default: 1,
}

#: In-place ops that write only part of their output: the argument whose
#: elements are written.
_INPLACE_SOURCE = {
    "copy_": 1,
    "index_put_": 2,
    "_index_put_impl_": 2,
    "index_add_": 3,
    "index_copy_": 3,
    "scatter_": 3,
    "scatter_add_": 3,
    "masked_scatter_": 2,
}

#: Functional collectives (``torch.distributed._functional_collectives``).
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    group_ranks: Tuple[int, ...]
    wire_bytes: float


@dataclasses.dataclass
class TraceCounts:
    flops_by_dtype: Dict[str, float]
    write_bytes: float
    collectives: List[CollectiveOp]
    start_bytes: int        # live storage of the tracked inputs when the call began
    peak_bytes: int         # largest live storage during the call
    ops: int                # ops counted

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def wire_bytes(self) -> float:
        return float(sum(op.wire_bytes for op in self.collectives))

    def collective_detail(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for op in self.collectives:
            d = out.setdefault(op.kind, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
            d["count"] += 1
            d["bytes"] += op.result_bytes
            d["wire_bytes"] += op.wire_bytes
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(group_name: str) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(group_name)))


class TraceCounter(TorchDispatchMode):
    """Counts the local ops of the calls made while it is active (see the
    module docstring). Enter it inside a ``FakeTensorMode`` for a dry-run."""

    def __init__(self) -> None:
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.write_bytes = 0.0
        self.collectives: List[CollectiveOp] = []
        self.ops = 0
        self._live = 0
        self._peak = 0
        self._start = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._fake = False

    # -- memory ---------------------------------------------------------------

    def _add_storage(self, st) -> None:
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._refs.pop(key, None) is not None:
                self._live -= n

        self._refs[key] = weakref.ref(st, freed)
        self._live += n
        self._peak = max(self._peak, self._live)

    def track(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors (DTensors: their local
        shards) as live from now on."""
        from torch.distributed.tensor import DTensor

        for leaf in tree_flatten(tree)[0]:
            if isinstance(leaf, DTensor):
                leaf = leaf.to_local()
            if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
                self._add_storage(leaf.untyped_storage())
        self._start = self._live

    # -- dispatch -------------------------------------------------------------

    def __enter__(self):
        from torch._guards import detect_fake_mode

        self._fake = detect_fake_mode() is not None
        return super().__enter__()

    def _shadow(self, tensors) -> bool:
        """An op DTensor runs only to propagate global shapes: on ``meta``
        or (in a real run) fake tensors, or, in a fake run, anywhere under
        its shape propagation (``_propagate_tensor_meta*``), found on the
        Python stack."""
        from torch._subclasses.fake_tensor import FakeTensor

        for t in tensors:
            if t.device.type == "meta":
                return True
            if not self._fake and isinstance(t, FakeTensor):
                return True
        if self._fake:
            frame = sys._getframe(2)
            while frame is not None:
                code = frame.f_code
                if code.co_name.startswith("_propagate_tensor_meta") and \
                        "distributed" in code.co_filename:
                    return True
                frame = frame.f_back
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run; its local ops come back here
        out = func(*args, **kwargs)
        flat_in = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if self._shadow(flat_in + flat_out):
            return out
        self.ops += 1
        self._count(func, args, kwargs, flat_in, flat_out)
        return out

    def _count(self, func, args, kwargs, flat_in, flat_out) -> None:
        lhs = _MATMUL_LHS.get(func)
        if lhs is not None:
            a = args[lhs]
            k = a.shape[-1]
            key = str(a.dtype).replace("torch.", "")
            self.flops_by_dtype[key] = (self.flops_by_dtype.get(key, 0.0)
                                        + 2.0 * flat_out[0].numel() * k)
        namespace = func.namespace
        name = func.overloadpacket.__name__
        if namespace == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                group = next(a for a in reversed(args) if isinstance(a, str))
                ranks = _group_ranks(group)
                result = sum(_nbytes(o) for o in flat_out)
                n = len(ranks)
                wire = WIRE_FACTOR[kind](n) * result if n > 1 else 0.0
                self.collectives.append(CollectiveOp(kind, result, n, ranks, wire))
        # Bytes written and new storages.
        in_storages = {id(t.untyped_storage()) for t in flat_in}
        if name.endswith("_") and flat_out:
            src = _INPLACE_SOURCE.get(name)
            target = flat_out[0]
            if src is not None and len(args) > src and isinstance(args[src], torch.Tensor):
                self.write_bytes += args[src].numel() * target.element_size()
            else:
                self.write_bytes += _nbytes(target)
            return
        if func.is_view:
            return
        for o in flat_out:
            st = o.untyped_storage()
            if id(st) in in_storages:
                continue  # an alias of an input
            self.write_bytes += _nbytes(o)
            self._add_storage(st)

    def counts(self) -> TraceCounts:
        return TraceCounts(
            flops_by_dtype=dict(self.flops_by_dtype),
            write_bytes=self.write_bytes,
            collectives=list(self.collectives),
            start_bytes=self._start,
            peak_bytes=self._peak,
            ops=self.ops,
        )


def count_call(fn, *args, track: Optional[Any] = None, **kwargs):
    """``(fn(*args, **kwargs), TraceCounts)``; ``track`` (default: the
    arguments) is live from the start."""
    counter = TraceCounter()
    counter.track((args, kwargs) if track is None else track)
    with counter:
        result = fn(*args, **kwargs)
    return result, counter.counts()
