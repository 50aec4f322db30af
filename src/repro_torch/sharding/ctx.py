"""Activation-sharding context (port of ``repro/sharding/ctx.py``).

Model code is mesh-agnostic; the sharded step and the dry-run wrap the
call in :func:`activation_sharding`, so that :func:`constrain` can
redistribute the hot activations (the residual stream between layers,
the logits) with the right axis names for whichever mesh is in use.
Outside the context ``constrain`` returns its input unchanged, so the
unsharded path is exactly what it was.

The key constraint is sequence parallelism on the residual stream: ``x
[B, S, d]`` is sharded over the TP axis along S between layers, which
cuts the activations kept for the backward by the TP degree; DTensor
gathers S where attention needs the whole sequence.

Inside the context plain tensors that meet a DTensor (positions, masks,
``arange``) count as replicated on the mesh (DTensor's
``implicit_replication``), as constants do under GSPMD.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch

from repro_torch.launch.mesh import axis_sizes


class _State:
    """The active context. Process-wide, not thread-local: autograd runs a
    CUDA backward (and the recomputation of a checkpointed layer in it)
    on a thread of its own, which must see the context of the step."""

    ctx = None


_STATE = _State()



@contextlib.contextmanager
def activation_sharding(mesh, dp_axes: Tuple[str, ...], tp_axis, vocab_axis=None):
    """``vocab_axis`` defaults to ``tp_axis``; under tp_scope="vocab" the
    layer carries see tp=None while logits still shard over the model axis."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = _STATE.ctx
    _STATE.ctx = (mesh, tuple(dp_axes), tp_axis,
                  vocab_axis if vocab_axis is not None else tp_axis)
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.ctx = prev


def current_mesh():
    """The mesh of the active context, or None."""
    ctx = _STATE.ctx
    return None if ctx is None else ctx[0]


def current_dp_axes() -> Tuple[str, ...]:
    ctx = _STATE.ctx
    return () if ctx is None else ctx[1]


def current_tp_axis():
    ctx = _STATE.ctx
    return None if ctx is None else ctx[2]


def current_tp_size() -> int:
    """Size of the TP axis (1 outside a context or without one)."""
    tp = current_tp_axis()
    return 1 if tp is None else axis_sizes(current_mesh())[tp]


def tp_group_of(x, tensor_dim: int):
    """The process group of the TP axis if it shards ``tensor_dim`` of the
    DTensor ``x``, else None."""
    from torch.distributed.tensor import DTensor

    tp = current_tp_axis()
    if tp is None or not isinstance(x, DTensor):
        return None
    i = tuple(x.device_mesh.mesh_dim_names).index(tp)
    return x.device_mesh.get_group(i) if x.placements[i].is_shard(tensor_dim) else None


def run_local(fn, args: Sequence, dims: Sequence, out_dims: Sequence, *, tp_ok: bool):
    """``fn(*args)`` on each rank's block of the batch and of one more dim.

    The per-(batch, head) cores that DTensor cannot follow (the attention
    and SSD einsums fold a batch dim sharded over the data axes with a
    head dim sharded over TP into one ``bmm`` batch dim, a strided shard
    it fails on; the depthwise conv pads S, which some DTensor versions
    fail to redistribute around) run locally (:func:`local_call`):
    ``dims[i]`` is ``(batch dim, TP dim)`` of argument ``i`` (None where it
    has none, or for a non-tensor), ``out_dims`` the same per output. The batch dim is
    sharded over the data axes when it divides, the TP dim over the TP
    axis when ``tp_ok``; every other mesh dim replicates. A call without
    a DTensor argument is ``fn(*args)``; DTensors outside a context raise.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = current_mesh()
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    if mesh is None:
        raise RuntimeError("DTensor arguments outside a sharding context "
                           "(repro_torch.sharding.ctx.activation_sharding)")
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    dp = [a for a in current_dp_axes() if sizes[a] > 1]
    tp = current_tp_axis()
    batch = next(a.shape[d[0]] for a, d in zip(args, dims)
                 if isinstance(a, DTensor) and d[0] is not None)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    shard_b = bool(dp) and batch % dp_size == 0
    shard_t = tp_ok and tp is not None and sizes[tp] > 1

    def pl(bd, td):
        out = [Replicate()] * len(names)
        if shard_b and bd is not None:
            for a in dp:
                out[names.index(a)] = Shard(bd)
        if shard_t and td is not None:
            out[names.index(tp)] = Shard(td)
        return out

    in_pl = [pl(*d) if isinstance(a, DTensor) else None for a, d in zip(args, dims)]
    out_pl = [pl(*d) for d in out_dims]
    split = [names.index(a) for a in dp] if shard_b else []
    if shard_t:
        split.append(names.index(tp))
    outs = local_call(fn, args, in_pl, out_pl, mesh, split)
    return outs[0] if len(out_dims) == 1 else outs


def local_call(fn, args: Sequence, in_placements: Sequence, out_placements: Sequence,
               mesh, split_dims: Sequence[int]):
    """``fn`` on the local shards of ``args`` (``local_map``'s contract,
    written out with DTensor's stable calls): each DTensor argument is
    redistributed to its ``in_placements`` entry and passed as its local
    tensor (any other argument as it is); the outputs (a tuple, one per
    ``out_placements`` entry) are DTensors with those placements. The
    gradient of an input replicated over a mesh dim in ``split_dims`` (the
    dims the work is split on) is a partial sum there
    (:func:`partial_grads`)."""
    from torch.distributed.tensor import DTensor

    local_args = []
    for a, p in zip(args, in_placements):
        if isinstance(a, DTensor):
            a = a.redistribute(mesh, p)
            a = a.to_local(grad_placements=partial_grads(p, split_dims))
            a = contiguous_grad(a)
        local_args.append(a)
    outs = fn(*local_args)
    if not isinstance(outs, tuple):
        outs = (outs,)
    return tuple(DTensor.from_local(o, mesh, p, run_check=False)
                 for o, p in zip(outs, out_placements))


def partial_grads(in_placements, split_dims):
    """The placements of a local function's gradient for an input placed at
    ``in_placements``: over a mesh dim the function splits its work on
    (``split_dims``) an input replicated there was used by every rank, so
    its local gradients are partial sums."""
    from torch.distributed.tensor import Partial

    return [Partial() if (i in split_dims and p.is_replicate()) else p
            for i, p in enumerate(in_placements)]


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is made contiguous on its way back (where
    autograd records)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ContiguousGrad.apply(x)
    return x


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous. A gradient in
    a transposed layout (an einsum's backward) would leave
    :func:`local_call` as a DTensor gradient that DTensor's ``view`` (the
    backward of the projection that made the input) cannot reshape, and
    would make the CUDA softmax backward copy it whole."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _resolve(entry, dp_axes, tp_axis, vocab_axis):
    if entry == "dp":
        return dp_axes
    if entry == "tp":
        return tp_axis
    if entry == "vocab":
        return vocab_axis
    return entry


def current_dp_size() -> int:
    """Product of the data-parallel axis sizes (1 outside a context)."""
    ctx = _STATE.ctx
    if ctx is None:
        return 1
    mesh, dp_axes = ctx[0], ctx[1]
    sizes = axis_sizes(mesh)
    size = 1
    for a in dp_axes:
        size *= sizes[a]
    return size


def constrain(x: torch.Tensor, spec_kinds: Sequence) -> torch.Tensor:
    """Redistribute a DTensor ``x`` if a context is active.

    ``spec_kinds`` entries: "dp", "tp", "vocab", None, or explicit axis
    names. Entries that do not evenly divide their dim are dropped.
    Outside a context, or for a plain tensor, ``x`` is returned unchanged.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.specs import P, placements

    ctx = _STATE.ctx
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, dp_axes, tp_axis, vocab_axis = ctx
    sizes = axis_sizes(mesh)
    entries = []
    for dim, kind in zip(x.shape, spec_kinds):
        axes = _resolve(kind, dp_axes, tp_axis, vocab_axis)
        if axes is None:
            entries.append(None)
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        size = 1
        for a in names:
            size *= sizes[a]
        entries.append(axes if dim % size == 0 else None)
    target = placements(P(*entries), mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """The residual stream with S whole again, at the entry of a layer.

    The carry between layers shards S over the TP axis. A matmul of
    ``x [B, S, d]`` flattens (B, S), and DTensor cannot multiply a
    flattened dim whose inner part is sharded (a strided shard), so the
    gather GSPMD inserts at the layer's first matmul is made here, inside
    the remat region: the backward keeps the S-sharded input and gathers
    again when it recomputes. A no-op outside a context.
    """
    return constrain(x, ("dp", None, None))


def split_last(x: torch.Tensor, sizes) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], *sizes)`` where DTensor can follow it.

    A shard of the last dim survives the split only if ``sizes[0]`` (the
    new outer dim, e.g. the heads) divides by the shard count; DTensor
    refuses an uneven split, so the last dim is gathered first (the
    resharding GSPMD makes there). A plain tensor is reshaped as it is.
    """
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        last = x.dim() - 1
        dims = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
        count = 1
        for i in dims:
            count *= x.device_mesh.size(i)
        if dims and sizes[0] % count != 0:
            target = [Replicate() if i in dims else p for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, target)
    return x.reshape(*x.shape[:-1], *sizes)


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``; for a DTensor, the backward first lays the
    gradient out as the output was (DTensor's own backward reshapes the
    gradient as it arrives, which fails when another op's backward handed
    it a layout that does not split evenly into the input's shape)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        from torch.distributed.tensor import Replicate

        out = x.reshape(shape)
        ctx.in_shape = tuple(x.shape)
        # The gradient of a partial sum is replicated.
        ctx.out_placements = tuple(Replicate() if p.is_partial() else p for p in out.placements)
        return out

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.out_placements:
            grad = grad.redistribute(grad.device_mesh, ctx.out_placements)
        return grad.reshape(ctx.in_shape), None


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations ``x [..., K]`` and a weight ``w [K, N]``.

    DTensor multiplies a ``[B, S, K]`` activation by flattening (B, S);
    when S (or another inner leading dim) is sharded the flattened dim is
    a strided shard, which its matmul rule fails on. Such a dim is
    gathered first, in the output's gradient too; a plain tensor is
    multiplied as it is.
    """
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and x.dim() > 2:
        x = _inner_dims_whole(x)
        # The backward multiplies the output's gradient the same way.
        return _InnerDimsWholeGrad.apply(x @ w)
    return x @ w


def _inner_dims_whole(x):
    """A DTensor ``[B, ..., K]`` with its dims between the first and the last
    replicated (the first, and the last, stay as they are)."""
    from torch.distributed.tensor import Replicate

    inner = range(1, x.dim() - 1)
    target = [Replicate() if p.is_shard() and p.dim in inner else p for p in x.placements]
    if target != list(x.placements):
        x = x.redistribute(x.device_mesh, target)
    return x


class _InnerDimsWholeGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient's inner dims
    (:func:`_inner_dims_whole`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _inner_dims_whole(grad)
