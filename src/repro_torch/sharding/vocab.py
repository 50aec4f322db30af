"""Vocabulary-parallel embedding lookup and cross entropy on DTensors.

**Cross entropy.** DTensor's own ``log_softmax`` needs the softmax dim whole, so on logits
sharded over the vocabulary it would all-gather ``[B, S, V]`` float32,
the largest tensor of a small model's train step. GSPMD keeps it sharded
in the JAX package. This op is therefore computed locally on each
vocabulary shard, with three all-reduces of ``[B, S]`` over the
vocabulary's mesh dim (max, sum of exponentials, target logit), the
Megatron vocab-parallel cross entropy. It gives the same numbers as
``-log_softmax(logits)[target]`` up to float rounding
(``tests/test_torch_sharding.py`` holds it to that on a gloo mesh).

**Embedding.** DTensor's own ``embedding`` on a vocab-sharded table
(a masked partial sum) fails when the token batch and the table's FSDP
shard use the same data axis (its mask is built at the tokens' batch
shard while the output is laid out otherwise), and otherwise may choose
to gather the whole table. So the lookup is computed locally too, the
Megatron vocab-parallel embedding: the table is gathered over its FSDP
axes only, each vocabulary shard looks up the tokens it holds (zero rows
for the others) and one all-reduce over the vocabulary's mesh dim sums
them; the backward adds each row's gradient into its own shard, with no
communication. Same numbers as ``F.embedding`` (one nonzero term per row).
"""
from __future__ import annotations

from typing import Optional

import torch


def vocab_sharded_dim(x, tensor_dim: int = -1) -> Optional[int]:
    """The mesh dim that shards ``tensor_dim`` (the vocabulary) of a
    DTensor, else None."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    tensor_dim = tensor_dim % x.dim()
    dims = [i for i, p in enumerate(x.placements) if p.is_shard(tensor_dim)]
    if len(dims) > 1:
        raise ValueError(f"the vocabulary is sharded over several mesh dims: {x.placements}")
    return dims[0] if dims else None


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(t, op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


class _LocalVocabNLL(torch.autograd.Function):
    """NLL of one vocabulary shard: logits [..., V_local] float32, targets
    [...] global ids; the softmax statistics are all-reduced over ``group``."""

    @staticmethod
    def forward(ctx, logits, targets, vocab_start: int, group):
        v_local = logits.shape[-1]
        m = _all_reduce(logits.detach().amax(dim=-1), "max", group)
        z = logits - m[..., None]
        lse = torch.log(_all_reduce(torch.exp(z).sum(dim=-1), "sum", group))
        local_t = targets - vocab_start
        inside = (local_t >= 0) & (local_t < v_local)
        local_t = torch.where(inside, local_t, torch.zeros_like(local_t))
        picked = torch.gather(z, -1, local_t[..., None])[..., 0]
        picked = _all_reduce(torch.where(inside, picked, torch.zeros_like(picked)), "sum", group)
        ctx.save_for_backward(z, lse, local_t, inside)
        return lse - picked

    @staticmethod
    def backward(ctx, grad):
        z, lse, local_t, inside = ctx.saved_tensors
        g = torch.exp(z - lse[..., None])                       # the local softmax
        g.scatter_add_(-1, local_t[..., None], -inside.to(g.dtype)[..., None])
        return g * grad[..., None], None, None, None


def vocab_parallel_nll(logits, targets):
    """``-log_softmax(logits)[targets]`` for DTensor logits [..., V] sharded
    over V on one mesh dim; returns a DTensor [...] replicated over that
    dim and sharded as ``logits`` on the others."""
    from torch.distributed.tensor import DTensor, Replicate

    vdim = vocab_sharded_dim(logits)
    mesh = logits.device_mesh
    out_placements = tuple(Replicate() if i == vdim else p
                           for i, p in enumerate(logits.placements))
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    targets = targets.redistribute(mesh, out_placements)
    local = logits.to_local()
    start = mesh.get_local_rank(vdim) * local.shape[-1]
    nll = _LocalVocabNLL.apply(local, targets.to_local(), start, mesh.get_group(vdim))
    return DTensor.from_local(nll, mesh, out_placements, run_check=False)


class _LocalVocabEmbed(torch.autograd.Function):
    """Lookup in one vocabulary shard ``table`` [V_local, d] of global token
    ids; the rows are summed over ``group`` (one shard holds each)."""

    @staticmethod
    def forward(ctx, table, tokens, vocab_start: int, group):
        v_local = table.shape[0]
        local_t = tokens.long() - vocab_start
        inside = (local_t >= 0) & (local_t < v_local)
        local_t = torch.where(inside, local_t, torch.zeros_like(local_t))
        rows = torch.nn.functional.embedding(local_t, table)
        rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))
        ctx.save_for_backward(local_t, inside)
        ctx.v_local = v_local
        return _all_reduce(rows, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        local_t, inside = ctx.saved_tensors
        d = grad.shape[-1]
        g = torch.where(inside[..., None], grad, torch.zeros((), dtype=grad.dtype,
                                                             device=grad.device))
        out = torch.zeros((ctx.v_local, d), dtype=grad.dtype, device=grad.device)
        out.index_add_(0, local_t.reshape(-1), g.reshape(-1, d))
        return out, None, None, None


def vocab_parallel_embed(table, tokens):
    """``F.embedding(tokens, table)`` for a DTensor table [V, d] sharded over
    V on one mesh dim; the rows come out sharded as ``tokens`` and
    replicated over that dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.sharding.ctx import partial_grads

    vdim = vocab_sharded_dim(table, 0)
    mesh = table.device_mesh
    table = table.redistribute(mesh, tuple(Shard(0) if i == vdim else Replicate()
                                           for i in range(mesh.ndim)))
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out_placements = tuple(Replicate() if i == vdim else p
                           for i, p in enumerate(tokens.placements))
    tokens = tokens.redistribute(mesh, out_placements)
    # Each rank adds the gradients of its own tokens: partial sums over the
    # mesh dims that split the tokens.
    split = [i for i, p in enumerate(out_placements) if p.is_shard()]
    local = table.to_local(grad_placements=partial_grads(table.placements, split))
    start = mesh.get_local_rank(vdim) * local.shape[0]
    rows = _LocalVocabEmbed.apply(local, tokens.to_local(), start, mesh.get_group(vdim))
    return DTensor.from_local(rows, mesh, out_placements, run_check=False)
