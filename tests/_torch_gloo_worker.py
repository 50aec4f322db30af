"""One rank of the gloo (2, 2) mesh run by ``tests/test_torch_sharding.py``.

    python tests/_torch_gloo_worker.py RANK WORLD STORE_FILE OUT_DIR

Every rank runs the same program on the CPU; rank 0 writes
``OUT_DIR/results.pt`` (a dict of numbers and tensors the tests read).
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import (
    TrainState,
    init_sharded_train_state,
    make_train_step,
    sharding_context,
    train_state_shardings,
)
from repro_torch.models.api import Model
from repro_torch.models.layers import basic
from repro_torch.models.layers.moe import apply_moe
from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.sharding.specs import (
    NamedSharding,
    P,
    ShardingPolicy,
    batch_shardings,
    cache_shardings,
    distribute,
    param_shardings,
)

SEED = 0
ARCHS = ("smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b")
ODD_VOCAB = 257  # does not divide the TP axis: the logits stay whole over it
ODD_VOCAB_ARCHS = ("smollm_135m", "mamba2_2_7b")
BATCH, SEQ = 4, 16


def f32_config(arch, **overrides):
    return dataclasses.replace(smoke_config(arch), compute_dtype="float32", **overrides)


def full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def tokens(cfg, b=BATCH, s=SEQ):
    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, s)), dtype=torch.int32)


def train_step_case(arch, mesh, policy, **overrides):
    """Loss and new params of one step: unsharded, then sharded."""
    from repro_torch.sharding.ctx import activation_sharding

    cfg = f32_config(arch, **overrides)
    # Adam's first update is lr·g/(|g| + eps): with eps at 1e-8 a gradient
    # at rounding level (a sum taken in another order) flips its sign and
    # moves the param by 2·lr. An eps of 1e-3 keeps the update a smooth
    # function of the gradient, so the comparison reads the gradients.
    opt_cfg = AdamWConfig(lr=1e-3, eps=1e-3, warmup_steps=1)
    params = Model(cfg).init_params(torch.Generator().manual_seed(SEED), device="cpu")
    state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    batch = {"tokens": tokens(cfg)}
    policy = policy.for_mesh(mesh)
    # The unsharded step, on plain tensors. MoE dispatch is group-local with
    # one group per data-parallel rank, so the plain step runs in a context
    # of the same data-parallel size: two groups, as the JAX step at dp 2.
    with activation_sharding(mesh, policy.dp_axes, policy.tp_axis):
        plain_state, plain_m = make_train_step(cfg, opt_cfg)(state, batch)

    sh_state = init_sharded_train_state(cfg, opt_cfg, mesh, policy,
                                        torch.Generator().manual_seed(SEED))
    shardings = train_state_shardings(cfg, policy, mesh, sh_state)
    b_sh = batch_shardings(cfg, policy, mesh, None, batch)
    sh_batch = {k: distribute(v, b_sh[k]) for k, v in batch.items()}
    step = make_train_step(cfg, opt_cfg, mesh=mesh, policy=policy, state_shardings=shardings)
    new_state, m = step(sh_state, sh_batch)
    from torch.distributed.tensor import DTensor

    all_dtensor = all(isinstance(leaf, DTensor) for leaf in tree_leaves(list(new_state)))
    errs = {name: float((full(a) - b).abs().max()) for (name, a), (_, b)
            in zip(named_leaves(new_state.params), named_leaves(plain_state.params))}
    worst = max(errs, key=errs.get)
    return {"loss": float(m["loss"]), "plain_loss": float(plain_m["loss"]),
            "param_err": errs[worst], "worst_leaf": worst, "all_dtensor": all_dtensor}


def named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def moe_case(mesh, policy, use_kernels=False):
    """apply_moe at dp 2 on the (2, 2) mesh; x and params from the seed.
    With ``use_kernels`` the expert FFN is the grouped-matmul kernel's
    (its plain version ``gmm_ref`` here on the CPU)."""
    from repro_torch.sharding.ctx import current_dp_size

    cfg = f32_config("phi3_5_moe_42b", use_kernels=use_kernels)
    policy = policy.for_mesh(mesh)
    gen = torch.Generator().manual_seed(SEED)
    params = Model(cfg).init_params(gen, device="cpu")
    moe = tree_map(lambda p: p[0], params["blocks"]["pos0"]["moe"])
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=gen)
    p_sh = param_shardings(cfg, policy, mesh, {"blocks": {"pos0": {"moe": params["blocks"]["pos0"]["moe"]}}})
    moe_sh = {k: NamedSharding(mesh, P(*s.spec[1:])) for k, s in p_sh["blocks"]["pos0"]["moe"].items()}
    with sharding_context(mesh, policy):
        dx = distribute(x, NamedSharding(mesh, P(policy.dp_axes, None, None)))
        dmoe = {k: distribute(v, moe_sh[k]) for k, v in moe.items()}
        out, aux = apply_moe(cfg, dmoe, dx)
        groups = current_dp_size()
    return {"out": full(out), "aux": float(full(aux)), "groups": groups}


def vocab_ce_case(mesh):
    """next_token_nll on logits sharded over the vocabulary, with its gradient."""
    from torch.distributed.tensor import Replicate, Shard

    gen = torch.Generator().manual_seed(SEED)
    logits = torch.randn((BATCH, SEQ, 96), generator=gen)
    tokens = torch.randint(0, 96, (BATCH, SEQ), generator=gen)
    ref = logits.clone().requires_grad_(True)
    ref_nll = basic.next_token_nll(ref, tokens)
    ref_nll.sum().backward()
    from torch.distributed.tensor import distribute_tensor

    dl = distribute_tensor(logits, mesh, [Shard(0), Shard(2)], src_data_rank=None)
    dl = dl.detach().requires_grad_(True)
    dt = distribute_tensor(tokens, mesh, [Shard(0), Replicate()], src_data_rank=None)
    nll = basic.next_token_nll(dl, dt)
    nll.sum().backward()
    return {"nll_err": float((full(nll) - ref_nll).abs().max()),
            "grad_err": float((full(dl.grad) - ref.grad).abs().max())}


def decode_case(mesh, policy):
    """A prefill and two decode steps with caches sharded by cache_shardings
    (T over the TP axis: the masked cache write) against the plain path."""
    from repro_torch.models.api import ShapeSpec

    cfg = f32_config("smollm_135m")
    policy = policy.for_mesh(mesh)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(SEED), device="cpu")
    prompt = tokens(cfg, BATCH, 8)
    max_len = 16

    def run(p, c, place_inputs):
        logits, c = model.prefill(p, {"tokens": place_inputs(prompt, "tokens")}, c)
        outs = [full(logits)]
        for i in range(2):
            tok = torch.full((BATCH,), 3 + i, dtype=torch.int32)
            pos = torch.full((BATCH,), 8 + i, dtype=torch.int32)
            logits, c = model.decode(p, c, place_inputs(tok, "token"), place_inputs(pos, "position"))
            outs.append(full(logits))
        return outs, c

    with torch.no_grad():
        plain, plain_cache = run(params, model.init_cache(BATCH, max_len, device="cpu"),
                                 lambda t, name: t)
        cache = model.init_cache(BATCH, max_len, device="cpu")
        c_sh = cache_shardings(cfg, policy, mesh, cache)
        p_sh = param_shardings(cfg, policy, mesh, params)
        shape = ShapeSpec("dec", "decode", max_len, BATCH)
        i_sh = batch_shardings(cfg, policy, mesh, shape,
                               {"tokens": prompt, "token": prompt[:, 0], "position": prompt[:, 0]})
        dcache = tree_map(distribute, cache, c_sh)
        dparams = tree_map(distribute, params, p_sh)
        with sharding_context(mesh, policy):
            sharded, sh_cache = run(dparams, dcache, lambda t, name: distribute(t, i_sh[name]))
        kv_sharded = str(dcache["pos0"]["k"].placements)
    return {
        "logit_err": max(float((a - b).abs().max()) for a, b in zip(sharded, plain)),
        "cache_err": max(float((full(a) - b).abs().max())
                         for a, b in zip(tree_leaves(sh_cache), tree_leaves(plain_cache))),
        "kv_placements": kv_sharded,
    }


def checkpoint_case(mesh, out_dir):
    """Save a state sharded on (2, 2); restore it on (4, 1) and on no mesh."""
    cfg = f32_config("smollm_135m")
    opt_cfg = AdamWConfig()
    policy = ShardingPolicy(fsdp_min_params=0).for_mesh(mesh)
    state = init_sharded_train_state(cfg, opt_cfg, mesh, policy, torch.Generator().manual_seed(SEED))
    ckpt = Checkpointer(f"{out_dir}/ckpt")
    ckpt.save(3, state, blocking=True)
    dist.barrier()
    mesh41 = make_debug_mesh((4, 1), ("data", "model"))
    policy41 = ShardingPolicy(fsdp_min_params=0).for_mesh(mesh41)
    sh41 = train_state_shardings(cfg, policy41, mesh41, state)
    on41, step41, _ = ckpt.restore(state, shardings=sh41)
    params = Model(cfg).init_params(torch.Generator().manual_seed(SEED), device="cpu")
    plain_like = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    plain, step0, _ = ckpt.restore(plain_like)
    originals = [full(x) for x in tree_leaves(list(state))]
    err41 = max(float((full(a) - b).abs().max()) for a, b in zip(tree_leaves(list(on41)), originals))
    err0 = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(list(plain)), originals))
    meshes = sorted({str(tuple(x.device_mesh.shape)) for x in tree_leaves(list(on41))})
    return {"err41": err41, "err_plain": err0, "steps": (step41, step0),
            "restored_meshes": meshes,
            "sharded_on_22": str(state.params["embed"]["table"].placements)}


def loop_case(mesh, out_dir):
    """run_training with the state's and the batch's shardings against
    the unsharded loop, 3 steps of the seeded data stream."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    cfg = f32_config("smollm_135m")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    policy = ShardingPolicy(fsdp_min_params=0).for_mesh(mesh)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=BATCH, seq_len=SEQ, seed=SEED)
    loop = TrainLoopConfig(total_steps=3, checkpoint_every=1000)
    params = Model(cfg).init_params(torch.Generator().manual_seed(SEED), device="cpu")
    plain = run_training(step_fn=make_train_step(cfg, opt_cfg),
                         state=TrainState(params=params, opt=adamw_init(opt_cfg, params)),
                         pipeline=SyntheticTokens(data), device="cpu", config=loop,
                         checkpointer=Checkpointer(f"{out_dir}/loop_plain_{dist.get_rank()}"))
    state = init_sharded_train_state(cfg, opt_cfg, mesh, policy,
                                     torch.Generator().manual_seed(SEED))
    shardings = train_state_shardings(cfg, policy, mesh, state)
    pipeline = SyntheticTokens(data)
    b_sh = batch_shardings(cfg, policy, mesh, None, pipeline.batch_at(0))
    sharded = run_training(
        step_fn=make_train_step(cfg, opt_cfg, mesh=mesh, policy=policy,
                                state_shardings=shardings),
        state=state, pipeline=pipeline, device="cpu", config=loop,
        checkpointer=Checkpointer(f"{out_dir}/loop_sharded"),
        batch_shardings=b_sh, state_shardings=shardings)
    return {"plain": plain.losses, "sharded": sharded.losses}


def outside_context_case(mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models.layers.attention import _sdpa

    q = distribute_tensor(torch.randn(2, 4, 2, 8), mesh, [Replicate(), Replicate()])
    try:
        _sdpa(q, q, q, None)
    except RuntimeError as e:
        return type(e).__name__
    return "no error"


def main():
    rank, world, store_file, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    torch.manual_seed(SEED)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    policy = ShardingPolicy(fsdp_min_params=0)
    results = {f"train/{arch}": train_step_case(arch, mesh, policy) for arch in ARCHS}
    for arch in ODD_VOCAB_ARCHS:
        results[f"train/{arch}/vocab{ODD_VOCAB}"] = train_step_case(arch, mesh, policy,
                                                                    vocab_size=ODD_VOCAB)
    results["moe"] = moe_case(mesh, policy)
    results["moe/kernels"] = moe_case(mesh, policy, use_kernels=True)
    results["vocab_ce"] = vocab_ce_case(mesh)
    results["decode"] = decode_case(mesh, policy)
    results["checkpoint"] = checkpoint_case(mesh, out_dir)
    results["loop"] = loop_case(mesh, out_dir)
    results["outside_context"] = outside_context_case(mesh)
    if rank == 0:
        torch.save(results, f"{out_dir}/results.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
