"""The sharded train step's memory plan, and the gradients of stacked params.

* On a fake (2, 4) mesh (the dry-run's tracing, :mod:`repro_torch.roofline.trace`),
  a smoke train step whose vocabulary (257) does not divide the TP axis:
  no storage made in the backward has the global batch's size in the
  cross entropy's gradient (``[B, ..., V]``), and none has the global
  size of a stacked param that the TP axis shards. GSPMD keeps both
  sharded in the JAX package; each must be a local shard here too. A
  period's gradient may pass through its whole size, but only one
  period's at a time.
* On the CPU, without a mesh: the stacked params' gradients and three
  train steps equal, to the bit, those of the forward that indexes one
  period at a time (``leaf[p]``, written out here).

A fake process group is the process's default group, so the fake-mesh
trace runs in one subprocess.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["smollm_135m", "mamba2_2_7b", "whisper_small"]
VOCAB = 257          # divides neither the TP axis (4) nor the data axis (2)
BATCH, SEQ = 8, 32   # the global batch; 4 rows a data-parallel rank
PERIODS = 6          # stacked periods (encoder and decoder layers for whisper)

_TRACE_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.launch.steps import abstract_train_state, train_state_shardings
    from repro_torch.models.api import ShapeSpec
    from repro_torch.roofline import trace
    from repro_torch.sharding.specs import ShardingPolicy

    def stacked_leaves(cfg, policy, mesh):
        state = abstract_train_state(cfg)
        shardings = train_state_shardings(cfg, policy, mesh, state).params
        out = []

        def visit(names, leaf, sharding):
            if isinstance(leaf, dict):
                for k in leaf:
                    visit(names + (k,), leaf[k], sharding[k])
            elif names[0] in ("blocks", "encoder", "decoder"):
                tp = any(e == "model" or (isinstance(e, tuple) and "model" in e)
                         for e in sharding.spec)
                out.append(("/".join(names), list(leaf.shape), tp))

        visit((), state.params, shardings)
        return out

    made, live, watched = [], {{}}, {{}}
    count = trace.TraceCounter._count

    def _count(self, func, args, kwargs, flat_in, flat_out):
        before = set(self._refs)
        count(self, func, args, kwargs, flat_in, flat_out)
        if torch._C._current_graph_task_id() == -1:
            return  # not in the backward
        for o in flat_out:
            key = id(o.untyped_storage())
            if key in self._refs and key not in before:
                made.append((str(func), list(o.shape)))
                if tuple(o.shape) in live and o.dtype == torch.float32:
                    watched[key] = tuple(o.shape)
        for key in [k for k in watched if k not in self._refs]:
            del watched[key]
        for shape in live:
            live[shape] = max(live[shape], sum(1 for v in watched.values() if v == shape))

    trace.TraceCounter._count = _count
    out = {{}}
    for arch in {archs!r}:
        base = smoke_config(arch)
        cfg = dataclasses.replace(base, vocab_size={vocab}, n_layers={periods} * base.period,
                                  encoder_layers={periods} if base.encoder_layers else 0)
        mesh = make_fake_mesh((2, 4), ("data", "model"))
        policy = ShardingPolicy(fsdp_min_params=0).for_mesh(mesh)
        stacked = stacked_leaves(cfg, policy, mesh)
        made.clear()
        watched.clear()
        # One period of each TP-sharded stacked param, at its whole size, in float32.
        live.clear()
        live.update({{tuple(shape[1:]): 0 for _, shape, tp in stacked if tp}})
        r = dryrun_cell(arch, ShapeSpec("small", "train", {seq}, {batch}), "(2, 4)", cfg=cfg,
                        mesh=mesh, save=False, verbose=False, policy=policy)
        assert r["status"] == "ok", r
        out[arch] = {{"made": list(made), "stacked": stacked,
                     "live_periods": [[list(k), v] for k, v in live.items()]}}
    print("RESULT:" + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def traced():
    script = _TRACE_SCRIPT.format(archs=ARCHS, vocab=VOCAB, batch=BATCH, seq=SEQ,
                                  periods=PERIODS)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:"))
    return json.loads(line[len("RESULT:"):])


def _unambiguous(stacked, shape_of):
    """{shape: names} of the TP-sharded stacked leaves whose ``shape_of``
    (the stack's, or one period's) no replicated leaf shares: a replicated
    leaf's gradient has its whole size, so those cannot be told apart."""
    replicated = {shape_of(shape) for _, shape, tp in stacked if not tp}
    out = {}
    for name, shape, tp in stacked:
        if tp and shape_of(shape) not in replicated:
            out.setdefault(shape_of(shape), []).append(name)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_the_nll_gradient_stays_on_the_batch_shard(traced, arch):
    made = traced[arch]["made"]
    at_vocab = [(op, shape) for op, shape in made if shape and shape[-1] == VOCAB]
    global_batch = [(op, shape) for op, shape in at_vocab if shape[0] == BATCH]
    assert not global_batch, global_batch
    # The gradient is there, at the local batch (4 rows of 31 positions).
    assert [BATCH // 2, SEQ - 1, VOCAB] in [shape for _, shape in at_vocab], at_vocab


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_param_gradients_stay_sharded(traced, arch):
    tp_sharded = _unambiguous(traced[arch]["stacked"], tuple)
    assert sum(map(len, tp_sharded.values())) >= 3  # the check is not vacuous
    whole = [(op, shape, tp_sharded[tuple(shape)]) for op, shape in traced[arch]["made"]
             if tuple(shape) in tp_sharded]
    assert not whole, whole


@pytest.mark.parametrize("arch", ARCHS)
def test_one_period_gradient_at_a_time_is_whole(traced, arch):
    """The layers' backward may leave a period's gradient at its whole size
    (FSDP gathered the weight). It must be resharded before the next
    period's backward, not held until the stack's gradient is formed: at
    most two float32 storages of a period's whole size are live at once a
    leaf (the gradient, and the weight a recomputed layer gathers),
    whatever the depth."""
    per_period = _unambiguous(traced[arch]["stacked"], lambda shape: tuple(shape[1:]))
    live = {tuple(shape): n for shape, n in traced[arch]["live_periods"]}
    assert any(live[shape] for shape in per_period)  # the check is not vacuous
    for shape, names in per_period.items():
        assert live[shape] <= 2 * len(names) < PERIODS * len(names), (shape, names, live[shape])


# ---------------------------------------------------------------------------
# Against the per-period select, on the CPU
# ---------------------------------------------------------------------------

CPU_ARCHS = ["smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b", "jamba_1_5_large_398b",
             "whisper_small"]


def _per_period_select(tree, n):
    """The forward's periods as ``leaf[p]``, one period at a time."""
    from repro_torch.models.lm import tree_map

    return [tree_map(lambda leaf, p=p: leaf[p], tree) for p in range(n)]


@pytest.fixture
def select_periods(monkeypatch):
    """Make the training forward index each period (``leaf[p]``)."""
    from repro_torch.models import encdec, lm

    def use_select():
        monkeypatch.setattr(lm, "unstack", _per_period_select)
        monkeypatch.setattr(encdec, "unstack", _per_period_select)

    return use_select


def _setup(arch):
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.api import Model

    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    params = Model(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=2, seq_len=16, seed=0,
        frames_dim=cfg.d_model if cfg.family == "encdec" else 0))
    return cfg, params, data


def _grads(cfg, params, batch):
    from repro_torch.models.api import Model
    from repro_torch.models.lm import tree_map

    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss, _ = Model(cfg).loss(leaves, batch)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, leaves)


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", CPU_ARCHS)
def test_stacked_gradients_equal_the_per_period_select(arch, select_periods):
    from repro_torch.data.pipeline import make_global_batch

    cfg, params, data = _setup(arch)
    batch = make_global_batch(data, 0, "cpu")
    loss, grads = _grads(cfg, params, batch)
    select_periods()
    want_loss, want = _grads(cfg, params, batch)
    assert torch.equal(loss, want_loss)
    stacked = [name for name, _ in _named(grads)
               if name.split("/")[1] in ("blocks", "encoder", "decoder")]
    assert stacked
    for (name, g), (_, w) in zip(_named(grads), _named(want)):
        assert g.shape == w.shape and torch.equal(g, w), name


@pytest.mark.parametrize("arch", CPU_ARCHS)
def test_three_train_steps_equal_the_per_period_select(arch, select_periods):
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg, params, data = _setup(arch)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)

    def run():
        step = make_train_step(cfg, opt_cfg)
        state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
        losses = []
        for i in range(3):
            state, metrics = step(state, make_global_batch(data, i, "cpu"))
            losses.append(metrics["loss"])
        return losses, state

    losses, state = run()
    select_periods()
    want_losses, want = run()
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses)), (losses, want_losses)
    for (name, a), (_, b) in zip(_named(state.params), _named(want.params)):
        assert torch.equal(a, b), name
    for (name, a), (_, b) in zip(_named(state.opt.v), _named(want.opt.v)):
        assert torch.equal(a, b), name
