"""The port's training path vs the JAX package: optimizer, compression,
data, checkpoints, the train step, remat and the fault-tolerant loop.

Inputs are made with numpy from a seed and given to both sides; JAX's
params and states reach the port through ``repro_torch.convert``.
Tolerances: the data stream and int8 compression are bit-identical; the
schedule and one AdamW update agree to float32 rounding (rtol 1e-6 on
the learning rate; params within 1e-3 × lr of each other, moments to
1e-6 of their scale, int8 moment codes within one step); a train step
on a smoke config gives the loss and the gradients to 1e-4 of their
scale and params within 1e-3 × lr (see ``test_train_step_matches_jax``).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import compression as jax_compression  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import TrainState, make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_at,
)
from repro_torch.optim.compression import ef_compress, ef_init, int8_roundtrip  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training  # noqa: E402

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


class TestSchedule:
    @pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
    def test_lr_at_matches_jax_over_the_schedule(self, schedule):
        kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1,
                  schedule=schedule)
        jcfg, tcfg = jax_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
        for step in list(range(0, 120, 7)) + [9, 10, 11, 99, 100]:
            got = float(lr_at(tcfg, torch.tensor(step, dtype=torch.int32)))
            want = float(jax_adamw.lr_at(jcfg, jnp.asarray(step, jnp.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (step, got, want)

    def test_schedule_shapes(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
        assert float(lr_at(cfg, torch.tensor(0))) < 0.2
        assert float(lr_at(cfg, torch.tensor(10))) == pytest.approx(1.0, rel=0.15)
        assert float(lr_at(cfg, torch.tensor(99))) == pytest.approx(0.1, rel=0.15)


def _update_case(case):
    """(config kwargs, param dtype) of one AdamW update case."""
    return {
        "f32": (dict(), "float32"),
        "int8_moments": (dict(moment_dtype="int8"), "float32"),
        "master_weights": (dict(master_weights=True), "bfloat16"),
        "int8_compression": (dict(compression="int8"), "float32"),
    }[case]


class TestAdamW:
    @pytest.mark.parametrize("case", ["f32", "int8_moments", "master_weights",
                                      "int8_compression"])
    def test_update_matches_jax(self, case):
        kw, pdtype = _update_case(case)
        kw.update(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=5.0)
        jcfg, tcfg = jax_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
        rng = np.random.default_rng(3)
        np_params = {"w": rng.standard_normal((6, 40)).astype(np.float32),
                     "b": {"v": rng.standard_normal((3000,)).astype(np.float32)}}
        jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(pdtype), np_params)
        tparams = convert.to_torch(jax.tree.map(np.asarray, jparams))
        jstate = jax_adamw.adamw_init(jcfg, jparams)
        tstate = adamw_init(tcfg, tparams)
        assert isinstance(tstate, AdamWState) and int(tstate.step) == 0
        lr = kw["lr"]
        for _ in range(3):
            grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                 np_params)
            jgrads = jax.tree.map(lambda a: jnp.asarray(a).astype(pdtype), grads)
            jparams, jstate, jmetrics = jax_adamw.adamw_update(jcfg, jgrads, jstate, jparams)
            tparams, tstate, tmetrics = adamw_update(
                tcfg, convert.to_torch(jax.tree.map(np.asarray, jgrads)), tstate, tparams)
            for key in ("grad_norm", "lr"):
                assert float(tmetrics[key]) == pytest.approx(float(jmetrics[key]), rel=1e-6)
            assert int(tstate.step) == int(jstate.step)
            for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
                assert got.dtype == getattr(torch, pdtype)
                # bf16 params round the same f32 update: one bf16 ulp at most.
                atol = 1e-3 * lr if pdtype == "float32" else 1e-3 * lr + 2 ** -8 * 4
                np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=atol)
            t_m = convert.to_numpy(tstate.m)
            j_m = jax.tree.map(np.asarray, jstate.m)
            for got, want in zip(jax.tree.leaves(t_m), jax.tree.leaves(j_m)):
                if got.dtype == np.int8:
                    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
                else:
                    assert _rel_err(got, want) <= 1e-6
            if case == "master_weights":
                for got, want in zip(tree_leaves(tstate.master), jax.tree.leaves(jstate.master)):
                    assert got.dtype == torch.float32
                    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-3 * lr)
            else:
                assert tstate.master is None

    def _quadratic(self):
        target = torch.tensor([1.5, -2.0, 0.5])

        def loss_and_grad(p):
            w = p["w"].detach().requires_grad_(True)
            loss = torch.sum((w - target) ** 2)
            loss.backward()
            return float(loss.detach()), {"w": w.grad}

        return {"w": torch.zeros(3)}, loss_and_grad

    def test_converges_on_quadratic(self):
        params, loss_and_grad = self._quadratic()
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=300,
                          schedule="constant")
        state = adamw_init(cfg, params)
        for _ in range(300):
            _, grads = loss_and_grad(params)
            params, state, _ = adamw_update(cfg, grads, state, params)
        assert loss_and_grad(params)[0] < 1e-3

    def test_int8_moments_track_f32(self):
        params, loss_and_grad = self._quadratic()
        kw = dict(lr=0.05, weight_decay=0.0, warmup_steps=1, total_steps=100,
                  schedule="constant")
        cfg32, cfg8 = AdamWConfig(**kw), AdamWConfig(moment_dtype="int8", **kw)
        p32, s32 = dict(params), adamw_init(cfg32, params)
        p8, s8 = dict(params), adamw_init(cfg8, params)
        for _ in range(100):
            p32, s32, _ = adamw_update(cfg32, loss_and_grad(p32)[1], s32, p32)
            p8, s8, _ = adamw_update(cfg8, loss_and_grad(p8)[1], s8, p8)
        assert loss_and_grad(p8)[0] < 1e-2
        np.testing.assert_allclose(p8["w"].numpy(), p32["w"].numpy(), atol=0.05)

    def test_grad_clip(self):
        clipped, norm = clip_by_global_norm({"a": torch.full((4,), 100.0)}, 1.0)
        assert float(norm) == pytest.approx(200.0)
        assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    def test_weight_decay_shrinks(self):
        params = {"w": torch.full((4,), 10.0)}
        cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=1, schedule="constant")
        new, _, _ = adamw_update(cfg, {"w": torch.zeros(4)}, adamw_init(cfg, params), params)
        assert float(new["w"][0]) < 10.0 and float(params["w"][0]) == 10.0


class TestCompression:
    @pytest.mark.parametrize("shape", [(1,), (2047,), (2048,), (5000,), (3, 1000)])
    def test_int8_roundtrip_is_bit_identical_to_jax(self, shape):
        x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
        got = int8_roundtrip({"g": torch.from_numpy(x)})["g"].numpy()
        want = np.asarray(jax_compression.int8_roundtrip({"g": jnp.asarray(x)})["g"])
        np.testing.assert_array_equal(got, want)
        assert np.abs(got - x).max() <= np.abs(x).max() / 127.0 + 1e-6

    def test_ef_compress_matches_jax(self):
        rng = np.random.default_rng(5)
        grads = [{"g": rng.standard_normal((3000,)).astype(np.float32) * 1e-3}
                 for _ in range(4)]
        jstate = jax_compression.ef_init({"g": jnp.asarray(grads[0]["g"])})
        tstate = ef_init({"g": torch.from_numpy(grads[0]["g"])})
        for g in grads:
            jout, jstate = jax_compression.ef_compress({"g": jnp.asarray(g["g"])}, jstate)
            tout, tstate = ef_compress({"g": torch.from_numpy(g["g"])}, tstate)
            np.testing.assert_array_equal(tout["g"].numpy(), np.asarray(jout["g"]))
            np.testing.assert_array_equal(tstate.residual["g"].numpy(),
                                          np.asarray(jstate.residual["g"]))

    def test_error_feedback_reduces_bias(self):
        g = torch.full((512,), 1e-4)
        state = ef_init({"g": g})
        total = torch.zeros_like(g)
        for _ in range(50):
            compressed, state = ef_compress({"g": g}, state)
            total = total + compressed["g"]
        np.testing.assert_allclose(total.numpy(), (50 * g).numpy(), rtol=0.05)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


class TestData:
    KW = dict(vocab_size=997, global_batch=8, seq_len=64)

    @pytest.mark.parametrize("frames_dim", [0, 32])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_batch_at_is_bit_identical_to_jax(self, seed, frames_dim):
        port = SyntheticTokens(DataConfig(seed=seed, frames_dim=frames_dim, **self.KW))
        ref = jax_pipeline.SyntheticTokens(
            jax_pipeline.DataConfig(seed=seed, frames_dim=frames_dim, **self.KW))
        for step in (0, 1, 5, 1000):
            for host_index, host_count in ((0, 1), (1, 2), (3, 4)):
                got = port.batch_at(step, host_index=host_index, host_count=host_count)
                want = ref.batch_at(step, host_index=host_index, host_count=host_count)
                assert sorted(got) == sorted(want)
                for key in want:
                    assert got[key].dtype == want[key].dtype
                    np.testing.assert_array_equal(got[key], want[key])

    def test_make_global_batch_on_the_cpu(self):
        cfg = dict(self.KW, frames_dim=16)
        port = SyntheticTokens(DataConfig(**cfg))
        want = jax_pipeline.make_global_batch(
            jax_pipeline.SyntheticTokens(jax_pipeline.DataConfig(**cfg)), 4)
        got = make_global_batch(port, 4, "cpu")
        assert got["tokens"].dtype == torch.int32 and got["frames"].dtype == torch.float32
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))

    def test_host_sharding_partitions_batch(self):
        p = SyntheticTokens(DataConfig(**self.KW))
        parts = [p.batch_at(3, host_index=i, host_count=4)["tokens"] for i in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts, 0), p.batch_at(3)["tokens"])
        with pytest.raises(ValueError):
            p.batch_at(0, host_count=3)


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "h": torch.arange(6.0).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                       want.view(torch.int16) if want.dtype == torch.bfloat16 else want)


class TestCheckpointer:
    def test_roundtrip_with_bfloat16(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        tree = _tree()
        ck.save(10, tree, extra={"note": "hi"})
        restored, step, extra = ck.restore(tree)
        assert step == 10 and extra["note"] == "hi"
        for got, want in zip(tree_leaves(restored), tree_leaves(tree)):
            _assert_same(got, want)
        import json

        manifest = json.loads((tmp_path / "step_000000010" / "manifest.json").read_text())
        assert [leaf["name"] for leaf in manifest["leaves"]] == \
            ["params/h", "params/w", "step"]  # the reference's names, keys sorted
        assert manifest["leaves"][0]["dtype"] == "bfloat16"

    def test_latest_and_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep_last=2)
        for s in (1, 2, 3, 4):
            ck.save(s, _tree())
        assert ck.latest_step() == 4
        assert len([p for p in tmp_path.glob("step_*") if p.is_dir()]) == 2

    def test_uncommitted_invisible(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree())
        (tmp_path / "step_000000001.COMMITTED").unlink()
        assert ck.latest_step() is None
        with pytest.raises(FileNotFoundError):
            ck.restore(_tree())

    def test_async_save(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        tree = _tree()
        ck.save(2, tree, blocking=False)
        tree["params"]["w"].add_(1.0)  # the snapshot was taken before returning
        ck.wait()
        assert ck.latest_step() == 2
        restored, _, _ = ck.restore(tree)
        assert float(restored["params"]["w"][0, 0]) == 0.0

    def test_restore_specific_step(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep_last=5)
        tree = _tree()
        ck.save(1, tree)
        ck.save(2, {"params": {"w": tree["params"]["w"] * 2, "h": tree["params"]["h"]},
                    "step": torch.tensor(8, dtype=torch.int32)})
        restored, step, _ = ck.restore(tree, step=1)
        assert step == 1
        _assert_same(restored["params"]["w"], tree["params"]["w"])

    @pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
    def test_jax_written_train_state_restores_into_the_port(self, tmp_path, param_dtype):
        cfg = jax_smoke_config("smollm_135m")
        jparams = jax.tree.map(lambda a: a.astype(param_dtype),
                               JaxModel(cfg).init_params(jax.random.PRNGKey(0)))
        jstate = jax_steps.TrainState(
            params=jparams,
            opt=jax_adamw.adamw_init(jax_adamw.AdamWConfig(moment_dtype="int8"), jparams))
        JaxCheckpointer(str(tmp_path)).save(5, jstate, extra={"from": "jax"})

        like = convert.to_torch(jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, jstate)))
        assert isinstance(like, TrainState) and isinstance(like.opt, AdamWState)
        restored, step, extra = Checkpointer(str(tmp_path)).restore(like)
        assert step == 5 and extra == {"from": "jax"}
        want = convert.to_torch(jax.tree.map(np.asarray, jstate))
        assert restored.opt.master is None
        got_leaves, want_leaves = list(tree_leaves(list(restored))), list(tree_leaves(list(want)))
        assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves(jstate))
        for got, want_leaf in zip(got_leaves, want_leaves):
            _assert_same(got, want_leaf)

    def test_port_written_float32_state_restores_into_jax(self, tmp_path):
        cfg = jax_smoke_config("smollm_135m")
        jparams = JaxModel(cfg).init_params(jax.random.PRNGKey(1))
        jstate = jax_steps.TrainState(
            params=jparams, opt=jax_adamw.adamw_init(jax_adamw.AdamWConfig(), jparams))
        port_state = convert.to_torch(jax.tree.map(np.asarray, jstate))
        Checkpointer(str(tmp_path)).save(3, port_state)
        restored, step, _ = JaxCheckpointer(str(tmp_path)).restore(jstate)
        assert step == 3
        for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

STEP_ARCHS = ["smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b", "whisper_small"]


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return batch


def _step_setup(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32", **kw)
    jparams = JaxModel(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, convert.to_torch(jax.tree.map(np.asarray, jparams))


def _port_grads(cfg, params, batch):
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    loss, _ = Model(cfg).loss(params, batch)
    loss.backward()
    return loss, tree_map(lambda p: p.grad, params)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_jax(arch):
    """One float32 step: loss and gradients to 1e-4 of their scale (sums in
    another order); the updated params within 1e-3 × lr. The first AdamW
    update is lr·(g/(|g| + eps) + decay), whose slope in g is up to
    lr/eps: with the default eps of 1e-8 a gradient element that is
    float32 noise on both sides (~1e-9) may move by a whole lr. So this
    step takes eps = 1e-3, where a gradient error δ moves a param by at
    most lr·δ/eps; the update's own arithmetic is held at the default eps
    in ``TestAdamW.test_update_matches_jax``."""
    jcfg, tcfg, jparams, tparams = _step_setup(arch)
    opt_kw = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
    np_batch = _batch(tcfg)
    jbatch = jax.tree.map(jnp.asarray, np_batch)
    tbatch = {k: torch.from_numpy(v) for k, v in np_batch.items()}

    jloss_fn = lambda p: JaxModel(jcfg).loss(p, jbatch)  # noqa: E731
    (jloss, _), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(jparams)
    tloss, tgrads = _port_grads(tcfg, tparams, tbatch)
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-4)
    j_np = jax.tree.map(np.asarray, jgrads)
    t_np = convert.to_numpy(tgrads)
    assert jax.tree.structure(t_np) == jax.tree.structure(j_np)
    scale = max(float(np.abs(leaf).max()) for leaf in jax.tree.leaves(j_np))
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(j_np)[0],
                                 jax.tree.leaves(t_np)):
        if path[-1].key == "bk":
            # Zero in exact arithmetic (softmax ignores a shift of a query's
            # scores): both sides hold only float32 noise.
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-6 * scale
        elif np.abs(want).max() == 0:
            assert np.abs(got).max() == 0
        else:
            assert _rel_err(got, want) <= 1e-4, jax.tree_util.keystr(path)

    jopt = jax_adamw.AdamWConfig(**opt_kw)
    jstate = jax_steps.TrainState(params=jparams, opt=jax_adamw.adamw_init(jopt, jparams))
    jnew, jmetrics = jax.jit(jax_steps.make_train_step(jcfg, jopt))(jstate, jbatch)
    topt = AdamWConfig(**opt_kw)
    tstate = TrainState(params=tparams, opt=adamw_init(topt, tparams))
    before = tree_map(torch.clone, tparams)
    tnew, tmetrics = make_train_step(tcfg, topt)(tstate, tbatch)
    for got, want in zip(tree_leaves(tparams), tree_leaves(before)):
        assert torch.equal(got, want)  # the step leaves its input state as it was
    assert float(tmetrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-4)
    assert float(tmetrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=1e-4)
    assert int(tnew.opt.step) == 1
    t_np = convert.to_numpy(tnew.params)
    for got, want in zip(jax.tree.leaves(t_np), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3 * opt_kw["lr"])


def test_int8_moment_training_matches_jax():
    """Four steps with int8 moments and int8 gradient compression, from the
    same params on the same batches: the losses agree to 1e-4 of scale,
    including the jump after the second update (the row-wise int8 code of
    v rounds small entries to 0; an entry whose next gradient is 0 then
    steps by m̂/eps in both packages)."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, moment_dtype="int8", compression="int8")
    jcfg, tcfg, jparams, tparams = _step_setup("smollm_135m")
    jopt, topt = jax_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jstate = jax_steps.TrainState(params=jparams, opt=jax_adamw.adamw_init(jopt, jparams))
    tstate = convert.to_torch(jax.tree.map(np.asarray, jstate))
    jstep, tstep = jax.jit(jax_steps.make_train_step(jcfg, jopt)), make_train_step(tcfg, topt)
    pipeline = jax_pipeline.SyntheticTokens(
        jax_pipeline.DataConfig(vocab_size=tcfg.vocab_size, global_batch=2, seq_len=32))
    jl, tl = [], []
    for step in range(4):
        tokens = pipeline.batch_at(step)["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_train_step_through_the_kernel_path_raises():
    cfg = dataclasses.replace(smoke_config("smollm_135m"), use_kernels=True)
    params = Model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    state = TrainState(params=params, opt=adamw_init(AdamWConfig(), params))
    with pytest.raises(NotImplementedError, match="has no backward kernel"):
        make_train_step(cfg, AdamWConfig())(state, {"tokens": torch.zeros((1, 8),
                                                                          dtype=torch.int32)})


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ["smollm_135m", "phi3_5_moe_42b", "whisper_small"])
def test_remat_gives_the_same_loss_and_grads(arch, remat):
    _, tcfg, _, tparams = _step_setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, seed=2).items()}
    base_loss, base = _port_grads(dataclasses.replace(tcfg, remat="none"), tparams, batch)
    loss, grads = _port_grads(dataclasses.replace(tcfg, remat=remat), tparams, batch)
    assert float(loss) == float(base_loss)
    for got, want in zip(tree_leaves(grads), tree_leaves(base)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_remat_leaves_serving_untouched(monkeypatch):
    """Without autograd recording, no checkpoint is taken."""
    import torch.utils.checkpoint as tuc

    def boom(*a, **k):
        raise AssertionError("checkpoint called")

    monkeypatch.setattr(tuc, "checkpoint", boom)
    cfg = dataclasses.replace(smoke_config("smollm_135m"), remat="full",
                              compute_dtype="float32")
    params = Model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    Model(cfg).loss(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def _loop_setup(tmp_path, arch="smollm_135m", total=12):
    cfg = smoke_config(arch)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=total, schedule="constant")
    params = Model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    state = TrainState(params=params, opt=adamw_init(opt_cfg, params))
    pipeline = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, global_batch=4,
                                          seq_len=32))
    return state, make_train_step(cfg, opt_cfg), pipeline, Checkpointer(str(tmp_path),
                                                                         keep_last=3)


class TestTrainLoop:
    def test_loss_decreases(self, tmp_path):
        state, step_fn, pipeline, ck = _loop_setup(tmp_path, total=25)
        report = run_training(step_fn=step_fn, state=state, pipeline=pipeline,
                              checkpointer=ck,
                              config=TrainLoopConfig(total_steps=25, checkpoint_every=10,
                                                     checkpoint_async=False))
        assert report.steps_run == 25 and report.steps == list(range(25))
        assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5])

    def test_restart_after_injected_failure_replays_the_same_steps(self, tmp_path):
        state, step_fn, pipeline, ck = _loop_setup(tmp_path, total=15)
        report = run_training(step_fn=step_fn, state=state, pipeline=pipeline,
                              checkpointer=ck,
                              config=TrainLoopConfig(total_steps=15, checkpoint_every=5,
                                                     checkpoint_async=True,
                                                     inject_failure_at=8))
        assert report.restarts == 1 and report.rollbacks == 0
        assert report.events == ["restart at step 8: RuntimeError: injected failure at step 8"]
        assert report.final_step == 14 and ck.latest_step() == 14
        assert report.steps == list(range(8)) + list(range(6, 15))
        first = dict(zip(report.steps[:8], report.losses[:8]))
        replay = dict(zip(report.steps[8:], report.losses[8:]))
        assert [replay[s] for s in (6, 7)] == [first[s] for s in (6, 7)]  # CPU: exact

    def test_resume_from_checkpoint(self, tmp_path):
        state, step_fn, pipeline, ck = _loop_setup(tmp_path, total=10)
        run_training(step_fn=step_fn, state=state, pipeline=pipeline, checkpointer=ck,
                     config=TrainLoopConfig(total_steps=6, checkpoint_every=5,
                                            checkpoint_async=False))
        report = run_training(step_fn=step_fn, state=state, pipeline=pipeline,
                              checkpointer=ck,
                              config=TrainLoopConfig(total_steps=10, checkpoint_every=5,
                                                     checkpoint_async=False))
        assert report.steps == [6, 7, 8, 9]  # resumed after the final save at step 5

    def test_rollback_on_a_non_finite_loss(self, tmp_path):
        state, step_fn, pipeline, ck = _loop_setup(tmp_path, total=10)
        poisoned = {"left": 1}

        def flaky(state, batch):
            new, metrics = step_fn(state, batch)
            if int(state.opt.step) == 7 and poisoned["left"]:
                poisoned["left"] -= 1
                metrics = dict(metrics, loss=torch.tensor(math.nan))
            return new, metrics

        report = run_training(step_fn=flaky, state=state, pipeline=pipeline, checkpointer=ck,
                              config=TrainLoopConfig(total_steps=10, checkpoint_every=5,
                                                     checkpoint_async=False))
        assert report.rollbacks == 1 and report.restarts == 0
        assert report.events == ["rollback at step 7: loss nan"]
        assert report.steps == list(range(7)) + [6, 7, 8, 9]
        assert all(math.isfinite(x) for x in report.losses)


@pytest.mark.parametrize("arch,extra", [
    ("smollm_135m", []),
    ("whisper_small", []),
    ("smollm_135m", ["--moment-dtype", "int8", "--grad-compression", "int8"]),
])
def test_train_cli_on_cpu(tmp_path, capsys, arch, extra):
    report = train_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "12",
                             "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
                            + extra)
    out = capsys.readouterr().out
    assert "(smoke config) on cpu" in out and "done: loss" in out
    assert report.steps_run == 12 and report.restarts == 0
    assert all(math.isfinite(x) for x in report.losses)
    assert Checkpointer(str(tmp_path)).latest_step() == 11


def test_train_cli_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.main(["--arch", "smollm_135m", "--smoke"])
