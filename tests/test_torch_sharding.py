"""Sharding of the PyTorch port against the JAX package.

* Spec parity: the port's partition specs equal the JAX package's, as
  tuples, for every leaf of the params, the train state (float32 and int8
  moments, with and without master weights), the batches and the caches
  of every applicable shape, for all ten archs at full width, on the
  single- and multi-pod meshes, under four policies. Neither side needs a
  device: JAX's ``AbstractMesh`` and the port's :class:`AbstractMesh`.
* The reference's own spec tests (``test_substrates.py::TestShardingSpecs``).
* ``placements`` and ``constrain`` of the port.
* A gloo (2, 2) mesh in four processes (``tests/_torch_gloo_worker.py``):
  the sharded train step against the unsharded one for three families
  (and for two with a vocabulary that does not divide the TP axis),
  the MoE layer at dp 2 against the JAX ``vmap`` of ``_moe_group`` over two
  groups, the locally wrapped ops (vocab-parallel cross entropy, decode
  against a T-sharded cache) against the plain path, and a checkpoint
  written on (2, 2) restored on (4, 1) and on no mesh.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis import given, settings, strategies as st  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["smollm_135m", "qwen1_5_0_5b", "qwen3_14b", "nemotron_4_15b", "chameleon_34b",
         "grok_1_314b", "phi3_5_moe_42b", "jamba_1_5_large_398b", "mamba2_2_7b",
         "whisper_small"]
MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = {
    "default": {},
    "no_tp": {"tp_enabled": False},
    "fsdp_all": {"fsdp_min_params": 0},
    "tp_vocab": {"tp_scope": "vocab"},
}
OPTS = {"f32": {}, "int8": {"moment_dtype": "int8"}, "master": {"master_weights": True}}


# ---------------------------------------------------------------------------
# Spec parity
# ---------------------------------------------------------------------------


def _jax_key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_specs(tree):
    """{path: spec tuple} of a tree of JAX NamedShardings."""
    from jax.sharding import NamedSharding

    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {"/".join(_jax_key(k) for k in path): tuple(s.spec) for path, s in leaves}


def _port_specs(tree, path=()):
    """{path: spec tuple} of a tree of the port's NamedShardings."""
    from repro_torch.sharding.specs import NamedSharding

    if isinstance(tree, NamedSharding):
        return {"/".join(path): tuple(tree.spec)}
    if tree is None:
        return {}
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    else:  # TrainState, AdamWState
        items = ((f, getattr(tree, f)) for f in tree._fields)
    for k, v in items:
        out.update(_port_specs(v, path + (str(k),)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_state(arch, opt):
    from repro.configs import get_config
    from repro.launch.steps import abstract_train_state
    from repro.optim.adamw import AdamWConfig

    return abstract_train_state(get_config(arch), opt_cfg=AdamWConfig(**OPTS[opt]))


@functools.lru_cache(maxsize=None)
def _port_state(arch, opt):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import abstract_train_state
    from repro_torch.optim.adamw import AdamWConfig

    return abstract_train_state(get_config(arch), AdamWConfig(**OPTS[opt]))


@functools.lru_cache(maxsize=None)
def _jax_inputs(arch, shape_name):
    from repro.configs import get_config
    from repro.models.api import SHAPES, Model

    model = Model(get_config(arch))
    shape = SHAPES[shape_name]
    cache = model.cache_specs(shape) if shape.kind != "train" else None
    return model.input_specs(shape), cache


@functools.lru_cache(maxsize=None)
def _port_inputs(arch, shape_name):
    from repro_torch.configs import get_config
    from repro_torch.models.api import SHAPES, Model

    model = Model(get_config(arch))
    shape = SHAPES[shape_name]
    cache = model.cache_specs(shape) if shape.kind != "train" else None
    return model.input_specs(shape), cache


@pytest.mark.parametrize("policy_name", sorted(POLICIES))
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_jax_package(arch, mesh_kind, policy_name):
    from jax.sharding import AbstractMesh as JaxMesh

    from repro.configs import get_config as jax_config
    from repro.launch.steps import train_state_shardings as jax_tss
    from repro.models.api import SHAPES as JAX_SHAPES, shape_applicable as jax_applicable
    from repro.sharding import specs as jspecs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import train_state_shardings
    from repro_torch.models.api import SHAPES, shape_applicable
    from repro_torch.sharding import specs

    shape, axes = MESHES[mesh_kind]
    jmesh, tmesh = JaxMesh(shape, axes), AbstractMesh(shape, axes)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jpol = jspecs.ShardingPolicy(**POLICIES[policy_name]).for_mesh(jmesh)
    tpol = specs.ShardingPolicy(**POLICIES[policy_name]).for_mesh(tmesh)
    assert tpol.dp_axes == jpol.dp_axes and tpol.tp_axis == jpol.tp_axis
    compared = 0

    for opt in OPTS:
        want = _jax_specs(jax_tss(jcfg, jpol, jmesh, _jax_state(arch, opt)))
        got = _port_specs(train_state_shardings(tcfg, tpol, tmesh, _port_state(arch, opt)))
        assert got == want, (opt, {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                                   if got.get(k) != want.get(k)})
        compared += len(want)
    # The params' shardings alone (param_shardings), as the serving cells use them.
    want = _jax_specs(jspecs.param_shardings(jcfg, jpol, jmesh, _jax_state(arch, "f32").params))
    got = _port_specs(specs.param_shardings(tcfg, tpol, tmesh, _port_state(arch, "f32").params))
    assert got == want

    for name in SHAPES:
        assert shape_applicable(tcfg, SHAPES[name]) == jax_applicable(jcfg, JAX_SHAPES[name])
        if not shape_applicable(tcfg, SHAPES[name]):
            continue
        j_in, j_cache = _jax_inputs(arch, name)
        t_in, t_cache = _port_inputs(arch, name)
        want = _jax_specs(jspecs.batch_shardings(jcfg, jpol, jmesh, JAX_SHAPES[name], j_in))
        got = _port_specs(specs.batch_shardings(tcfg, tpol, tmesh, SHAPES[name], t_in))
        assert got == want, name
        compared += len(want)
        if j_cache is not None:
            want = _jax_specs(jspecs.cache_shardings(jcfg, jpol, jmesh, j_cache))
            got = _port_specs(specs.cache_shardings(tcfg, tpol, tmesh, t_cache))
            assert got == want, name
            compared += len(want)
    assert compared > 50


# ---------------------------------------------------------------------------
# The reference's own spec tests, on the port
# ---------------------------------------------------------------------------


def _debug_mesh():
    from repro_torch.launch.mesh import AbstractMesh

    return AbstractMesh((1, 1), ("data", "model"))


class TestShardingSpecs:
    def test_sanitize_drops_nondivisible(self):
        from repro_torch.launch.mesh import AbstractMesh
        from repro_torch.sharding.specs import P, sanitize_spec

        spec = sanitize_spec(P("data", "model"), (5, 7), _debug_mesh())
        # axis size 1 divides everything
        assert spec == P("data", "model")
        spec = sanitize_spec(P("data", "model"), (6, 7), AbstractMesh((2, 2), ("data", "model")))
        assert spec == P("data", None)

    @given(dims=st.tuples(st.integers(1, 64), st.integers(1, 64)),
           sizes=st.tuples(st.integers(1, 8), st.integers(1, 8)))
    @settings(max_examples=30, deadline=None)
    def test_sanitize_always_divides(self, dims, sizes):
        from repro_torch.launch.mesh import AbstractMesh
        from repro_torch.sharding.specs import P, _axis_size, sanitize_spec

        mesh = AbstractMesh(sizes, ("data", "model"))
        spec = sanitize_spec(P("data", "model"), dims, mesh)
        for dim, axes in zip(dims, list(spec)):
            if axes is not None:
                assert dim % _axis_size(mesh, axes) == 0

    def test_param_spec_rules(self):
        from repro_torch.configs import get_config
        from repro_torch.sharding.specs import P, ShardingPolicy, param_spec

        cfg = get_config("qwen3_14b")
        mesh = _debug_mesh()
        policy = ShardingPolicy().for_mesh(mesh)
        # embed table vocab-parallel
        spec = param_spec(cfg, policy, mesh, ("embed", "table"), (151936, 5120))
        assert spec[0] == "model"
        # column parallel
        spec = param_spec(cfg, policy, mesh, ("blocks", "pos0", "attn", "wq"),
                          (40, 5120, 5120))
        assert spec == P(None, ("data",), "model")
        # row parallel
        spec = param_spec(cfg, policy, mesh, ("blocks", "pos0", "attn", "wo"),
                          (40, 5120, 5120))
        assert spec == P(None, "model", ("data",))
        # norm scales replicated
        spec = param_spec(cfg, policy, mesh, ("final_norm", "scale"), (5120,))
        assert spec == P(None)


# ---------------------------------------------------------------------------
# placements and constrain
# ---------------------------------------------------------------------------


def test_placements_follow_the_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding.specs import P, placements

    multi = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), multi) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), multi) == (Replicate(), Shard(1), Replicate())
    # A mesh dim of size 1 replicates (the same layout on one rank).
    assert placements(P("data", "model"), _debug_mesh()) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), multi)


def test_constrain_is_a_noop_outside_a_context():
    from repro_torch.sharding.ctx import constrain, current_dp_size, gather_sequence

    x = torch.randn(4, 8, 16)
    assert constrain(x, ("dp", "tp", None)) is x
    assert gather_sequence(x) is x
    assert current_dp_size() == 1


def test_constrain_leaves_a_plain_tensor_inside_a_context():
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.sharding.ctx import activation_sharding, constrain, current_dp_size

    x = torch.randn(4, 8, 16)
    with activation_sharding(AbstractMesh((2, 2), ("data", "model")), ("data",), "model"):
        assert constrain(x, ("dp", "tp", None)) is x
        assert current_dp_size() == 2
    assert current_dp_size() == 1


# ---------------------------------------------------------------------------
# The gloo (2, 2) mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Run tests/_torch_gloo_worker.py in four processes; rank 0's results."""
    out = tmp_path_factory.mktemp("gloo")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_gloo_worker.py"), str(rank), "4",
         str(out / "store"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    return torch.load(out / "results.pt", weights_only=False)


@pytest.mark.parametrize("arch", ["smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b",
                                  # a vocabulary that does not divide the TP axis
                                  "smollm_135m/vocab257", "mamba2_2_7b/vocab257"])
def test_sharded_train_step_equals_the_unsharded_one(gloo, arch):
    r = gloo[f"train/{arch}"]
    print(arch, r)
    assert r["all_dtensor"]
    assert abs(r["loss"] - r["plain_loss"]) <= 1e-5 * abs(r["plain_loss"])
    assert r["param_err"] <= 1e-5, r["worst_leaf"]


def _moe_case(use_kernels):
    """The gloo worker's MoE inputs (float32 phi3.5-MoE smoke layer 0 and
    x [4, 16, d] from seed 0) and the JAX package's own body on them,
    ``vmap`` of ``_moe_group`` over 2 groups: (cfg, layer params, x, out,
    aux). With ``use_kernels`` the JAX side runs the Pallas gmm (in
    interpret mode on the CPU)."""
    import jax.numpy as jnp

    from repro.configs import smoke_config as jax_smoke
    from repro.models.layers.moe import _moe_group
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import Model

    cfg = dataclasses.replace(smoke_config("phi3_5_moe_42b"), compute_dtype="float32",
                              use_kernels=use_kernels)
    gen = torch.Generator().manual_seed(0)
    params = Model(cfg).init_params(gen, device="cpu")
    x = torch.randn((4, 16, cfg.d_model), generator=gen)
    layer = {k: v[0] for k, v in params["blocks"]["pos0"]["moe"].items()}
    moe = {k: jnp.asarray(v.numpy()) for k, v in layer.items()}
    jcfg = dataclasses.replace(jax_smoke("phi3_5_moe_42b"), compute_dtype="float32",
                               use_kernels=use_kernels)
    xg = jnp.asarray(x.numpy()).reshape(2, -1, cfg.d_model)
    out, aux = jax.vmap(lambda xs: _moe_group(jcfg, moe, xs))(xg)
    return cfg, layer, x, np.asarray(out).reshape(4, 16, cfg.d_model), float(jnp.mean(aux))


def _check_moe_against_the_jax_vmap(r, use_kernels):
    """``r`` (the gloo worker's apply_moe at dp 2) against :func:`_moe_case`."""
    _, _, _, want, want_aux = _moe_case(use_kernels)
    assert r["groups"] == 2
    np.testing.assert_allclose(r["out"].numpy(), want, rtol=1e-5, atol=1e-5)
    assert abs(r["aux"] - want_aux) <= 1e-5


def test_moe_at_dp2_equals_the_jax_vmap_over_groups(gloo):
    """The port's apply_moe on the (2, 2) mesh (two groups) against the
    JAX package's own body: ``vmap`` of ``_moe_group`` over 2 groups."""
    _check_moe_against_the_jax_vmap(gloo["moe"], use_kernels=False)


def test_moe_with_kernels_at_dp2_equals_the_jax_vmap_over_groups(gloo):
    """The same under ``use_kernels``: the grouped path's expert FFN goes
    through ``moe_ffn_gmm`` on each rank's own groups and experts, where
    the JAX package ``vmap``s ``moe_ffn_gmm`` (the Pallas kernel)."""
    _check_moe_against_the_jax_vmap(gloo["moe/kernels"], use_kernels=True)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_in_two_plain_groups_equals_the_jax_vmap_over_groups(use_kernels):
    """Plain tensors in a context of dp 2 take the grouped path too (two
    groups, no DTensor): the expert FFN of the ``[E, 2·C, d]`` buffer,
    through ``moe_ffn_gmm`` under ``use_kernels``, equals JAX's per group."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.layers.moe import apply_moe
    from repro_torch.sharding.ctx import activation_sharding, current_dp_size

    cfg, layer, x, want, want_aux = _moe_case(use_kernels)
    with activation_sharding(AbstractMesh((2, 2), ("data", "model")), ("data",), "model"):
        assert current_dp_size() == 2
        out, aux = apply_moe(cfg, layer, x)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - want_aux) <= 1e-5


def test_vocab_parallel_cross_entropy_is_unchanged(gloo):
    r = gloo["vocab_ce"]
    assert r["nll_err"] <= 1e-5 and r["grad_err"] <= 1e-6


def test_decode_against_a_t_sharded_cache_is_unchanged(gloo):
    r = gloo["decode"]
    assert "Shard(dim=1)" in r["kv_placements"]  # T over a mesh dim
    assert r["logit_err"] <= 1e-5 and r["cache_err"] <= 1e-5


def test_checkpoint_restores_across_meshes(gloo):
    r = gloo["checkpoint"]
    assert "Shard" in r["sharded_on_22"]
    assert r["steps"] == (3, 3)
    assert r["restored_meshes"] == ["(4, 1)"]
    assert r["err41"] == 0.0 and r["err_plain"] == 0.0


def test_run_training_with_shardings_equals_the_unsharded_loop(gloo):
    r = gloo["loop"]
    assert len(r["sharded"]) == len(r["plain"]) == 3
    for a, b in zip(r["sharded"], r["plain"]):
        assert abs(a - b) <= 1e-5 * abs(b)


def test_the_card_mesh_needs_a_card():
    from repro_torch.launch.mesh import make_gpu_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_gpu_mesh()


def test_a_dtensor_core_outside_a_context_raises(gloo):
    """The attention core on DTensors outside a sharding context raises
    instead of recursing or running on whole tensors."""
    assert gloo["outside_context"] == "RuntimeError"
