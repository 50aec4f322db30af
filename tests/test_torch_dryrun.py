"""The port's dry-run and roofline against the JAX package.

* The roofline formulas (``model_flops``, ``model_bytes_min``,
  ``_cache_bytes``) equal JAX's for all ten archs, four shapes and three
  mesh sizes; ``shape_applicable``, ``input_specs`` and ``cache_specs``
  match JAX's shapes and dtypes.
* Per-device counting: a column-parallel matmul on a fake (2, 4) mesh
  counts the global FLOPs / 8, on fake and on real tensors (DTensor's own
  shape propagation runs each op once more at the global shape; it must
  not be counted).
* The port's matmul FLOPs of a smoke train step on a (1, 1) mesh are
  within 1% of ``repro.roofline.hlo.analyze_hlo(...).dot_flops`` of the
  same JAX step compiled on one CPU device, for smollm, phi3.5-MoE and
  mamba2.
* The mirror of ``tests/test_dryrun_small.py``: the same three archs at
  the same small config on a fake (2, 4) mesh: train FLOPs > 0, collective
  wire > 0, decode traces; on a (1, 1) mesh the wire is 0.

A fake process group is the process's default group, so the port's side
runs in one subprocess.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["smollm_135m", "qwen1_5_0_5b", "qwen3_14b", "nemotron_4_15b", "chameleon_34b",
         "grok_1_314b", "phi3_5_moe_42b", "jamba_1_5_large_398b", "mamba2_2_7b",
         "whisper_small"]
SMALL_ARCHS = ["smollm_135m", "phi3_5_moe_42b", "mamba2_2_7b"]
SMALL = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32)  # test_dryrun_small's
SMALL_BATCH, SMALL_SEQ = 8, 32


# ---------------------------------------------------------------------------
# Formulas and stand-ins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_formulas_equal_the_jax_package(arch):
    from repro.configs import get_config as jax_config
    from repro.models.api import SHAPES as JAX_SHAPES
    from repro.roofline import analysis as jax_analysis
    from repro_torch.configs import get_config
    from repro_torch.models.api import SHAPES
    from repro_torch.roofline import analysis

    jcfg, tcfg = jax_config(arch), get_config(arch)
    for name in SHAPES:
        jshape, tshape = JAX_SHAPES[name], SHAPES[name]
        assert analysis.model_flops(tcfg, tshape) == jax_analysis.model_flops(jcfg, jshape)
        assert analysis._cache_bytes(tcfg, tshape) == jax_analysis._cache_bytes(jcfg, jshape)
        for n in (1, 256, 512):
            assert (analysis.model_bytes_min(tcfg, tshape, n)
                    == jax_analysis.model_bytes_min(jcfg, jshape, n))


def _shapes_dtypes(tree):
    """{path: (shape, dtype name)} of a tree of JAX or torch leaves."""
    out = {}

    def visit(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(path + (str(k),), node[k])
        else:
            out["/".join(path)] = (tuple(node.shape), str(node.dtype).split(".")[-1])

    visit((), tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_stand_ins_match_the_jax_package(arch):
    from repro.configs import get_config as jax_config
    from repro.models.api import SHAPES as JAX_SHAPES, Model as JaxModel
    from repro.models.api import shape_applicable as jax_applicable
    from repro_torch.configs import get_config
    from repro_torch.models.api import LONG_CONTEXT_FAMILIES, SHAPES, Model, shape_applicable

    assert LONG_CONTEXT_FAMILIES == ("ssm", "hybrid")
    jm, tm = JaxModel(jax_config(arch)), Model(get_config(arch))
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(JAX_SHAPES[name])
        assert shape_applicable(tm.cfg, shape) == jax_applicable(jm.cfg, JAX_SHAPES[name])
        if not shape_applicable(tm.cfg, shape):
            continue
        got = tm.input_specs(shape)
        assert all(t.device.type == "meta" for t in got.values())
        assert _shapes_dtypes(got) == _shapes_dtypes(jm.input_specs(JAX_SHAPES[name]))
        if shape.kind != "train":
            assert (_shapes_dtypes(tm.cache_specs(shape))
                    == _shapes_dtypes(jm.cache_specs(JAX_SHAPES[name])))


# ---------------------------------------------------------------------------
# The port on fake meshes (one subprocess)
# ---------------------------------------------------------------------------

_PORT_SCRIPT = textwrap.dedent(
    """
    import dataclasses, json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import smoke_config
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models.api import ShapeSpec
    from repro_torch.roofline.trace import count_call
    from repro_torch.sharding.specs import ShardingPolicy

    out = {{}}
    # A column-parallel matmul: x rows over "data" (2), w columns over "model" (4).
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    for fake in (True, False):
        ctx = FakeTensorMode() if fake else torch.no_grad()
        with ctx:
            x = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.randn(32, 48), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            _, counts = count_call(lambda a, b: a @ b, x, w)
        out["column_parallel_fake" if fake else "column_parallel_real"] = counts.flops

    small = {small!r}
    train = ShapeSpec("small", "train", {seq}, {batch})
    decode = ShapeSpec("smalldec", "decode", 64, {batch})
    for arch in {archs!r}:
        cfg = dataclasses.replace(smoke_config(arch), **small)
        rec = {{}}
        for shape_kind, mesh_shape in (("train", (2, 4)), ("decode", (2, 4)), ("train", (1, 1))):
            mesh = make_fake_mesh(mesh_shape, ("data", "model"))
            r = dryrun_cell(arch, train if shape_kind == "train" else decode,
                            f"{{mesh_shape}}", cfg=cfg, mesh=mesh, save=False, verbose=True,
                            policy=ShardingPolicy(fsdp_min_params=0))
            assert r["status"] == "ok", r
            rec[f"{{shape_kind}}{{mesh_shape}}"] = {{
                "flops": r["roofline"]["flops_per_device"],
                "wire": r["roofline"]["wire_bytes_per_device"],
                "peak": r["memory"]["per_device_bytes"],
            }}
        out[arch] = rec
    print("RESULT:" + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def port():
    script = _PORT_SCRIPT.format(small=SMALL, archs=SMALL_ARCHS, batch=SMALL_BATCH,
                                 seq=SMALL_SEQ)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:"))
    return json.loads(line[len("RESULT:"):])


@pytest.mark.parametrize("mode", ["fake", "real"])
def test_a_sharded_matmul_counts_its_local_shard(port, mode):
    assert port[f"column_parallel_{mode}"] == 2.0 * 64 * 32 * 48 / 8


@functools.lru_cache(maxsize=None)
def _jax_dot_flops(arch):
    """``analyze_hlo(...).dot_flops`` of the JAX train step compiled on one
    CPU device, at the small config."""
    from repro.configs import smoke_config
    from repro.launch.steps import abstract_train_state, make_train_step
    from repro.optim.adamw import AdamWConfig
    from repro.roofline.hlo import analyze_hlo

    cfg = dataclasses.replace(smoke_config(arch), **SMALL)
    state = abstract_train_state(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((SMALL_BATCH, SMALL_SEQ), jax.numpy.int32)}
    compiled = jax.jit(make_train_step(cfg, AdamWConfig())).lower(state, batch).compile()
    return analyze_hlo(compiled.as_text()).dot_flops


@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_matmul_flops_match_the_jax_hlo(port, arch):
    got = port[arch]["train(1, 1)"]["flops"]
    want = _jax_dot_flops(arch)
    print(f"{arch}: port {got:.0f} JAX {want:.0f} gap {got / want - 1:+.4%}")
    assert want > 0
    assert abs(got / want - 1) <= 0.01


@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_the_small_dry_run(port, arch):
    """The mirror of test_dryrun_small.py on the port's fake (2, 4) mesh."""
    r = port[arch]
    assert r["train(2, 4)"]["flops"] > 0
    # a sharded train step must move bytes over the mesh
    assert r["train(2, 4)"]["wire"] > 0
    assert r["decode(2, 4)"]["peak"] > 0
    # one device moves nothing
    assert r["train(1, 1)"]["wire"] == 0
    # eight devices share the work: each counts less than one device does
    assert r["train(2, 4)"]["flops"] < r["train(1, 1)"]["flops"]


def test_a_failing_cell_fails_the_cli(tmp_path):
    code = textwrap.dedent(
        """
        import repro_torch.launch.dryrun as d
        def boom(*args, **kwargs):
            raise RuntimeError("boom")
        d._trace = boom
        d.main(["--arch", "smollm_135m", "--shape", "train_4k", "--no-save"])
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode != 0
    assert "[ERR]" in proc.stdout and "boom" in proc.stdout
