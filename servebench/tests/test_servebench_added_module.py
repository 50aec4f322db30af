"""A configuration of another architecture, added as new files only.

Under a temporary root: a copy of the benchmark at a tiny size, and
beside it a configuration file, a traffic mix and a module
``reference/toy.py`` that the harness has never seen. The module is a
period-2 ``lm``: a dense SwiGLU layer at position 0 and a MoE layer at
position 1 (``moe_every=2``), which the port lays out as ``blocks.pos0``
and ``blocks.pos1`` and which the ``lm`` module refuses. Nothing under
the repository's ``servebench/`` is written.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import pytest
import torch

from servebench import harness
from servebench import weights as W
from servebench.tests.test_servebench_run import TINY_LIMITS, _run, make_tiny_root

REPO_BENCH = Path(__file__).resolve().parents[1]

TOY = '''"""A period-2 lm: a dense SwiGLU FFN at position 0, a MoE FFN at position 1."""
import sys

import torch

from servebench import weights as W
from servebench.reference import lm

_MODULE = sys.modules[__name__]
COMPUTE_LEAVES = lm.COMPUTE_LEAVES
top_leaves = lm.top_leaves


def _at(cfg, position):
    """The lm configuration of the layer at ``position``."""
    return dict(cfg, moe_every=1, moe_experts=cfg["moe_experts"] if position else 0)


def period(cfg):
    return 2


def layer_leaves(cfg, position):
    return lm.layer_leaves(_at(cfg, position), 0)


def attention_layers(cfg):
    return cfg["n_layers"]


def _layer_params(cfg):
    """Parameters one token multiplies through in all layers."""
    per_period = lm.layer_matmul_params(_at(cfg, 0)) + lm.layer_matmul_params(_at(cfg, 1))
    return cfg["n_layers"] // 2 * per_period


def decode_token_flops(cfg, position):
    head = cfg["vocab_size"] * cfg["d_model"]
    return 2 * (_layer_params(cfg) + head) + lm.attention_flops(cfg, position + 1)


def prefill_flops(cfg, s):
    head = cfg["vocab_size"] * cfg["d_model"]
    return 2 * (_layer_params(cfg) * s + head) + lm.attention_flops(cfg, s * (s + 1) // 2)


def teacher_forced_logits(cfg, seed, prompts, served, device, quant=None, layer_weights=None):
    make_layer = layer_weights or (lambda p: W.layer_float32(_MODULE, cfg, seed, p, device))
    top = W.top_float32(_MODULE, cfg, seed, device)
    xs, starts = [], []
    for prompt, out in zip(prompts, served):
        ids = torch.as_tensor(list(prompt) + list(out[:-1]), dtype=torch.long, device=device)
        xs.append(top["embed.table"][ids])
        starts.append(len(prompt) - 1)
    for p in range(cfg["n_layers"]):
        lw = make_layer(p)
        xs = [lm.layer(_at(cfg, p % 2), lw, x, s + 1, quant) for x, s in zip(xs, starts)]
    head = top["embed.table"] if cfg.get("tie_embeddings") else top["lm_head.table"]
    return [lm.linear(lm.norm(cfg, x[s:], top["final_norm.scale"], top.get("final_norm.bias")),
                      head.t(), quant) for x, s in zip(xs, starts)]
'''

CELL = "toy-chat"


def _snapshot(root: Path):
    return {p: (p.stat().st_mtime_ns, p.stat().st_size) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_toy(root: Path, reference: Optional[str] = "toy", write_module: bool = True) -> None:
    """The toy's configuration (naming the module ``reference``, or none),
    mix and module as new files under ``root``, and its cell in
    ``root/BENCHMARK.json``."""
    sb = root / "servebench"
    conf = json.loads((sb / "configs" / "smollm-135m.json").read_text())
    conf.update(name="toy-moe2", reference=reference)
    if reference is None:
        del conf["reference"]
    conf["model"].update(name="toy-moe2", n_layers=4, moe_experts=4, moe_every=2,
                         norm_kind="layernorm", tie_embeddings=False)
    (sb / "configs" / "toy-moe2.json").write_text(json.dumps(conf))
    mix = json.loads((sb / "traffic" / "chat-poisson.json").read_text())
    (sb / "traffic" / "chat-toy.json").write_text(json.dumps(mix))
    if write_module:
        (sb / "reference" / "toy.py").write_text(TOY)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-moe2", "source": "x", "reduced": [], "why": "x",
                             "file": "servebench/configs/toy-moe2.json"})
    bench["workloads"].append({"name": CELL, "config": "toy-moe2", "traffic": "chat-toy",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "smollm-chat-poisson" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def repo_files():
    """The repository's ``servebench/`` files, before the toy is added."""
    return _snapshot(REPO_BENCH)


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory, repo_files):
    root = make_tiny_root(tmp_path_factory.mktemp("toy"))
    _add_toy(root)
    return root


def test_the_module_is_laid_out_as_the_port_lays_it_out(toy_root):
    from repro_torch.models import Model, ModelConfig

    cell = harness.load_cell(toy_root, CELL)
    assert cell.reference.__file__ == str(toy_root / "servebench" / "reference" / "toy.py")
    model_cfg = dict(cell.config["model"], compute_dtype="bfloat16")
    model = Model(ModelConfig(**model_cfg))
    port = model.cast_params(model.init_params(torch.Generator().manual_seed(0), "cpu"))
    ours = W.make_params(cell.reference, model_cfg, 7, "cpu")
    want = {k: (tuple(v.shape), v.dtype) for k, v in W.iter_leaves(port)}
    got = {k: (tuple(v.shape), v.dtype) for k, v in W.iter_leaves(ours)}
    assert got == want
    assert {k.split(".")[1] for k in got if k.startswith("blocks.")} == {"pos0", "pos1"}
    assert got["blocks.pos1.moe.w_up"][0] == (2, 4, 64, 96)
    # layer 2 is period 1's position 0, made again alone as the reference makes it
    again = W.layer_float32(cell.reference, model_cfg, 7, 2, "cpu")
    assert torch.equal(again["ffn.w_gate"], ours["blocks"]["pos0"]["ffn"]["w_gate"][1].float())


def test_the_module_is_the_ports_prefill_and_decode(toy_root):
    """In float32 on the CPU, the toy's reference at every served position
    equals the port's prefill then decode steps through its cache."""
    from repro_torch.models import Model, ModelConfig

    toy = harness.load_cell(toy_root, CELL).reference
    cfg = json.loads((toy_root / "servebench" / "configs" / "toy-moe2.json").read_text())["model"]
    seed = 2**31 + 3
    model = Model(ModelConfig(**cfg))
    params = W.make_params(toy, cfg, seed, "cpu")
    prompt, served = list(range(5, 25)), [3, 8, 13]
    cache = model.init_cache(1, 64, device="cpu")
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt])}, cache)
    rows = [logits[0, -1]]
    for i, tok in enumerate(served[:-1]):
        logits, cache = model.decode(params, cache, torch.tensor([tok]),
                                     torch.tensor([len(prompt) + i]))
        rows.append(logits[0, -1])
    ref = toy.teacher_forced_logits(cfg, seed, [prompt], [served], "cpu")[0]
    torch.testing.assert_close(torch.stack(rows), ref, rtol=1e-4, atol=1e-4)


def test_a_cell_of_the_module_runs_correct(toy_root):
    """The whole run, traced: served by the port, judged by the toy's
    reference, its prefills counted by the toy's module."""
    c, res = _run(toy_root, CELL, seed=2**31 + 17, trace=True)
    assert res["correct"], res["checks"]
    (name,) = c.config["check"]
    assert res["checks"][name]["value"] < TINY_LIMITS[name]
    assert res["metrics"]["mfu_prefill.ttft"]["value"] > 0


def test_nothing_of_the_repository_was_written(toy_root, repo_files):
    harness.load_cell(toy_root, CELL)
    assert _snapshot(REPO_BENCH) == repo_files


@pytest.mark.parametrize("write_module,reference", [(False, "toy"), (True, None)],
                         ids=["no_module_file", "no_reference_key"])
def test_a_missing_module_names_the_file_it_expected(tmp_path, write_module, reference):
    root = make_tiny_root(tmp_path)
    _add_toy(root, reference=reference, write_module=write_module)
    with pytest.raises(SystemExit, match=r"servebench/reference/(toy|<name>)\.py"):
        harness.load_cell(root, CELL)
