"""Whole runs of the harness on the CPU at a tiny size, sound and with faults planted.

A copy of the benchmark's files with its two configurations cut to a
tiny width (float32, so that a sound run reads a gap of rounding alone)
drives the rest of a run: the look for a chip is the command's, and is
skipped here. A sound run has to come out correct, the float8 control
and each planted fault not.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from servebench import check, harness

REPO = Path(__file__).resolve().parents[2]
#: The tiny cells' limits: above a float32 run's rounding, below the control's.
TINY_LIMITS = {"max_logit_gap": 0.1, "mean_logit_gap": 0.02}
CPU = torch.device("cpu")
# One thread a process: the tests run beside others, and a whole run's
# timing must not hang on how many cores the machine lends it.
torch.set_num_threads(1)


def make_tiny_root(root: Path) -> Path:
    """The benchmark's files under ``root``, each configuration cut to a tiny
    width and every mix to a few seconds."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    sb = root / "servebench"
    shutil.copytree(REPO / "servebench" / "metrics", sb / "metrics")
    shutil.copytree(REPO / "servebench" / "reference", sb / "reference",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (sb / "configs").mkdir(parents=True)
    (sb / "traffic").mkdir()
    for entry in bench["configs"]:
        c = json.loads((REPO / entry["file"]).read_text())
        c["model"].update(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                          vocab_size=256, n_layers=2, compute_dtype="float32")
        if c["model"]["moe_experts"]:
            c["model"]["moe_experts"] = 4
        c["deployment"].update(slots=4, max_len=128)
        c["check"] = {name: TINY_LIMITS[name] for name in c["check"]}
        (root / entry["file"]).write_text(json.dumps(c))
    for w in bench["workloads"]:
        t = json.loads((REPO / "servebench" / "traffic" / f"{w['traffic']}.json").read_text())
        # The drain ends once the window's requests are done: its limit only
        # has to hold on a slow, shared machine.
        t.update(warmup_s=0.5, drain_s=60, max_total=120, check_requests=4,
                 output={"dist": "uniform", "min": 4, "max": 10})
        if t["loop"] == "open":
            t["prompt"] = {"dist": "uniform", "min": 8, "max": 48, "grid": 8}
            t["rate_per_s"] = 8.0
        else:
            for f in t["functions"]:
                f["prompt"] = max(4, f["prompt"] // 8)
            t.update(callers=8, invocations=500)
        (sb / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, seed=5, trace=False, fault=None, seconds=1.5):
    c = harness.load_cell(root, cell)
    return c, harness.run(c, seed, seconds, trace, CPU, time.perf_counter(), fault=fault,
                          log=lambda line: None)


@pytest.mark.parametrize("cell", ["smollm-chat-poisson", "phi-moe-rag-poisson"])
def test_sound_run_is_correct_and_the_control_is_not(tiny, cell):
    c, res = _run(tiny, cell, seed=2**31 + 11)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["placement_violations"]["value"] == 0
    assert set(res["metrics"]) == {m.name for m in c.end_to_end}
    (name,) = c.config["check"]
    assert res["checks"][name]["value"] < 1e-3
    _, control = check.control_gaps(c.reference, c.config, 2**31 + 11, res["_sample"], CPU)
    assert check.NUMBERS[name](control) > TINY_LIMITS[name]


def test_closed_loop_traced_run_reports_its_layers(tiny):
    c, res = _run(tiny, "smollm-invoke-closed", trace=True)
    assert res["correct"], res["checks"]
    # the device metrics need the card's trace; the host ones are read here
    assert {"route_us_per_request.tput", "decode_tick_ms.tput", "mfu_decode.tput"} <= \
        set(res["metrics"])
    assert list(res)[-3:] == ["checks", "_knee", "_sample"]


def _token_altered(dep):
    for rep in dep.replicas:
        inner = rep._decode

        def altered(params, cache, tokens, positions, inner=inner):
            logits, cache = inner(params, cache, tokens, positions)
            return torch.roll(logits, 1, dims=-1), cache

        rep._decode = altered


def _state_unchanged(dep):
    from repro_torch.models.lm import tree_map

    for rep in dep.replicas:
        inner = rep._decode

        def stale(params, cache, tokens, positions, inner=inner):
            logits, _ = inner(params, tree_map(torch.clone, cache), tokens, positions)
            return logits, cache

        rep._decode = stale


def _half_batch(dep):
    for rep in dep.replicas:
        inner = rep._decode

        def half(params, cache, tokens, positions, inner=inner):
            logits, cache = inner(params, cache, tokens, positions)
            # the first half of the slots left out: they get the other half's logits
            n = logits.shape[0] // 2
            logits = logits.clone()
            logits[:n] = logits[n:2 * n]
            return logits, cache

        rep._decode = half


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged", "half_the_batch"])
@pytest.mark.parametrize("cell", ["smollm-chat-poisson", "phi-moe-decode-poisson"])
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    c, res = _run(tiny, cell, fault=fault)
    assert not res["correct"]
    (name,) = c.config["check"]
    assert res["checks"][name]["value"] > TINY_LIMITS[name]


#: The frozen script with its tags taken out: every request placed by the default tag.
TAGS_IGNORED = "- default:\n  - workers:\n    - set:\n    strategy: platform\n    invalidate: overload\n"


def _tags_ignored(dep):
    dep.engine.platform.apply_policy(TAGS_IGNORED)


@pytest.mark.parametrize("cell", ["smollm-chat-poisson", "smollm-invoke-closed"])
def test_a_router_that_ignores_tags_is_not_correct(tiny, cell):
    """Placed by the default tag alone, interactive requests land on cloud while
    edge has room and batch ones off cloud: the tokens stay right, the
    placement check fails the run."""
    c, res = _run(tiny, cell, fault=_tags_ignored)
    assert not res["correct"]
    assert res["checks"]["placement_violations"]["value"] > 0
    (name,) = c.config["check"]
    assert res["checks"][name]["value"] < TINY_LIMITS[name]


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as files, and named in
    BENCHMARK.json, are run without a change to the harness."""
    root = make_tiny_root(tmp_path)
    sb = root / "servebench"
    conf = json.loads((sb / "configs" / "smollm-135m.json").read_text())
    conf["name"] = "wide-tiny"
    conf["model"]["d_ff"] = 128
    (sb / "configs" / "wide-tiny.json").write_text(json.dumps(conf))
    mix = json.loads((sb / "traffic" / "chat-poisson.json").read_text())
    mix["rate_per_s"] = 5.0
    (sb / "traffic" / "chat-slow.json").write_text(json.dumps(mix))
    (sb / "metrics" / "requests_done.slow.py").write_text(
        'def read(ctx):\n'
        '    return sum(1 for r in ctx.records if not r["failed"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wide-tiny", "source": "x", "reduced": [], "why": "x",
                             "file": "servebench/configs/wide-tiny.json"})
    bench["workloads"].append({"name": "wide-chat-slow", "config": "wide-tiny",
                               "traffic": "chat-slow", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests_done.slow", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "engine",
                               "moves": "ttft_p95_ms", "workloads": ["wide-chat-slow"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ttft_p95_ms":
            m["workloads"].append("wide-chat-slow")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell(root, "wide-chat-slow")
    assert c.config["model"]["d_ff"] == 128 and c.mix["rate_per_s"] == 5.0
    assert [m.name for m in c.end_to_end] == ["ttft_p95_ms", "setup_s"]
    _, res = _run(root, "wide-chat-slow", trace=True)
    assert res["metrics"]["requests_done.slow"]["value"] == res["attempted"] > 0


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": f"{REPO}:{REPO / 'src'}", "PATH": "/usr/bin:/bin"})
    return json.loads(out.stdout.splitlines()[-1])


def test_no_jax_nor_the_jax_package_is_loaded():
    """The harness, every metric, the reference and the scripts, with the
    program's serving path imported as a run imports it: no module whose
    top-level name is jax, jaxlib, flax or repro (compared whole)."""
    mods = _modules_after(
        "import servebench.harness, servebench.check, servebench.devtrace\n"
        "import servebench.reference.lm, servebench.readers\n"
        "import repro_torch.runtime.serve_engine, repro_torch.kernels.ops\n"
        "from pathlib import Path\n"
        "for p in sorted(Path('servebench/metrics').glob('*.py')):\n"
        "    servebench.harness._load_module(p)\n"
        "import runpy\n"
        "for s in ('run', 'knee', 'control'):\n"
        "    runpy.run_path(f'servebench/{s}.py', run_name='not_main')\n")
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    assert not [m for m in mods if m.split(".")[0] in harness.FORBIDDEN_MODULES]


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after("import servebench.reference.lm, servebench.check\n"
                          "servebench.check.control_gaps")
    tops = {m.split(".")[0] for m in mods}
    assert "servebench" in tops
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
