"""The port's two user-facing examples against the JAX package's.

* ``examples/quickstart_torch.py``: the control plane prints the same
  placements, ``explain`` text and stats as ``examples/quickstart.py``;
  the data plane (two replicas behind the policy) places the two requests
  on the same replicas with the same greedy tokens as the JAX engine, in
  float32, on params carried over with :mod:`repro_torch.convert` (the
  port on the CPU runs the kernels' plain versions).
* ``examples/train_smollm_torch.py --preset smoke --steps 20
  --inject-failure-at 10 --device cpu``: its first three losses are within
  1e-4 of ``examples/train_smollm.py``'s with the same flags, the same
  converted params and the same data, both in float32, and both restart
  once. A failure at step 10 comes before the first checkpoint (saved
  after step 10), so both loops go on from step 0 with the state they
  hold, as the reference's loop does; with the failure at step 15 the
  loop restores step 10's checkpoint, and the replayed steps 11-14 must
  repeat their losses exactly, the loss must fall.
"""
import dataclasses
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_ARGS = ["--preset", "smoke", "--steps", "20", "--inject-failure-at", "10"]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _float32(smoke_config):
    return lambda arch: dataclasses.replace(smoke_config(arch), compute_dtype="float32")


def _converted(jax_cfg):
    """The JAX examples' params (``init_params(PRNGKey(0))``) in the port's layout."""
    from repro.models import Model as JaxModel
    from repro_torch.convert import to_torch

    params = JaxModel(jax_cfg).init_params(jax.random.PRNGKey(0))
    return to_torch(jax.tree.map(np.asarray, params))


def _lines(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def test_quickstart_control_plane_equals_the_jax_example(capsys):
    jax_example, port_example = _load("quickstart"), _load("quickstart_torch")
    jax_example.control_plane_demo()
    want = capsys.readouterr().out
    got = port_example.control_plane_demo()
    out = capsys.readouterr().out
    assert out == want
    assert got["placements"] == [("critical", "w-edge", "EdgeCtl"), (None, "w-edge", "EdgeCtl")]
    assert got["explain"] in want and "w-edge: valid" in got["explain"]


def test_quickstart_data_plane_equals_the_jax_engine(capsys, monkeypatch):
    jax_example, port_example = _load("quickstart"), _load("quickstart_torch")
    monkeypatch.setattr(jax_example, "smoke_config", _float32(jax_example.smoke_config))
    jax_example.data_plane_demo()
    want = _lines(capsys.readouterr().out, ("critical", "normal"))
    jax_cfg = dataclasses.replace(jax_example.smoke_config("smollm_135m"), n_layers=2)
    cfg = dataclasses.replace(port_example.demo_config(), compute_dtype="float32")
    assert cfg.use_kernels and cfg.n_layers == 2
    engine, critical, normal = port_example.data_plane_demo(
        "cpu", cfg=cfg, params=_converted(jax_cfg))
    got = _lines(capsys.readouterr().out, ("critical", "normal"))
    assert len(want) == 2 and got == want
    assert critical.replica == "w-edge"  # the policy pins critical to the edge
    assert critical.state == normal.state == "done"
    assert len(critical.output) == len(normal.output) == 5
    assert sorted(engine.replicas) == ["w-cloud", "w-edge"]


def test_quickstart_needs_a_card_unless_told_otherwise():
    port_example = _load("quickstart_torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_example.main([])


def _replays(report):
    """{step: (first loss, replayed loss)} of the steps run twice."""
    first, replayed = {}, {}
    for step, loss in zip(report.steps, report.losses):
        (replayed if step in first else first)[step] = loss
    return {s: (first[s], replayed[s]) for s in replayed}


def test_train_smollm_restarts_and_replays_on_the_cpu(tmp_path):
    port_example = _load("train_smollm_torch")
    report = port_example.main(["--preset", "smoke", "--steps", "20", "--inject-failure-at",
                                "15", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert report.restarts == 1 and report.rollbacks == 0
    assert report.steps == list(range(15)) + list(range(11, 20))
    replays = _replays(report)
    assert sorted(replays) == [11, 12, 13, 14]
    assert all(a == b for a, b in replays.values()), replays
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5])


def test_train_smollm_first_losses_equal_the_jax_example(tmp_path, monkeypatch):
    jax_example, port_example = _load("train_smollm"), _load("train_smollm_torch")
    reports = []

    def run_training(**kwargs):
        reports.append(original(**kwargs))
        return reports[-1]

    original = jax_example.run_training
    monkeypatch.setattr(jax_example, "run_training", run_training)
    monkeypatch.setattr(jax_example, "smoke_config", _float32(jax_example.smoke_config))
    monkeypatch.setattr(port_example, "smoke_config", _float32(port_example.smoke_config))
    monkeypatch.setattr(sys, "argv", ["train_smollm.py", *TRAIN_ARGS,
                                      "--ckpt-dir", str(tmp_path / "jax")])
    jax_example.main()
    want = reports[0]
    params = _converted(jax_example.smoke_config("smollm_135m"))
    got = port_example.main(TRAIN_ARGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")],
                            params=params)
    # The JAX report has no steps: both ran 10 steps, then 20 from step 0.
    assert got.steps == list(range(10)) + list(range(20))
    assert got.steps_run == want.steps_run == 30
    assert got.restarts == want.restarts == 1
    np.testing.assert_allclose(got.losses[:3], want.losses[:3], rtol=0, atol=1e-4)
