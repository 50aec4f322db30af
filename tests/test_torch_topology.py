"""The paper's case study on real model replicas, in the port and in the JAX engine.

``chip_smoke.py``'s ``[topology]`` phase drives ``examples/serve_topology.py``'s
steps (request classes, a replica lost mid-service, a live policy flip and
its rollback, the anti-affinity spread with its ``explain()`` report, and
the two-zone federation with a 40 ms forwarding hop) through
``topology_case``. Here the same function runs the port's engine and the
JAX engine on the CPU, at 2 layers in float32 with the same weights
(``repro_torch.convert``), under both batch backends: the port must give
the same replica, tokens and finished tick per request, the same
``explain`` text, rejections and platform stats, and the same federation
stats and hops. The phase's hard checks run on the port's result too.
"""
import collections
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402

import chip_smoke  # noqa: E402
import repro.kernels.ops as jax_ops  # noqa: E402
import repro_torch.kernels.ops as port_ops  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core.platform import ClusterSpec, ControllerSpec, FederationSpec  # noqa: E402
from repro.core.scheduler.topology import DistributionPolicy  # noqa: E402
from repro.core.sim import NetworkModel  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime.serve_engine import Replica, ServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402

JAX_API = {"ClusterSpec": ClusterSpec, "ControllerSpec": ControllerSpec,
           "FederationSpec": FederationSpec, "DistributionPolicy": DistributionPolicy,
           "NetworkModel": NetworkModel, "Replica": Replica, "ServingEngine": ServingEngine}
BACKENDS = ("numpy", "torch")
#: What each request observed: replica, tokens, finished tick and state.
OUTCOMES = ("classes", "running_at_failure", "failure", "flip", "rollback", "spread_placed",
            "spread", "fed_critical", "fed_generic")


def _run(api, ops_module, cfg, params):
    """``topology_case`` with the package's select op counted by backend."""
    calls = collections.Counter()
    select = ops_module.select_first_available

    def counting(words, orders, *, backend="numpy"):
        calls[backend] += 1
        return select(words, orders, backend=backend)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ops_module, "select_first_available", counting)
        run, _ = chip_smoke.topology_case(api, cfg, params)
    return run, dict(calls)


@pytest.fixture(scope="module")
def jax_run():
    cfg = dataclasses.replace(jax_smoke_config("smollm_135m"), n_layers=2,
                              compute_dtype="float32")
    params = JaxModel(cfg).init_params(jax.random.PRNGKey(0))
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("REPRO_BATCH_BACKEND", "numpy")
        run, calls = _run(JAX_API, jax_ops, cfg, params)
    return run, calls, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_runs(jax_run):
    """{backend: (observations, select calls)}, each run once."""
    _, _, np_params = jax_run
    cfg = dataclasses.replace(smoke_config("smollm_135m"), n_layers=2, compute_dtype="float32")
    runs = {}
    for backend in BACKENDS:
        with pytest.MonkeyPatch.context() as patch:
            patch.setenv("REPRO_BATCH_BACKEND", backend)
            runs[backend] = _run(chip_smoke.port_topology_api(), port_ops, cfg,
                                 convert.to_torch(np_params))
    return runs


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_replicas_tokens_and_ticks(jax_run, port_runs, backend):
    want, got = jax_run[0], port_runs[backend][0]
    for key in OUTCOMES:
        assert got[key] == want[key], key


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_explain_text(jax_run, port_runs, backend):
    want, got = jax_run[0], port_runs[backend][0]
    assert got["explain"] == want["explain"]
    assert got["fed_explain"] == want["fed_explain"]
    assert "anti-affinity" in got["explain"] and "forwarded" in got["fed_explain"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_rejections_per_worker(jax_run, port_runs, backend):
    want, got = jax_run[0], port_runs[backend][0]
    assert got["rejections"] == want["rejections"]
    assert got["rejections"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_platform_stats(jax_run, port_runs, backend):
    assert port_runs[backend][0]["stats"] == jax_run[0]["stats"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_same_federation_stats_and_hops(jax_run, port_runs, backend):
    want, got = jax_run[0], port_runs[backend][0]
    assert got["fed_stats"] == want["fed_stats"]
    assert got["fed_hops"] == want["fed_hops"]
    assert got["fed_stats"]["cross_zone_rtt"] == want["fed_stats"]["cross_zone_rtt"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_select_op_reached_under_the_backend_asked_for(jax_run, port_runs, backend):
    jax_calls, calls = jax_run[1], port_runs[backend][1]
    assert set(jax_calls) == {"numpy"}
    assert calls == {backend: jax_calls["numpy"]}


@pytest.mark.parametrize("backend", BACKENDS)
def test_case_study_checks_hold(port_runs, backend):
    """The ``[topology]`` phase's hard checks, at 2 layers on the CPU."""
    chip_smoke._check_topology(port_runs[backend][0])


def test_scripts_are_the_examples():
    from examples import serve_topology as example

    for name in ("CASE_STUDY_SCRIPT", "FLIPPED", "SPREAD_SCRIPT", "FEDERATION_SCRIPT"):
        assert getattr(chip_smoke, name) == getattr(example, name), name
