"""The port's evaluation simulator (``repro_torch.core.sim``) against the JAX package's.

Every scenario runner of ``core/sim/scenarios.py`` runs in both packages
on the same arguments and seed, in one process: the port's run must give
the JAX run's ``RequestRecord``s field for field, the same ``summary()``,
the same platform stats and the same warnings. Each case runs under
``REPRO_BATCH_BACKEND`` = ``numpy`` and ``torch`` on the port (the JAX
package's batch router knows ``numpy`` and ``jax``; it runs ``numpy``).

The port's and the JAX package's ``select_first_available`` are wrapped
with counters. The port must call its op only with the backend asked
for, and exactly as often as the JAX simulator calls its own. The batch
router reaches the op only where submits coincide in time on a flat
platform with a policy, which the runners' own workloads rarely make
happen: ``_expects_select`` states for each case whether it should, so a
case that never reaches the op is declared, not vacuously equal. The
"together" cases start a runner's users at once (``ramp_up`` 0), so
that the §5.3 deployment reaches the op under each backend.

The paper's claims that ``tests/test_sim.py`` checks on the JAX
simulator are restated against the port.
"""
import collections
import dataclasses
import math
import os
import statistics
import warnings

import pytest

pytest.importorskip("torch")

import repro.core.platform as jax_platform  # noqa: E402
import repro.kernels.ops as jax_ops  # noqa: E402
import repro_torch.core.platform as port_platform  # noqa: E402
import repro_torch.kernels.ops as port_ops  # noqa: E402
from repro.core.sim import scenarios as jax_scenarios  # noqa: E402
from repro_torch.core.sim import scenarios  # noqa: E402

TESTS = sorted(scenarios.WORKLOADS)  # the §5.2 tests, as adhoc_profiles() names them
SCHEDULERS = ("vanilla", "default", "min_memory", "isolated", "shared")
BACKENDS = ("numpy", "torch")
#: The §5.2 tests whose workload has more than one user: only their users
#: can start together.
MULTI_USER = sorted(t for t, spec in scenarios.WORKLOADS.items() if spec.users > 1)


def _plain(value):
    """``value`` with NaN as a string, so that equal results compare equal
    (a summary of a run without one successful request is NaN)."""
    if isinstance(value, float) and math.isnan(value):
        return "nan"
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def _result(result):
    return {"records": [dataclasses.asdict(r) for r in result.records],
            "summary": _plain(result.summary())}


def _observed(runner, out):
    """What one runner call produced, as plain values."""
    if runner == "run_mqtt_case":
        return {fn: _result(res) for fn, res in out.items()}
    first, second = out
    if runner == "run_mqtt_federated_case":
        return {"results": {fn: _result(res) for fn, res in second.items()},
                "stats": _plain(dataclasses.asdict(first.stats()))}
    return {"result": _result(second),
            "stats": _plain(dataclasses.asdict(first.platform.stats()))}


def _run(module, ops_module, runner, kwargs, together, monkeypatch):
    """Run ``module.<runner>(**kwargs)``; returns (observed, warnings,
    select calls by backend)."""
    calls = collections.Counter()
    select = ops_module.select_first_available

    def counting(words, orders, *, backend="numpy"):
        calls[backend] += 1
        return select(words, orders, backend=backend)

    with monkeypatch.context() as patch:
        patch.setattr(ops_module, "select_first_available", counting)
        if together:
            for test, spec in module.WORKLOADS.items():
                patch.setitem(module.WORKLOADS, test, dataclasses.replace(spec, ramp_up=0.0))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = getattr(module, runner)(**kwargs)
    seen = [(w.category.__name__, str(w.message), os.path.basename(w.filename), w.lineno)
            for w in caught]
    return _observed(runner, out), seen, dict(calls)


def _expects_select(runner, kwargs, together):
    """Whether the case's routing reaches the batch router's select op.

    ``Simulation`` batches the submits of one instant into one
    ``invoke_batch``; a federation routes the items of a batch one by
    one, and a policy-free (vanilla) platform never enters the tAPP
    batch router. Staggered users (ramp-up over several users, one user
    per MQTT stage) never submit at one instant.
    """
    if runner == "run_benchmark":
        return (together and kwargs["scheduler"] != "vanilla"
                and kwargs["test"] in MULTI_USER)
    if runner == "run_colocation_case":
        return not kwargs["federated"]  # four classes start at 0, 0.25, 0.5, 0.75 s
    if runner == "run_chaos_case":
        # An overload burst adds copies of a submit at its instant.
        bursts = getattr(kwargs.get("chaos"), "overload_bursts", 0) > 0
        return (together or bursts) and not kwargs.get("federated", False)
    return False  # run_mqtt_case, run_mqtt_federated_case


def _compare(runner, kwargs, backend, monkeypatch, *, together=False, port_first=False,
             jax_kwargs=None):
    """The port's run under ``backend`` against the JAX package's under numpy."""
    def port():
        monkeypatch.setenv("REPRO_BATCH_BACKEND", backend)
        return _run(scenarios, port_ops, runner, kwargs, together, monkeypatch)

    def reference():
        monkeypatch.setenv("REPRO_BATCH_BACKEND", "numpy")
        return _run(jax_scenarios, jax_ops, runner, jax_kwargs or kwargs, together, monkeypatch)

    if port_first:
        mine = port()
        ref = reference()
    else:
        ref = reference()
        mine = port()
    (got, got_warnings, got_calls), (want, want_warnings, want_calls) = mine, ref
    assert got == want
    assert got_warnings == want_warnings
    assert set(want_calls) <= {"numpy"}
    expected = want_calls.get("numpy", 0)
    assert got_calls == ({backend: expected} if expected else {})
    assert (expected > 0) == _expects_select(runner, kwargs, together), (
        f"select op called {expected} times")
    return got


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tagged", [False, True])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("test", TESTS)
def test_run_benchmark(test, scheduler, tagged, seed, backend, monkeypatch):
    got = _compare("run_benchmark",
                   dict(test=test, scheduler=scheduler, tagged=tagged, seed=seed),
                   backend, monkeypatch, port_first=seed == 1)
    assert got["result"]["records"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tagged", [False, True])
@pytest.mark.parametrize("scheduler", SCHEDULERS[1:])
@pytest.mark.parametrize("test", MULTI_USER)
def test_run_benchmark_users_together(test, scheduler, tagged, backend, monkeypatch):
    _compare("run_benchmark", dict(test=test, scheduler=scheduler, tagged=tagged, seed=0),
             backend, monkeypatch, together=True, port_first=tagged)


def test_benchmark_warns_as_the_reference(monkeypatch):
    """``FunctionProfile``'s deprecated ``warm_ttl`` warns in both packages,
    at the same line of ``scenarios.py``, and the port keeps the warning."""
    _, seen, _ = _run(scenarios, port_ops, "run_benchmark",
                      dict(test="hellojs", scheduler="shared"), False, monkeypatch)
    assert seen == [("DeprecationWarning", seen[0][1], "scenarios.py", seen[0][3])]
    assert "warm_ttl is deprecated" in seen[0][1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cloud_first", [True, False])
@pytest.mark.parametrize("use_tapp", [False, True])
def test_run_mqtt_case(use_tapp, cloud_first, backend, monkeypatch):
    _compare("run_mqtt_case", dict(use_tapp=use_tapp, cloud_first=cloud_first, minutes=20),
             backend, monkeypatch, port_first=cloud_first)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_mqtt_federated_case(backend, monkeypatch):
    got = _compare("run_mqtt_federated_case", dict(minutes=20), backend, monkeypatch,
                   port_first=backend == "torch")
    assert got["stats"]["forwards"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("federated", [False, True])
@pytest.mark.parametrize("constrained", [False, True])
def test_run_colocation_case(constrained, federated, backend, monkeypatch):
    _compare("run_colocation_case",
             dict(constrained=constrained, federated=federated, requests_per_user=30),
             backend, monkeypatch, port_first=constrained)


def _chaos_kwargs(case, platform, module):
    """``run_chaos_case``'s arguments for ``case``, built from one package
    (its ``core.platform`` and ``core.sim.scenarios``), as
    ``tests/test_chaos.py`` drives it."""
    if case == "default":
        return {}
    if case == "crashes":
        return dict(test="sleep", seed=1, chaos=module.chaos_benchmark_chaos(seed=1, crashes=3))
    if case == "overload":
        return dict(test="hellojs", seed=1,
                    chaos=platform.ChaosSpec(seed=2, horizon=60.0, overload_bursts=2,
                                             burst_duration=8.0, burst_factor=4.0),
                    overload=platform.OverloadSpec(
                        queue=platform.QueueSpec(depth=16, deadline=2.0)),
                    script=module.OVERLOAD_SCRIPT)
    assert case == "federated"
    return dict(test="sleep", seed=1, federated=True,
                chaos=module.chaos_benchmark_chaos(seed=1, crashes=2, partitions=1))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("together", [False, True])
@pytest.mark.parametrize("case", ["default", "crashes", "overload", "federated"])
def test_run_chaos_case(case, together, backend, monkeypatch):
    got = _compare("run_chaos_case", _chaos_kwargs(case, port_platform, scenarios),
                   backend, monkeypatch, together=together, port_first=case == "crashes",
                   jax_kwargs=_chaos_kwargs(case, jax_platform, jax_scenarios))
    if case == "overload":
        assert got["stats"]["queued"] > 0
    if case == "crashes":
        assert got["stats"]["retries"] > 0


# ---------------------------------------------------------------------------
# The paper's claims (tests/test_sim.py), restated against the port
# ---------------------------------------------------------------------------


def _mean_over_deployments(test, scheduler, tagged=False, n=6):
    means = [scenarios.run_benchmark(test, scheduler=scheduler, tagged=tagged,
                                     seed=seed)[1].summary()["mean"] for seed in range(n)]
    return statistics.fmean(means), statistics.pstdev(means)


class TestPaperClaims:
    def test_vanilla_fails_every_collection_in_the_cloud_first_deployment(self):
        results = scenarios.run_mqtt_case(use_tapp=False, minutes=10, cloud_first=True)
        assert results["data-collection"].failure_rate == 1.0
        lucky = scenarios.run_mqtt_case(use_tapp=False, minutes=10, cloud_first=False)
        assert lucky["data-collection"].failure_rate == 0.0

    @pytest.mark.parametrize("cloud_first", [True, False])
    def test_tapp_fails_nothing_and_pins_the_stages(self, cloud_first):
        results = scenarios.run_mqtt_case(use_tapp=True, minutes=10, cloud_first=cloud_first)
        assert all(res.failure_rate == 0.0 for res in results.values())
        assert {r.worker for r in results["data-collection"].records} == {"W_1"}
        assert {r.worker for r in results["feature-analysis"].records} == {"W_2"}

    def test_federated_collection_is_forwarded_to_the_edge(self):
        federation, results = scenarios.run_mqtt_federated_case(minutes=10)
        collection = results["data-collection"]
        assert collection.failure_rate == 0.0
        assert {r.worker for r in collection.records} == {"W_1"}
        assert collection.n_forwarded == len(collection.records)
        assert federation.stats().forwards >= len(collection.records)

    def test_default_policy_not_worse_than_vanilla(self):
        assert (_mean_over_deployments("hellojs", "default")[0]
                <= _mean_over_deployments("hellojs", "vanilla")[0] * 1.05)
        assert (_mean_over_deployments("matrixMult", "default")[0]
                < _mean_over_deployments("matrixMult", "vanilla")[0])

    def test_policies_beat_vanilla_on_the_heavy_query(self):
        vanilla, vanilla_spread = _mean_over_deployments("data-locality", "vanilla")
        for scheduler in ("default", "min_memory", "isolated", "shared"):
            assert _mean_over_deployments("data-locality", scheduler)[0] < vanilla, scheduler
        tagged, tagged_spread = _mean_over_deployments("data-locality", "shared", tagged=True)
        assert tagged_spread < vanilla_spread / 3

    def test_tagged_beats_untagged_on_the_heavy_query(self):
        untagged, _ = _mean_over_deployments("data-locality", "shared")
        tagged, _ = _mean_over_deployments("data-locality", "shared", tagged=True)
        assert tagged < untagged

    def test_colocation_constraints_cut_interference(self):
        blank_means, constrained_means = [], []
        for seed in (0, 1):
            _, blank = scenarios.run_colocation_case(constrained=False, seed=seed,
                                                     requests_per_user=30)
            _, constrained = scenarios.run_colocation_case(constrained=True, seed=seed,
                                                           requests_per_user=30)
            assert blank.failure_rate == constrained.failure_rate == 0.0
            blank_means.append(blank.for_function("latency_api").summary()["mean"])
            constrained_means.append(constrained.for_function("latency_api").summary()["mean"])
            warm_hosts = set(constrained.for_function("cache_warmer").per_worker_counts())
            joins = constrained.for_function("feature_join").per_worker_counts()
            cohosted = sum(n for worker, n in joins.items() if worker in warm_hosts)
            assert cohosted / sum(joins.values()) > 0.5
        assert statistics.fmean(constrained_means) < statistics.fmean(blank_means)
