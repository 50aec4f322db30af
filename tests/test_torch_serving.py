"""The port's tAPP-scheduled serving engine (``repro_torch.runtime.serve_engine``).

The serving tests of ``tests/test_runtime.py`` mirrored on the port, on
the CPU, and an end-to-end check that the JAX engine and the port's
engine, given the same script, seed, weights and requests in float32,
place every request on the same replica and emit the same tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core.scheduler.topology import DistributionPolicy as JaxDistributionPolicy  # noqa: E402,E501
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime.serve_engine import Replica as JaxReplica  # noqa: E402
from repro.runtime.serve_engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.scheduler.topology import DistributionPolicy  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime.serve_engine import Replica, ServingEngine  # noqa: E402

torch.set_num_threads(1)


def _small_replica(name, zone, sets=(), slots=2, seed=0):
    cfg = dataclasses.replace(smoke_config("smollm_135m"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(seed), "cpu")
    return Replica(name, cfg, params, zone=zone, sets=sets, slots=slots,
                   max_len=48)


ZONED_SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- edge_only:
  - controller: EdgeCtl
    workers:
    - set: edge
    topology_tolerance: none
  followup: fail
"""


class TestServingEngine:
    def test_completes_requests(self):
        engine = ServingEngine(tapp_script=ZONED_SCRIPT)
        engine.add_controller("EdgeCtl", zone="edge")
        engine.add_controller("CloudCtl", zone="cloud")
        engine.add_replica(_small_replica("r-edge", "edge", ["edge"]))
        engine.add_replica(_small_replica("r-cloud", "cloud", ["cloud"]))
        reqs = [
            engine.submit("smollm-135m", [1, 2, 3], max_new_tokens=4)
            for _ in range(5)
        ]
        engine.run_until_done(max_ticks=100)
        assert all(r.state == "done" for r in reqs)
        assert all(len(r.output) == 4 for r in reqs)

    def test_tagged_requests_pinned_to_zone(self):
        engine = ServingEngine(tapp_script=ZONED_SCRIPT)
        engine.add_controller("EdgeCtl", zone="edge")
        engine.add_controller("CloudCtl", zone="cloud")
        engine.add_replica(_small_replica("r-edge", "edge", ["edge"]))
        engine.add_replica(_small_replica("r-cloud", "cloud", ["cloud"]))
        reqs = [
            engine.submit("smollm-135m", [1, 2, 3], tag="edge_only",
                          max_new_tokens=3)
            for _ in range(4)
        ]
        engine.run_until_done(max_ticks=100)
        assert all(r.state == "done" for r in reqs)
        assert {r.replica for r in reqs} == {"r-edge"}

    def test_federated_engine_routes_by_entry_zone_and_forwards(self):
        from repro_torch.core.platform import (
            ClusterSpec,
            ControllerSpec,
            FederationSpec,
        )

        spec = FederationSpec.of({
            "edge": ClusterSpec(controllers=(ControllerSpec("EdgeCtl"),)),
            "cloud": ClusterSpec(controllers=(ControllerSpec("CloudCtl"),)),
        })
        engine = ServingEngine(tapp_script=ZONED_SCRIPT, federation=spec)
        engine.add_replica(_small_replica("r-edge", "edge", ["edge"]))
        engine.add_replica(_small_replica("r-cloud", "cloud", ["cloud"]))
        pinned = [
            engine.submit("smollm-135m", [1, 2, 3], tag="edge_only",
                          entry_zone="cloud", max_new_tokens=3)
            for _ in range(2)
        ]
        generic = engine.submit("smollm-135m", [4, 5], entry_zone="cloud",
                                max_new_tokens=3)
        engine.run_until_done(max_ticks=100)
        assert all(r.state == "done" for r in pinned + [generic])
        assert {r.replica for r in pinned} == {"r-edge"}
        assert generic.replica == "r-cloud"
        stats = engine.platform.stats()
        assert stats.forwards >= 2
        assert stats.zone("edge").forwarded_in >= 2
        assert engine.gateway is engine.platform.zone_gateway("edge")

    def test_decode_is_deterministic_across_replicas(self):
        engine = ServingEngine(tapp_script=None)
        engine.add_controller("C", zone="z")
        r1 = _small_replica("r1", "z", seed=7)
        r2 = Replica("r2", r1.cfg, r1.params, zone="z", slots=2, max_len=48)
        engine.add_replica(r1)
        engine.add_replica(r2)
        a = engine.submit("smollm-135m", [5, 6, 7, 8], max_new_tokens=5)
        b = engine.submit("smollm-135m", [5, 6, 7, 8], max_new_tokens=5)
        engine.run_until_done(max_ticks=100)
        assert a.state == b.state == "done"
        assert a.output == b.output

    def test_failover_on_replica_loss(self):
        engine = ServingEngine(tapp_script=ZONED_SCRIPT)
        engine.add_controller("EdgeCtl", zone="edge")
        engine.add_controller("CloudCtl", zone="cloud")
        r_edge = _small_replica("r-edge", "edge", ["edge"], seed=1)
        engine.add_replica(r_edge)
        engine.add_replica(_small_replica("r-cloud", "cloud", ["cloud"], seed=1))
        reqs = [
            engine.submit("smollm-135m", [1, 2], max_new_tokens=6)
            for _ in range(3)
        ]
        engine.step_once()
        engine.remove_replica("r-edge")
        engine.run_until_done(max_ticks=200)
        assert all(r.state == "done" for r in reqs)
        assert all(r.replica == "r-cloud" for r in reqs)

    def test_edge_only_fails_when_zone_lost(self):
        engine = ServingEngine(tapp_script=ZONED_SCRIPT)
        engine.add_controller("EdgeCtl", zone="edge")
        engine.add_controller("CloudCtl", zone="cloud")
        engine.add_replica(_small_replica("r-cloud", "cloud", ["cloud"]))
        req = engine.submit("smollm-135m", [1, 2], tag="edge_only",
                            max_new_tokens=2)
        for _ in range(3):
            engine.step_once()
        assert req.state == "queued"

    def test_capacity_spills_to_second_replica(self):
        engine = ServingEngine(
            tapp_script=None, distribution=DistributionPolicy.SHARED
        )
        engine.add_controller("C", zone="z")
        r1 = _small_replica("r1", "z", slots=1, seed=3)
        r2 = Replica("r2", r1.cfg, r1.params, zone="z", slots=1, max_len=48)
        engine.add_replica(r1)
        engine.add_replica(r2)
        reqs = [
            engine.submit("smollm-135m", [9, 9], max_new_tokens=6)
            for _ in range(2)
        ]
        engine.run_until_done(max_ticks=200)
        assert all(r.state == "done" for r in reqs)
        assert {r.replica for r in reqs} == {"r1", "r2"}

    def test_slot_prefill_writes_in_place_and_clears_the_slot(self):
        rep = _small_replica("r", "z", slots=2)
        for leaf in (rep.cache["pos0"]["k"], rep.cache["pos0"]["v"]):
            leaf.fill_(7.0)
        cache_id = id(rep.cache["pos0"]["k"])
        engine = ServingEngine(tapp_script=None)
        engine.add_controller("C", zone="z")
        engine.add_replica(rep)
        engine.submit("smollm-135m", [1, 2, 3], max_new_tokens=1)
        engine.step_once()
        k = rep.cache["pos0"]["k"]
        assert id(k) == cache_id
        # Slot 0: the prompt's K (0-2), the decoded token's (3), then cleared.
        assert bool((k[:, 0, :4] != 7.0).all())
        assert bool((k[:, 0, 4:] == 0).all())
        assert bool((k[:, 1, 1:] == 7.0).all())        # slot 1 untouched past position 0
        assert len(rep.prefill_times) == 1 and rep.prefill_times[0][0] == 3


class TestStragglerMitigation:
    def test_slow_replica_is_flagged_and_routed_around(self, monkeypatch):
        import time as _time

        engine = ServingEngine(tapp_script=None, straggler_factor=2.0)
        engine.add_controller("C", zone="z")
        fast = _small_replica("fast", "z", slots=4, seed=5)
        slow = Replica("slow", fast.cfg, fast.params, zone="z", slots=4,
                       max_len=48)
        engine.add_replica(fast)
        engine.add_replica(slow)
        for _ in range(8):
            engine.submit("smollm-135m", [1, 2], max_new_tokens=3)
        engine.run_until_done(max_ticks=80)
        assert fast.tick_times and slow.tick_times

        orig_decode = slow._decode

        def slow_decode(*args, **kwargs):
            _time.sleep(0.25)
            return orig_decode(*args, **kwargs)

        monkeypatch.setattr(slow, "_decode", slow_decode)
        reqs = [engine.submit("smollm-135m", [3, 4], max_new_tokens=4)
                for _ in range(6)]
        engine.run_until_done(max_ticks=200)
        assert all(r.state == "done" for r in reqs)
        assert engine.stragglers_flagged >= 1


def _mix(n=18, vocab=256, seed=0):
    """Prompts of a few lengths (each length is one JAX compile)."""
    rng = np.random.default_rng(seed)
    tags = ["interactive", "batch", None]
    return [(rng.integers(0, vocab, size=int(rng.choice([3, 6, 9]))).tolist(), tags[i % 3])
            for i in range(n)]


def _jax_serve(cfg, params, requests, max_new_tokens, max_len):
    """The JAX launcher's deployment (repro/launch/serve.py), on given params."""
    engine = JaxServingEngine(distribution=JaxDistributionPolicy.SHARED,
                              tapp_script=serve_mod.DEFAULT_SCRIPT)
    engine.add_controller("EdgeCtl", zone="edge")
    engine.add_controller("CloudCtl", zone="cloud")
    for zone in ("edge", "cloud"):
        for i in range(2):
            engine.add_replica(JaxReplica(f"{zone}-{i}", cfg, params, zone=zone, sets=[zone],
                                          slots=4, max_len=max_len))
    reqs = [engine.submit(cfg.name, tokens, tag=tag, max_new_tokens=max_new_tokens)
            for tokens, tag in requests]
    engine.run_until_done(max_ticks=2000)
    return reqs


class TestEndToEndParity:
    @pytest.fixture(scope="class")
    def jax_run(self):
        cfg = dataclasses.replace(jax_smoke_config("smollm_135m"), n_layers=2,
                                  compute_dtype="float32")
        params = JaxModel(cfg).init_params(jax.random.PRNGKey(0))
        requests = _mix()
        reqs = _jax_serve(cfg, params, requests, max_new_tokens=6, max_len=32)
        return requests, jax.tree.map(np.asarray, params), reqs

    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_same_placements_and_tokens_as_jax(self, jax_run, use_kernels, backend,
                                               monkeypatch):
        requests, np_params, jax_reqs = jax_run
        monkeypatch.setenv("REPRO_BATCH_BACKEND", backend)
        cfg = dataclasses.replace(smoke_config("smollm_135m"), n_layers=2,
                                  compute_dtype="float32")
        result = serve_mod.serve(cfg, device="cpu", requests=requests,
                                 params=convert.to_torch(np_params),
                                 max_new_tokens=6, max_len=32, use_kernels=use_kernels)
        assert result.engine.gateway._engine._batch_backend == backend
        assert all(r.state == "done" for r in result.requests)
        assert all(r.state == "done" for r in jax_reqs)
        assert [r.replica for r in result.requests] == [r.replica for r in jax_reqs]
        assert [r.output for r in result.requests] == [r.output for r in jax_reqs]
        assert ([r.finished_tick for r in result.requests]
                == [r.finished_tick for r in jax_reqs])


class TestEndToEndParityMoe:
    """The same check on the phi3.5-MoE smoke config: routing, capacity
    drops and the expert FFN (the grouped matmul's plain version on the
    CPU) must leave placements, tokens and ticks as the JAX engine's."""

    @pytest.fixture(scope="class")
    def jax_run(self):
        cfg = dataclasses.replace(jax_smoke_config("phi3_5_moe_42b"), n_layers=2,
                                  compute_dtype="float32")
        params = JaxModel(cfg).init_params(jax.random.PRNGKey(0))
        requests = _mix(seed=1)
        reqs = _jax_serve(cfg, params, requests, max_new_tokens=6, max_len=32)
        return requests, jax.tree.map(np.asarray, params), reqs

    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_same_placements_and_tokens_as_jax(self, jax_run, use_kernels, backend,
                                               monkeypatch):
        requests, np_params, jax_reqs = jax_run
        monkeypatch.setenv("REPRO_BATCH_BACKEND", backend)
        cfg = dataclasses.replace(smoke_config("phi3_5_moe_42b"), n_layers=2,
                                  compute_dtype="float32")
        result = serve_mod.serve(cfg, device="cpu", requests=requests,
                                 params=convert.to_torch(np_params),
                                 max_new_tokens=6, max_len=32, use_kernels=use_kernels)
        assert all(r.state == "done" for r in result.requests)
        assert all(r.state == "done" for r in jax_reqs)
        assert [r.replica for r in result.requests] == [r.replica for r in jax_reqs]
        assert [r.output for r in result.requests] == [r.output for r in jax_reqs]
        assert ([r.finished_tick for r in result.requests]
                == [r.finished_tick for r in jax_reqs])


class TestEndToEndParityMamba:
    """The same check on the mamba2 smoke config: the slot prefill (the
    plain chunked scan, which fills the conv window and the SSM state) and
    the decode recurrence must leave placements, tokens and ticks as the
    JAX engine's, with ``use_kernels`` on or off (serving never reaches
    the scan kernel, in either package)."""

    @pytest.fixture(scope="class")
    def jax_run(self):
        cfg = dataclasses.replace(jax_smoke_config("mamba2_2_7b"), compute_dtype="float32")
        params = JaxModel(cfg).init_params(jax.random.PRNGKey(0))
        requests = _mix(seed=2)
        reqs = _jax_serve(cfg, params, requests, max_new_tokens=6, max_len=32)
        return requests, jax.tree.map(np.asarray, params), reqs

    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_same_placements_and_tokens_as_jax(self, jax_run, use_kernels, backend,
                                               monkeypatch):
        from repro_torch.kernels import ssd_scan

        requests, np_params, jax_reqs = jax_run
        monkeypatch.setenv("REPRO_BATCH_BACKEND", backend)
        cfg = dataclasses.replace(smoke_config("mamba2_2_7b"), compute_dtype="float32")
        before = ssd_scan.launches
        result = serve_mod.serve(cfg, device="cpu", requests=requests,
                                 params=convert.to_torch(np_params),
                                 max_new_tokens=6, max_len=32, use_kernels=use_kernels)
        assert ssd_scan.launches == before
        assert all(r.state == "done" for r in result.requests)
        assert all(r.state == "done" for r in jax_reqs)
        assert [r.replica for r in result.requests] == [r.replica for r in jax_reqs]
        assert [r.output for r in result.requests] == [r.output for r in jax_reqs]
        assert ([r.finished_tick for r in result.requests]
                == [r.finished_tick for r in jax_reqs])

    def test_slot_prefill_writes_state_in_place_and_clears_the_slot(self):
        cfg = dataclasses.replace(smoke_config("mamba2_2_7b"), compute_dtype="float32")
        model = Model(cfg)
        params = model.init_params(torch.Generator().manual_seed(0), "cpu")
        rep = Replica("r", cfg, params, zone="z", slots=2, max_len=32)
        conv, ssm = rep.cache["pos0"]["conv"], rep.cache["pos0"]["ssm"]
        conv.fill_(7.0)
        ssm.fill_(7.0)
        prompt = [3, 1, 4, 1, 5]
        engine = ServingEngine(tapp_script=None)
        engine.add_controller("C", zone="z")
        engine.add_replica(rep)
        req = engine.submit(cfg.name, prompt, max_new_tokens=2)
        slot_rows = {k: v[:, 1].clone() for k, v in rep.cache["pos0"].items()}
        rep.admit(req, placement=None)
        assert rep.cache["pos0"]["conv"] is conv and rep.cache["pos0"]["ssm"] is ssm
        # Slot 0 holds exactly what a fresh batch-1 prefill computes.
        fresh = model.init_cache(1, 32, device="cpu")
        _, fresh = model.prefill(rep.params, {"tokens": torch.tensor([prompt])}, fresh)
        for key in ("conv", "ssm"):
            torch.testing.assert_close(rep.cache["pos0"][key][:, 0], fresh["pos0"][key][:, 0],
                                       rtol=0, atol=0)
            assert bool((rep.cache["pos0"][key][:, 1] == slot_rows[key]).all())  # untouched
        # A decode tick steps both slots; the free slot's step leaves slot 0
        # as a batch-1 decode leaves it.
        rep.step()
        _, fresh = model.decode(rep.params, fresh, torch.tensor([req.output[0]]),
                                torch.tensor([len(prompt)]))
        for key in ("conv", "ssm"):
            torch.testing.assert_close(rep.cache["pos0"][key][:, 0], fresh["pos0"][key][:, 0],
                                       rtol=1e-5, atol=1e-5)


class TestLauncher:
    def test_cli_on_cpu(self, capsys):
        serve_mod.main(["--device", "cpu", "--requests", "6", "--max-new-tokens", "3"])
        out = capsys.readouterr().out
        assert "requests=6 done=6" in out
        assert "batch: zones=['cloud']" in out

    def test_serve_refuses_a_missing_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_mod.serve(smoke_config("smollm_135m"))
