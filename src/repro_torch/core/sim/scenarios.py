"""Paper-faithful evaluation scenarios (§5.1–§5.3).

Builders for:
* the two-zone benchmark cluster of §5.3 (France Central / East US, two
  controllers, three workers, MongoDB + terrain backend in East US);
* the qualitative MQTT case of §5.1 (edge zone with a local-only broker);
* the ad-hoc and real-world function profiles (§5.2) with timings scaled
  to reproduce the paper's relationships (absolute values are calibration
  constants — documented per profile);
* the tAPP scripts used in the experiments (Fig. 8 analogues).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.platform import (
    ChaosSpec,
    ClusterSpec,
    ControllerSpec,
    FederationSpec,
    OverloadSpec,
    RetryPolicy,
    TappFederation,
    TappPlatform,
    WorkerSpec,
)
from repro_torch.core.scheduler.topology import DistributionPolicy
from repro_torch.core.sim.core import (
    FunctionProfile,
    NetworkModel,
    SimConfig,
    Simulation,
    WorkloadSpec,
)

# Zones of the quantitative cluster (§5.3): the data (MongoDB, terrain
# backend) lives next to the `east_us` nodes; `france` is ~80ms away.
ZONE_EAST = "east_us"
ZONE_FRANCE = "france"

# Zones of the qualitative case (§5.1).
ZONE_EDGE = "edge"
ZONE_CLOUD = "cloud"


# ---------------------------------------------------------------------------
# Clusters
# ---------------------------------------------------------------------------


def benchmark_cluster(*, deployment_seed: int = 0) -> ClusterSpec:
    """§5.3: 1 controller + 1 worker in France, 1 controller + 2 workers in
    East US. Worker slots model Standard_DS1_v2 (1 vCPU) invoker pools.

    ``deployment_seed`` permutes worker registration order — the paper's
    methodology redeploys the whole platform every 2 repetitions "to avoid
    benchmarking specific configurations, e.g., bad, random configurations
    where vanilla OpenWhisk elects as primary a high-latency worker". Each
    seed is one such deployment: vanilla's co-prime primary depends on the
    order, tAPP's topology-aware choice does not.
    """
    return ClusterSpec(
        controllers=(
            ControllerSpec("FranceCtl", zone=ZONE_FRANCE),
            ControllerSpec("EastCtl", zone=ZONE_EAST),
        ),
        workers=(
            WorkerSpec("fr-w0", zone=ZONE_FRANCE, sets=("france", "any"),
                       capacity_slots=2),
            WorkerSpec("us-w0", zone=ZONE_EAST, sets=("east", "any"),
                       capacity_slots=2),
            WorkerSpec("us-w1", zone=ZONE_EAST, sets=("east", "any"),
                       capacity_slots=2),
        ),
    ).shuffled(deployment_seed)


def benchmark_network() -> NetworkModel:
    """Measured latencies of §5.3: ~2ms from East US to the data host,
    ~80ms from France Central. Bandwidths sized for the 124MB payload."""
    return NetworkModel(
        rtt={
            (ZONE_EAST, ZONE_EAST): 0.002,
            (ZONE_FRANCE, ZONE_EAST): 0.080,
            (ZONE_FRANCE, ZONE_FRANCE): 0.002,
        },
        bandwidth={
            (ZONE_EAST, ZONE_EAST): 300e6,     # same-region ~2.4 Gbps
            (ZONE_FRANCE, ZONE_EAST): 35e6,    # cross-Atlantic ~280 Mbps
            (ZONE_FRANCE, ZONE_FRANCE): 300e6,
        },
    )


def mqtt_cluster(*, cloud_first: bool = True) -> ClusterSpec:
    """§5.1: edge zone (controller + worker + broker/db) and cloud zone
    (controller + worker). The broker is reachable only from the edge.

    ``cloud_first`` controls worker registration order. Vanilla OpenWhisk's
    co-prime schedule makes "the first worker chosen for the function depend
    on the deployment" (§5.1) — the paper observed the *unlucky* deployment
    where the cloud worker is primary and every invocation fails. The
    qualitative benchmark runs both orders to show vanilla is
    deployment-dependent while tAPP succeeds under either.
    """
    edge = WorkerSpec("W_1", zone=ZONE_EDGE, sets=("edge", "any"),
                      capacity_slots=4)
    cloud = WorkerSpec("W_2", zone=ZONE_CLOUD, sets=("cloud", "any"),
                       capacity_slots=4)
    return ClusterSpec(
        controllers=(
            ControllerSpec("LocalCtl", zone=ZONE_EDGE),
            ControllerSpec("CloudCtl", zone=ZONE_CLOUD),
        ),
        workers=(cloud, edge) if cloud_first else (edge, cloud),
    )


def mqtt_federation_spec() -> FederationSpec:
    """§5.1 as a two-entry federation: each zone is an entrypoint.

    Same topology as :func:`mqtt_cluster`, but sliced per zone so
    :class:`TappFederation` stands up an edge gateway (where the sensors
    publish) and a cloud gateway (where the analytics dashboards live).
    The inter-zone network model prices the forwarding hops.
    """
    return FederationSpec.of(
        {
            ZONE_EDGE: ClusterSpec(
                controllers=(ControllerSpec("LocalCtl"),),
                workers=(
                    WorkerSpec("W_1", sets=("edge", "any"), capacity_slots=4),
                ),
            ),
            ZONE_CLOUD: ClusterSpec(
                controllers=(ControllerSpec("CloudCtl"),),
                workers=(
                    WorkerSpec("W_2", sets=("cloud", "any"), capacity_slots=4),
                ),
            ),
        },
        network=mqtt_network(),
        default_entry=ZONE_EDGE,
    )


def mqtt_network() -> NetworkModel:
    return NetworkModel(
        rtt={
            (ZONE_EDGE, ZONE_EDGE): 0.001,
            (ZONE_EDGE, ZONE_CLOUD): 0.040,
            (ZONE_CLOUD, ZONE_CLOUD): 0.002,
        },
        bandwidth={
            (ZONE_EDGE, ZONE_EDGE): 1e9,
            (ZONE_EDGE, ZONE_CLOUD): 100e6,
            (ZONE_CLOUD, ZONE_CLOUD): 1e9,
        },
        # The broker is only reachable from the edge network (§5.1).
        resource_zones={"mqtt_broker": [ZONE_EDGE]},
    )


# ---------------------------------------------------------------------------
# Function profiles (§5.2)
# ---------------------------------------------------------------------------

#: Ad-hoc tests. exec_time values are calibration constants chosen to match
#: the paper's qualitative relationships (Fig. 9): hellojs ~ tens of ms,
#: sleep = 3s exactly, matrixMult ~ meaningful CPU work, cold-start loads
#: 42.8MB of dependencies.
def adhoc_profiles(tagged: bool) -> Dict[str, FunctionProfile]:
    def tag(name: Optional[str]) -> Optional[str]:
        return name if tagged else None

    return {
        "hellojs": FunctionProfile(
            name="hellojs", exec_time=0.020, cold_start_time=0.30,
        ),
        "sleep": FunctionProfile(
            name="sleep", exec_time=3.0, exec_jitter=0.0, cold_start_time=0.30,
        ),
        "matrixMult": FunctionProfile(
            name="matrixMult", exec_time=0.160, cold_start_time=0.30,
        ),
        "cold-start": FunctionProfile(
            name="cold-start", exec_time=0.030,
            cold_start_time=2.8,            # 42.8MB dependency load
            warm_ttl=60.0,                  # throttled past cache timeout
        ),
        "mongoDB": FunctionProfile(
            name="mongoDB", exec_time=0.010, cold_start_time=0.35,
            data_zone=ZONE_EAST, data_bytes=106, data_roundtrips=3,
            tag=tag("db_query"),
        ),
        "data-locality": FunctionProfile(
            name="data-locality", exec_time=0.060, cold_start_time=0.35,
            data_zone=ZONE_EAST, data_bytes=int(124.38e6), data_roundtrips=3,
            tag=tag("db_query"),
        ),
        # Real-world (Wonderless) tests.
        "slackpost": FunctionProfile(
            name="slackpost", exec_time=0.180, cold_start_time=0.40,
        ),
        "pycatj": FunctionProfile(
            name="pycatj", exec_time=0.045, cold_start_time=0.45,
        ),
    }


#: JMeter configurations (§5.3 "Configuration").
WORKLOADS: Dict[str, WorkloadSpec] = {
    "hellojs": WorkloadSpec("hellojs", users=4, requests_per_user=200, ramp_up=10.0),
    "sleep": WorkloadSpec("sleep", users=4, requests_per_user=25, ramp_up=10.0),
    "matrixMult": WorkloadSpec("matrixMult", users=4, requests_per_user=200, ramp_up=10.0),
    "cold-start": WorkloadSpec("cold-start", users=1, requests_per_user=3, pause=660.0),
    "mongoDB": WorkloadSpec("mongoDB", users=4, requests_per_user=200, ramp_up=10.0),
    "data-locality": WorkloadSpec("data-locality", users=4, requests_per_user=50, ramp_up=10.0),
    "slackpost": WorkloadSpec("slackpost", users=1, requests_per_user=100, pause=1.0),
    "pycatj": WorkloadSpec("pycatj", users=4, requests_per_user=200, ramp_up=10.0),
}


#: tAPP script used for the tagged data-locality runs (§5.4.2): prefer the
#: workers co-located with the data (East US), spill to France on load.
DATA_LOCALITY_SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- db_query:
  - workers:
    - set: east
    strategy: random
    invalidate: capacity_used 90%
  - workers:
    - set: france
    strategy: random
    invalidate: overload
  followup: default
"""

#: tAPP script of the MQTT case (Fig. 8).
MQTT_SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- MQTT:
  - controller: LocalCtl
    workers:
    - set: edge
    topology_tolerance: none
  followup: fail
- DB:
  - workers:
    - wrk: W_1
      invalidate: capacity_used 50%
    - wrk: W_2
    strategy: best_first
- Cloud:
  - controller: CloudCtl
    workers:
    - set: cloud
    topology_tolerance: none
  followup: fail
"""


def mqtt_profiles() -> Dict[str, FunctionProfile]:
    """The three pipeline functions of the §5.1 case study."""
    return {
        "data-collection": FunctionProfile(
            name="data-collection", exec_time=1.1,  # collects 1s of sensor data
            requires="mqtt_broker", data_zone=ZONE_EDGE, data_bytes=60_000 * 40,
            tag="MQTT",
        ),
        "feature-extraction": FunctionProfile(
            name="feature-extraction", exec_time=0.08,
            data_zone=ZONE_EDGE, data_bytes=60_000 * 40, tag="DB",
        ),
        "feature-analysis": FunctionProfile(
            name="feature-analysis", exec_time=0.15,
            data_zone=ZONE_EDGE, data_bytes=12 * 8, tag="Cloud",
        ),
    }


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------


def run_benchmark(
    test: str,
    *,
    scheduler: str,                      # "vanilla" | a DistributionPolicy value
    tagged: bool = False,
    script: Optional[str] = None,
    seed: int = 0,
) -> Tuple[Simulation, "SimResult"]:
    """Run one §5.2 test on a fresh §5.3 deployment. Returns (sim, result)."""
    spec = benchmark_cluster(deployment_seed=seed)
    profiles = adhoc_profiles(tagged)
    network = benchmark_network()
    config = SimConfig(seed=seed, gateway_zone=ZONE_EAST)

    if scheduler == "vanilla":
        # A policy-free platform routes through the vanilla fallback.
        platform = TappPlatform(spec, seed=seed)
        sim = Simulation(platform, network, profiles, config, is_tapp=False)
    else:
        policy = DistributionPolicy.parse(scheduler)
        platform = TappPlatform(spec, distribution=policy, seed=seed)
        if script is not None:
            platform.apply_policy(script)
        elif tagged:
            platform.apply_policy(DATA_LOCALITY_SCRIPT)
        # No script + untagged → gateway falls back to vanilla logic but the
        # run still pays the tAPP platform overhead (§5.4.1 methodology),
        # with topology-prioritised worker order. We emulate the co-located
        # preference by loading a minimal blank-set default script.
        else:
            platform.apply_policy(
                "- default:\n"
                "  - workers:\n"
                "    - set:\n"
                "    strategy: platform\n"
                "    invalidate: overload\n"
            )
        sim = Simulation(platform, network, profiles, config, is_tapp=True)

    result = sim.run([WORKLOADS[test]])
    return sim, result


# ---------------------------------------------------------------------------
# Co-location / interference scenario family (constraint layer v2)
# ---------------------------------------------------------------------------
#
# The affinity/anti-affinity extension (arXiv:2407.14572) targets workloads
# the original paper cannot express: *what else runs on the worker* matters.
# Two racks of identical workers; a latency-sensitive API function suffers
# noisy-neighbour interference from a batch cruncher (cache/membus
# pressure), and a join function wants to co-locate with the cache-warmer
# that holds its working set.

ZONE_RACK_A = "rack_a"
ZONE_RACK_B = "rack_b"


def colocation_cluster() -> ClusterSpec:
    """Two racks × two workers, one controller per rack."""
    return ClusterSpec(
        controllers=(
            ControllerSpec("RackACtl", zone=ZONE_RACK_A),
            ControllerSpec("RackBCtl", zone=ZONE_RACK_B),
        ),
        workers=tuple(
            WorkerSpec(
                f"w{i}",
                zone=(ZONE_RACK_A if i < 2 else ZONE_RACK_B),
                sets=((ZONE_RACK_A if i < 2 else ZONE_RACK_B), "any"),
                capacity_slots=4,
            )
            for i in range(4)
        ),
    )


def colocation_network() -> NetworkModel:
    """Rack-to-rack hops are cheap; interference, not topology, dominates."""
    return NetworkModel(
        rtt={
            (ZONE_RACK_A, ZONE_RACK_A): 0.0005,
            (ZONE_RACK_A, ZONE_RACK_B): 0.002,
            (ZONE_RACK_B, ZONE_RACK_B): 0.0005,
        },
        bandwidth={},
        default_bandwidth=1e9,
    )


def colocation_profiles() -> Dict[str, FunctionProfile]:
    return {
        # Latency-sensitive: each co-running foreign invocation multiplies
        # its 20ms service time (cache-thrash victim).
        "latency_api": FunctionProfile(
            name="latency_api", exec_time=0.020, cold_start_time=0.25,
            interference_sensitivity=4.0, tag="latency",
        ),
        # Noisy neighbour: long CPU burns, insensitive itself.
        "batch_crunch": FunctionProfile(
            name="batch_crunch", exec_time=0.8, cold_start_time=0.25,
            tag="batch",
        ),
        # Affinity pair: the warmer pins a working set; the join wants to
        # land where a warmer instance is running.
        "cache_warmer": FunctionProfile(
            name="cache_warmer", exec_time=1.5, cold_start_time=0.25,
            tag="warm",
        ),
        "feature_join": FunctionProfile(
            name="feature_join", exec_time=0.030, cold_start_time=0.25,
            tag="join",
        ),
    }


#: Baseline: constraint-free default policy — the scheduler is blind to
#: co-location, so latency_api lands next to batch_crunch.
COLOCATION_BLANK_SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
"""

#: Constraint-layer policy: anti-affinity keeps the interference victims
#: away from the cruncher (spilling to loaded-but-quiet workers first),
#: and affinity steers the join onto a warmer-hosting worker.
COLOCATION_SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- latency:
  - workers:
    - set:
    strategy: platform
    invalidate: capacity_used 90%
    anti-affinity: [batch_crunch]
  followup: default
- batch:
  - workers:
    - set:
    strategy: best_first
    invalidate: overload
    anti-affinity: [latency_api]
  followup: default
- warm:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- join:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
    affinity: [cache_warmer]
  followup: default
"""


def colocation_workload(
    *, requests_per_user: int = 50
) -> List[WorkloadSpec]:
    return [
        WorkloadSpec("latency_api", users=4,
                     requests_per_user=requests_per_user, ramp_up=1.0),
        WorkloadSpec("batch_crunch", users=4,
                     requests_per_user=max(1, requests_per_user // 4),
                     ramp_up=1.0),
        WorkloadSpec("cache_warmer", users=1,
                     requests_per_user=max(1, requests_per_user // 5),
                     pause=0.2),
        WorkloadSpec("feature_join", users=2,
                     requests_per_user=requests_per_user, ramp_up=1.0),
    ]


def colocation_federation_spec() -> FederationSpec:
    """The two racks as federation zones — each rack is an entrypoint."""
    cluster = colocation_cluster()
    return FederationSpec.of(
        {
            zone: ClusterSpec(
                workers=tuple(w for w in cluster.workers if w.zone == zone),
                controllers=tuple(
                    c for c in cluster.controllers if c.zone == zone
                ),
            )
            for zone in (ZONE_RACK_A, ZONE_RACK_B)
        },
        network=colocation_network(),
        default_entry=ZONE_RACK_A,
    )


def run_colocation_case(
    *,
    constrained: bool,
    seed: int = 0,
    requests_per_user: int = 50,
    federated: bool = False,
) -> Tuple[Simulation, "SimResult"]:
    """Run the interference workload with/without the affinity constraints.

    ``federated`` drives the same deployment through a two-entry
    :class:`TappFederation` instead of the flat platform: each workload
    class enters at its own rack's gateway (latency_api + cache_warmer
    at rack A, batch_crunch + feature_join at rack B) and spills across
    racks only when its own rack declines. Returns (sim, result); split
    per-class stats via ``result.for_function(...)``.
    """
    policy = COLOCATION_SCRIPT if constrained else COLOCATION_BLANK_SCRIPT
    if federated:
        platform = TappFederation(
            colocation_federation_spec(),
            distribution=DistributionPolicy.SHARED,
            seed=seed,
            policy=policy,
        )
    else:
        platform = TappPlatform(
            colocation_cluster(),
            distribution=DistributionPolicy.SHARED,
            seed=seed,
            policy=policy,
        )
    sim = Simulation(
        platform,
        colocation_network(),
        colocation_profiles(),
        SimConfig(seed=seed, gateway_zone=ZONE_RACK_A),
        is_tapp=True,
    )
    workload = colocation_workload(requests_per_user=requests_per_user)
    if federated:
        entries = {
            "latency_api": ZONE_RACK_A,
            "cache_warmer": ZONE_RACK_A,
            "batch_crunch": ZONE_RACK_B,
            "feature_join": ZONE_RACK_B,
        }
        workload = [
            dataclasses.replace(spec, entry_zone=entries[spec.function])
            for spec in workload
        ]
    result = sim.run(workload)
    return sim, result


#: Overload-aware variant of the data-locality policy (PR 9): db_query
#: traffic is higher-priority than best-effort default traffic (the queue
#: sheds default first when full) and may relax its affinity for the
#: east-side workers under a sustained brownout.
OVERLOAD_SCRIPT = """
- default:
  - workers:
    - set:
    strategy: platform
    invalidate: overload
- db_query:
  - workers:
    - set: east
    strategy: random
    invalidate: capacity_used 90%
    priority: 2
  - workers:
    - set: france
    strategy: random
    invalidate: overload
    priority: 2
  followup: default
  on-overload: relax-affinity
"""


def chaos_benchmark_chaos(
    *, seed: int = 0, crashes: int = 2, partitions: int = 0
) -> ChaosSpec:
    """A §5.3-sized chaos schedule: a couple of worker crashes (with
    recovery) inside the first minute, optional inter-zone partitions."""
    return ChaosSpec(
        seed=seed,
        horizon=60.0,
        worker_crashes=crashes,
        crash_downtime=10.0,
        partitions=partitions,
        partition_duration=15.0,
    )


def run_chaos_case(
    *,
    test: str = "hellojs",
    seed: int = 0,
    chaos: Optional[ChaosSpec] = None,
    retry: Optional[RetryPolicy] = RetryPolicy(max_attempts=3),
    federated: bool = False,
    overload: Optional[OverloadSpec] = None,
    script: Optional[str] = None,
) -> Tuple[Simulation, "SimResult"]:
    """Run one §5.2 test under seeded fault injection (PR 6).

    The same deployment + workload as :func:`run_benchmark`'s tAPP
    shared-distribution arm, but with a :class:`RetryPolicy` on the
    platform and a :class:`ChaosSpec` threaded into the simulator's
    event stream: workers crash (evicting their in-flight tickets) and
    recover mid-run, and affected requests re-route under the policy.
    ``chaos=None`` runs the schedule-free control — bit-identical to a
    pre-chaos simulation. ``federated=True`` drives the two-rack
    federation instead (partitions then sever real forwarding links).
    ``overload`` arms the PR 9 admission-queue / breaker / brownout
    layer (off by default — placements stay bit-identical without it);
    ``script`` overrides the default policy (e.g. ``OVERLOAD_SCRIPT``).
    """
    profiles = adhoc_profiles(False)
    config = SimConfig(seed=seed, gateway_zone=ZONE_EAST)
    if federated:
        platform = TappFederation(
            colocation_federation_spec(),
            distribution=DistributionPolicy.SHARED,
            seed=seed,
            policy=script if script is not None else COLOCATION_BLANK_SCRIPT,
            retry=retry,
            overload=overload,
        )
        network = colocation_network()
        config = SimConfig(seed=seed, gateway_zone=ZONE_RACK_A)
    else:
        platform = TappPlatform(
            benchmark_cluster(deployment_seed=seed),
            distribution=DistributionPolicy.SHARED,
            seed=seed,
            policy=script if script is not None else DATA_LOCALITY_SCRIPT,
            retry=retry,
            overload=overload,
        )
        network = benchmark_network()
    sim = Simulation(
        platform, network, profiles, config, is_tapp=True, chaos=chaos
    )
    result = sim.run([WORKLOADS[test]])
    return sim, result


def run_mqtt_case(
    *, use_tapp: bool, minutes: int = 30, seed: int = 0, cloud_first: bool = True
) -> Dict[str, "SimResult"]:
    """§5.1 qualitative case: one pipeline invocation per minute."""
    spec = mqtt_cluster(cloud_first=cloud_first)
    profiles = mqtt_profiles()
    network = mqtt_network()
    config = SimConfig(seed=seed, gateway_zone=ZONE_CLOUD)

    if use_tapp:
        platform = TappPlatform(
            spec, distribution=DistributionPolicy.SHARED, seed=seed,
            policy=MQTT_SCRIPT,
        )
        is_tapp = True
    else:
        platform = TappPlatform(spec, seed=seed)
        is_tapp = False

    # One platform across the three pipeline stages: scheduler cursors and
    # cluster state carry over, exactly like one live deployment would.
    results: Dict[str, "SimResult"] = {}
    for fn in ("data-collection", "feature-extraction", "feature-analysis"):
        sim = Simulation(platform, network, profiles, config, is_tapp=is_tapp)
        workload = [
            WorkloadSpec(function=fn, users=1, requests_per_user=minutes, pause=60.0)
        ]
        results[fn] = sim.run(workload)
    return results


def run_mqtt_federated_case(
    *, minutes: int = 30, seed: int = 0
) -> Tuple[TappFederation, Dict[str, "SimResult"]]:
    """§5.1 end-to-end through a federation with TWO entrypoints.

    The paper's pipeline, but with requests entering where they
    originate: ``data-collection`` is triggered from the *cloud*
    dashboard (entry = cloud) yet must run next to the edge-only broker —
    its ``topology_tolerance: none`` home — so every invocation is
    forwarded cloud→edge and never placed outside the edge;
    ``feature-extraction`` enters at the edge (data gravity);
    ``feature-analysis`` enters at the edge but its ``Cloud`` tag
    designates the cloud controller, a designated cross-zone hop. The
    returned federation's :meth:`~TappFederation.stats` expose the
    forwarding ledger; per-request hops land on the sim records
    (``forwarded`` / ``forward_rtt``).
    """
    federation = TappFederation(
        mqtt_federation_spec(),
        distribution=DistributionPolicy.SHARED,
        seed=seed,
        policy=MQTT_SCRIPT,
    )
    profiles = mqtt_profiles()
    network = mqtt_network()
    config = SimConfig(seed=seed, gateway_zone=ZONE_CLOUD)

    entries = {
        "data-collection": ZONE_CLOUD,      # dashboard-triggered
        "feature-extraction": ZONE_EDGE,    # data gravity
        "feature-analysis": ZONE_EDGE,      # edge-triggered, cloud-designated
    }
    results: Dict[str, "SimResult"] = {}
    for fn, entry in entries.items():
        sim = Simulation(federation, network, profiles, config, is_tapp=True)
        results[fn] = sim.run([
            WorkloadSpec(
                function=fn, users=1, requests_per_user=minutes,
                pause=60.0, entry_zone=entry,
            )
        ])
    return federation, results
