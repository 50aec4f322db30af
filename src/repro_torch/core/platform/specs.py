"""Declarative cluster construction for the platform façade.

A :class:`ClusterSpec` is the serialisable description of a deployment —
workers with their zones/sets/capacities and the per-zone controllers —
that :class:`~repro_torch.core.platform.TappPlatform` turns into live state.
It replaces the ad-hoc ``make_cluster`` + field-mutation pattern: specs
are frozen values, so a deployment can be permuted (the paper's
redeploy-every-N-repetitions methodology), diffed, or embedded in a
scenario table, and the *live* mutable state only ever exists behind the
watcher.

A :class:`FederationSpec` is the multi-zone sibling (PR 5): an ordered
mapping of zone name → :class:`ClusterSpec` slice plus an inter-zone
network model, which
:class:`~repro_torch.core.platform.federation.TappFederation` turns into one
shared cluster with a per-zone gateway per slice. The network model is
duck-typed — anything with ``get_rtt(a, b)`` works, notably the
simulator's ``NetworkModel`` — so the platform layer never imports the
simulator.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Mapping, Optional, Tuple, Union

from repro_torch.core.scheduler.state import (
    ClusterState,
    ControllerState,
    WorkerState,
)

_DEFAULT_MEMORY = 16 * 1024**3


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Deterministic retry/backoff policy for worker-failure re-routing.

    ``max_attempts`` bounds total attempts (first try included); backoff
    before retry *k* (1-based) is ``backoff_base * backoff_multiplier**(k-1)``
    — deterministic, no jitter, so seeded runs reproduce bit-for-bit.
    ``deadline`` caps the cumulative backoff a request may accumulate
    (a per-function latency budget); a retry whose backoff would exceed
    it is not issued. Retries apply to *worker* failures (crash, timeout,
    no valid worker); a tAPP ``followup: fail`` policy failure is
    terminal and never retried (paper §3.3 semantics).
    """

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_multiplier: float = 2.0
    deadline: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base < 0:
            raise ValueError("backoff_base must be >= 0")
        if self.backoff_multiplier <= 0:
            raise ValueError("backoff_multiplier must be > 0")
        if self.deadline is not None and self.deadline < 0:
            raise ValueError("deadline must be >= 0")

    def backoff(self, attempts_made: int) -> float:
        """Wait (seconds) before the retry following ``attempts_made``
        attempts (>= 1)."""
        return self.backoff_base * self.backoff_multiplier ** (attempts_made - 1)

    def allows(self, attempts_made: int, waited: float = 0.0) -> bool:
        """May another attempt be issued after ``attempts_made`` tries and
        ``waited`` seconds of cumulative backoff?"""
        if attempts_made >= self.max_attempts:
            return False
        if self.deadline is not None:
            return waited + self.backoff(attempts_made) <= self.deadline
        return True


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Declarative description of one worker (model replica / invoker).

    ``keep_alive`` overrides the platform's
    :class:`~repro_torch.core.platform.lifecycle.LifecycleSpec` keep-alive
    window for instances pooled on this worker (None: inherit; inert
    when the lifecycle layer is unarmed).
    """

    name: str
    zone: str = "default"
    sets: Tuple[str, ...] = ()
    capacity_slots: int = 16
    resident_models: Tuple[str, ...] = ()
    memory_bytes: int = _DEFAULT_MEMORY
    perf_factor: float = 1.0
    keep_alive: Optional[float] = None

    def __post_init__(self) -> None:
        if self.keep_alive is not None and self.keep_alive <= 0:
            raise ValueError(
                f"keep_alive must be positive, got {self.keep_alive}"
            )

    def build(self) -> WorkerState:
        return WorkerState(
            name=self.name,
            zone=self.zone,
            sets=frozenset(self.sets),
            capacity_slots=self.capacity_slots,
            resident_models=frozenset(self.resident_models),
            memory_bytes=self.memory_bytes,
            perf_factor=self.perf_factor,
            keep_alive=self.keep_alive,
        )

    @classmethod
    def coerce(
        cls, value: Union["WorkerSpec", WorkerState, Mapping]
    ) -> "WorkerSpec":
        if isinstance(value, cls):
            return value
        if isinstance(value, WorkerState):
            return cls(
                name=value.name,
                zone=value.zone,
                sets=tuple(sorted(value.sets)),
                capacity_slots=value.capacity_slots,
                resident_models=tuple(sorted(value.resident_models)),
                memory_bytes=value.memory_bytes,
                perf_factor=value.perf_factor,
                keep_alive=value.keep_alive,
            )
        fields = dict(value)
        for key in ("sets", "resident_models"):
            if key in fields:
                fields[key] = tuple(fields[key])
        return cls(**fields)


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Declarative description of one per-zone controller.

    ``retry`` is the :class:`RetryPolicy` for invocations this controller
    schedules (None: the platform-level default, if any). It is platform
    configuration, not live state — :class:`ControllerState` does not
    carry it; the platform façade resolves it per placement.
    ``keep_alive`` likewise overrides the platform lifecycle's
    keep-alive window for instances completed under this controller
    (resolution: worker > controller > spec default; inert unarmed).
    """

    name: str
    zone: str = "default"
    retry: Optional[RetryPolicy] = None
    keep_alive: Optional[float] = None

    def __post_init__(self) -> None:
        if self.keep_alive is not None and self.keep_alive <= 0:
            raise ValueError(
                f"keep_alive must be positive, got {self.keep_alive}"
            )

    def build(self) -> ControllerState:
        return ControllerState(name=self.name, zone=self.zone)

    @classmethod
    def coerce(
        cls, value: Union["ControllerSpec", ControllerState, Mapping]
    ) -> "ControllerSpec":
        if isinstance(value, cls):
            return value
        if isinstance(value, ControllerState):
            return cls(name=value.name, zone=value.zone)
        fields = dict(value)
        if isinstance(fields.get("retry"), Mapping):
            fields["retry"] = RetryPolicy(**fields["retry"])
        return cls(**fields)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A whole deployment: controllers + workers, in registration order.

    Registration order matters to the vanilla baseline (its co-prime home
    depends on it), which is why :meth:`shuffled` exists: one seed = one
    deployment permutation, reproducing the paper's methodology of
    redeploying the platform between repetitions.
    """

    workers: Tuple[WorkerSpec, ...] = ()
    controllers: Tuple[ControllerSpec, ...] = ()

    @classmethod
    def of(
        cls,
        workers: Iterable[Union[WorkerSpec, WorkerState, Mapping]] = (),
        controllers: Iterable[Union[ControllerSpec, ControllerState, Mapping]] = (),
    ) -> "ClusterSpec":
        """Coerce plain dicts / live states into a spec (config-file path)."""
        return cls(
            workers=tuple(WorkerSpec.coerce(w) for w in workers),
            controllers=tuple(ControllerSpec.coerce(c) for c in controllers),
        )

    def shuffled(self, seed: int) -> "ClusterSpec":
        """The same deployment with worker registration order permuted."""
        workers = list(self.workers)
        random.Random(seed).shuffle(workers)
        return dataclasses.replace(self, workers=tuple(workers))

    def build(self) -> ClusterState:
        """Materialise live cluster state (duplicate names raise here)."""
        cluster = ClusterState()
        for controller in self.controllers:
            cluster.add_controller(controller.build())
        for worker in self.workers:
            cluster.add_worker(worker.build())
        return cluster


def _coerce_zone_slice(zone: str, spec) -> ClusterSpec:
    """Coerce one zone's slice, pinning every member to the zone.

    Members declared with the default zone are adopted into the
    federation zone; an explicit *different* zone is a contradiction and
    raises — a slice cannot smuggle workers into another zone.
    """
    if not isinstance(spec, ClusterSpec):
        spec = ClusterSpec.of(**dict(spec))

    def _pin(member):
        if member.zone in ("default", zone):
            return dataclasses.replace(member, zone=zone)
        raise ValueError(
            f"zone slice {zone!r} declares {member.name!r} with "
            f"contradictory zone {member.zone!r}"
        )

    return ClusterSpec(
        workers=tuple(_pin(w) for w in spec.workers),
        controllers=tuple(_pin(c) for c in spec.controllers),
    )


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    """A multi-zone deployment: ordered zone → :class:`ClusterSpec` slices.

    ``network`` is any object exposing ``get_rtt(zone_a, zone_b) ->
    seconds`` (e.g. the simulator's ``NetworkModel``); it prices the
    cross-zone forwarding hops and orders forward targets latency-first.
    Without one, hops are free and forwarding follows declaration order.
    ``default_entry`` names the zone ``invoke`` enters when the caller
    does not say (defaults to the first declared zone).
    """

    zones: Tuple[Tuple[str, ClusterSpec], ...] = ()
    network: Optional[object] = None
    default_entry: Optional[str] = None

    def __post_init__(self) -> None:
        pairs = tuple((name, _coerce_zone_slice(name, spec))
                      for name, spec in self.zones)
        names = [name for name, _ in pairs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate federation zone in {names}")
        object.__setattr__(self, "zones", pairs)
        if self.default_entry is not None and self.default_entry not in names:
            raise ValueError(
                f"default_entry {self.default_entry!r} is not a federation "
                f"zone (have {names})"
            )
        if self.network is not None and not hasattr(self.network, "get_rtt"):
            raise TypeError(
                "network must expose get_rtt(zone_a, zone_b) (e.g. "
                "repro_torch.core.sim.NetworkModel)"
            )

    @classmethod
    def of(
        cls,
        zones: Mapping[str, Union[ClusterSpec, Mapping]],
        *,
        network: Optional[object] = None,
        default_entry: Optional[str] = None,
    ) -> "FederationSpec":
        """Build from a zone-name mapping (insertion order = zone order)."""
        return cls(
            zones=tuple(zones.items()),
            network=network,
            default_entry=default_entry,
        )

    @property
    def zone_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.zones)

    @property
    def entry_zone(self) -> str:
        """The zone ``invoke`` enters when the caller does not specify."""
        if not self.zones:
            raise ValueError("federation spec declares no zones")
        return self.default_entry or self.zones[0][0]

    def get(self, zone: str) -> ClusterSpec:
        for name, spec in self.zones:
            if name == zone:
                return spec
        raise KeyError(zone)

    def merged(self) -> ClusterSpec:
        """The whole federation as one flat deployment, in zone order."""
        return ClusterSpec(
            workers=tuple(w for _, s in self.zones for w in s.workers),
            controllers=tuple(c for _, s in self.zones for c in s.controllers),
        )

    def build(self) -> ClusterState:
        """Materialise the shared live cluster state of all zones."""
        return self.merged().build()

    def shuffled(self, seed: int) -> "FederationSpec":
        """Permute worker registration order *within* each zone slice.

        Zone membership is structural here, so the paper's
        redeploy-permutation methodology applies per slice; one seed
        permutes every slice deterministically.
        """
        rng = random.Random(seed)
        shuffled = []
        for name, spec in self.zones:
            workers = list(spec.workers)
            rng.shuffle(workers)
            shuffled.append(
                (name, dataclasses.replace(spec, workers=tuple(workers)))
            )
        return dataclasses.replace(self, zones=tuple(shuffled))

    def rtt(self, zone_a: str, zone_b: str) -> float:
        """Inter-zone RTT in seconds (0.0 without a network model)."""
        if self.network is None:
            return 0.0
        return float(self.network.get_rtt(zone_a, zone_b))

    def zone_order_from(self, entry: str) -> Tuple[str, ...]:
        """Every *other* zone, nearest-first from ``entry``.

        Ties (and the no-network case) fall back to declaration order —
        the latency-aware forwarding order of this entrypoint.
        """
        others = [
            (self.rtt(entry, name), index, name)
            for index, name in enumerate(self.zone_names)
            if name != entry
        ]
        others.sort()
        return tuple(name for _, _, name in others)
