"""Seeded fault injection for failure-domain testing (PR 6).

A :class:`ChaosSpec` declares *how much* chaos (worker crashes, degraded
workers, flappy heartbeats, controller losses, inter-zone partitions)
over a time horizon; :class:`FaultInjector` expands it — with one
``random.Random(seed)`` stream, so the schedule is a pure function of
the spec — into a sorted list of :class:`FaultEvent` pairs
(crash/recover, sever/heal, …) and knows how to apply each one to a
platform façade. The injector drives two consumers:

* the discrete-event simulator threads the events into its heap as
  ``"fault"`` events (``Simulation(chaos=...)``), so faults interleave
  deterministically with request traffic;
* the chaos property tests (``tests/test_chaos.py``) replay schedules
  against a live platform and assert the ledger/robustness invariants
  after every step.

Chaos is strictly additive: with no spec (or an all-zero one) the
schedule is empty, no platform call is made, and placements, traces,
and RNG streams are bit-identical to a chaos-free run — property-tested
alongside the invariants.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

#: Event kinds, in the order pairs are emitted (each fault kind emits a
#: start event and, where applicable, its recovery twin).
KINDS = (
    "crash", "recover",          # worker DEAD → restored
    "degrade", "restore_perf",   # worker perf_factor inflated → nominal
    "flap_down", "flap_up",      # worker SUSPECT → restored (flappy lease)
    "controller_down", "controller_up",
    "sever", "heal",             # inter-zone partition (federations only)
    # Traffic-side fault (PR 9): arrival-rate multiplier against one zone
    # for a duration. The platform itself is untouched — the simulator
    # consumes the window to amplify offered load, exercising the
    # admission-queue / shedding / brownout overload path.
    "overload_burst", "burst_end",
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: apply ``kind`` to ``target`` at time ``at``.

    ``target`` is a worker name, a controller name, or — for
    ``sever``/``heal`` — a ``(zone_a, zone_b)`` pair. Paired events
    (crash/recover, …) share a target; ``until`` on the *start* event
    records when its twin fires (provenance only; the twin is a separate
    event in the schedule). ``value`` carries kind-specific payload
    (the degraded ``perf_factor``).
    """

    at: float
    kind: str
    target: object
    until: Optional[float] = None
    value: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """How much seeded chaos to inject over ``horizon`` seconds.

    Counts are *event pair* counts (each crash schedules its recovery
    too, unless the downtime would outlive the horizon — a fault may
    outlive the run, which is exactly the non-recovered-crash case the
    invariants must survive). All randomness comes from ``seed``; two
    specs with equal fields expand to identical schedules.
    """

    seed: int = 0
    horizon: float = 60.0
    worker_crashes: int = 0
    crash_downtime: float = 8.0
    degraded_events: int = 0
    degraded_duration: float = 6.0
    degraded_factor: float = 4.0
    flappy_workers: int = 0
    flap_period: float = 2.0
    controller_losses: int = 0
    controller_downtime: float = 5.0
    partitions: int = 0
    partition_duration: float = 10.0
    overload_bursts: int = 0
    burst_duration: float = 5.0
    burst_factor: float = 3.0

    def __post_init__(self) -> None:
        if self.horizon <= 0:
            raise ValueError("horizon must be > 0")
        for field in ("worker_crashes", "degraded_events", "flappy_workers",
                      "controller_losses", "partitions", "overload_bursts"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0")
        for field in ("crash_downtime", "degraded_duration", "flap_period",
                      "controller_downtime", "partition_duration",
                      "burst_duration"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be > 0")
        if self.degraded_factor < 1.0:
            raise ValueError("degraded_factor must be >= 1.0")
        if self.burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1.0")

    @property
    def total_faults(self) -> int:
        return (self.worker_crashes + self.degraded_events
                + self.flappy_workers + self.controller_losses
                + self.partitions + self.overload_bursts)


class FaultInjector:
    """Expands a :class:`ChaosSpec` into a deterministic fault schedule
    and applies events to a platform façade.

    ``workers`` / ``controllers`` / ``zones`` name the targets faults
    may pick from (pass the deployment's; zone pairs are only drawn when
    two or more zones exist). The schedule is computed once, eagerly, in
    :meth:`schedule` order; :meth:`apply` maps each event onto the
    platform's failure-detection API (``fail_worker`` / ``restore`` /
    ``suspect_worker`` / ``heartbeat`` / ``update_controller`` /
    ``sever`` / ``heal``), tolerating targets that disappeared since
    scheduling (a deregistered worker) by skipping the event — every
    skip is recorded in :attr:`skipped` with its reason, so a chaos run
    whose schedule silently stopped biting is visible after the fact.
    """

    def __init__(
        self,
        spec: ChaosSpec,
        workers: Sequence[str],
        controllers: Sequence[str] = (),
        zones: Sequence[str] = (),
    ) -> None:
        self.spec = spec
        self._workers = tuple(workers)
        self._controllers = tuple(controllers)
        self._zones = tuple(zones)
        self._schedule: Optional[Tuple[FaultEvent, ...]] = None
        #: Events that did not take effect at apply time, with reasons.
        self.skipped: List[Tuple[FaultEvent, str]] = []

    # -- schedule construction ---------------------------------------------------

    def schedule(self) -> Tuple[FaultEvent, ...]:
        """The full fault schedule, sorted by time (memoized; pure in the
        spec + target lists)."""
        if self._schedule is None:
            self._schedule = tuple(sorted(
                self._expand(), key=lambda e: (e.at, KINDS.index(e.kind),
                                               str(e.target))
            ))
        return self._schedule

    def _expand(self) -> List[FaultEvent]:
        spec = self.spec
        rng = random.Random(spec.seed)
        events: List[FaultEvent] = []

        def _paired(count, targets, start_kind, end_kind, duration,
                    value=None):
            for _ in range(count):
                if not targets:
                    return
                target = targets[rng.randrange(len(targets))]
                at = rng.uniform(0.0, spec.horizon)
                until = at + duration
                if until <= spec.horizon:
                    events.append(FaultEvent(at, start_kind, target,
                                             until=until, value=value))
                    events.append(FaultEvent(until, end_kind, target,
                                             value=value))
                else:
                    # The fault outlives the run — no recovery twin.
                    events.append(FaultEvent(at, start_kind, target,
                                             value=value))

        _paired(spec.worker_crashes, self._workers, "crash", "recover",
                spec.crash_downtime)
        _paired(spec.degraded_events, self._workers, "degrade",
                "restore_perf", spec.degraded_duration,
                value=spec.degraded_factor)
        _paired(spec.flappy_workers, self._workers, "flap_down", "flap_up",
                spec.flap_period)
        _paired(spec.controller_losses, self._controllers, "controller_down",
                "controller_up", spec.controller_downtime)
        if len(self._zones) >= 2:
            pairs = [
                (a, b)
                for i, a in enumerate(self._zones)
                for b in self._zones[i + 1:]
            ]
            _paired(spec.partitions, pairs, "sever", "heal",
                    spec.partition_duration)
        # Drawn last so a default (zero-burst) spec consumes exactly the
        # PR-6 stream — schedules stay bit-identical per seed.
        _paired(spec.overload_bursts, self._zones, "overload_burst",
                "burst_end", spec.burst_duration, value=spec.burst_factor)
        return events

    # -- application --------------------------------------------------------------

    def apply(self, event: FaultEvent, platform, *, now: float = 0.0) -> bool:
        """Apply one event to ``platform``; returns whether it took effect
        (False: the target no longer exists, or the façade lacks the
        capability — e.g. ``sever`` on a single-zone platform). A False
        return is never silent: the (event, reason) pair lands in
        :attr:`skipped`."""
        kind, target = event.kind, event.target
        try:
            if kind == "crash":
                platform.fail_worker(target)
            elif kind == "recover":
                platform.restore(target)
                # Restart the lease clock too, or the next check_leases
                # sweep would immediately re-kill the revived worker.
                platform.heartbeat_lease(target, now)
            elif kind == "degrade":
                platform.heartbeat(target, perf_factor=float(event.value))
            elif kind == "restore_perf":
                platform.heartbeat(target, perf_factor=1.0)
            elif kind == "flap_down":
                platform.suspect_worker(target)
            elif kind == "flap_up":
                platform.restore(target)
                platform.heartbeat_lease(target, now)
            elif kind == "controller_down":
                return self._set_controller(platform, event, False)
            elif kind == "controller_up":
                return self._set_controller(platform, event, True)
            elif kind in ("sever", "heal"):
                if not hasattr(platform, kind):
                    return self._skip(
                        event, "platform has no inter-zone links"
                    )
                getattr(platform, kind)(*target)
            elif kind in ("overload_burst", "burst_end"):
                # Traffic-side fault: nothing to do to the platform — the
                # simulator consumes the window to amplify arrivals. Still
                # validate the target so a burst against a zone the
                # deployment no longer has is reported, not ignored.
                zones = getattr(platform, "zones", None)
                if zones is not None and target not in zones:
                    return self._skip(event, f"unknown zone {target!r}")
            else:  # pragma: no cover - KINDS-validated at construction
                raise ValueError(f"unknown fault kind {kind!r}")
        except KeyError:
            return self._skip(event, "target deregistered since scheduling")
        return True

    def _skip(self, event: FaultEvent, reason: str) -> bool:
        self.skipped.append((event, reason))
        return False

    def _set_controller(self, platform, event: FaultEvent,
                        healthy: bool) -> bool:
        name = event.target
        controller = platform.watcher.cluster.controllers.get(name)
        if controller is None:
            return self._skip(event, f"unknown controller {name!r}")
        platform.watcher.update_controller(name, healthy=healthy,
                                           reachable=healthy)
        return True
