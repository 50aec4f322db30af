"""One run of one cell: build the deployment, drive the window, read the metrics.

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration file and a traffic mix; its metrics are the files
``servebench/metrics/<name>.py`` that ``BENCHMARK.json`` lists for it.
The configuration file names its module with ``"reference"``: the file
``servebench/reference/<name>.py``, which supplies what depends on the
architecture (the weights' layout for :mod:`servebench.weights`, the
plain reference for :mod:`servebench.check`, the operation counts for
the model and kernel metrics; ``reference/lm.py`` says what each is).
Nothing here names a cell, a configuration, an architecture or a metric:
a later change adds files, and this module finds them by name.

The run builds the deployment as ``repro_torch.launch.serve.serve``
does (two zones of replicas behind the tAPP router, one controller per
zone, every replica on the one device), with seeded weights made here
(:mod:`servebench.weights`); warms up every prompt length the traffic
sends on every replica, then runs the mix un-timed for its warm-up;
then, for ``seconds``, submits each request when it is due
(``ServingEngine.submit``) and runs the engine's loop
(``ServingEngine.step_once``); then stops sending and lets the window's
requests finish, up to the mix's drain limit. A token is stamped when
the ``step_once`` that produced it returns (the engine syncs on every
token). Every admission is recorded with the loads the router decided it
on (:class:`Placements`). Then it frees the program's state and decides
``correct`` (:mod:`servebench.check`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from servebench import check, traffic, weights

#: Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    bench_dir: Path
    config: Dict
    traffic_name: str
    mix: Dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    reference: object               # the configuration's module, reference/<name>.py


def _load_module(path: Path, name: Optional[str] = None):
    """The Python file ``path`` as a new module. Under a ``name``, it is
    entered in ``sys.modules`` while it runs, as an import would, so that
    it can hand itself to :mod:`servebench.weights`."""
    spec = importlib.util.spec_from_file_location(name or f"servebench_metric_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    if name is not None:
        sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_reference(bench_dir: Path, config: Dict, config_file: str):
    """The module ``reference/<name>.py`` that the configuration's
    ``"reference"`` names, loaded by path from ``bench_dir``."""
    name = config.get("reference")
    if not name:
        raise SystemExit(f"{config_file} has no \"reference\" naming its module "
                         f"{bench_dir / 'reference'}/<name>.py")
    path = bench_dir / "reference" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"{config_file} names the reference {name!r}, but there is no {path}")
    return _load_module(path, f"servebench_reference_{name}")


def _metric(bench_dir: Path, entry: Dict) -> Metric:
    """The metric's reader, ``read`` of ``metrics/<name>.py``; its unit, layer
    and ``moves`` are ``BENCHMARK.json``'s."""
    module = _load_module(bench_dir / "metrics" / f"{entry['name']}.py")
    return Metric(entry["name"], entry["unit"], module.read)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench_dir = root / bench["paths"][0]
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    reference = load_reference(bench_dir, config, conf_entry["file"])
    mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, root=root, bench_dir=bench_dir, config=config,
        traffic_name=cell["traffic"], mix=mix, chips=cell["chips"],
        end_to_end=[_metric(bench_dir, m) for m in bench["end_to_end"] if applies(m)],
        per_layer=[_metric(bench_dir, m) for m in bench["per_layer"] if applies(m)],
        reference=reference,
    )


def forbidden_modules() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# The deployment
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Deployment:
    engine: object
    replicas: List[object]
    model_cfg: object
    vocab: int


def build(reference, config: Dict, seed: int, device: torch.device) -> Deployment:
    """The configuration's deployment on ``device``: weights from ``seed`` in
    the layout of its module ``reference``, kernels built or loaded from the
    checkout's ``build/``, the engine with its controllers and replicas (each
    replica captures its decode step)."""
    from repro_torch.core.scheduler.topology import DistributionPolicy
    from repro_torch.models import ModelConfig
    from repro_torch.runtime.serve_engine import Replica, ServingEngine

    model = config["model"]
    cfg = ModelConfig(**model)
    params = weights.make_params(reference, model, seed, device)
    if device.type == "cuda" and cfg.use_kernels:
        from repro_torch.kernels import _build, flash_attention, gmm, ssd_scan

        _build.build_all()
        flash_attention.build()
        gmm.build()
        ssd_scan.build()
    dep = config["deployment"]
    engine = ServingEngine(distribution=DistributionPolicy.parse(dep["distribution"]),
                           tapp_script=config["tapp_script"], seed=seed)
    for zone, ctl in dep["controllers"].items():
        engine.add_controller(ctl, zone=zone)
    replicas = []
    for zone in dep["zones"]:
        for i in range(dep["replicas_per_zone"]):
            rep = Replica(f"{zone}-{i}", cfg, params, zone=zone, sets=[zone],
                          slots=dep["slots"], max_len=dep["max_len"])
            engine.add_replica(rep)
            replicas.append(rep)
    return Deployment(engine, replicas, cfg, model["vocab_size"])


def warm_prefills(dep: Deployment, lengths, device) -> None:
    """Every prompt length on every replica, once, through the replica's own
    batch-1 prefill (on the card, its per-length CUDA graph is captured
    here, not in the window). No slot is touched."""
    for rep in dep.replicas:
        for s in lengths:
            rep._prefill_b1(torch.zeros((1, s), dtype=torch.int32, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def captures(dep: Deployment) -> int:
    return sum(len(getattr(rep._prefill_b1, "graphs", ())) for rep in dep.replicas)


class Placements:
    """Every admission of the run, with what the router saw when it placed it.

    Each replica's ``admit`` is wrapped (an instance attribute, in every
    run): an admission that took a slot records the request's tag, the
    replica's index, the controller of the decision, and the slots each
    replica had in use just before (``None`` for a dead one). The engine
    admits each placement before the router makes the next decision, so
    these are the loads the decision was made on."""

    def __init__(self, dep: "Deployment") -> None:
        self.items: List[tuple] = []       # (tag, replica index, controller, in use)
        reps = dep.replicas
        for k, rep in enumerate(reps):
            def admit(request, placement, k=k, inner=rep.admit):
                in_use = tuple(len(r.active) if r.alive else None for r in reps)
                ok = inner(request, placement)
                if ok:
                    self.items.append((request.tag, k, placement.decision.controller, in_use))
                return ok

            rep.admit = admit


# ---------------------------------------------------------------------------
# Spans (traced run only): set as instance attributes around the program's calls
# ---------------------------------------------------------------------------


class Spans:
    def __init__(self) -> None:
        self.items: List[tuple] = []        # (name, t0, t1, info)

    def wrap(self, owner, attr: str, name_of, info_of) -> None:
        inner = getattr(owner, attr)
        items = self.items
        record = torch.profiler.record_function

        def wrapped(*args, **kwargs):
            name, info = name_of(*args), info_of(*args)
            t0 = time.perf_counter()
            with record(name):
                out = inner(*args, **kwargs)
            items.append((name, t0, time.perf_counter(), info))
            return out

        setattr(owner, attr, wrapped)


def install_spans(dep: Deployment) -> Spans:
    spans = Spans()
    spans.wrap(dep.engine.platform, "invoke_batch", lambda inv, **k: "route",
               lambda inv, **k: len(inv))
    for rep in dep.replicas:
        def prefill_name(request, placement, rep=rep):
            graphs = getattr(rep._prefill_b1, "graphs", None)
            seen = graphs is None or len(request.tokens) in graphs
            return "prefill.replay" if seen else "prefill.first_sight"

        spans.wrap(rep, "admit", prefill_name, lambda request, placement: len(request.tokens))
        spans.wrap(rep, "step", lambda rep=rep: "decode_tick",
                   lambda rep=rep: [st.position for st in rep.active.values()])
    return spans


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


class LoadLoop:
    """Submits requests when due and runs ``step_once``, stamping tokens."""

    def __init__(self, dep: Deployment, model_id: str) -> None:
        self.dep, self.engine, self.model_id = dep, dep.engine, model_id
        self.records: List[Dict] = []
        self.inflight: List[Dict] = []
        self.lateness: List[float] = []
        self.max_active_over = 0
        self.on_done: Optional[Callable[[Dict, float], None]] = None
        self.hook: Callable[[], None] = lambda: None
        self.trace = False

    def submit(self, item: traffic.Item, due: float, now: float) -> Dict:
        req = self.engine.submit(self.model_id, item.tokens, tag=item.tag,
                                 max_new_tokens=item.max_new_tokens)
        rec = {"req": req, "due": due, "submitted": now, "stamps": [],
               "prompt_len": item.prompt_len, "max_new_tokens": item.max_new_tokens,
               "tag": item.tag, "failed": False}
        self.records.append(rec)
        self.inflight.append(rec)
        self.lateness.append(now - due)
        return rec

    def busy(self) -> bool:
        return bool(self.engine.queue) or any(r.active for r in self.dep.replicas)

    def step(self) -> float:
        span = (torch.profiler.record_function("step_once") if self.trace
                else contextlib.nullcontext())
        with span:
            self.engine.step_once()
        now = time.perf_counter()
        over = max(len(r.active) - r.slots for r in self.dep.replicas)
        self.max_active_over = max(self.max_active_over, over)
        still = []
        for rec in self.inflight:
            req = rec["req"]
            new = len(req.output) - len(rec["stamps"])
            if new > 0:
                rec["stamps"].extend([now] * new)
            if req.state == "done":
                if self.on_done is not None:
                    self.on_done(rec, now)
            else:
                still.append(rec)
        self.inflight = still
        self.hook()
        return now


def _wait_until(t: float) -> None:
    dt = t - time.perf_counter()
    if dt > 0.002:
        time.sleep(dt - 0.001)
    while time.perf_counter() < t:
        pass


def drive_open(load: LoadLoop, items: List[traffic.Item], t0: float, window: tuple,
               drain_s: float) -> None:
    """Open loop: each item submitted at ``t0 + arrival`` (its due time)
    until the window closes; then the window's requests drained."""
    ws, we = window
    i, n = 0, len(items)
    while True:
        load.hook()
        now = time.perf_counter()
        if now >= we:
            break
        while i < n and t0 + items[i].arrival_s <= now:
            load.submit(items[i], t0 + items[i].arrival_s, now)
            i += 1
        if load.busy():
            load.step()
        else:
            nxt = t0 + items[i].arrival_s if i < n else we
            _wait_until(min(nxt, we, ws if now < ws else we))
    _drain(load, ws, we, drain_s)


def drive_closed(load: LoadLoop, items: List[traffic.Item], callers: int, t0: float,
                 window: tuple, drain_s: float) -> None:
    """Closed loop: ``callers`` callers, each invoking again (the next item)
    when its reply comes, until the window closes; then the rest drained."""
    ws, we = window
    queue = itertools.cycle(items)

    def issue(now: float) -> None:
        if now < we:
            load.submit(next(queue), now, now)

    load.on_done = lambda rec, now: issue(now)
    for _ in range(callers):
        issue(t0)
    while time.perf_counter() < we:
        load.step()
    load.hook()
    load.on_done = None
    _drain(load, ws, we, drain_s)


def _drain(load: LoadLoop, ws: float, we: float, drain_s: float) -> None:
    # From now, not from the window's close: a traced run's profiler stops and
    # is read between the two.
    limit = time.perf_counter() + drain_s
    pending = [r for r in load.records if ws <= r["due"] < we]
    while any(r["req"].state != "done" for r in pending) and time.perf_counter() < limit:
        if load.busy():
            load.step()
        else:
            break
    for r in pending:
        if r["req"].state != "done":
            r["failed"] = True


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cfg: Dict
    reference: object               # the configuration's module (its operation counts)
    records: List[Dict]             # the window's requests (due in it)
    all_records: List[Dict]
    window: tuple                   # (start, end), perf_counter seconds
    seconds: float
    setup_s: float
    tick_times: List[float] = dataclasses.field(default_factory=list)
    prefill_times: List[tuple] = dataclasses.field(default_factory=list)
    prefill_captures: int = 0
    spans: List[tuple] = dataclasses.field(default_factory=list)
    device: Optional[object] = None  # servebench.devtrace.Slice in a traced run


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, rate: Optional[float] = None, fault: Optional[Callable] = None,
        log=print) -> Dict:
    """One run; returns the result line's object (``correct`` and the rest)."""
    from servebench import devtrace

    mix, config = cell.mix, cell.config
    dep = build(cell.reference, config, seed, device)
    if fault is not None:
        fault(dep)
    placements = Placements(dep)
    warmup_s, drain_s = mix["warmup_s"], mix["drain_s"]
    horizon = warmup_s + seconds
    if mix["loop"] == "open":
        items = traffic.open_loop(mix, seed, horizon, dep.vocab, rate)
    else:
        items = traffic.closed_loop(mix, seed, mix["invocations"], dep.vocab)
    lengths = sorted({it.prompt_len for it in items})
    warm_prefills(dep, lengths, device)
    captured_before = captures(dep)

    profiled = trace and device.type == "cuda"    # a device trace needs the card
    if profiled:
        devtrace.Slicer.warm()
    load = LoadLoop(dep, dep.model_cfg.name)
    t0 = time.perf_counter()
    ws = t0 + warmup_s
    we = ws + seconds
    marks: Dict = {}
    prof_slice = devtrace.Slicer(mix["trace_slice_s"], ws, we) if profiled else None

    def at_window_start():
        marks["ticks"] = [len(r.tick_times) for r in dep.replicas]
        marks["prefills"] = [len(r.prefill_times) for r in dep.replicas]
        marks["captures"] = captures(dep)
        marks["queue_start"] = len(dep.engine.queue)
        marks["setup_s"] = time.perf_counter() - t_start
        if trace:
            marks["spans"] = install_spans(dep)
            load.trace = True

    def hook():
        now = time.perf_counter()
        if "ticks" not in marks and now >= ws:
            at_window_start()
        if "end" not in marks and now >= we:
            marks["end"] = ([len(r.tick_times) for r in dep.replicas],
                            [len(r.prefill_times) for r in dep.replicas], captures(dep))
            marks["queue_end"] = len(dep.engine.queue)
        if prof_slice is not None:
            prof_slice.tick(now)

    load.hook = hook
    if mix["loop"] == "open":
        drive_open(load, items, t0, (ws, we), drain_s)
    else:
        drive_closed(load, items, mix["callers"], t0, (ws, we), drain_s)
    if "ticks" not in marks:
        at_window_start()
    if "end" not in marks:
        hook()
    if prof_slice is not None:
        prof_slice.close()

    window = [r for r in load.records if ws <= r["due"] < we]
    tick_times, prefill_times = [], []
    for k, rep in enumerate(dep.replicas):
        tick_times += rep.tick_times[marks["ticks"][k]:marks["end"][0][k]]
        prefill_times += rep.prefill_times[marks["prefills"][k]:marks["end"][1][k]]
    spans = marks["spans"].items if trace else []
    ctx = Context(
        cfg=config["model"], reference=cell.reference, records=window,
        all_records=load.records, window=(ws, we), seconds=seconds,
        setup_s=marks["setup_s"], tick_times=tick_times,
        prefill_times=prefill_times, prefill_captures=marks["end"][2] - marks["captures"],
        spans=[s for s in spans if ws <= s[1] < we],
        device=prof_slice.result(spans) if prof_slice is not None else None,
    )
    late = sorted(load.lateness)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log("[run] " + json.dumps({
        "cell": cell.name, "seed": seed, "window_requests": len(window),
        "requests_sent": len(load.records),
        "generator_lateness_ms": {"p50": 1e3 * late[len(late) // 2] if late else 0.0,
                                  "max": 1e3 * late[-1] if late else 0.0},
        "prefill_lengths_warmed": len(lengths),
        "prefill_graphs_captured": captured_before,
        "prefill_graphs_captured_in_window": ctx.prefill_captures,
        "memory_peak_bytes": peak,
        "queue_at_close": len(dep.engine.queue),
        "placements_judged": len(placements.items),
    }))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": None if value == float("inf") else value,
                               "unit": m.unit}

    sample = check.sample(window, seed, mix["check_requests"])
    engine_checks = check.engine_checks(window, dep, load.max_active_over)
    engine_checks.update(check.placement_checks(placements.items, dep.replicas,
                                                config["placement"]))
    gpu_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": gpu_name,
                "count": 1, "memory_peak_bytes": peak}
    if ctx.device is not None:
        dev_info["busy_s"] = ctx.device.busy_s
        dev_info["window_s"] = ctx.device.window_s
    breakdown = ctx.device.breakdown() if ctx.device is not None else None
    knee_point = {"queue_start": marks["queue_start"], "queue_end": marks["queue_end"]}

    # Free the program's state before the reference runs.
    del dep, load, ctx, spans, marks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.reference_checks(cell.reference, config, config["check"], seed, sample,
                                    device)
    checks.update(engine_checks)
    result = {
        "correct": all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()),
        "attempted": len(window),
        "failed": sum(1 for r in window if r["failed"]),
        "metrics": metrics,
        "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_knee"] = knee_point
    result["_sample"] = sample
    return result
