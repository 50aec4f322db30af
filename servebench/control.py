"""Readings that set the limit of ``correct``: the program's and the control's.

    python3 servebench/control.py --workload <cell> --seeds 1,2,3 --seconds 10 [--dtype float32]

For each seed, one run of the cell (a short window at the cell's own
load, its sample drawn as a benchmark run draws it), then, on the same
prompts and served tokens, the control: the configuration's reference
(its module, ``servebench/reference/<name>.py``) in float8 (e4m3),
whose first token at each position is read against the float32
reference. Prints, per seed, each number a check may compare (the
widest and the mean gap) of the program's served tokens and of the
control's first tokens, with the spread of the gaps beneath (the share
of positions whose token is not the reference's first, percentiles, the
shares over fixed gaps). A limit lies between the largest program
reading and the smallest control reading. ``--dtype``
runs the program in another compute dtype (a witness: in float32 the
program's gap is rounding alone). The benchmark's own runs never run
the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gap_stats(gaps):
    """The numbers a check may compare, and the spread of the gaps beneath."""
    from servebench import check

    out = {name: fn(gaps) for name, fn in check.NUMBERS.items()}
    out.update({"p50": float(gaps.quantile(0.5)), "p99": float(gaps.quantile(0.99)),
                "mismatch": float((gaps > 0).double().mean()), "n": int(gaps.numel())})
    for t in (0.25, 0.5, 1.0):
        out[f"over_{t}"] = float((gaps > t).double().mean())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--dtype", default=None, help="the program's compute dtype, if not the cell's")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from servebench import check, harness

    cell = harness.load_cell(ROOT, args.workload)
    if args.dtype:
        cell.config["model"]["compute_dtype"] = args.dtype
    device = torch.device("cuda", 0)
    program, control = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(cell, seed, args.seconds, False, device, time.perf_counter(),
                          log=lambda line: None)
        prog, ctl = check.control_gaps(cell.reference, cell.config, seed, res["_sample"],
                                       device)
        prog, ctl = gap_stats(prog), gap_stats(ctl)
        program.append(prog)
        control.append(ctl)
        print("[control] " + json.dumps({
            "seed": seed, "dtype": cell.config["model"]["compute_dtype"],
            "checks": res["checks"], "program": prog, "control": ctl,
            "attempted": res["attempted"], "failed": res["failed"]}), flush=True)
    for name in check.NUMBERS:
        print("[control] " + json.dumps({
            "workload": args.workload, "number": name,
            "lower": max(p[name] for p in program), "upper": min(c[name] for c in control)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
