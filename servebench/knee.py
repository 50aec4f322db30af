"""Sweep the offered rate of an open-loop cell to find its knee, on the chip.

    python3 servebench/knee.py --workload <cell> --rates 10,20,30 --seconds 20 --seed <n>

Runs the cell once per rate in one process (each run builds its
deployment anew, as the benchmark does) and prints, per rate, the queue
of waiting requests at the window's start and end and the tails. The
knee is the highest rate at which the queue at the end of the window was
no longer than at its start (:func:`servebench.stats.knee`); the cell's
traffic file then takes 0.8 of it as its rate.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests per second")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from servebench import harness, stats

    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    points = []
    for rate in (float(r) for r in args.rates.split(",")):
        res = harness.run(cell, args.seed, args.seconds, False, device, time.perf_counter(),
                          rate=rate, log=lambda line: None)
        point = {"rate": rate, **res["_knee"], "attempted": res["attempted"],
                 "failed": res["failed"], "correct": res["correct"],
                 **{k: v["value"] for k, v in res["metrics"].items()}}
        points.append(point)
        print("[knee] " + json.dumps(point), flush=True)
    print("[knee] " + json.dumps({"workload": args.workload, "knee": stats.knee(points)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
