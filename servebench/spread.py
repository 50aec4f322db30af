"""Spreads of a cell's runs, and the bound each end-to-end metric would take.

    python3 servebench/spread.py DIR

reads the result lines saved as ``DIR/<cell>.<set>.<seed>.json`` (the
last line of a run's standard output) and prints, per cell and metric,
each set's median and spread (first to third quartile as a share of the
median, ``statistics.quantiles(n=4)``), the widest spread of the two
sets, and five times it (never under 1%): the bound it would support.
"""
from __future__ import annotations

import collections
import json
import statistics
import sys
from pathlib import Path


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else 0.0


def main(argv=None) -> int:
    root = Path((argv or sys.argv[1:])[0])
    runs = collections.defaultdict(lambda: collections.defaultdict(list))
    correct = collections.Counter()
    for path in sorted(root.glob("*.json")):
        cell, set_name, seed = path.name[:-5].rsplit(".", 2)
        lines = path.read_text().strip().splitlines()
        if not lines:
            print(f"{path.name}: no result line")
            continue
        res = json.loads(lines[-1])
        correct[(cell, res["correct"])] += 1
        for name, m in res["metrics"].items():
            runs[(cell, name)][set_name].append(m["value"])
    for (cell, name), sets in sorted(runs.items()):
        parts, widest = [], 0.0
        for set_name, values in sorted(sets.items()):
            if len(values) >= 3:
                s = spread(values)
                widest = max(widest, s)
                parts.append(f"{set_name}: n={len(values)} median={statistics.median(values):.6g} "
                             f"spread={s:.4f}")
        print(f"{cell} {name}: " + "; ".join(parts)
              + f"; widest={widest:.4f} bound(5x)={max(0.01, 5 * widest):.4f}")
    for (cell, ok), n in sorted(correct.items()):
        print(f"{cell}: correct={ok} in {n} runs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
