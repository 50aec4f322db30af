#!/usr/bin/env python3
"""What a dry-run cell's per-device peak is made of.

    PYTHONPATH=src python3 tools/dryrun_peak_breakdown.py ARCH SHAPE MESH

Traces one cell as ``python -m repro_torch.launch.dryrun`` does (fake
tensors, a fake process group; no device) and prints, at the moment of
the per-device peak, the live local storages summed by the op that
created them ("input": the step's state, batch and caches), largest
first; then the same storages grouped by creating op and the local shape
of the tensor each was made for, with their count.
"""
import collections
import sys


def main(arch: str, shape: str, mesh: str) -> None:
    from repro_torch.launch import dryrun
    from repro_torch.roofline import trace

    created_by = {}
    at_peak = {"bytes": 0, "by_op": collections.Counter(), "by_shape": collections.Counter(),
               "count": collections.Counter()}
    current = {"op": "input", "outs": []}
    add_storage = trace.TraceCounter._add_storage
    count = trace.TraceCounter._count

    def _add_storage(self, st):
        key = id(st)
        if key not in self._refs:  # a new storage (a freed one's id may be reused)
            shape = next((tuple(o.shape) for o in current["outs"]
                          if id(o.untyped_storage()) == key), None)
            created_by[key] = (current["op"], st.nbytes(), shape)
        add_storage(self, st)

    def _count(self, func, args, kwargs, flat_in, flat_out):
        current["op"] = str(func)
        current["outs"] = flat_out
        count(self, func, args, kwargs, flat_in, flat_out)
        current["outs"] = []
        if self._live > at_peak["bytes"]:
            at_peak["bytes"] = self._live
            for name in ("by_op", "by_shape", "count"):
                at_peak[name] = collections.Counter()
            for key in self._refs:
                op, n, shape = created_by[key]
                at_peak["by_op"][op] += n
                at_peak["by_shape"][(op, shape)] += n
                at_peak["count"][(op, shape)] += 1

    trace.TraceCounter._add_storage = _add_storage
    trace.TraceCounter._count = _count
    record = dryrun.dryrun_cell(arch, shape, mesh, save=False)
    if record["status"] != "ok":
        raise SystemExit(record["error"])
    print(f"peak {at_peak['bytes'] / 2**30:.3f} GiB a device, by creating op:")
    for op, n in at_peak["by_op"].most_common(10):
        print(f"  {n / 2**30:9.3f} GiB  {op}")
    print("by creating op and local shape (count):")
    for (op, shape), n in at_peak["by_shape"].most_common(10):
        print(f"  {n / 2**30:9.3f} GiB  {op}  {shape} x{at_peak['count'][(op, shape)]}")


if __name__ == "__main__":
    main(*sys.argv[1:4])
