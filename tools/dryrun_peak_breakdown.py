#!/usr/bin/env python3
"""What a dry-run cell's per-device peak is made of.

    PYTHONPATH=src python3 tools/dryrun_peak_breakdown.py ARCH SHAPE MESH

Traces one cell as ``python -m repro_torch.launch.dryrun`` does (fake
tensors, a fake process group; no device) and prints, at the moment of
the per-device peak, the live local storages summed by the op that
created them ("input": the step's state, batch and caches), largest
first.
"""
import collections
import sys


def main(arch: str, shape: str, mesh: str) -> None:
    from repro_torch.launch import dryrun
    from repro_torch.roofline import trace

    created_by = {}
    at_peak = {"bytes": 0, "by_op": collections.Counter()}
    current = {"op": "input"}
    add_storage = trace.TraceCounter._add_storage
    count = trace.TraceCounter._count

    def _add_storage(self, st):
        created_by.setdefault(id(st), (current["op"], st.nbytes()))
        add_storage(self, st)

    def _count(self, func, args, kwargs, flat_in, flat_out):
        current["op"] = str(func)
        count(self, func, args, kwargs, flat_in, flat_out)
        if self._live > at_peak["bytes"]:
            at_peak["bytes"] = self._live
            at_peak["by_op"] = collections.Counter()
            for key in self._refs:
                op, n = created_by[key]
                at_peak["by_op"][op] += n

    trace.TraceCounter._add_storage = _add_storage
    trace.TraceCounter._count = _count
    record = dryrun.dryrun_cell(arch, shape, mesh, save=False)
    if record["status"] != "ok":
        raise SystemExit(record["error"])
    print(f"peak {at_peak['bytes'] / 2**30:.3f} GiB a device, by creating op:")
    for op, n in at_peak["by_op"].most_common(10):
        print(f"  {n / 2**30:9.3f} GiB  {op}")


if __name__ == "__main__":
    main(*sys.argv[1:4])
