"""trunk_host_ms.*: the host ms a serving tile of the traced window spends
in the program's spans cfnerf.trunk.pack (the trunk's weights packed for
the kernels) and cfnerf.trunk.launch (the kernel wrapper's host work: its
checks, the bf16 weights, the outputs, the tensor maps and the enqueue).
None in a training cell, and where the program has no such spans."""
from benchmark import program_trace

SPANS = ("cfnerf.trunk.pack", "cfnerf.trunk.launch")


def read(run):
    if run.train or run.traced is None or not run.traced.units:
        return None
    snap = program_trace.snapshot()
    spans = [None if snap is None else snap["spans"].get(name) for name in SPANS]
    if any(not s or not s["calls"] for s in spans):
        return None
    tiles = run.traced.units * run.tiles_per_view
    return sum(s["total_ns"] for s in spans) / 1e6 / tiles
