"""The program's own spans and counters (cfnerf_torch/utils/trace.py), the
one place where the benchmark reads them.

The program records them only while a torch profiler records.  A run
turns the profiler on for its traced window alone, one cell a process, so
the record holds that window.  A checkout of the program without them
gives nothing: every reading is None, and so is each metric that reads
one."""
from __future__ import annotations

from typing import Dict, Optional


def snapshot() -> Optional[Dict]:
    try:
        from cfnerf_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def _traced(run) -> Optional[Dict]:
    """The traced training window's record, else None."""
    if not run.train or run.traced is None:
        return None
    return snapshot()


def calls(run, name: str) -> Optional[int]:
    """Calls of the span `name` in the traced window; None where it never
    ran."""
    snap = _traced(run)
    s = None if snap is None else snap["spans"].get(name)
    return s["calls"] if s and s["calls"] else None


def total_ms(run, *names: str) -> Optional[float]:
    """The summed host ms of the spans `names` in the traced window; None
    where one of them never ran."""
    snap = _traced(run)
    if snap is None or any(calls(run, n) is None for n in names):
        return None
    return sum(snap["spans"][n]["total_ns"] for n in names) / 1e6


def mean_ms(run, name: str) -> Optional[float]:
    """The mean host ms of a call of the span `name` in the traced window."""
    n = calls(run, name)
    return None if n is None else total_ms(run, name) / n


def counter(run, name: str) -> Optional[int]:
    """The counter `name` over the traced window (0 where it never counted);
    None where the program has no record."""
    snap = _traced(run)
    return None if snap is None else snap["counters"].get(name, 0)
