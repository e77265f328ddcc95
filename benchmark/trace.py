"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer metrics read.

The grouping of device work is `chip_smoke.py:profile_device`'s, copied:
only kernels, memcpys and memsets count (a user annotation on the device's
timeline spans the kernels it annotates and is left out); the busy time is
the union of their intervals; kernels are grouped by name (the port's six
kernels by their entry names, cuBLAS's and CUTLASS's GEMMs as "matmul",
copies and sets as "copy", the rest "other").

The benchmark's own spans (`span`) mark its calls into the program: the
whole window ("bench.window"), a prefetcher wait ("bench.batch_wait"), a
training step or a served view ("bench.step", "bench.view").  Each idle gap
of the device inside the window is put down to what the host was doing at
its middle: the benchmark's span and, inside it, the outermost operation of
the program on the main thread ("python" where the host ran the program's
Python between operations).
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PORT_KERNELS = ("render_core_bwd", "render_core_fwd", "flow_stack_bwd", "flow_stack_fwd",
                "trunk_fwd", "trunk_bwd")
WINDOW = "bench.window"


def group(name: str, kind: str = "kernel") -> str:
    low = name.lower()
    if kind != "kernel":
        return "copy"
    for kernel in PORT_KERNELS:
        if kernel in low:
            return kernel
    # cuBLAS's Hopper GEMMs are named nvjet_*
    if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90", "nvjet")):
        return "matmul"
    return "other"


class Tracer:
    """A profiler over the window when `on`, else nothing; `span(name)`
    marks a region of the benchmark's own on the profiler's timeline."""

    def __init__(self, on: bool):
        self.on, self.prof = on, None

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities, acc_events=True) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
            if cuda:
                torch.cuda.synchronize()
        self.prof = prof

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def reduce(self) -> Optional[Dict]:
        return None if self.prof is None else reduce_events(self.prof.profiler.kineto_results.events())


def _kind(evt) -> str:
    """A device event's kind: "kernel", "copy" (a memcpy or memset) or
    "annotation" (a range that spans the kernels it annotates)."""
    if getattr(evt, "is_user_annotation", lambda: False)():
        return "annotation"
    name = evt.name()
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def _is_device(evt) -> bool:
    return evt.device_type() == torch.autograd.DeviceType.CUDA


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def _outermost(events) -> Tuple[List[int], List[int], List[str]]:
    """The outermost of possibly nested host events, as sorted, disjoint
    (starts, ends, names)."""
    starts, ends, names, reach = [], [], [], -1
    for start, end, name in sorted(events, key=lambda e: (e[0], -e[1])):
        if start >= reach:
            starts.append(start)
            ends.append(end)
            names.append(name)
            reach = end
    return starts, ends, names


def _at(t: int, index) -> Optional[str]:
    starts, ends, names = index
    i = bisect.bisect_right(starts, t) - 1
    return names[i] if i >= 0 and t < ends[i] else None


def reduce_events(events) -> Optional[Dict]:
    """Kernels by name and group, the busy and window seconds, and the idle
    gaps by host activity, from the profiler's raw events (times in ns)."""
    window = [e for e in events if not _is_device(e) and e.name() == WINDOW]
    if not window:
        return None
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    main = window[0].start_thread_id()
    by_name: Dict[str, List[float]] = {}
    spans, bench, host = [], [], []
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if _is_device(e):
            kind = _kind(e)
            if kind == "annotation" or end <= w0 or start >= w1:
                continue
            start, end = max(start, w0), min(end, w1)
            spans.append((start, end))
            key = (e.name(), kind)
            entry = by_name.setdefault(key, [0, 0.0])
            entry[0] += 1
            entry[1] += (end - start) / 1e9
        elif e.start_thread_id() == main and w0 <= start < w1:
            if e.name().startswith("bench.") and e.name() != WINDOW:
                bench.append((start, end, e.name()[len("bench."):]))
            elif not e.name().startswith("bench."):
                host.append((start, end, e.name()))
    if not spans:
        return None
    busy = _merge(spans)
    busy_ns = sum(b - a for a, b in busy)
    bench_index, host_index = _outermost(bench), _outermost(host)
    gaps: Dict[str, float] = {}
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        where = _at(mid, bench_index) or "between"
        what = _at(mid, host_index) or "python"  # between the program's ops
        label = f"{where}/{what}"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    kernels = {name: (int(n), s) for (name, _), (n, s) in by_name.items()}
    groups: Dict[str, float] = {}
    for (name, kind), (_, s) in by_name.items():
        g = group(name, kind)
        groups[g] = groups.get(g, 0.0) + s
    return dict(kernels=kernels, groups=groups, busy_s=busy_ns / 1e9,
                window_s=(w1 - w0) / 1e9, gaps=gaps)


def breakdown(summary: Dict) -> Dict[str, list]:
    """The ten device operations that took most time and the ten largest
    sums of idle gaps by host activity, as the result line gives them."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name, s] for name, (_, s) in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}
