"""The program's spans and counters, recorded while a torch profiler records.

    with span("cfnerf.train.forward"):
        ...
    count("feed.empty")

Recording is on exactly while a `torch.profiler` (or `torch.autograd.
profiler`) profile records anywhere in the process: the CLI's
`--profile_dir` window, or a benchmark's traced window.  There is no flag
of its own.  With no profile recording, `span()` returns one shared null
context and `count()` does nothing; either costs one read of the
profiler's process-wide flag.

While recording, a span is

  * a host event of the profiler's, under the span's name, on the
    profiler's clock and in the same trace as the kernels.  The profiler
    follows the thread that started it (and autograd's); a worker thread's
    spans reach the trace only under a profile started with
    `_ExperimentalConfig(profile_all_threads=True)`.  `step`, where given,
    is the event's keyword argument "step", which the trace's args show
    under a profile that records shapes;
  * added to an in-memory aggregate kept per thread: calls, total ns, self
    ns (the total less the time its child spans on the same thread cover)
    and the most ns of one call, each on `time.perf_counter_ns`.

`snapshot()` gives the aggregate, merged over threads and by thread, the
counters, and the hand-written kernels' launch counters (the functions'
`launches` attributes, which count whether or not a profile records);
`reset()` clears the aggregate and the counters.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()
# a host event of the profiler's that carries keyword arguments; it costs
# about a ninth of torch.profiler.record_function's on the CPU
_Event = torch._C._profiler._RecordFunctionFast

_lock = threading.Lock()  # guards _threads' list and _counts
# each thread's (name, {span name: [calls, total ns, self ns, max ns]}),
# written by that thread alone: a span takes no lock
_threads: List[Tuple[str, Dict[str, List[int]]]] = []
_counts: Dict[str, int] = {}
_local = threading.local()  # .stack: the thread's open spans; .stats: its entry


def recording() -> bool:
    """Whether a torch profiler records, on any thread of the process."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "event", "t0", "children")

    def __init__(self, name: str, step: Optional[int]):
        self.name = name
        self.event = _Event(name) if step is None else _Event(name, (), {"step": int(step)})
        self.children = 0

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.stats = {}
            with _lock:
                _threads.append((threading.current_thread().name, _local.stats))
        stack.append(self)
        self.event.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        total = time.perf_counter_ns() - self.t0
        self.event.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children += total
        own = total - self.children
        s = _local.stats.get(self.name)
        if s is None:
            _local.stats[self.name] = [1, total, own, total]
        else:
            s[0] += 1
            s[1] += total
            s[2] += own
            s[3] = max(s[3], total)
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager marking a region of the program (see the module's
    docstring); the shared null context while no profile records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, step)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`, while a profile records."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def _stats(s: List[int]) -> Dict[str, int]:
    return {"calls": s[0], "total_ns": s[1], "self_ns": s[2], "max_ns": s[3]}


def launch_counters() -> Dict[str, Callable]:
    """The hand-written kernels' entry functions, by kernel; each counts its
    launches in its `launches` attribute."""
    from cfnerf_torch.ops.kernels import flow_stack, render_core, trunk

    return {"render_core_fwd": render_core.fused_flow_composite,
            "render_core_bwd": render_core.fused_flow_composite_bwd,
            "flow_stack_fwd": flow_stack.fused_flow_stack,
            "flow_stack_bwd": flow_stack.fused_flow_stack_bwd,
            "trunk_fwd": trunk.trunk_encode,
            "trunk_bwd": trunk.trunk_encode_bwd}


def _launches() -> Dict[str, int]:
    """The hand-written kernels' launch counters, by kernel."""
    return {name: fn.launches for name, fn in launch_counters().items()}


def snapshot() -> Dict[str, Dict]:
    """{"spans": {name: stats} merged over threads, "threads": {thread
    name: {name: stats}}, "counters": {name: n}, "launches": {kernel: n}},
    stats being {"calls", "total_ns", "self_ns", "max_ns"}."""
    with _lock:
        # each copy is one step of the interpreter: a thread's span cannot
        # change its dict midway
        items = [(thread, name, list(s)) for thread, stats in _threads
                 for name, s in list(stats.items())]
        counters = dict(_counts)
    merged: Dict[str, List[int]] = {}
    threads: Dict[str, Dict[str, List[int]]] = {}
    for thread, name, s in items:
        mine = threads.setdefault(thread, {}).setdefault(name, [0, 0, 0, 0])
        m = merged.setdefault(name, [0, 0, 0, 0])
        for acc in (mine, m):
            for i in range(3):
                acc[i] += s[i]
            acc[3] = max(acc[3], s[3])
    return {"spans": {name: _stats(s) for name, s in merged.items()},
            "threads": {thread: {name: _stats(s) for name, s in spans.items()}
                        for thread, spans in threads.items()},
            "counters": counters, "launches": _launches()}


def reset() -> None:
    """Clear the aggregate and the counters (not the launch counters)."""
    with _lock:
        for _, stats in _threads:
            stats.clear()  # in place: each thread keeps writing to its own
        _counts.clear()
