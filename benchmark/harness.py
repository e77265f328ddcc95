"""Run one cell of the benchmark once.

A cell (BENCHMARK.json's `workloads` entry, and benchmark/workloads/<cell>.json
beside it) names a configuration (benchmark/configs/<config>.json: the
port's flags, its family and the kernels on its path) and a traffic mix
(benchmark/traffic/<traffic>.json).  Everything else is found by name too:
the loop that drives the mix's kind (benchmark/cells/<kind>.py), the
family's reference, weights and draws (benchmark/reference/<family>.py)
and counts (benchmark/counts/<family>.py), and each metric's reader
(benchmark/metrics/<metric>.py, or the reader of the name's longest dotted
prefix that has one).  So a later cell, mix, family or metric is a new file.

A run: the kernels from the port's cache in the checkout; the weights from
the seed on the device; the nets, the step or the renderer, warmed on the
cell's own shapes (a training cell's warm-up is its first steps, which the
check replays on the reference); then `seconds` of closed-loop traffic, one
step or one view after another, each timed on the host clock ending in a
synchronize, the window closing at the end of the first that ends after
`seconds`; a traced run then adds a second window of up to TRACE_SECONDS
under the profiler, so that the host-clock metrics are never read under
the profiler's cost; then the launch counters held to the configuration's
path, the peak memory, the program's state freed, the reference, the
verdict, and the result line.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from benchmark import check, mixes
from benchmark.trace import Tracer, breakdown

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cfnerf_tpu")
# the traced window: torch.profiler's stop and the reduction of a 30 s
# training window's ~1.5 M events took 190-230 s on an H100 host, of
# the 360 s a run may take
TRACE_SECONDS = 10.0
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*$")


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(root: Path, package: str, name: str) -> ModuleType:
    """benchmark/<package>/<name>.py of the checkout at `root`, found by
    name."""
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    if root == REPO:
        return importlib.import_module(f"benchmark.{package}.{name}")
    path = root / "benchmark" / package / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{package}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Spec:
    name: str
    cell: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = REPO

    @property
    def flags(self) -> Dict:
        return self.config["flags"]

    @property
    def train(self) -> bool:
        return self.traffic["kind"] == "train"

    @property
    def reference(self) -> ModuleType:
        """The family's reference, weights and draws."""
        return _module(self.root, "reference", self.config["family"])

    @property
    def counts(self) -> ModuleType:
        """The family's counts of a step's and a tile's work."""
        return _module(self.root, "counts", self.config["family"])

    def cell_class(self):
        """The loop that drives the mix's kind."""
        return _module(self.root, "cells", self.traffic["kind"]).Cell


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(workload: str, root: Path = REPO) -> Spec:
    """The cell `workload` as BENCHMARK.json and the benchmark's files give
    it."""
    bench = _read(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = dict(_read(root / "benchmark" / "workloads" / f"{workload}.json"), **entry)
    return Spec(
        name=workload, cell=cell, config=_read(root / config["file"]),
        traffic=_read(root / "benchmark" / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)], root=root)


def load_reader(name: str, root: Path = REPO) -> ModuleType:
    """The reader of metric `name`: benchmark/metrics/<name>.py, or else the
    one of the longest dotted prefix of the name that has a file
    (`mfu.serve.placed` is read by mfu.serve.py, else by mfu.py).  Its
    read(run) gives the metric's value, or None where it finds nothing to
    read."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        stem = ".".join(parts[:n])
        path = root / "benchmark" / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"benchmark_metric_{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no reader for metric {name!r} under benchmark/metrics/")


@dataclasses.dataclass
class Window:
    """One measured window: each unit's (a step's or a view's) time, each
    step's wait for its batch, the window's length and the port's launches
    in it."""

    durations: List[float] = dataclasses.field(default_factory=list)
    waits: List[float] = dataclasses.field(default_factory=list)
    elapsed_s: float = math.nan
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def units(self) -> int:
        return len(self.durations)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers: the host-clock window,
    and in a traced run the traced window and its reduced trace."""

    spec: Spec
    seed: int
    setup_s: float = math.nan
    window: Window = dataclasses.field(default_factory=Window)
    traced: Optional[Window] = None
    trace: Optional[Dict] = None
    rays_per_unit: int = 0  # a step's rays, or a view's pixels
    tiles_per_view: int = 0

    @property
    def train(self) -> bool:
        return self.spec.train


def clone(tree):
    """A detached copy of nested dicts, tuples and lists of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return type(tree)(clone(v) for v in tree)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, seconds: float, tracer: Tracer, port) -> Window:
    """Closed-loop units until the first that ends `seconds` after the
    window opened."""
    w = Window()
    before = port.launches()
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            u0 = time.perf_counter()
            cell.unit(tracer, w)
            t1 = time.perf_counter()
            w.durations.append(t1 - u0)
            if t1 - t0 >= seconds:
                break
    w.elapsed_s = t1 - t0
    after = port.launches()
    w.launches = {k: after[k] - before[k] for k in after}
    thirds = [w.durations[i * w.units // 3:(i + 1) * w.units // 3] for i in range(3)]
    print("window%s: %d units in %.3f s, mean ms by thirds %s" % (
        " (traced)" if tracer.on else "", w.units, w.elapsed_s,
        [round(1e3 * sum(t) / len(t), 3) if t else None for t in thirds]), file=sys.stderr)
    return w


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device, t_start: float,
             port=None) -> Dict:
    """One run of the cell; returns the result line's object, and under
    "left_path" what the launch counters show off the configuration's path
    (a run that left it prints no result).  `port` is the door into the
    program (benchmark/port.py unless a test passes one with a fault
    planted)."""
    if port is None:
        from benchmark import port
    device = torch.device(device)
    seeds = mixes.sub_seeds(seed, 6)
    phases = {"start": time.perf_counter() - t_start}
    if device.type == "cuda":
        port.build_kernels()
    phases["kernels"] = time.perf_counter() - t_start
    weights = spec.reference.make_weights(spec.flags, seeds[1], device)
    phases["weights"] = time.perf_counter() - t_start
    cell = spec.cell_class()(port, spec, seeds, device, weights)
    phases["cell"] = time.perf_counter() - t_start
    phases.update({f"cell.{k}": v for k, v in getattr(cell, "phases", {}).items()})
    cell.warm()
    phases["warm"] = time.perf_counter() - t_start
    print("setup phases (s from the start): " + json.dumps(phases), file=sys.stderr)
    run = Run(spec=spec, seed=seed)
    run.setup_s = time.perf_counter() - t_start
    run.window = measure(cell, seconds, Tracer(False), port)
    launches = dict(run.window.launches)
    if trace:
        tracer = Tracer(True)
        run.traced = measure(cell, min(seconds, TRACE_SECONDS), tracer, port)
        launches = {k: v + run.traced.launches[k] for k, v in launches.items()}
        run.trace = tracer.reduce()
        tracer.prof = None
    run.rays_per_unit, run.tiles_per_view = cell.rays_per_unit, cell.tiles_per_view
    left = check.path_faults(spec.config["kernels"], launches, spec.train,
                             counting=device.type == "cuda")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.numbers(weights)
    correct, failed, compared = check.verdict(numbers, spec.cell["limits"])
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = load_reader(m["name"], spec.root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    attempted = run.window.units + (run.traced.units if run.traced else 0)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        result["breakdown"] = breakdown(run.trace)
    result["launches"] = launches
    result["left_path"] = left
    result["compared"] = compared
    return result


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = parser.parse_args(argv)
    # one client thread and the prefetcher's: no intra-op pool spinning
    # beside them on the machine's few cores
    torch.set_num_threads(1)
    spec = load_spec(a.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(spec, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    left = result.pop("left_path")
    if left:
        print("benchmark: the cell left its configuration's path (\"kernels\"): "
              + "; ".join(left), file=sys.stderr)
        return 5
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
