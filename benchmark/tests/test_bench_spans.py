"""The per-layer metrics that read the program's own spans and counters
(benchmark/program_trace.py): all five in a traced flagship.train run at a
tiny size on the CPU, none in an untraced run, none in a serving cell, and
None from a checkout of the program that has no spans."""
import sys
import time

import pytest

from benchmark import harness, program_trace
from benchmark.tests.helpers import tiny_spec
from cfnerf_torch.utils import trace

SPAN_METRICS = {"forward_host_ms.train", "backward_host_ms.train", "update_host_ms.train",
                "feed_make_ms.train", "feed_stall_share.train"}


def run(workload, traced):
    trace.reset()
    return harness.run_cell(tiny_spec(workload), 2**31 + 5, 0.1, traced, "cpu",
                            time.perf_counter())


def test_a_traced_training_run_reads_all_five():
    metrics = run("flagship.train", True)["metrics"]
    assert SPAN_METRICS <= set(metrics), metrics
    for name in SPAN_METRICS - {"feed_stall_share.train"}:
        assert metrics[name]["value"] > 0, (name, metrics[name])
    assert 0 <= metrics["feed_stall_share.train"]["value"] <= 100


def test_an_untraced_run_lists_none():
    assert not SPAN_METRICS & set(run("flagship.train", False)["metrics"])


@pytest.mark.parametrize("workload", ["flagship.serve", "hier.serve"])
def test_the_serving_cells_list_none(workload):
    assert not SPAN_METRICS & {m["name"] for m in harness.load_spec(workload).per_layer}
    assert not SPAN_METRICS & set(run(workload, True)["metrics"])


def test_a_program_without_spans_reads_none(monkeypatch):
    import cfnerf_torch.utils

    monkeypatch.delattr(cfnerf_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "cfnerf_torch.utils.trace", None)  # import fails
    assert program_trace.snapshot() is None
    spec = harness.load_spec("flagship.train")
    r = harness.Run(spec=spec, seed=0, traced=harness.Window(durations=[1.0]))
    for name in SPAN_METRICS:
        assert harness.load_reader(name).read(r) is None, name
