"""The frozen reference against cfnerf_torch at a tiny size on the CPU:
each cell's run (a render of its views, or its first training steps and a
window of steps) through the harness, the program's plain PyTorch
versions in place of its kernels, judged by the reference."""
import time

import pytest

from benchmark import harness
from benchmark.tests.helpers import tiny_spec

CELLS = ("flagship.train", "flagship.serve", "hier.train", "hier.serve")  # hier.train: helpers


@pytest.mark.parametrize("workload", CELLS)
def test_program_matches_reference(workload):
    result = harness.run_cell(tiny_spec(workload), 2 ** 31 + 5, 0.2, False, "cpu",
                              time.perf_counter())
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for name, c in result["compared"].items():
        assert c["value"] < 1e-5, (name, c)
    spec = tiny_spec(workload)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert result["left_path"] == []


@pytest.mark.parametrize("workload", ["flagship.train", "hier.serve"])
def test_traced_run_reports_per_layer_metrics_only(workload):
    result = harness.run_cell(tiny_spec(workload), 3, 0.1, True, "cpu", time.perf_counter())
    names = {m["name"] for m in harness.load_spec(workload).per_layer}
    assert set(result["metrics"]) <= names
    # the host-clock metrics come from the untraced window, beside the traced one
    assert any(n.startswith("mfu") for n in result["metrics"])
    assert result["attempted"] >= 2
    # on the CPU no device trace: the device's metrics find nothing to read
    assert not any(n.startswith(("device_idle", "trunk_gemm", "render_core", "flow_stack"))
                   for n in result["metrics"])
