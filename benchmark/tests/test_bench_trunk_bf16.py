"""The two cells of cfnerf-flagship-pallas (the bf16 trunk kernels) at a
tiny size on the CPU through the harness, the trunk kernels' plain
versions in their place: correct against the triangular_bf16 reference,
every listed end-to-end metric reported, on the configuration's path; a
traced run reports only its listed per-layer metrics, and none of the
device's.  The family's reference imports nothing of the program
(test_bench_imports.py checks every reference file).

On the card (`-m card`), at each cell's own sizes on three seeds, the
program passes the cell's limits, and its control (the trunk's operands in
e4m3) and, in training, the fault "half of the batch left out" fail them,
as test_bench_control.py holds the f32 cells."""
import time

import pytest

from benchmark import harness
from benchmark.tests.helpers import tiny_spec
from benchmark.tests.test_bench_control import fails, readings

CELLS = ("flagship.train-pallas", "flagship.serve-pallas")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_and_reports_its_metrics(workload):
    spec = tiny_spec(workload)
    assert spec.config["family"] == "triangular_bf16" and spec.flags["trunk_impl"] == "pallas"
    result = harness.run_cell(spec, 2**31 + 7, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert result["left_path"] == []


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_listed_per_layer_metrics(workload):
    result = harness.run_cell(tiny_spec(workload), 9, 0.1, True, "cpu", time.perf_counter())
    names = {m["name"] for m in harness.load_spec(workload).per_layer}
    assert set(result["metrics"]) <= names
    assert any(n.startswith("mfu") for n in result["metrics"])
    # on the CPU no device trace, and no kernel launch for the trunk's
    # launch span: the trunk's readers find nothing
    assert not any(n.startswith(("device_idle", "trunk_", "render_core"))
                   for n in result["metrics"])


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_fault_fail_the_cell_at_its_size(workload, card):
    spec = harness.load_spec(workload)
    from benchmark import port

    port.build_kernels()
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = readings(spec, seed, card)
        assert not fails(r["program"], spec.cell["limits"]), r
        assert fails(r["control"], spec.cell["limits"]), r
        if "fault_half_batch" in r:
            assert fails(r["fault_half_batch"], spec.cell["limits"]), r
