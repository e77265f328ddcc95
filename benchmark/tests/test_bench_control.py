"""The control: the reference in TF32 (the precision just below the
configurations' f32 with TF32 off) put in the program's place must come
out not correct, and the fault "half of the batch left out" too.

On the CPU, at a tiny size (TF32 emulated by rounding each product's
inputs), the control reads well apart from the program: at least ten times
its reading in some number.  On the card (`-m card`) at each cell's own
sizes, on three seeds, the control fails at least one of the cell's limits
(benchmark/calibrate.py gives every reading)."""
import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.helpers import tiny_spec

CELLS = ("flagship.train", "flagship.serve", "hier.serve")


def readings(spec, seed, device):
    if spec.traffic["kind"] == "train":
        return calibrate.train_readings(spec, seed, device, True)
    return calibrate.serve_readings(spec, seed, device, True, 2)


def fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("workload", CELLS + ("hier.train",))
def test_control_reads_apart_from_the_program(workload):
    r = readings(tiny_spec(workload), 4, torch.device("cpu"))
    assert any(r["control"][k] >= 10 * max(v, 1e-9) for k, v in r["program"].items()), r
    if "fault_half_batch" in r:
        assert any(r["fault_half_batch"][k] >= 10 * max(v, 1e-9)
                   for k, v in r["program"].items()), r


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cell_at_its_size(workload, card):
    spec = harness.load_spec(workload)
    from benchmark import port

    port.build_kernels()
    for seed in (101, 102, 103):
        r = readings(spec, seed, card)
        assert not fails(r["program"], spec.cell["limits"]), r
        assert fails(r["control"], spec.cell["limits"]), r
        if "fault_half_batch" in r:
            assert fails(r["fault_half_batch"], spec.cell["limits"]), r
