"""cfnerf_torch's bf16 trunk (trunk_impl="pallas") against the benchmark's
reference family triangular_bf16 (benchmark/reference/triangular_bf16.py),
at the tiny size of benchmark/tests/helpers.py (D3/W32, heads 16, within
trunk.supported) on the CPU, where the trunk kernels' plain versions run;
the family's counts; the trunk's spans and counters.

Tolerances.  The port and the reference round the same operands to bf16 and
sum the same exact f32 products, in other orders (the port's plain version
sums the skip layer's and the views layer's two products apart, the
reference takes each as one product over the concatenation).  The sums then
differ by f32 ulps, and where such a sum lies at a bf16 rounding tie the two
sides round one activation an ulp apart (2^-8 of it).  Over 8 seeds at this
size that reads: heads <= ~1e-6 of their largest value, loss_gap 0 - 1.4e-6,
grad_gap <= 3.8e-5, change_gap <= 1.5e-5, maps_gap <= 4.3e-5.  Each tolerance
below is 1e-4 for the loss and 1e-3 for the rest: above those by 25x or more,
and under the control's smallest reading (the reference with the trunk's
operands in e4m3, 2^-4 apart: loss 1.6e-3, grad 4.8e-2, change 1.8e-2, maps
0.10) by 16x or more.
"""
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import calibrate, check, harness, port  # noqa: E402
from benchmark.counts import triangular, triangular_bf16, work  # noqa: E402
from benchmark.reference import triangular as ref_f32  # noqa: E402
from benchmark.reference import triangular_bf16 as ref  # noqa: E402
from benchmark.tests.helpers import tiny_spec  # noqa: E402
from cfnerf_torch.utils import trace  # noqa: E402

CELLS = ("flagship.train-pallas", "flagship.serve-pallas")
TOL = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3, "maps_gap": 1e-3}
HEADS_TOL = 1e-3  # of each head's largest value, for the reasons above


def nets(seed: int):
    """The tiny configuration's flags, the reference's weights, and the
    port's net built from them; and B rows of the trunk's input."""
    flags = tiny_spec("flagship.serve-pallas").flags
    weights = ref.make_weights(flags, seed, "cpu")
    model = port.build(flags, weights, "cpu")[0]
    g = torch.Generator().manual_seed(seed)
    pts, views = torch.rand(200, 3, generator=g) * 4 - 2, torch.randn(200, 3, generator=g)
    x = torch.cat([ref_f32.encode(pts, flags["multires"]),
                   ref_f32.encode(views / views.norm(dim=-1, keepdim=True),
                                  flags["multires_views"])], -1)
    return flags, weights["coarse"], model, x


def reference_heads(flags, w, x, matmul="f32"):
    n = 3 + 6 * flags["multires"]
    p = ref.Precision(matmul, [w[f"{name}.weight"]
                               for name in ref.trunk_layers(flags["netdepth"])])
    return ref_f32.heads(p, w, flags["netdepth"], x[:, :n], x[:, n:])


def rel_gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_heads_match_the_reference(seed):
    flags, w, model, x = nets(seed)
    with torch.no_grad():
        got = model.encode(x)
        want = reference_heads(flags, w, x)
        control = reference_heads(flags, w, x, "tf32")
    for g, r, c in zip(got, want, control):
        assert rel_gap(g, r) < HEADS_TOL
        assert rel_gap(c, r) > HEADS_TOL  # the e4m3 control reads above it


def test_trunk_gradients_match_the_reference():
    flags, w, model, x = nets(5)
    cot = [torch.randn(x.shape[0], flags[k], generator=torch.Generator().manual_seed(i))
           for i, k in enumerate(("h_alpha_size", "h_rgb_size"))]
    names = ref.trunk_layers(flags["netdepth"])
    got_a, got_r = model.encode(x)
    ((got_a * cot[0]).sum() + (got_r * cot[1]).sum()).backward()
    params = dict(model.named_parameters())
    got = {f"{n}.{k}": params[f"{n}.{k}"].grad for n in names for k in ("weight", "bias")}
    leaves = {k: w[k].clone().requires_grad_(True) for k in got}
    ha, hr = reference_heads(flags, {**w, **leaves}, x)
    ((ha * cot[0]).sum() + (hr * cot[1]).sum()).backward()
    want = {k: v.grad for k, v in leaves.items()}
    assert check.norm_gap(got, want) < TOL["grad_gap"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu(workload):
    result = harness.run_cell(tiny_spec(workload), 2**31 + 5, 0.1, False, "cpu",
                              time.perf_counter())
    assert result["correct"], result["compared"]
    for name, c in result["compared"].items():
        assert c["value"] < TOL[name], (name, c)
    assert set(result["metrics"]) == {m["name"] for m in tiny_spec(workload).end_to_end}
    assert result["left_path"] == []


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_the_tolerances(workload):
    spec = tiny_spec(workload)
    if spec.train:
        r = calibrate.train_readings(spec, 51, torch.device("cpu"), True)
    else:
        r = calibrate.serve_readings(spec, 51, torch.device("cpu"), True, 2)
    assert all(v < TOL[k] for k, v in r["program"].items()), r
    assert all(v > TOL[k] for k, v in r["control"].items()), r


def test_trunk_bound_is_its_work_at_the_bf16_peak():
    flags = harness.load_spec("flagship.train-pallas").flags
    net = (8, 512, 63, 27, 64, 64)
    for n_rays, train, B in ((640, True, 81920), (8192, False, 1048576)):
        fwd = triangular_bf16.kernel_bound_ms(flags, "trunk", n_rays, train, False)
        assert fwd == pytest.approx(1e3 * work.trunk_work(B, *net)[1] / 989e12)
    bwd = triangular_bf16.kernel_bound_ms(flags, "trunk", 640, True, True)
    assert bwd == pytest.approx(1e3 * work.trunk_bwd_work(81920, *net)[1] / 989e12)
    assert fwd == pytest.approx(4.981, abs=1e-3)  # a serving tile (PERF.md, section 6)
    assert triangular_bf16.launches_per_render(flags, "trunk") == 1
    assert (triangular_bf16.kernel_bound_ms(flags, "render_core", 640, True, True)
            == triangular.kernel_bound_ms(flags, "render_core", 640, True, True))


@pytest.mark.parametrize("train", [False, True])
def test_model_ops_are_f32_equivalent(train):
    flags = harness.load_spec("flagship.serve-pallas").flags
    net, B = (8, 512, 63, 27, 64, 64), 640 * 128
    trunk = work.trunk_work(B, *net)[1] + (work.trunk_bwd_work(B, *net)[1] if train else 0)
    rest = triangular.model_ops(flags, 640, train) - trunk
    got = triangular_bf16.model_ops(flags, 640, train)
    # the trunk at the bf16 peak and the rest at the f32 peak take the time
    # that the f32-equivalent operations take at the f32 peak
    assert got / 67e12 == pytest.approx(trunk / 989e12 + rest / 67e12)
    assert triangular_bf16.linear_ops(flags, 640, train) == pytest.approx(
        triangular.linear_ops(flags, 640, train) - trunk)


def test_encode_records_one_pack_and_its_rows():
    _, _, model, x = nets(7)
    trace.reset()
    try:
        with torch.no_grad():
            model.encode(x)  # no profile: nothing recorded
            with profile(activities=[ProfilerActivity.CPU]):
                model.encode(x)
                model.encode(x[:50])
        snap = trace.snapshot()
    finally:
        trace.reset()
    assert snap["spans"]["cfnerf.trunk.pack"]["calls"] == 2
    assert snap["counters"] == {"trunk.packs": 2, "trunk.rows": x.shape[0] + 50}
