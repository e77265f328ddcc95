"""The training step's CUDA graph (cfnerf_torch/train/graph.py), as far as
the CPU can hold it: which step objects graph_refusal graphs; the CPU step
and the CPU's member-batched ensemble step keep today's Adam and build no
graph; a graph's key tells calls apart by shape, dtype, seam and generator;
the composite's cumprod, whose backward the graph can capture, is
torch.cumprod bit for bit, forward and backward.  The graph itself, and that
its draws from a registered generator are the eager step's bit for bit, run
on the card only (chip_smoke.py, phase graph_step)."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cfnerf_torch.models.factory import build_model
from cfnerf_torch.ops.compositing import TRANS_EPS, _CumProd
from cfnerf_torch.parallel.ensemble import make_ensemble_train_step
from cfnerf_torch.train.graph import StepGraph
from cfnerf_torch.train.step import (
    OccTrainConfig,
    TrainConfig,
    graph_refusal,
    make_optimizer,
    make_train_step,
)
from cfnerf_torch.utils import trace
from cfnerf_torch.utils.config import parse_args

FLAGS = ["--model", "NeRF_Flows", "--type_flows", "triangular", "--netdepth", "2",
         "--netwidth", "16", "--N_samples", "6", "--K_samples", "3", "--n_flows", "2",
         "--h_alpha_size", "8", "--h_rgb_size", "8", "--n_hidden", "8", "--multires", "2",
         "--multires_views", "1", "--use_viewdirs", "--no_ndc", "--N_rand", "8"]
HIER = ["--N_importance", "6", "--netdepth_fine", "2", "--netwidth_fine", "16"]
NOT_CUDA = "not on a CUDA device"


def _cfg(**over):
    return TrainConfig(**{**dict(H=6, W=5, focal=4.0, ndc=False, near=2.0, far=6.0, k_samples=3,
                                 colmap_depth=True, beta1=0.01, depth_lambda=0.1), **over})


def _nets(extra=(), noise=False):
    torch.manual_seed(0)
    model, fine, rc = build_model(parse_args(FLAGS + list(extra)), device="cpu")
    if noise:
        rc = dataclasses.replace(rc, apply_noise=True, raw_noise_std=1.0)
    return model, fine, rc


def _batch(seed, n_rgb=8, n_depth=4):
    g = torch.Generator().manual_seed(seed)
    batch = {k: torch.randn(n_rgb, 3, generator=g) for k in ("rays_o", "rays_d", "target")}
    batch.update(depth_rays_o=torch.randn(n_depth, 3, generator=g),
                 depth_rays_d=torch.randn(n_depth, 3, generator=g),
                 target_depth=2.0 + 4.0 * torch.rand(n_depth, generator=g))
    return batch


@pytest.mark.parametrize("extra, over, expect", [
    ([], {}, NOT_CUDA),
    (["--fused_render", "off", "--raw_noise_std", "1.0"], {}, NOT_CUDA),
    (HIER, {}, NOT_CUDA),
    (["--type_flows", "householder", "--compute_dtype", "bfloat16"], {}, NOT_CUDA),
    ([], {"mesh": object()}, "a mesh"),
    ([], {"occ": OccTrainConfig(lo=(-1.0,) * 3, hi=(1.0,) * 3)}, "occ"),
    ([], {"remat": True}, "remat"),
    (["--model", "nerf_dropout", "--fused_render", "off"], {}, "a baseline"),
], ids=["fused", "unfused_noise", "hierarchical", "householder_bf16", "mesh", "occ", "remat",
        "baseline"])
def test_graph_refusal_names_what_keeps_a_step_eager(extra, over, expect):
    """Every NeRFFlows step is refused on the CPU for the device alone (on
    the card it is graphed); a mesh, occ, remat and the baselines are
    refused for themselves, whatever the device."""
    model, fine, rc = _nets(extra)
    mesh, occ = over.pop("mesh", None), over.pop("occ", None)
    reason = graph_refusal(model, fine, rc, _cfg(**over), mesh=mesh, occ=occ)
    assert reason is not None and reason.startswith(expect), reason


@pytest.mark.parametrize("ensemble", [False, True], ids=["one_net", "ensemble_batched"])
def test_the_cpu_step_keeps_its_adam_and_builds_no_graph(monkeypatch, ensemble):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was built on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    model, fine, rc = _nets()
    optimizer, scheduler = make_optimizer(model.parameters(), _cfg())
    assert isinstance(optimizer.param_groups[0]["lr"], float)
    assert not optimizer.param_groups[0]["capturable"]
    if ensemble:
        models = [model, _nets()[0]]
        step, optimizers = make_ensemble_train_step(
            models, rc, _cfg(), 2, optimizers=[(optimizer, scheduler), None])
        assert step.batched and all(s.graph_refusal == NOT_CUDA for s in step.members)
        batch = {k: torch.stack([v, v.flip(0)]) for k, v in _batch(3).items()}
        gens = [torch.Generator().manual_seed(s) for s in (4, 5)]
        optimizer = optimizers[0]
    else:
        step, optimizer = make_train_step(model, rc, _cfg(), optimizer=(optimizer, scheduler))
        assert step.graph_refusal == NOT_CUDA
        batch, gens = _batch(3), torch.Generator().manual_seed(4)
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            step(batch, gens)
        snap = trace.snapshot()
    finally:
        trace.reset()
    if not ensemble:  # the batched step's eager phases carry no spans
        assert set(snap["spans"]) == {"cfnerf.train.zero_grad", "cfnerf.train.forward",
                                      "cfnerf.train.backward", "cfnerf.train.update"}
    assert not any(k.startswith("cfnerf.train.stage") for k in snap["spans"])
    assert not any(k.startswith("train.graph") for k in snap["counters"])
    state = optimizer.state[next(model.parameters())]
    assert state["step"].device.type == "cpu" and float(state["step"]) == 1.0


def _other_call(case, batch, seams, gen):
    """A call that differs from (batch, seams, gen) in one way, or not."""
    if case == "other_values":
        return _batch(1), seams, gen
    if case == "numpy":
        return {k: v.numpy() for k, v in batch.items()}, seams, gen
    if case == "other_rays":
        return _batch(1, n_rgb=7), seams, gen
    if case == "other_dtype":
        return {**batch, "target": batch["target"].double()}, seams, gen
    if case == "seam_handed_in":
        return batch, {**seams, "z_vals": torch.zeros(12, 6)}, gen
    if case == "other_seam_shape":
        return batch, {**seams, "eps": (torch.zeros(3, 1), torch.zeros(3, 2))}, gen
    if case == "other_generator":
        return batch, seams, torch.Generator().manual_seed(0)
    if case == "no_generator":
        return batch, seams, None
    raise ValueError(case)


@pytest.mark.parametrize("case, same", [
    ("other_values", True), ("numpy", True), ("other_rays", False), ("other_dtype", False),
    ("seam_handed_in", False), ("other_seam_shape", False), ("other_generator", False),
    ("no_generator", False)])
def test_a_graph_key_tells_calls_apart_by_shape_dtype_seam_and_generator(case, same):
    """StepGraph.matches against a captured call (the step's flagship
    keywords, eps handed in, a generator): the same shapes and the very
    same generator replay; any other shape, dtype, seam or generator is
    another call, run eagerly."""
    model, _, _ = _nets()
    graph = StepGraph(lambda *a: None, [make_optimizer(model.parameters(), _cfg())[0]], "cpu")
    gen = torch.Generator().manual_seed(0)
    batch = _batch(0)
    seams = dict(z_vals=None, eps=(torch.zeros(3, 1), torch.zeros(3, 3)), eps_fine=None,
                 pdf_u=None, noise=None)
    graph._key, graph._generators = StepGraph._flatten(batch, seams)[2], (gen,)
    assert graph.matches(StepGraph._flatten(batch, seams)[2], (gen,))
    batch, seams, gen = _other_call(case, batch, seams, gen)
    assert graph.matches(StepGraph._flatten(batch, seams)[2], (gen,)) == same


@pytest.mark.parametrize("shape", [(64, 16, 8), (5, 129, 3), (7, 1, 2), (1, 1, 1)])
def test_the_composites_cumprod_is_torchs_bitwise(shape):
    g = torch.Generator().manual_seed(sum(shape))
    alpha = torch.rand(shape, generator=g)
    alpha[0, :, 0] = 1.0  # saturated: the factor is 1e-10
    cotangent = torch.randn(shape, generator=g)
    grads, outs = [], []
    for cumprod in (torch.cumprod, _CumProd.apply):
        a = alpha.clone().requires_grad_()
        out = cumprod(1.0 - a + TRANS_EPS, -2)
        (out * cotangent)[:, :-1].sum().backward()  # the exclusive product's slice
        outs.append(out.detach())
        grads.append(a.grad)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_a_generator_on_another_device_is_not_staged():
    """Draws made on the CPU for a CUDA step are copied over, which no
    graph can hold: such a call is left to the eager step, and nothing is
    captured."""
    model, _, _ = _nets()
    graph = StepGraph(lambda *a: None, [make_optimizer(model.parameters(), _cfg())[0]],
                      torch.device("cuda"))
    assert not graph.stage(_batch(0), (torch.Generator().manual_seed(0),), {})
    assert graph._graph is None
