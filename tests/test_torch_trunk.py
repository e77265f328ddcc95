"""The trunk kernel's plain version against cfnerf_tpu's pallas_encode (the
Pallas kernel run through its interpreter on the CPU); the model's
trunk_impl dispatch, the factory and the train step with a kernel trunk; the slice
end to end (the flat and the hierarchical render with trunk_impl="interpret"
models against JAX's); the wrapper's routing, with stand-in kernel entries;
and the golden file that lets chip_smoke.py hold the card's kernel against
JAX numbers.

The CUDA kernel itself cannot run here (no card, no nvcc): chip_smoke.py
holds it against this plain version on the H100.

Tolerances.  h_alpha / h_rgb atol 1e-3 / rtol 1e-2: both sides round the
same values to bf16 and sum f32 products, in another order, so an
activation sometimes rounds to the neighbouring bf16 value (2^-8 relative);
measured 9e-8 to 4.0e-4 (the f32 nn.Linear trunk: 2.5e-4 to 1.9e-3).  The
renders carry that through the flows and the composite: maps atol 1e-4 /
rtol 1e-5, measured <= 1.3e-5 (the hierarchical pair's depth0; the f32
trunk's renders sit up to 1.3e-4 from JAX's interpreted ones).

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_trunk
(test_trunk_golden_is_current fails while the committed file is stale).
"""
import contextlib
import ctypes
import dataclasses
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops.pallas.trunk import pallas_encode
from cfnerf_tpu.render import renderer as jrender
from cfnerf_torch.convert import nerf_flows_pair_state_dicts_from_jax
from cfnerf_torch.models.factory import build_model
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.ops.kernels import _build, trunk
from cfnerf_torch.ops.kernels.trunk import (
    pack_trunk_weights,
    supported,
    trunk_encode,
    trunk_encode_plain,
)
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays
from cfnerf_torch.train.step import TrainConfig, make_train_step
from tests.test_torch_common import Tiny, jax_nerf_flows, port_nerf_flows, to_np
from tests.test_torch_hierarchical import _rays

GOLDEN = Path(__file__).parent / "fixtures" / "torch_port_trunk_golden.npz"
ENC_TOL = dict(rtol=1e-2, atol=1e-3)
MAP_TOL = dict(rtol=1e-5, atol=1e-4)
IN_CH, V_CH = 63, 27
SMALL = Tiny(depth=4, width=256, k=4, flows=2, h_alpha=64, h_rgb=64)
WIDE = Tiny(depth=8, width=512, k=4, flows=2, h_alpha=64, h_rgb=64)
MAPS = ("rgb_map", "disp_map", "depth_map", "acc_map")
HIER_MAPS = MAPS + ("rgb0", "disp0", "depth0")
T = torch.as_tensor


@functools.lru_cache(maxsize=None)
def _jax(cfg: Tiny, seed: int = 0):
    """(JAX model with an interpreted trunk, params, test eps)."""
    return jax_nerf_flows(cfg, seed, trunk_impl="interpret")


def _trunk_params(params, depth):
    names = [f"pts_linear_{i}" for i in range(depth)] + [
        "feature_linear", "views_linear", "h_alpha_linear", "h_rgb_linear"]
    return {n: params[n] for n in names}


def jax_encode(cfg: Tiny, params, x):
    ha, hr = pallas_encode(_trunk_params(params, cfg.depth), jnp.asarray(x),
                           depth=cfg.depth, width=cfg.width, input_ch=IN_CH,
                           views_ch=V_CH, interpret=True)
    return np.asarray(ha), np.asarray(hr)


def _x(B, seed):
    return np.random.RandomState(seed).randn(B, IN_CH + V_CH).astype(np.float32)


def _model(cfg: Tiny, trunk_impl="xla", seed=0):
    _, params, eps = _jax(cfg, seed)
    return port_nerf_flows(cfg, params, eps, trunk_impl=trunk_impl)


def _assert_enc_close(out, ref):
    for name, a, b in zip(("h_alpha", "h_rgb"), out, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(to_np(a), b, err_msg=name, **ENC_TOL)


# ---------------------------------------------------------------------- #
# the plain version against pallas_encode
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("B", [300, 77], ids=["B300", "ragged_B77"])
@pytest.mark.parametrize("cfg", [SMALL, WIDE], ids=["D4W256", "D8W512"])
def test_plain_matches_jax_pallas_encode(cfg, B):
    _, params, _ = _jax(cfg)
    x = _x(B, seed=B)
    ref = jax_encode(cfg, params, x)
    packed = pack_trunk_weights(_model(cfg))
    with torch.no_grad():
        out = trunk_encode_plain(packed, T(x))
    _assert_enc_close(out, ref)
    # the kernel's arithmetic, not merely a trunk: the f32 nn.Linear trunk
    # sits further from JAX's kernel
    with torch.no_grad():
        f32 = _model(cfg).encode(T(x))
    for a, f, r in zip(out, f32, ref):
        assert np.abs(to_np(a) - r).max() < np.abs(to_np(f) - r).max()


@pytest.mark.parametrize("trunk_impl", ["pallas", "interpret"])
def test_converted_model_encodes_as_pallas_encode(trunk_impl):
    """JAX params -> convert.nerf_flows_state_dict_from_jax -> the port's
    model with a kernel trunk -> encode, against pallas_encode; leading
    dimensions are kept."""
    _, params, _ = _jax(SMALL)
    x = _x(96, seed=3)
    ref = jax_encode(SMALL, params, x)
    model = _model(SMALL, trunk_impl)
    with torch.no_grad():
        ha, hr = model.encode(T(x).reshape(8, 12, -1))
    assert tuple(ha.shape) == (8, 12, 64) and tuple(hr.shape) == (8, 12, 64)
    _assert_enc_close((ha.reshape(96, -1), hr.reshape(96, -1)), ref)


def test_interpret_mode_differentiates_through_the_plain_version():
    """trunk_impl="interpret" is the kernels' arithmetic in eager PyTorch:
    the gradient reaches every trunk weight, as JAX's interpret mode is
    differentiable, and none reaches x (JAX's custom VJP returns zeros for
    it: the embedded points are data)."""
    model = _model(SMALL, "interpret")
    x = T(_x(32, seed=4)).requires_grad_()
    ha, hr = model.encode(x)
    (ha.sum() + hr.square().sum()).backward()
    for layer in (*model.pts_linears, model.feature_linear, model.views_linear,
                  model.h_alpha_linear, model.h_rgb_linear):
        assert layer.weight.grad is not None and bool(layer.weight.grad.any())
    assert x.grad is None or not bool(x.grad.any())


# ---------------------------------------------------------------------- #
# packing and the model's rules
# ---------------------------------------------------------------------- #


def test_pack_splits_and_pads_the_weights():
    model = _model(SMALL)
    packed = pack_trunk_weights(model)
    m, b = packed.matrices(), packed.biases()
    D, W = SMALL.depth, SMALL.width
    # f32: the kernels round the weights to bf16 themselves, so that the
    # weight gradients stay f32 (see test_torch_trunk_bwd.py)
    assert packed.w.dtype == torch.float32 and packed.b.dtype == torch.float32
    assert packed.w.numel() == sum(t.numel() for t in m.values())
    assert packed.b.numel() == sum(t.numel() for t in b.values())

    def same(a, ref):
        torch.testing.assert_close(a, ref.detach(), rtol=0, atol=0)

    same(m["w0"][:, :IN_CH], model.pts_linears[0].weight)
    skip = model.pts_linears[D // 2 + 1].weight  # (W, 63 + W): [input_pts, h]
    same(m["wsx"][:, :IN_CH], skip[:, :IN_CH])
    same(m["wsh"], skip[:, IN_CH:])
    same(m["wvf"], model.views_linear.weight[:, :W])
    same(m["wvv"][:, :V_CH], model.views_linear.weight[:, W:])
    same(m["whr"], model.h_rgb_linear.weight)
    for name in ("w0", "wsx", "wvv"):  # the k-step padding is zeros
        assert m[name].shape[1] % trunk.K_STEP == 0
        assert not m[name][:, IN_CH if name != "wvv" else V_CH:].any()
    assert set(m) == {"w0", "w1", "w2", "wsx", "wsh", "wha", "wf", "wvf", "wvv", "whr"}
    torch.testing.assert_close(b["bv"], model.views_linear.bias.detach(), rtol=0, atol=0)
    torch.testing.assert_close(b[f"b{D - 1}"], model.pts_linears[D - 1].bias.detach(),
                               rtol=0, atol=0)


def test_supported():
    assert supported(8, 512, True, (4,), 64, 64, IN_CH, V_CH)
    assert supported(4, 256, True, (2,), 64, 64, IN_CH, V_CH)
    assert not supported(8, 512, False, (4,), 64, 64, IN_CH, V_CH)
    assert not supported(8, 300, True, (4,), 64, 64, IN_CH, V_CH)
    assert not supported(8, 1024, True, (4,), 64, 64, IN_CH, V_CH)  # shared memory
    assert not supported(2, 256, True, (1,), 64, 64, IN_CH, V_CH)  # no skip + 1 layer
    assert not supported(8, 512, True, (3,), 64, 64, IN_CH, V_CH)
    assert not supported(8, 512, True, (4,), 24, 64, IN_CH, V_CH)


@pytest.mark.parametrize("over", [
    dict(net_width=300), dict(use_viewdirs=False, input_ch_views=0), dict(net_depth=2, skips=(1,)),
    dict(h_alpha_size=24), dict(skips=(1,)),
], ids=["width300", "no_viewdirs", "depth2", "head24", "skip1"])
@pytest.mark.parametrize("trunk_impl", ["pallas", "interpret"])
def test_unsupported_configuration_raises(trunk_impl, over):
    """An explicit trunk_impl never falls back to the nn.Linear trunk
    (tests/test_pallas_trunk.py:test_unsupported_config_raises).  A head
    width that is not a multiple of 16 is outside the kernels' domain only:
    "interpret" takes JAX's domain, which has any head widths
    (tests/test_torch_trunk_domain.py)."""
    kw = dict(net_depth=4, net_width=256, input_ch=IN_CH, input_ch_views=V_CH, skips=(2,),
              h_alpha_size=64, h_rgb_size=64, n_flows=2, k_samples=4)
    NeRFFlows(**{**kw, **over})  # fine with the nn.Linear trunk
    if trunk_impl == "interpret" and "h_alpha_size" in over:
        NeRFFlows(**{**kw, **over}, trunk_impl=trunk_impl)
        return
    with pytest.raises(ValueError, match="trunk_impl"):
        NeRFFlows(**{**kw, **over}, trunk_impl=trunk_impl)


def test_unknown_trunk_impl_raises():
    with pytest.raises(ValueError, match="trunk_impl"):
        NeRFFlows(net_depth=4, net_width=256, skips=(2,), trunk_impl="triton")


def _args(**over):
    base = dict(multires=10, multires_views=4, i_embed=0, use_viewdirs=True, netdepth=4,
                netwidth=256, h_alpha_size=64, h_rgb_size=64, n_flows=2, K_samples=4,
                type_flows="triangular", N_importance=0, N_samples=8, perturb=1.0,
                white_bkgd=False, raw_noise_std=0.0, seed=0)
    return types.SimpleNamespace(**{**base, **over})


def test_factory_passes_trunk_impl_to_both_nets():
    model, _, _ = build_model(_args(), device="cpu")
    assert model.trunk_impl == "xla"  # the default, as the JAX flag's
    hier = dict(N_importance=8, netdepth_fine=4, netwidth_fine=512)
    for impl in ("pallas", "interpret"):
        model, fine, _ = build_model(_args(trunk_impl=impl, **hier), device="cpu")
        assert model.trunk_impl == fine.trunk_impl == impl
    with pytest.raises(ValueError, match="trunk_impl"):
        build_model(_args(trunk_impl="cuda"), device="cpu")
    with pytest.raises(ValueError, match="trunk_impl"):  # a fine net the kernel cannot take
        build_model(_args(trunk_impl="pallas", N_importance=8, netdepth_fine=4,
                          netwidth_fine=48), device="cpu")


@pytest.mark.parametrize("which", ["model", "model_fine"])
def test_make_train_step_trains_a_trunk_kernel_model(which):
    """A hierarchical step with a trunk_impl="pallas" net as either net (on
    the CPU: `_Trunk` on the plain route): its trunk weights get gradients
    and move, as the f32 net's do."""
    hier = dict(N_importance=8, netdepth_fine=4, netwidth_fine=256)
    model, fine, rc = build_model(_args(**hier), device="cpu")
    kernel_net, _, _ = build_model(_args(trunk_impl="pallas"), device="cpu")
    nets = {"model": model, "model_fine": fine, which: kernel_net}
    cfg = TrainConfig(H=8, W=8, focal=10.0, ndc=False, near=2.0, far=6.0, k_samples=4)
    step, _ = make_train_step(nets["model"], rc, cfg, model_fine=nets["model_fine"])
    rng = np.random.RandomState(1)
    o = (rng.randn(8, 3) * 0.3 + [0.0, 0.0, 4.0]).astype(np.float32)
    batch = dict(rays_o=o, rays_d=(-o / np.linalg.norm(o, axis=-1, keepdims=True)),
                 target=rng.rand(8, 3).astype(np.float32))
    before = [p.detach().clone() for p in kernel_net.pts_linears.parameters()]
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    for p, b in zip(kernel_net.pts_linears.parameters(), before):
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert not torch.equal(p.detach(), b)


# ---------------------------------------------------------------------- #
# the slice end to end: renders against JAX's with interpreted trunks
# ---------------------------------------------------------------------- #


def _apply(model):
    def apply(p, x, *, is_test, rng):
        return model.apply({"params": p}, x, is_test=is_test, rng=rng)
    return apply


def _assert_maps_close(out, ref, keys):
    for k in keys:
        a, b = to_np(out[k]), np.asarray(ref[k])
        if k.startswith("disp"):  # 1/(depth/acc): meaningful where acc > 0
            mask = np.asarray(ref["acc_map"]) > 1e-3
            a, b = a[mask], b[mask]
        np.testing.assert_allclose(a, b, err_msg=k, **MAP_TOL)


def test_flat_render_matches_jax_with_interpreted_trunks():
    """The serving path at D4/W256: the port's make_render_rays (the render
    core's plain version) on a trunk_impl="interpret" model, against JAX's
    test-mode render on the same weights, test eps and depths."""
    jm, params, _ = _jax(SMALL)
    rays = _rays(32, seed=5)
    rc = jrender.RenderConfig(n_samples=16, perturb=False, use_viewdirs=True,
                              white_bkgd=True)
    ref = jax.jit(jrender.make_render_rays(_apply(jm), rc), static_argnames=("is_test",))(
        params, *map(jnp.asarray, rays), None, is_test=True)
    model = _model(SMALL, "interpret")
    with torch.no_grad():
        out = make_render_rays(model, RenderConfig(n_samples=16, perturb=False,
                                                   white_bkgd=True))(
            *map(T, rays), None, is_test=True)
    assert tuple(out["rgb_map"].shape) == (32, 3, SMALL.k)
    _assert_maps_close(out, ref, MAPS)


def test_hierarchical_render_matches_jax_with_interpreted_trunks():
    """The coarse + fine pair at D4/W256 (8 + 8 samples), both nets'
    trunks interpreted, against JAX's hierarchical render."""
    jm, pc, ec = _jax(SMALL, 0)
    jmf, pf, ef = _jax(SMALL, 1)
    rays = _rays(32, seed=6)
    rc = jrender.RenderConfig(n_samples=8, n_importance=8, perturb=False, use_viewdirs=True)
    fn = jax.jit(jrender.make_render_rays(_apply(jm), rc, _apply(jmf)),
                 static_argnames=("is_test",))
    ref = fn({"coarse": pc, "fine": pf}, *map(jnp.asarray, rays), None, is_test=True)
    sd, sd_fine = nerf_flows_pair_state_dicts_from_jax({"coarse": pc, "fine": pf}, ec, ef)
    nets = []
    for state in (sd, sd_fine):
        net = NeRFFlows(net_depth=4, net_width=256, skips=(2,), h_alpha_size=64,
                        h_rgb_size=64, n_flows=SMALL.flows, k_samples=SMALL.k,
                        trunk_impl="interpret")
        net.load_state_dict(state)
        nets.append(net)
    with torch.no_grad():
        out = make_render_rays(nets[0], RenderConfig(n_samples=8, n_importance=8,
                                                     perturb=False),
                               model_fine=nets[1])(*map(T, rays), None, is_test=True)
    _assert_maps_close(out, ref, HIER_MAPS)


# ---------------------------------------------------------------------- #
# routing: CPU -> plain; CUDA -> kernel or raise; never a quiet fallback
# ---------------------------------------------------------------------- #


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the routing can be
    tested on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Entry:
    """A stand-in for a ctypes kernel entry: records each call and runs
    `body` on its arguments; returns `ret` (0: no CUDA error)."""

    argtypes = None
    restype = None

    def __init__(self, body, ret=0):
        self.calls, self.body, self.ret = [], body, ret

    def __call__(self, *a):
        self.calls.append(a)
        self.body(*a)
        return self.ret


@contextlib.contextmanager
def _no_cuda_context():
    yield 0  # stream handle


def _no_plain(*a, **k):
    raise AssertionError("the plain version ran for a CUDA tensor")


def _on_cuda(packed):
    return dataclasses.replace(packed, w=packed.w.as_subclass(_OnCuda),
                               b=packed.b.as_subclass(_OnCuda))


def _packed(cfg=SMALL):
    with torch.no_grad():
        return pack_trunk_weights(_model(cfg))


def test_cpu_route_is_plain_and_counts_no_launch():
    packed, x = _packed(), T(_x(20, seed=7))
    before = trunk_encode.launches
    with torch.no_grad():
        for a, p in zip(trunk_encode(packed, x), trunk_encode_plain(packed, x)):
            torch.testing.assert_close(a, p, rtol=0, atol=0)
    assert trunk_encode.launches == before


def test_cuda_route_launches_the_kernel(monkeypatch):
    """The embedding goes in as it is (row stride 90, no cast or pad copy);
    the outputs come back at their true widths; one launch is counted."""
    seen = {}

    def body(*a):  # emb, stride, w, b, h_alpha, h_rgb, B, D, W, in, v, ha, hr, stream
        seen["ints"] = a[6:13]
        seen["stride"] = a[1]
        for ptr, n in ((a[4], a[6] * a[11]), (a[5], a[6] * a[12])):
            np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))[:] = 1.5

    entry = _Entry(body)
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(trunk_fwd=entry))
    monkeypatch.setattr(trunk, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(trunk, "trunk_encode_plain", _no_plain)
    packed = _on_cuda(_packed())
    x = T(_x(10, seed=8)).as_subclass(_OnCuda)
    before = trunk_encode.launches
    with torch.inference_mode():
        ha, hr = trunk_encode(packed, x)
    assert trunk_encode.launches == before + 1
    assert seen["stride"] == IN_CH + V_CH
    assert seen["ints"] == (10, 4, 256, IN_CH, V_CH, 64, 64)
    assert tuple(ha.shape) == (10, 64) and bool((ha == 1.5).all()) and bool((hr == 1.5).all())


@pytest.mark.parametrize("trunk_impl", ["pallas", "interpret"])
def test_a_required_gradient_goes_through_the_function(monkeypatch, trunk_impl):
    """On CPU tensors a required gradient takes `_Trunk` with the plain
    versions (no launch, no build); without one the plain forward runs
    alone.  Both give the plain forward's values."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no launch expected"))
    model = _model(SMALL, trunk_impl)
    x = T(_x(8, seed=9))
    ha, hr = model.encode(x)
    # encode reshapes the Function's output to x's leading dimensions
    assert type(ha.grad_fn.next_functions[0][0]).__name__ == "_TrunkBackward"
    with torch.no_grad():
        ref = trunk_encode_plain(pack_trunk_weights(model), x)
        ha0, _ = model.encode(x)
    assert ha0.grad_fn is None
    torch.testing.assert_close(ha.detach(), ref[0], rtol=0, atol=0)
    torch.testing.assert_close(hr.detach(), ref[1], rtol=0, atol=0)
    before = trunk.trunk_encode_bwd.launches
    (ha.sum() + hr.sum()).backward()
    assert trunk.trunk_encode_bwd.launches == before
    assert model.pts_linears[0].weight.grad is not None


def test_cuda_route_raises_instead_of_falling_back(monkeypatch):
    def failed_build(name):
        raise RuntimeError("kernel build failed: simulated")

    monkeypatch.setattr(trunk, "trunk_encode_plain", _no_plain)
    monkeypatch.setattr(_build, "load", failed_build)
    before = trunk_encode.launches
    with torch.no_grad(), pytest.raises(RuntimeError, match="build failed"):
        trunk_encode(_on_cuda(_packed()), T(_x(4, seed=1)).as_subclass(_OnCuda))
    assert trunk_encode.launches == before


def test_other_devices_and_mixed_devices_raise():
    packed, x = _packed(), T(_x(4, seed=2))
    with torch.no_grad():
        with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
            trunk_encode(_on_cuda(packed), x)
        with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
            trunk_encode(packed, x.as_subclass(_OnCuda))
        with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
            trunk_encode(packed, x.to("meta"))
        with pytest.raises(ValueError, match="expected"):
            trunk_encode(packed, x[:, :80])


def test_kernel_refuses_what_its_layout_cannot_take(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("no launch expected"))
    packed, x = _packed(), T(_x(4, seed=3))
    with pytest.raises(ValueError, match="contiguous"):
        trunk._launch(packed, x.t().contiguous().t())
    with pytest.raises(ValueError, match="float32"):
        trunk._launch(packed, x.double())


TRUNK_SOURCES = ("trunk.cu", "trunk.cuh", "trunk_bwd.cu", "hopper.cuh")


def test_kernel_source_is_built_for_hopper():
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "trunk" in _build.KERNELS
    src = (_build.CSRC / "trunk.cu").read_text()
    assert 'extern "C" int trunk_fwd' in src
    assert "cfnerf_tpu/ops/pallas/trunk.py:_fwd_kernel" in src
    # the Hopper pieces come from the header both trunk sources include, the
    # shared layouts from trunk.cuh
    for name in ("trunk.cu", "trunk_bwd.cu"):
        text = (_build.CSRC / name).read_text()
        assert '#include "hopper.cuh"' in text and '#include "trunk.cuh"' in text, name
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    # wgmma on TMA-streamed weights behind mbarriers, the activations handed
    # to the products through the async proxy, the saves by TMA store
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "fence.proxy.async", "mbarrier",
                "cp.async.bulk.wait_group.read"):
        assert ptx in src + hopper, ptx
    for call in ("wgmma_ss<", "tma_load(", "tma_store(", "fence_proxy_async()", "mbar_wait(",
                 "bulk_wait_read<", "setmaxnreg"):
        assert call in src, call
    for name in TRUNK_SOURCES:  # no mma.sync fragments left in any trunk source
        assert "wmma::" not in (_build.CSRC / name).read_text(), name
    assert "atomicAdd" not in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert trunk.REPLACES == "cfnerf_tpu/ops/pallas/trunk.py:160"


def _act_offsets(B, depth, width, in_pad, v_pad):
    """ActPlan's offsets as csrc/trunk.cuh writes them, spelled out here:
    rows_pad = B rounded up to 64; x, v, then h_0..h_{D-1} and f in one
    block, then hv; each region 256-aligned."""
    R = (B + 63) // 64 * 64
    up = lambda n: (n + 255) // 256 * 256
    x = 0
    v = x + up(R * in_pad * 2)
    h = v + up(R * v_pad * 2)
    hv = h + up((depth + 1) * R * width * 2)
    return R, {"x": x, "v": v, "h": h, "f": h + depth * R * width * 2, "hv": hv,
               "bytes": hv + up(R * width // 2 * 2)}


@pytest.mark.parametrize("cfg,B", [(WIDE, 150), (SMALL, 77)], ids=["D8W512_B150", "D4W256_B77"])
def test_workspace_views_read_back_the_saved_activations(cfg, B, monkeypatch):
    """A workspace written at ActPlan's offsets from `_forward`'s activations
    (the padded rows past B filled with NaN bits) reads back exactly, with
    the offsets taken from the library's trunk_fwd_act_plan entry (here a
    stand-in that answers with the offsets spelled out above)."""
    packed, x = _packed(cfg), T(_x(B, seed=21))
    with torch.no_grad():
        xb, vb, hs, f, hv = trunk._forward(packed, x)
    R, off = _act_offsets(B, cfg.depth, cfg.width, xb.shape[1], vb.shape[1])

    def plan_body(*a):  # B, depth, width, input_ch, views_ch, out
        assert a[:5] == (B, cfg.depth, cfg.width, IN_CH, V_CH)
        for i, v in enumerate([R] + [off[k] for k in ("x", "v", "h", "f", "hv", "bytes")]):
            a[5][i] = v

    entry = _Entry(plan_body)
    monkeypatch.setattr(_build, "load",
                        lambda name: types.SimpleNamespace(trunk_fwd_act_plan=entry))
    acts = torch.full((off["bytes"],), 0xFF, dtype=torch.uint8)

    def write(at, t):
        acts[at:at + R * t.shape[1] * 2].view(torch.bfloat16).view(R, -1)[:B] = t.bfloat16()

    write(off["x"], xb)
    write(off["v"], vb)
    for i, h in enumerate(hs):
        write(off["h"] + i * R * cfg.width * 2, h)
    write(off["f"], f)
    write(off["hv"], hv)
    got = trunk.workspace_views(packed, B, acts)
    want = (xb, vb, hs, f, hv)
    for name, a, b in zip(("xb", "vb", "hs", "f", "hv"), got, want):
        for i, (ai, bi) in enumerate(zip(a, b) if name == "hs" else [(a, b)]):
            assert ai.shape == bi.shape and torch.equal(ai, bi), (name, i)
    assert len(entry.calls) == 1
    with pytest.raises(ValueError, match="bytes"):
        trunk.workspace_views(packed, B, acts[:-1])


# ---------------------------------------------------------------------- #
# golden for the card: pallas_encode (interpreted) on a D4/W256 trunk
# ---------------------------------------------------------------------- #


def trunk_golden_arrays():
    _, params, eps = _jax(SMALL)
    x = _x(256, seed=11)
    ha, hr = jax_encode(SMALL, params, x)
    arrays = {f"p/{path}": leaf for path, leaf in _flatten(params)}
    arrays["test_eps_a"], arrays["test_eps_r"] = eps
    arrays["config"] = np.array([SMALL.depth, SMALL.width, SMALL.k, SMALL.flows,
                                 SMALL.h_alpha, SMALL.h_rgb], np.int64)
    arrays["x"] = x
    arrays["jax/h_alpha"], arrays["jax/h_rgb"] = ha, hr
    return arrays


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val, np.float32)


def save_trunk_golden():
    np.savez_compressed(GOLDEN, **trunk_golden_arrays())


def test_trunk_golden_is_current():
    assert GOLDEN.exists(), "run: python -m tests.test_torch_trunk"
    assert GOLDEN.stat().st_size < 2 << 20
    fresh = trunk_golden_arrays()
    with np.load(GOLDEN) as saved:
        assert set(saved.files) == set(fresh)
        for k in fresh:
            if k.startswith("jax/"):
                # XLA's CPU dots are deterministic on one build; the margin
                # only absorbs a thread-count-dependent summation order
                np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-6, atol=1e-7,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_trunk_golden_through_the_plain_version():
    """What chip_smoke.py does on the card, here through the plain version."""
    with np.load(GOLDEN) as g:
        g = {k: g[k] for k in g.files}
    D, W, K, F, ha, hr = (int(v) for v in g["config"])
    params = {}
    for k, v in g.items():
        if k.startswith("p/"):
            node = params
            *parents, leaf = k[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    model = port_nerf_flows(Tiny(depth=D, width=W, k=K, flows=F, h_alpha=ha, h_rgb=hr),
                            params, (g["test_eps_a"], g["test_eps_r"]), trunk_impl="pallas")
    with torch.no_grad():
        out = model.encode(T(g["x"]))
    _assert_enc_close(out, (g["jax/h_alpha"], g["jax/h_rgb"]))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_trunk_golden()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
