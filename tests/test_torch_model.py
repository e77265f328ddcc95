"""NeRFFlows and the model factory: port vs cfnerf_tpu on converted weights.

Eps is injected (torch cannot reproduce JAX's PRNG) or, in test mode,
carried across with the weights.  Tolerances: rtol/atol 2e-5 at D=4/W=64;
rtol 1e-4 / atol 2e-5 at the flagship widths, where XLA's and PyTorch's CPU
matmuls sum 512-wide products in different orders through eight layers.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.models.nerf_flows import NeRFFlows as JaxNeRFFlows
from cfnerf_tpu.ops.compositing import raw2outputs as jax_raw2outputs
from cfnerf_torch.models.factory import build_model, init_params
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays
from tests.test_torch_common import (
    FLAGSHIP,
    Tiny,
    dists_np,
    jax_nerf_flows,
    port_nerf_flows,
    to_np,
)

T = torch.as_tensor
SMALL_TOL = dict(rtol=2e-5, atol=2e-5)
WIDE_TOL = dict(rtol=1e-4, atol=2e-5)


def _x(cfg, n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 63 + cfg.views_ch)).astype(np.float32)


def _eps(cfg, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(cfg.k, 1).astype(np.float32), rng.randn(cfg.k, 3).astype(np.float32))


def _both(cfg):
    jm, params, test_eps = jax_nerf_flows(cfg)
    return jm, params, port_nerf_flows(cfg, params, test_eps)


@pytest.mark.parametrize("cfg", [Tiny(), Tiny(use_viewdirs=False), FLAGSHIP],
                         ids=["tiny", "no_viewdirs", "flagship"])
def test_encode_matches(cfg):
    jm, params, model = _both(cfg)
    x = _x(cfg, 64)
    ja, jr = jm.apply({"params": params}, jnp.asarray(x), method=JaxNeRFFlows.encode)
    with torch.no_grad():
        ta, tr = model.encode(T(x))
    tol = WIDE_TOL if cfg is FLAGSHIP else SMALL_TOL
    np.testing.assert_allclose(to_np(ta), np.asarray(ja), **tol)
    np.testing.assert_allclose(to_np(tr), np.asarray(jr), **tol)


@pytest.mark.parametrize("is_test", [True, False])
def test_call_with_injected_eps_matches(is_test):
    cfg = Tiny()
    jm, params, model = _both(cfg)
    x, eps = _x(cfg, 96, seed=2), _eps(cfg)
    jraw, jent = jm.apply({"params": params}, jnp.asarray(x), is_test=is_test,
                          eps=tuple(map(jnp.asarray, eps)))
    with torch.no_grad():
        raw, ent = model(T(x), is_test=is_test, eps=eps)
    assert tuple(raw.shape) == (96, cfg.k, 4)
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **SMALL_TOL)
    np.testing.assert_allclose(float(ent), float(jent), rtol=2e-5, atol=2e-5)
    if is_test:
        # the last draw is the mean sample even for injected eps
        assert float(ent) == 0.0


def test_test_mode_uses_the_carried_over_eps_buffers():
    cfg = Tiny()
    jm, params, model = _both(cfg)
    x = _x(cfg, 32, seed=3)
    jraw, _ = jm.apply({"params": params}, jnp.asarray(x), is_test=True)
    with torch.no_grad():
        raw, _ = model(T(x), is_test=True)
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **SMALL_TOL)


@pytest.mark.parametrize("is_test", [True, False])
def test_forward_composited_matches_jax_kernel_path(is_test):
    # R=128, S=16: a shape the JAX Pallas kernel takes (run interpreted)
    cfg = Tiny()
    jm, params, model = _both(cfg)
    R, S = 128, 16
    rng = np.random.RandomState(4)
    x = _x(cfg, R * S, seed=5)
    z_vals = (np.sort(rng.rand(R, S), -1) * 4 + 2).astype(np.float32)
    d_pts = dists_np(z_vals, rng.randn(R, 3).astype(np.float32))
    eps = _eps(cfg, seed=6)
    jout = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(z_vals.ravel()),
                    jnp.asarray(d_pts.ravel()), S, is_test=is_test,
                    eps=tuple(map(jnp.asarray, eps)), interpret=True,
                    method=JaxNeRFFlows.forward_composited)
    with torch.no_grad():
        tout = model.forward_composited(T(x), T(z_vals.ravel()), T(d_pts.ravel()), S,
                                        is_test=is_test, eps=eps)
    for name, a, b in zip(("rgb", "depth", "acc", "entropy"), tout, jout):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=2e-5, atol=2e-4,
                                   err_msg=name)


def test_forward_composited_hands_the_kernel_contiguous_float32(monkeypatch):
    """The CUDA kernel refuses strided or non-f32 inputs; the CPU route
    does not check, so the model's side of the contract is checked here."""
    from cfnerf_torch.models import nerf_flows

    seen = []

    def spy(*args):
        seen.extend(args[:10])
        return render_core_plain(*args)

    from cfnerf_torch.ops.kernels.render_core import (
        fused_flow_composite_plain as render_core_plain,
    )

    monkeypatch.setattr(nerf_flows, "fused_flow_composite", spy)
    model = NeRFFlows(net_depth=2, net_width=16, skips=(1,), h_alpha_size=8,
                      h_rgb_size=8, n_flows=3, k_samples=4)
    R, S = 3, 5
    z = torch.linspace(2, 6, S).repeat(R)
    with torch.no_grad():
        model.forward_composited(torch.rand(R * S, 90), z, torch.ones(R * S), S,
                                 is_test=True)
    assert len(seen) == 10
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in seen)


def test_flagship_widths_on_128_sample_rays():
    """D=8, W=512, h=64/64, F=4, K=32 on 4 rays x 128 samples: the port's
    unfused forward and its fused path against JAX's forward + raw2outputs
    (the JAX kernel cannot take R=4)."""
    cfg = FLAGSHIP
    jm, params, model = _both(cfg)
    R, S = 4, 128
    rng = np.random.RandomState(7)
    x = _x(cfg, R * S, seed=8)
    z_vals = (np.sort(rng.rand(R, S), -1) * 4 + 2).astype(np.float32)
    rays_d = rng.randn(R, 3).astype(np.float32)
    jraw, _ = jm.apply({"params": params}, jnp.asarray(x), is_test=True)
    jrgb, _, jacc, _, jdepth = jax_raw2outputs(
        jraw.reshape(R, S, cfg.k, 4), jnp.asarray(z_vals), jnp.asarray(rays_d))
    with torch.no_grad():
        raw, _ = model(T(x), is_test=True)
        rgb, depth, acc, _ = model.forward_composited(
            T(x), T(z_vals.ravel()), T(dists_np(z_vals, rays_d).ravel()), S, is_test=True)
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **WIDE_TOL)
    for name, a, b in (("rgb", rgb, jrgb), ("depth", depth, jdepth), ("acc", acc, jacc)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4, atol=2e-4,
                                   err_msg=name)


def test_training_eps_come_from_the_generator():
    model = NeRFFlows(net_depth=2, net_width=16, skips=(1,), h_alpha_size=8,
                      h_rgb_size=8, n_flows=2, k_samples=5)
    x = torch.rand(6, 90)
    with pytest.raises(ValueError, match="Generator"):
        model(x, is_test=False)
    with torch.no_grad():
        a, ea = model(x, is_test=False, generator=torch.Generator().manual_seed(3))
        b, eb = model(x, is_test=False, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(ea) and float(ea) == float(eb)


# ---------------------------------------------------------------------- #
# factory
# ---------------------------------------------------------------------- #


def _args(**over):
    base = dict(
        multires=10, multires_views=4, i_embed=0, use_viewdirs=True,
        netdepth=4, netwidth=32, h_alpha_size=8, h_rgb_size=8, n_flows=2,
        K_samples=4, type_flows="triangular", N_importance=0, N_samples=16,
        perturb=1.0, white_bkgd=False, raw_noise_std=0.0, seed=0,
    )
    base.update(over)
    return types.SimpleNamespace(**base)


def test_build_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_args())


def test_build_model_on_cpu():
    model, model_fine, rc = build_model(_args(), device="cpu")
    assert model_fine is None
    assert model.input_ch == 63 and model.input_ch_views == 27
    assert model.skips == (2,) and rc.n_samples == 16 and rc.perturb
    assert next(model.parameters()).device.type == "cpu"
    again, _, _ = build_model(_args(), device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)  # weights from the seed
    other, _, _ = build_model(_args(seed=1), device="cpu")
    assert not torch.equal(model.pts_linears[0].weight, other.pts_linears[0].weight)


def test_init_params_uses_the_linear_default_bound():
    model = init_params(NeRFFlows(net_depth=2, net_width=64, skips=(1,)), seed=0)
    w = model.pts_linears[1].weight.detach()
    bound = 1.0 / 64 ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert float(model.test_eps_a[-1]) == 0.0 and float(model.test_eps_r[-1].abs().sum()) == 0.0


@pytest.mark.parametrize("over,message", [
    (dict(type_flows="realnvp"), "type_flows='realnvp' has no implementation"),
    (dict(type_flows="glow"), "type_flows='glow' has no implementation"),
])
def test_configurations_of_later_slices_raise(over, message):
    """Every flow family and model JAX implements builds (slice 7,
    tests/test_torch_families.py); realnvp and glow, whose sources the
    reference deleted, raise JAX's ValueError."""
    with pytest.raises(ValueError, match=message):
        build_model(_args(**over), device="cpu")


def test_build_model_with_compute_dtype_bfloat16_on_cpu():
    """--compute_dtype bfloat16: the xla trunk in bf16 on f32 parameters."""
    model, _, _ = build_model(_args(compute_dtype="bfloat16"), device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        h_alpha, h_rgb = model.encode(torch.rand(5, 90))
    assert h_alpha.dtype == h_rgb.dtype == torch.float32


def test_build_model_with_n_importance_on_cpu():
    model, model_fine, rc = build_model(
        _args(N_importance=64, netdepth_fine=2, netwidth_fine=16), device="cpu")
    assert rc.n_importance == 64
    assert (model_fine.net_depth, model_fine.net_width, model_fine.skips) == (2, 16, (1,))
    assert next(model_fine.parameters()).device.type == "cpu"


# ---------------------------------------------------------------------- #
# --fused_render and --flow_impl: each value reaches its path, or raises
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("flag,fused", [
    ("auto", "on"), ("on", "on"), ("off", "off"), ("interpret", "interpret"),
])
def test_factory_resolves_fused_render(flag, fused):
    """auto resolves to the render core (the kernel on the card), as JAX's
    factory resolves it to its kernel on a TPU."""
    _, _, rc = build_model(_args(fused_render=flag), device="cpu")
    assert rc.fused == fused


@pytest.mark.parametrize("flag", ["auto", "xla", "pallas", "interpret"])
def test_factory_passes_flow_impl_to_both_nets(flag):
    model, fine, _ = build_model(_args(flow_impl=flag, N_importance=8, netdepth_fine=2,
                                       netwidth_fine=16), device="cpu")
    assert model.flow_impl == fine.flow_impl == flag


@pytest.mark.parametrize("over", [dict(fused_render="yes"), dict(flow_impl="triton")],
                         ids=["fused_render", "flow_impl"])
def test_unknown_implementation_choices_raise(over):
    with pytest.raises(ValueError, match=next(iter(over))):
        build_model(_args(**over), device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        if "flow_impl" in over:
            NeRFFlows(net_depth=2, net_width=16, skips=(1,), **over)
        else:
            make_render_rays(NeRFFlows(net_depth=2, net_width=16, skips=(1,)),
                             RenderConfig(fused=over["fused_render"]))


def _render(model, rc, seed=0):
    rng = np.random.RandomState(seed)
    o = (rng.randn(6, 3) * 0.3 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full((6, 1), 2.0, np.float32), np.full((6, 1), 6.0, np.float32)
    return make_render_rays(model, rc)(*map(T, (o, d, vd, near, far)),
                                       torch.Generator().manual_seed(1), is_test=False)


def _raises(*a, **k):
    raise AssertionError("the kernel entry was called")


@pytest.mark.parametrize("fused", ["on", "off", "interpret"])
def test_fused_render_value_picks_its_path(monkeypatch, fused):
    """'on' calls the render core's entry (the kernel on the card); 'off'
    takes the unfused path, whose train-mode render returns the per-sample
    weights; 'interpret' the render core's plain version, never the entry.
    All three render the same rays alike."""
    from cfnerf_torch.models import nerf_flows as nf

    model, _, rc = build_model(_args(fused_render=fused), device="cpu")
    ref = _render(model, dataclasses.replace(rc, fused="off"))
    calls = []
    real = nf.fused_flow_composite
    monkeypatch.setattr(nf, "fused_flow_composite",
                        lambda *a: calls.append(1) or real(*a))
    out = _render(model, rc)
    assert len(calls) == (1 if fused == "on" else 0)
    assert ("weights" in out) == (fused == "off")
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(to_np(out[k]), to_np(ref[k]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flow_impl", ["auto", "xla", "pallas", "interpret"])
def test_flow_impl_value_picks_its_path(monkeypatch, flow_impl):
    """'auto' and 'pallas' call the flow-stack entry (the kernel on the
    card); 'xla' and 'interpret' its plain version, never the entry."""
    from cfnerf_torch.models import nerf_flows as nf

    model, _, rc = build_model(_args(flow_impl=flow_impl, fused_render="off"), device="cpu")
    calls = []
    real = nf.fused_flow_stack
    monkeypatch.setattr(nf, "fused_flow_stack", lambda *a: calls.append(1) or real(*a))
    out = _render(model, rc)
    assert len(calls) == (2 if flow_impl in ("auto", "pallas") else 0)
    assert bool(torch.isfinite(out["rgb_map"]).all())
