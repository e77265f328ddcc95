"""--compute_dtype bfloat16 on the xla trunk: the port's NeRFFlows against
cfnerf_tpu's NeRFFlows(compute_dtype=jnp.bfloat16) on converted weights,
plus the golden file that lets chip_smoke.py hold the card's bf16 render
against JAX numbers.

JAX runs op by op here (model.apply, the renderer and the step's `_update`
without jit), as its source rounds each bf16 product and add: under jit XLA
may skip those roundings (xla_allow_excess_precision; the jitted encode's
h_rgb differs from the op-by-op one by one bf16 ulp on half its entries).

Tolerances, and why:
  * encode: the same bf16 products of the same f32 sums, rounded once each,
    then the bias added and rounded: bitwise equal at D4/W64 and D2/W32
    (where the heads read the skip concatenation); at D8/W512 PyTorch's and
    XLA's 512-long f32 sums differ in their last bits and ~0.2% of the
    entries round to the neighbouring bf16 value, and on through the layers:
    atol 2e-3 (measured <= 4.9e-4 on outputs up to ~0.2);
  * renders: the same encode, then f32 flows and composite: the render
    tolerances of tests/test_torch_render.py (rtol = atol = 2e-5);
  * one training step: loss and metrics rtol 1e-5; gradients per leaf
    relative RMS <= 2e-2 and cosine >= 0.9999: the backward's bf16 products
    sum in another order and round apart now and then, and each rounding on
    the way down to the first layers adds to it (measured <= 1.07e-2 /
    >= 0.99995, the biases of the heads and first layers);
  * the golden on the card (chip_smoke.py) is held at rtol = atol = 2e-3:
    cuBLAS sums each bf16 product in another order than XLA's CPU dot, so a
    trunk entry lands one bf16 ulp (2^-8 relative) apart here and there, and
    the flows and the composite carry that into the maps (measured 2.3e-4
    on an H100).  The maps alone would not tell the bf16 trunk from the f32
    one (the f32 trunk's maps lie within 5.7e-4 of these), so the golden also
    holds JAX's bf16 encode of 1024 rows: bitwise equal here, and on the
    card at least chip_smoke.py's BF16_ENCODE_EQUAL_MIN of its entries
    bitwise equal, which the f32 trunk (its outputs not bf16 values) misses
    by far.

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_bf16
(test_bf16_golden_is_current fails while the committed file is stale).
"""
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.models.nerf_flows import NeRFFlows as JaxNeRFFlows
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
from cfnerf_torch.models.factory import build_model
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays, render_image
from cfnerf_torch.train.step import TrainConfig, make_train_step
from tests.test_torch_common import FLAGSHIP, Tiny, jax_nerf_flows, to_np
from tests.test_torch_train import (
    LOSS_RTOL,
    TRAIN_KW,
    _flatten,
    _grads_in_opt_state,
    _port_names,
    jax_draws,
    make_batch,
    port_z_vals,
)

GOLDEN = Path(__file__).parent / "fixtures" / "torch_port_bf16_golden.npz"
CFG = Tiny(depth=4, width=64, k=8, flows=2, h_alpha=16, h_rgb=16)
STEP_CFG = Tiny(depth=2, width=32, k=8, flows=2, h_alpha=16, h_rgb=16)
VIEW = dict(H=12, W=12, focal=14.0, ndc=False, use_viewdirs=True, near=2.0, far=6.0)
N_SAMPLES = 32
MAPS = ("rgb_map", "depth_map", "acc_map", "disp_map")
MAP_TOL = dict(rtol=2e-5, atol=2e-5)
GOLDEN_ENCODE_ROWS = 1024
GRAD_REL_RMS, GRAD_MIN_COS = 2e-2, 0.9999
T = torch.as_tensor


def jax_bf16(cfg: Tiny, seed=0):
    """JAX's bf16 model beside the f32 one's params and test eps (the
    parameters are f32 in both)."""
    _, params, test_eps = jax_nerf_flows(cfg, seed)
    model = JaxNeRFFlows(
        net_depth=cfg.depth, net_width=cfg.width, input_ch=63,
        input_ch_views=cfg.views_ch, skips=(cfg.depth // 2,), h_alpha_size=cfg.h_alpha,
        h_rgb_size=cfg.h_rgb, n_flows=cfg.flows, k_samples=cfg.k,
        use_viewdirs=cfg.use_viewdirs, type_flows="triangular", compute_dtype=jnp.bfloat16)
    return model, params, test_eps


def port_bf16(cfg: Tiny, params, test_eps) -> NeRFFlows:
    model = NeRFFlows(
        net_depth=cfg.depth, net_width=cfg.width, input_ch=63, input_ch_views=cfg.views_ch,
        skips=(cfg.depth // 2,), h_alpha_size=cfg.h_alpha, h_rgb_size=cfg.h_rgb,
        n_flows=cfg.flows, k_samples=cfg.k, use_viewdirs=cfg.use_viewdirs,
        compute_dtype=torch.bfloat16)
    model.load_state_dict(nerf_flows_state_dict_from_jax(params, test_eps))
    return model


def _x(cfg, n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 63 + cfg.views_ch)).astype(np.float32)


def _c2w():
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.3, -0.2, 4.0]
    return c2w


# ---------------------------------------------------------------------- #
# encode, render
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("cfg", [CFG, STEP_CFG, Tiny(use_viewdirs=False), FLAGSHIP],
                         ids=["d4w64", "d2w32_skip_heads", "no_viewdirs", "flagship"])
def test_encode_matches_jax_bf16(cfg):
    jm, params, test_eps = jax_bf16(cfg)
    model = port_bf16(cfg, params, test_eps)
    x = _x(cfg, 256)
    ref = jm.apply({"params": params}, jnp.asarray(x), method=JaxNeRFFlows.encode)
    with torch.no_grad():
        out = model.encode(T(x))
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        if cfg is FLAGSHIP:
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=0, atol=2e-3)
        else:
            np.testing.assert_array_equal(to_np(a), np.asarray(b))
    # not the f32 trunk
    with torch.no_grad():
        model.compute_dtype = torch.float32
        assert not torch.equal(model.encode(T(x))[1], out[1])


def _jax_bf16_render(params, test_eps):
    """JAX's op-by-op test-mode render of the view, unfused."""
    jm, _, _ = jax_bf16(CFG)
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, perturb=False, use_viewdirs=True,
                              white_bkgd=True)

    def apply(p, x, *, is_test, rng):
        return jm.apply({"params": p}, x, is_test=is_test, rng=rng)

    from cfnerf_tpu.ops.rays import get_rays

    kw = {k: VIEW[k] for k in ("H", "W", "focal", "ndc", "use_viewdirs", "near", "far")}
    ro, rd = get_rays(VIEW["H"], VIEW["W"], VIEW["focal"], jnp.asarray(_c2w()))
    rays = jrender.prepare_rays(ro, rd, **kw)
    out = jrender.make_render_rays(apply, rc)(params, *rays, None, is_test=True)
    return {k: np.asarray(out[k]).reshape(VIEW["H"], VIEW["W"], *out[k].shape[1:])
            for k in MAPS}


def _port_render(model):
    rc = RenderConfig(n_samples=N_SAMPLES, perturb=False, use_viewdirs=True, white_bkgd=True)
    out = render_image(make_render_rays(model, rc), _c2w(), tile=64, device="cpu", **VIEW)
    return {k: to_np(out[k]) for k in MAPS}


def _assert_maps_close(out, ref, rtol, atol):
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(out[k], ref[k], rtol=rtol, atol=atol, err_msg=k)
    mask = ref["acc_map"] > 1e-3
    np.testing.assert_allclose(out["disp_map"][mask], ref["disp_map"][mask],
                               rtol=max(rtol, 1e-4), atol=atol, err_msg="disp_map")


def test_flat_render_matches_jax_bf16():
    _, params, test_eps = jax_bf16(CFG)
    out = _port_render(port_bf16(CFG, params, test_eps))
    _assert_maps_close(out, _jax_bf16_render(params, test_eps), **MAP_TOL)


# ---------------------------------------------------------------------- #
# one training step against JAX's make_train_step
# ---------------------------------------------------------------------- #


def test_train_step_matches_jax_bf16():
    jm, params, test_eps = jax_bf16(STEP_CFG)
    batch = make_batch(20, 7, seed=0)
    key = jax.random.PRNGKey(3)
    n = 13
    cfg = jstep.TrainConfig(**TRAIN_KW)
    rc = jrender.RenderConfig(n_samples=n, perturb=True, use_viewdirs=True, fused="off")
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    _, state, jmetrics = step._update(p, tx.init(p), batch, key)
    jgrads = _port_names(state[0])
    t_rand, eps = jax_draws(key, 27, n, STEP_CFG.k)

    model = port_bf16(STEP_CFG, params, test_eps)
    tstep, optimizer = make_train_step(model, RenderConfig(n_samples=n), TrainConfig(**TRAIN_KW))
    loss, metrics = tstep.loss_fn(batch, None, z_vals=port_z_vals(t_rand, n), eps=eps)
    loss.backward()
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    for name, p_ in model.named_parameters():
        got, want = to_np(p_.grad), jgrads[name]
        assert p_.grad.dtype == torch.float32, name
        if not np.any(want):
            assert not np.any(got), name
            continue
        rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        cos = np.sum(got * want) / np.linalg.norm(got) / np.linalg.norm(want)
        assert rel <= GRAD_REL_RMS and cos >= GRAD_MIN_COS, (name, rel, cos)
    tstep.update()
    # the parameters and Adam's moments stay f32
    for p_ in model.parameters():
        assert p_.dtype == torch.float32
        assert all(v.dtype == torch.float32 for k, v in optimizer.state[p_].items()
                   if k != "step")


# ---------------------------------------------------------------------- #
# the factory
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


def test_build_model_bfloat16_trains_on_cpu():
    """--compute_dtype bfloat16 builds both nets in bf16 on f32 weights, the
    same weights as float32, and a step keeps them f32."""
    model, fine, rc = build_model(_args(compute_dtype="bfloat16", N_importance=4,
                                        netdepth_fine=2, netwidth_fine=16), device="cpu")
    assert model.compute_dtype == fine.compute_dtype == torch.bfloat16
    ref, _, _ = build_model(_args(), device="cpu")
    assert ref.compute_dtype == torch.float32
    for a, b in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    model, _, rc = build_model(_args(compute_dtype="bfloat16"), device="cpu")
    step, _ = make_train_step(model, rc, TrainConfig(**{**TRAIN_KW, "k_samples": 4}))
    metrics = step(make_batch(12, 4, seed=1), torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model(_args(compute_dtype="float16"), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        NeRFFlows(net_depth=2, net_width=16, skips=(1,), compute_dtype=torch.float16)


def test_trunk_kernels_ignore_compute_dtype():
    """trunk_impl="interpret" runs the kernels' own bf16 products whatever
    compute_dtype says, as JAX's pallas_encode does."""
    cfg = Tiny(depth=4, width=256, k=4)
    _, params, test_eps = jax_nerf_flows(cfg)
    outs = []
    for dtype in (torch.float32, torch.bfloat16):
        model = NeRFFlows(net_depth=4, net_width=256, skips=(2,), h_alpha_size=16,
                          h_rgb_size=16, n_flows=2, k_samples=4, trunk_impl="interpret",
                          compute_dtype=dtype)
        model.load_state_dict(nerf_flows_state_dict_from_jax(params, test_eps))
        with torch.no_grad():
            outs.append(model.encode(T(_x(cfg, 64))))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# golden for the card: JAX's bf16 render of a tiny model, with its weights
# ---------------------------------------------------------------------- #


def bf16_golden_arrays():
    jm, params, test_eps = jax_bf16(CFG)
    arrays = {f"p/{path}": leaf for path, leaf in _flatten(params)}
    arrays["test_eps_a"], arrays["test_eps_r"] = test_eps
    arrays["c2w"] = _c2w()
    arrays["config"] = np.array([CFG.depth, CFG.width, CFG.k, CFG.flows, CFG.h_alpha,
                                 CFG.h_rgb, N_SAMPLES, VIEW["H"], VIEW["W"]], np.int64)
    arrays["view"] = np.array([VIEW["focal"], VIEW["near"], VIEW["far"]], np.float32)
    arrays.update({f"jax/{k}": v for k, v in _jax_bf16_render(params, test_eps).items()})
    arrays["x"] = _x(CFG, GOLDEN_ENCODE_ROWS, seed=3)
    arrays["jax/h_alpha"], arrays["jax/h_rgb"] = (np.asarray(h) for h in jm.apply(
        {"params": params}, jnp.asarray(arrays["x"]), method=JaxNeRFFlows.encode))
    return arrays


def save_bf16_golden():
    np.savez_compressed(GOLDEN, **bf16_golden_arrays())


def test_bf16_golden_is_current():
    assert GOLDEN.exists(), "run: python -m tests.test_torch_bf16"
    assert GOLDEN.stat().st_size < 1 << 20
    fresh = bf16_golden_arrays()
    with np.load(GOLDEN) as saved:
        assert set(saved.files) == set(fresh)
        for k in fresh:
            if k.startswith("jax/"):
                # XLA's CPU reductions are deterministic on one build; the
                # margin only absorbs a thread-count-dependent summation order
                np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-6, atol=1e-7,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_bf16_golden_renders_through_the_port():
    """What chip_smoke.py does on the card, here through the plain version."""
    with np.load(GOLDEN) as g:
        D, W, K, F, ha, hr, n, H, Wd = (int(v) for v in g["config"])
        params = {}
        for k in g.files:
            if k.startswith("p/"):
                node = params
                *parents, leaf = k[2:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = g[k]
        model = NeRFFlows(net_depth=D, net_width=W, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K, compute_dtype=torch.bfloat16)
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            params, (g["test_eps_a"], g["test_eps_r"])))
        _assert_maps_close(_port_render(model), {k: g[f"jax/{k}"] for k in MAPS}, **MAP_TOL)
        with torch.no_grad():
            h_alpha, h_rgb = model.encode(T(g["x"]))
        np.testing.assert_array_equal(to_np(h_alpha), g["jax/h_alpha"])
        np.testing.assert_array_equal(to_np(h_rgb), g["jax/h_rgb"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_bf16_golden()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
