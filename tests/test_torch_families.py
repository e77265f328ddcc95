"""The other flow families (no_flow, householder, orthogonal, planar, IAF):
their flow functions, amortizers, IAF, NeRFFlows of each family, one
training step, sample and interpolation, the weight maps, the factory's
resolution of --fused_render; plus the golden file that lets chip_smoke.py
hold the card's families and baselines against JAX numbers.

Same seeded numpy inputs through JAX (CPU) and the port (CPU, plain).
Tolerances, and why:
  * flow functions, amortizers, IAF: values rtol = atol = 1e-5, gradients
    (jax.vjp against autograd, random cotangents) rtol 1e-4 / atol 1e-6:
    the same f32 arithmetic, the Z sums unrolled in another order;
  * NeRFFlows maps and raw: rtol = atol = 1e-4 (the f32 map rule; XLA's and
    PyTorch's CPU matmuls sum in other orders); entropy rtol 1e-5;
  * one training step: loss and metrics rtol = atol = 1e-4 (the f32 rule;
    planar's log|1 + psi| amplifies rounding where 1 + psi nears 0:
    measured 1.2e-5 relative), gradients rtol 1e-4 / atol 1e-6
    (tests/test_torch_train.py's rule) at D2/W32;
  * QᵀQ - I: <= 1e-6 for orthogonalize_q.

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_families
(test_families_golden_is_current fails while the committed file is stale).
"""
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.flows import amortized as jamor
from cfnerf_tpu.flows import iaf as jiaf
from cfnerf_tpu.flows import sylvester as jsyl
from cfnerf_tpu.models import factory as jfactory
from cfnerf_tpu.models.nerf_flows import NeRFFlows as JaxNeRFFlows
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import checkpoint as jckpt
from cfnerf_tpu.train import step as jstep
from cfnerf_tpu.utils.config import parse_args as jparse
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax, state_dict_from_jax
from cfnerf_torch.flows import amortized as tamor
from cfnerf_torch.flows import iaf as tiaf
from cfnerf_torch.flows import sylvester as tsyl
from cfnerf_torch.models.baseline_adapter import KSampleBaseline
from cfnerf_torch.models.factory import build_model, create_nerf, loss_mode_for_model
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays, prepare_rays
from cfnerf_torch.train.step import TrainConfig, make_train_step
from cfnerf_torch.utils.config import parse_args as tparse
from tests.test_torch_baselines import (
    jax_baseline,
    jax_test_draws,
    jax_train_draws,
    jax_wild_test_eps,
    port_baseline,
)
from tests.test_torch_common import Tiny, to_np
from tests.test_torch_train import (
    TRAIN_KW,
    _flatten,
    _grads_in_opt_state,
    jax_draws,
    make_batch,
    port_z_vals,
)

T = torch.as_tensor
ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_families_golden.npz"
FAMILIES = ("no_flow", "householder", "orthogonal", "planar", "IAF")
ALL_FAMILIES = ("triangular",) + FAMILIES
FN_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MAP_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = Tiny()  # D4/W64, K8, F2, h 16/16
STEP = Tiny(depth=2, width=32, k=8, flows=2, h_alpha=16, h_rgb=16)


def jax_family(type_flows, cfg=SMALL, seed=0, **kw):
    """(JAX NeRFFlows of the family, params as nested numpy dicts, test eps);
    the base parameters moved off their 0/1 init, as
    tests/test_torch_common.py:jax_nerf_flows does.  `kw` goes to the model
    (trunk_impl, flow_impl)."""
    model = JaxNeRFFlows(
        net_depth=cfg.depth, net_width=cfg.width, input_ch=63,
        input_ch_views=cfg.views_ch, skips=(cfg.depth // 2,), h_alpha_size=cfg.h_alpha,
        h_rgb_size=cfg.h_rgb, n_flows=cfg.flows, k_samples=cfg.k,
        use_viewdirs=cfg.use_viewdirs, type_flows=type_flows, **kw)
    x = jnp.zeros((2, 63 + cfg.views_ch), jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), x, is_test=True)["params"]
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), dict(params))
    rng = np.random.RandomState(seed + 100)
    params["alpha_mean"] = (rng.randn(1) * 0.3).astype(np.float32)
    params["alpha_std"] = (0.5 + rng.rand(1)).astype(np.float32)
    params["rgb_mean"] = (rng.randn(3) * 0.3).astype(np.float32)
    params["rgb_std"] = (0.5 + rng.rand(3)).astype(np.float32)
    eps = model.apply({"params": params}, method=JaxNeRFFlows._test_eps)
    return model, params, tuple(np.asarray(e) for e in eps)


def port_family(type_flows, cfg, params, test_eps, **kw) -> NeRFFlows:
    model = NeRFFlows(
        net_depth=cfg.depth, net_width=cfg.width, input_ch=63,
        input_ch_views=cfg.views_ch, skips=(cfg.depth // 2,), h_alpha_size=cfg.h_alpha,
        h_rgb_size=cfg.h_rgb, n_flows=cfg.flows, k_samples=cfg.k,
        use_viewdirs=cfg.use_viewdirs, type_flows=type_flows, **kw)
    model.load_state_dict(nerf_flows_state_dict_from_jax(params, test_eps, type_flows))
    return model


def flax_to_state_dict(tree, prefix=""):
    """Dense layers of a flax params tree as nn.Linear entries."""
    sd = {}
    for name, node in tree.items():
        if "kernel" in node:
            sd[f"{prefix}{name}.weight"] = T(np.array(node["kernel"]).T.copy())
            sd[f"{prefix}{name}.bias"] = T(np.array(node["bias"]))
        else:
            sd.update(flax_to_state_dict(node, f"{prefix}{name}."))
    return sd


def _x(cfg, n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 63 + cfg.views_ch)).astype(np.float32)


def _eps(k, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(k, 1).astype(np.float32), rng.randn(k, 3).astype(np.float32)


def jax_interp_eps(seed=0):
    """JAX's interpolation end draws: PRNGKey(test_eps_seed + 1), split."""
    ka, kr = jax.random.split(jax.random.PRNGKey(seed + 1))
    return (np.asarray(jax.random.normal(ka, (2, 1))), np.asarray(jax.random.normal(kr, (2, 3))))


def _vjp_check(jfun, tfun, args, n_out, seed=0):
    """Values and gradients of jfun (JAX) and tfun (torch) on the same numpy
    args, with random cotangents on every output."""
    jout, vjp = jax.vjp(jfun, *map(jnp.asarray, args))
    jout = jout if isinstance(jout, tuple) else (jout,)
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*np.shape(o)).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(map(jnp.asarray, cots)) if len(jout) > 1 else jnp.asarray(cots[0]))
    targs = [torch.tensor(a).requires_grad_() for a in args]
    tout = tfun(*targs)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(tout) == len(jout) == n_out
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **FN_TOL)
    grads = torch.autograd.grad(tout, targs, [T(c) for c in cots], allow_unused=True)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        g = np.zeros(np.shape(jg), np.float32) if g is None else to_np(g)
        assert np.all(np.isfinite(g)), i
        np.testing.assert_allclose(g, np.asarray(jg), err_msg=f"grad {i}", **GRAD_TOL)
    return tout


def _triangular(rng, B, Z):
    """(B, Z, Z) upper-triangular with tanh-bounded diagonals, as the
    amortizers give them."""
    m = np.triu(rng.randn(B, Z, Z) * 0.5, 1)
    m[:, np.arange(Z), np.arange(Z)] = np.tanh(rng.randn(B, Z))
    return m.astype(np.float32)


# ---------------------------------------------------------------------- #
# flow functions
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("compute_log_det", [True, False])
def test_general_sylvester_step_matches_jax(Z, compute_log_det):
    rng = np.random.RandomState(Z)
    B, K = 40, 6
    z = rng.randn(B, K, Z).astype(np.float32)
    r1, r2 = _triangular(rng, B, Z), _triangular(rng, B, Z)
    q = np.asarray(jsyl.householder_q(jnp.asarray(rng.randn(B, Z).astype(np.float32))))
    b = rng.randn(B, Z).astype(np.float32)
    n_out = 2 if compute_log_det else 1

    def jf(*a):
        out = jsyl.general_sylvester_step(*a, compute_log_det=compute_log_det)
        return out if compute_log_det else out[0]

    def tf(*a):
        out = tsyl.general_sylvester_step(*a, compute_log_det=compute_log_det)
        if not compute_log_det:
            assert not out[1].any()
            return out[0]
        return out

    _vjp_check(jf, tf, (z, r1, r2, q, b), n_out)


def test_householder_q_matches_jax_and_is_exact_at_zero():
    """|v|^2 <= 1e-12 gives the identity exactly, with a finite (zero)
    gradient, as JAX's where with a safe denominator gives it."""
    rng = np.random.RandomState(2)
    v = rng.randn(12, 3).astype(np.float32)
    v[0] = 0.0
    v[1] = [1e-7, 0.0, 0.0]   # |v|^2 = 1e-14: below the guard
    q = _vjp_check(jsyl.householder_q, tsyl.householder_q, (v,), 1)[0].detach()
    eye = torch.eye(3)
    assert torch.equal(q[0], eye) and torch.equal(q[1], eye)
    # |v|^2 = 4e-12, just above the guard: a reflection (its gradient, ~1/|v|,
    # is too ill-conditioned to compare)
    tiny = np.array([[2e-6, 0.0, 0.0]], np.float32)
    np.testing.assert_allclose(to_np(tsyl.householder_q(T(tiny))),
                               np.asarray(jsyl.householder_q(jnp.asarray(tiny))), **FN_TOL)
    assert float(tsyl.householder_q(T(tiny))[0, 0, 0]) == -1.0
    v1 = T(v[:1]).requires_grad_()
    tsyl.householder_q(v1).sum().backward()
    assert torch.equal(v1.grad, torch.zeros_like(v1))
    qq = q.transpose(1, 2) @ q
    assert float((qq - eye).abs().max()) <= 1e-6


@pytest.mark.parametrize("Z", [1, 3])
def test_orthogonalize_q_matches_jax_and_is_orthogonal(Z):
    rng = np.random.RandomState(3 + Z)
    m = rng.randn(30, Z, Z).astype(np.float32)
    if Z == 3:  # at Z = 1 Q is -1 whatever m is: its gradient is rounding noise
        _vjp_check(jsyl.orthogonalize_q, tsyl.orthogonalize_q, (m,), 1)
    # degenerate inputs, values only: small rows amplify the gradient's
    # rounding as 1/|row|
    m[0] = 0.0                    # every reflection the identity
    m[1, 0] = 1e-8                # one row below the guard
    m[2] = m[2, :1] * 1e-3        # near rank-deficient: rows nearly parallel
    q = tsyl.orthogonalize_q(T(m))
    np.testing.assert_allclose(to_np(q), np.asarray(jsyl.orthogonalize_q(jnp.asarray(m))),
                               **FN_TOL)
    qq = q.transpose(1, 2) @ q
    assert float((qq - torch.eye(Z)).abs().max()) <= 1e-6
    assert torch.equal(q[0], torch.eye(Z))


@pytest.mark.parametrize("Z", [1, 3])
def test_planar_step_matches_jax(Z):
    rng = np.random.RandomState(5 + Z)
    B, K = 40, 6
    args = (rng.randn(B, K, Z), rng.randn(B, Z), rng.randn(B, Z), rng.randn(B))
    args = tuple(a.astype(np.float32) for a in args)
    _vjp_check(jsyl.planar_step, tsyl.planar_step, args, 2)


# ---------------------------------------------------------------------- #
# amortizers, IAF
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("family", ["householder", "orthogonal", "planar"])
def test_amortizer_matches_jax(family, Z):
    F, H = 3, 16
    h = np.random.RandomState(Z).randn(20, H).astype(np.float32)
    if family == "planar":
        jmod, tmod = jamor.AmortizedPlanar(Z, F), tamor.AmortizedPlanar(H, Z, F)
    else:
        jmod = jamor.AmortizedGeneralSylvester(Z, F, q_mode=family)
        tmod = tamor.AmortizedGeneralSylvester(H, Z, F, q_mode=family)
    params = jmod.init(jax.random.PRNGKey(Z), jnp.asarray(h))["params"]
    tmod.load_state_dict(flax_to_state_dict(params))  # the heads, JAX's names
    jouts = jmod.apply({"params": params}, jnp.asarray(h))
    houts = tmod(T(h))
    assert len(houts) == len(jouts)
    for a, b in zip(houts, jouts):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(to_np(a), np.asarray(b), **FN_TOL)
    if family == "planar":
        assert tuple(tmod.amor_b.weight.shape) == (F, H)  # (h, F) in JAX's layout


def test_made_masks_match_jax():
    for z, h in ((1, 64), (3, 64), (3, 5)):
        np.testing.assert_array_equal(tiaf.input_mask(z, h), jiaf.input_mask(z, h))
        np.testing.assert_array_equal(tiaf.output_mask(z, h), jiaf.output_mask(z, h))
        for a, b in zip(tiaf.made_degrees(z, h), jiaf.made_degrees(z, h)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("compute_log_det", [True, False])
def test_iaf_matches_jax(Z, compute_log_det):
    """IAFNeRF: ctx_proj, flow_k, the flip on odd steps, log(gate + 1e-12)
    computed and zeroed in test mode; values and gradients (inputs and
    parameters)."""
    F, C = 3, 16
    rng = np.random.RandomState(7 + Z)
    z0 = rng.randn(12, 5, Z).astype(np.float32)
    ctx = rng.randn(12, C).astype(np.float32)
    jmod = jiaf.IAFNeRF(Z, F)
    params = jmod.init(jax.random.PRNGKey(Z), jnp.asarray(z0), jnp.asarray(ctx))["params"]
    tmod = tiaf.IAFNeRF(C, Z, F)
    tmod.load_state_dict(flax_to_state_dict(params))
    assert all(isinstance(getattr(tmod, f"flow_{k}").mean, tiaf.MaskedLinear) for k in range(F))
    with torch.no_grad():  # the weights: the unmasked kernels, as JAX stores them
        np.testing.assert_array_equal(to_np(tmod.flow_0.z_feats.weight),
                                      params["flow_0"]["z_feats"]["kernel"].T)

    def jf(z, c, p):
        return jmod.apply({"params": p}, z, c, compute_log_det)

    (jz, jld), vjp = jax.vjp(jf, jnp.asarray(z0), jnp.asarray(ctx), params)
    cz, cl = rng.randn(*jz.shape).astype(np.float32), rng.randn(*jld.shape).astype(np.float32)
    gz, gc, gp = vjp((jnp.asarray(cz), jnp.asarray(cl)))
    tz0, tctx = T(z0).requires_grad_(), T(ctx).requires_grad_()
    z, ld = tmod(tz0, tctx, compute_log_det)
    np.testing.assert_allclose(to_np(z), np.asarray(jz), **FN_TOL)
    np.testing.assert_allclose(to_np(ld), np.asarray(jld), **FN_TOL)
    if not compute_log_det:
        assert not ld.any()
    (z * T(cz)).sum().add_((ld * T(cl)).sum()).backward()
    np.testing.assert_allclose(to_np(tz0.grad), np.asarray(gz), **GRAD_TOL)
    np.testing.assert_allclose(to_np(tctx.grad), np.asarray(gc), **GRAD_TOL)
    want = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gp)).items()}
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(to_np(p.grad), want[name], err_msg=name, **GRAD_TOL)


# ---------------------------------------------------------------------- #
# NeRFFlows of each family
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_covers_every_parameter(family):
    _, params, eps = jax_family(family)
    sd = nerf_flows_state_dict_from_jax(params, eps, family)
    model = port_family(family, SMALL, params, eps)  # strict
    assert set(sd) == set(model.state_dict())
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())


def test_no_flow_checkpoint_has_no_amortizers_and_loads_strictly():
    """JAX's no_flow pytree has no flows_* (flax never calls them); the
    converted state dict has no amortizer keys and loads strictly into a
    no_flow NeRFFlows, which has none either."""
    _, params, eps = jax_family("no_flow")
    assert not any(k.startswith("flows_") for k in params)
    sd = state_dict_from_jax(params, None, "no_flow", eps)
    assert not any(k.startswith("flows_") for k in sd)
    model = NeRFFlows(net_depth=4, net_width=64, skips=(2,), h_alpha_size=16, h_rgb_size=16,
                      n_flows=2, k_samples=8, type_flows="no_flow")
    assert model.flows_alpha is None and model.flows_rgb is None
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("is_test", [True, False])
def test_forward_with_injected_eps_matches_jax(family, is_test):
    jm, params, test_eps = jax_family(family)
    model = port_family(family, SMALL, params, test_eps)
    x, eps = _x(SMALL, 96, seed=2), _eps(SMALL.k)
    jraw, jent = jm.apply({"params": params}, jnp.asarray(x), is_test=is_test,
                          eps=tuple(map(jnp.asarray, eps)))
    with torch.no_grad():
        raw, ent = model(T(x), is_test=is_test, eps=eps)
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **MAP_TOL)
    np.testing.assert_allclose(float(ent), float(jent), rtol=1e-5, atol=1e-5)
    # test mode: the carried buffers
    jraw, _ = jm.apply({"params": params}, jnp.asarray(x), is_test=True)
    with torch.no_grad():
        raw, ent = model(T(x), is_test=True)
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **MAP_TOL)
    assert float(ent) == 0.0


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_composited_refuses_other_families(family):
    model = NeRFFlows(net_depth=2, net_width=16, skips=(1,), h_alpha_size=8, h_rgb_size=8,
                      n_flows=2, k_samples=4, type_flows=family)
    with pytest.raises(ValueError, match="requires type_flows='triangular'"):
        model.forward_composited(torch.rand(6, 90), torch.rand(6), torch.rand(6), 3)


@pytest.mark.parametrize("family", ["realnvp", "glow"])
def test_deleted_families_raise_jax_message(family):
    with pytest.raises(ValueError) as jerr:
        JaxNeRFFlows(type_flows=family).init(jax.random.PRNGKey(0), jnp.zeros((2, 90)),
                                             is_test=True)
    with pytest.raises(ValueError) as terr:
        NeRFFlows(type_flows=family)
    assert str(terr.value) == str(jerr.value)


def jax_family_step(family, params, batch, key, n_samples, cfg=STEP):
    """One cfnerf_tpu make_train_step step of the family (unfused).  Returns
    metrics and gradients under the port's names."""
    jm, _, _ = jax_family(family, cfg)
    rc = jrender.RenderConfig(n_samples=n_samples, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    _, state, metrics = step(p, tx.init(p), batch, key)
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state[0]), None, family)
    return {k: float(v) for k, v in metrics.items()}, {k: v.numpy() for k, v in grads.items()}


def port_step(model, batch, t_rand, eps, n_samples, loss_mode="kde"):
    """The loss half of the port's unfused step: (step, metrics, grads; a
    parameter without a gradient reads as zeros, as JAX's)."""
    step, _ = make_train_step(model, RenderConfig(n_samples=n_samples, fused="off"),
                              TrainConfig(**{**TRAIN_KW, "loss_mode": loss_mode}))
    loss, metrics = step.loss_fn(batch, None, z_vals=port_z_vals(t_rand, n_samples), eps=eps)
    loss.backward()
    grads = {n: (np.zeros(tuple(p.shape), np.float32) if p.grad is None else to_np(p.grad))
             for n, p in model.named_parameters()}
    return step, {k: float(v.detach()) for k, v in metrics.items()}, grads


# planar, Z = 1 (density): u^ = u + (m(w u) - w u) w / |w|^2 divides by
# |w|^2, and the amortizer makes w as a sum that cancels.  Where |w| is
# ~1e-4, the last bits of that sum (XLA's and PyTorch's summation orders)
# move u^ by ~1e-3 relative and the point's density draws by O(1);
# test_planar_differs_only_through_its_amortizer shows it.  The planar step
# is held where that lands: the entropy (a mean of log|1 + psi|) rtol 1e-3,
# every other metric at the f32 rule, gradients per leaf relative RMS 1e-2
# and cosine 0.9999 (measured 2.9e-4, and 7.1e-3 / 0.999988 at the worst
# leaf, h_alpha_linear.weight).
PLANAR_ENTROPY_RTOL, PLANAR_GRAD_REL_RMS, PLANAR_GRAD_MIN_COS = 1e-3, 1e-2, 0.9999


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_jax(family):
    _, params, test_eps = jax_family(family, STEP)
    n_rgb, n_depth, S = 20, 7, 13
    batch = make_batch(n_rgb, n_depth, seed=0)
    key = jax.random.PRNGKey(3)
    jmetrics, jgrads = jax_family_step(family, params, batch, key, S)
    t_rand, eps = jax_draws(key, n_rgb + n_depth, S, STEP.k)
    model = port_family(family, STEP, params, test_eps)
    _, tmetrics, tgrads = port_step(model, batch, t_rand, eps, S)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        tol = (dict(rtol=PLANAR_ENTROPY_RTOL, atol=0)
               if family == "planar" and k == "loss_entropy" else MAP_TOL)
        np.testing.assert_allclose(tmetrics[k], jmetrics[k], err_msg=k, **tol)
    assert set(tgrads) == set(jgrads)
    for name in jgrads:
        if family != "planar":
            np.testing.assert_allclose(tgrads[name], jgrads[name], err_msg=name, **GRAD_TOL)
            continue
        got, want = tgrads[name].astype(np.float64), jgrads[name].astype(np.float64)
        if not np.any(want):
            assert not np.any(got), name
            continue
        rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        cos = np.sum(got * want) / np.linalg.norm(got) / np.linalg.norm(want)
        assert rel <= PLANAR_GRAD_REL_RMS and cos >= PLANAR_GRAD_MIN_COS, (name, rel, cos)
    if family == "no_flow":
        # the draws do not depend on x: the trunk gets no gradient, in JAX too
        grad = model.pts_linears[0].weight.grad
        assert grad is None or not grad.any()
        assert not np.any(jgrads["pts_linears.0.weight"])


def test_planar_differs_only_through_its_amortizer():
    """Where the port's planar density draws leave JAX's, |w|^2 is tiny, and
    the port's planar steps on JAX's own amortizer outputs give JAX's draws:
    the difference is the amortizer's last bits over |w|^2 (a property of
    the planar family at Z = 1, JAX's as much as the port's).  Points whose
    |w|^2 >= 1e-4 at every step agree at the f32 rule."""
    jm, params, test_eps = jax_family("planar", STEP)
    model = port_family("planar", STEP, params, test_eps)
    x = _x(STEP, 5000, seed=0) * 3.0
    eps = _eps(STEP.k)

    def jax_alpha(m, x):
        h_alpha, _ = m.encode(x)
        return m.flows_alpha(h_alpha)

    jraw, _ = jm.apply({"params": params}, jnp.asarray(x), is_test=False,
                       eps=tuple(map(jnp.asarray, eps)))
    ju, jw, jb = (np.asarray(t) for t in jm.apply({"params": params}, jnp.asarray(x),
                                                 method=jax_alpha))
    with torch.no_grad():
        raw, _ = model(T(x), is_test=False, eps=eps)
        diff = (raw[..., 3] - T(np.asarray(jraw))[..., 3]).abs().amax(-1)
        w2 = (jw ** 2).sum(1).min(-1)  # the smallest |w|^2 over the steps
        worst = int(diff.argmax())
        assert float(diff[worst]) > 1e-2 and w2[worst] < 1e-6
        z = (T(eps[0]) * model.alpha_std + model.alpha_mean)[None].expand(5000, STEP.k, 1)
        for k in range(STEP.flows):
            z, _ = tsyl.planar_step(z, T(ju[..., k]), T(jw[..., k]), T(jb[..., k]))
    np.testing.assert_allclose(to_np(z[..., 0]), np.asarray(jraw)[..., 3], rtol=1e-4,
                               atol=1e-4)
    good = w2 >= 1e-4
    np.testing.assert_allclose(to_np(raw)[good], np.asarray(jraw)[good], **MAP_TOL)


@pytest.mark.parametrize("family", ALL_FAMILIES)
def test_sample_and_interpolation_match_jax(family):
    """sample: density draws from the test eps buffers; interpolation: the
    21-step walk from JAX's end draws, through both flows."""
    jm, params, test_eps = jax_family(family)
    model = port_family(family, SMALL, params, test_eps)
    x = _x(SMALL, 64, seed=4)
    js = jm.apply({"params": params}, jnp.asarray(x), method=JaxNeRFFlows.sample)
    ji = jm.apply({"params": params}, jnp.asarray(x), method=JaxNeRFFlows.interpolation)
    with torch.no_grad():
        s = model.sample(T(x))
        i = model.interpolation(T(x), eps=jax_interp_eps())
        i_default = model.interpolation(T(x))
    assert tuple(s.shape) == (64, SMALL.k, 1) and tuple(i.shape) == (64, 21, 4)
    np.testing.assert_allclose(to_np(s), np.asarray(js), **MAP_TOL)
    np.testing.assert_allclose(to_np(i), np.asarray(ji), **MAP_TOL)
    assert torch.isfinite(i_default).all() and tuple(i_default.shape) == (64, 21, 4)


def test_at_k_keeps_the_family():
    model = NeRFFlows(net_depth=2, net_width=16, skips=(1,), h_alpha_size=8, h_rgb_size=8,
                      n_flows=2, k_samples=6, type_flows="IAF")
    view = model.at_k(3)
    assert view.flows_alpha is model.flows_alpha and view.k_samples == 3
    with torch.no_grad():
        raw, _ = view(torch.rand(5, 90), is_test=True)
    assert tuple(raw.shape) == (5, 3, 4) and tuple(model.test_eps_a.shape) == (6, 1)


# ---------------------------------------------------------------------- #
# the factory
# ---------------------------------------------------------------------- #


def _args(**over):
    base = dict(
        multires=10, multires_views=4, i_embed=0, use_viewdirs=True, netdepth=4,
        netwidth=32, h_alpha_size=8, h_rgb_size=8, n_flows=2, K_samples=4,
        type_flows="triangular", N_importance=0, N_samples=16, perturb=1.0,
        white_bkgd=False, raw_noise_std=0.0, seed=0)
    base.update(over)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("over", [dict(type_flows=f) for f in ALL_FAMILIES]
                         + [dict(model=m) for m in ("nerf", "nerf_dropout", "nerf_wild",
                                                    "NeRF_Flows")],
                         ids=list(ALL_FAMILIES) + ["nerf", "nerf_dropout", "nerf_wild",
                                                   "NeRF_Flows"])
def test_fused_render_resolves_as_jax(over):
    """auto: 'on' for the triangular NeRFFlows only, else 'off'; an explicit
    on / interpret elsewhere raises JAX's message; off always builds."""
    triangular = over.get("type_flows", "triangular") == "triangular" and \
        over.get("model", "nerf_flows").lower() == "nerf_flows"
    model, _, rc = build_model(_args(**over), device="cpu")
    assert rc.fused == ("on" if triangular else "off")
    assert isinstance(model, NeRFFlows if "model" not in over or triangular
                      else KSampleBaseline)
    for mode in ("on", "interpret"):
        if triangular:
            assert build_model(_args(fused_render=mode, **over), device="cpu")[2].fused == mode
        else:
            with pytest.raises(ValueError, match=f"--fused_render={mode} requires the "
                                                 "triangular NeRFFlows model"):
                build_model(_args(fused_render=mode, **over), device="cpu")
    assert build_model(_args(fused_render="off", **over), device="cpu")[2].fused == "off"


def test_loss_mode_for_model_matches_jax():
    for name in (None, "nerf_flows", "NeRF_Flows", "nerf", "nerf_dropout", "nerf_wild"):
        assert loss_mode_for_model(name) == jfactory.loss_mode_for_model(name)


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown baseline model 'mlp'"):
        build_model(_args(model="mlp"), device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_build_model_trains_each_family_on_cpu(family):
    """Each family through build_model and the unfused step, with a fine
    net; the trunk kernels' plain versions with trunk_impl interpret."""
    model, fine, rc = build_model(_args(type_flows=family, N_importance=4, netdepth_fine=3,
                                        netwidth_fine=256, netwidth=256, netdepth=3,
                                        h_alpha_size=16, h_rgb_size=16,
                                        trunk_impl="interpret"), device="cpu")
    assert model.type_flows == fine.type_flows == family and rc.fused == "off"
    step, _ = make_train_step(model, rc, TrainConfig(**{**TRAIN_KW, "k_samples": 4}),
                              model_fine=fine)
    metrics = step(make_batch(6, 2, seed=3), torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in metrics.values())


# ---------------------------------------------------------------------- #
# scripts/jax_checkpoint_to_torch.py for a non-triangular family
# ---------------------------------------------------------------------- #


def test_jax_checkpoint_script_round_trip_householder(tmp_path, capsys):
    """A JAX householder run's Orbax checkpoint converts through the script
    and resumes in the port: the test-mode render of a few rays matches
    JAX's on the restored weights."""
    flags = ["--netdepth", "2", "--netwidth", "32", "--K_samples", "4", "--n_flows", "2",
             "--h_alpha_size", "16", "--h_rgb_size", "16", "--type_flows", "householder",
             "--use_viewdirs", "--N_samples", "16", "--dataname", "scene",
             "--expname", "exp"]
    jargs = jparse(flags + ["--basedir", str(tmp_path / "jax_logs")])
    jm, _, jrc, params, _ = jfactory.create_nerf(jargs)
    params = jax.tree_util.tree_map(lambda a: a + 0.01, params)  # off the seed's init
    jrundir = jckpt.run_dir(jargs.basedir, jargs.dataname, jargs.type_flows, jargs.expname)
    jpath = jckpt.save_checkpoint(jrundir, 5, params, None)
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", ROOT / "scripts" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--jax_ckpt", jpath] + flags
                    + ["--basedir", str(tmp_path / "port_logs")]) == 0
    model, _, rc, start = create_nerf(tparse(flags + ["--basedir", str(tmp_path / "port_logs")]),
                                      device="cpu")
    assert start == 5 and model.type_flows == "householder" and rc.fused == "off"
    assert "Reloading from" in capsys.readouterr().out
    x = _x(Tiny(depth=2, width=32), 40, seed=9)
    jraw, _ = jm.apply({"params": params}, jnp.asarray(x), is_test=True)
    with torch.no_grad():
        raw, _ = model(T(x), is_test=True)
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **MAP_TOL)


# ---------------------------------------------------------------------- #
# golden for the card: a test render and one training step of each family
# and baseline (D4/W64, K8, F2), JAX's numbers with their inputs
# ---------------------------------------------------------------------- #

GOLDEN_MODELS = FAMILIES + ("nerf", "nerf_dropout", "nerf_wild", "nerf_wild_bf16")
GOLDEN_RENDER = dict(rays=32, samples=16)
GOLDEN_STEP = dict(rgb=24, depth=8, samples=16, key=11)
GOLDEN_MAPS = ("rgb_map", "depth_map", "acc_map")
GOLDEN_METRICS = ("loss", "loss_nll", "loss_entropy", "depth_loss", "mse", "psnr")
VIEW_KW = dict(H=10, W=10, focal=10.0, ndc=False, use_viewdirs=True, near=2.0, far=6.0)


def golden_kind(name):
    """(model kind or None for NeRFFlows, family or None, bf16)."""
    if name in FAMILIES:
        return None, name, False
    return name.replace("_bf16", ""), None, name.endswith("_bf16")


def golden_rays(seed=21):
    b = make_batch(GOLDEN_RENDER["rays"], 1, seed)
    return b["rays_o"], b["rays_d"]


def golden_jax(name):
    """(JAX apply fn, params, test eps, JAX model)."""
    kind, family, bf16 = golden_kind(name)
    if kind is None:
        jm, params, eps = jax_family(family)
    else:
        jm, params = jax_baseline(kind, depth=4, width=64, k=8,
                                  compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        eps = jax_wild_test_eps(jm) if kind == "nerf_wild" else None
    return jm, params, eps


def golden_port(name, params, eps):
    kind, family, bf16 = golden_kind(name)
    if kind is None:
        return port_family(family, SMALL, params, eps)
    return port_baseline(kind, 4, 64, 8, params,
                         compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                         test_eps=eps)


def _jax_render(jm, params, ro, rd):
    rc = jrender.RenderConfig(n_samples=GOLDEN_RENDER["samples"], perturb=False,
                              use_viewdirs=True, white_bkgd=True, fused="off")

    def apply(p, x, *, is_test, rng):
        return jm.apply({"params": p}, x, is_test=is_test, rng=rng)

    rays = jrender.prepare_rays(jnp.asarray(ro), jnp.asarray(rd), **VIEW_KW)
    with jax.disable_jit():
        out = jrender.make_render_rays(apply, rc)(params, *rays, None, is_test=True)
    return {k: np.asarray(out[k]) for k in GOLDEN_MAPS}


def _jax_golden_step(name, jm, params, batch, key):
    kind, family, bf16 = golden_kind(name)
    rc = jrender.RenderConfig(n_samples=GOLDEN_STEP["samples"], perturb=True,
                              use_viewdirs=True, fused="off")
    cfg = jstep.TrainConfig(**{**TRAIN_KW, "loss_mode": loss_mode_for_model(kind)})
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    # op by op in bf16, as tests/test_torch_bf16.py runs it
    _, state, metrics = (step._update if bf16 else step)(p, tx.init(p), batch, key)
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state[0]), kind,
                                family or "triangular")
    return {k: float(v) for k, v in metrics.items()}, {k: v.numpy() for k, v in grads.items()}


def _store_draws(arrays, prefix, draws):
    if draws is None:
        return
    if isinstance(draws, (list, tuple)) and isinstance(draws[0], list):  # dropout masks
        for k, masks in enumerate(draws):
            for j, m in enumerate(masks):
                arrays[f"{prefix}/{k}/{j}"] = np.asarray(m, bool)
    elif isinstance(draws, tuple):  # eps_a, eps_r
        arrays[f"{prefix}/a"], arrays[f"{prefix}/r"] = draws
    else:
        arrays[f"{prefix}/wild"] = np.asarray(draws, np.float32)


def load_draws(g, prefix):
    """The draws `_store_draws` wrote under `prefix` (None if none)."""
    keys = [k for k in g.files if k.startswith(prefix + "/")]
    if not keys:
        return None
    if f"{prefix}/a" in keys:
        return g[f"{prefix}/a"], g[f"{prefix}/r"]
    if f"{prefix}/wild" in keys:
        return g[f"{prefix}/wild"]
    n_k = 1 + max(int(k.split("/")[-2]) for k in keys)
    n_j = 1 + max(int(k.split("/")[-1]) for k in keys)
    return [[g[f"{prefix}/{k}/{j}"] for j in range(n_j)] for k in range(n_k)]


def families_golden_arrays():
    arrays = {"config": np.array([SMALL.depth, SMALL.width, SMALL.k, SMALL.flows,
                                  SMALL.h_alpha, SMALL.h_rgb, GOLDEN_RENDER["samples"],
                                  GOLDEN_STEP["samples"]], np.int64)}
    ro, rd = golden_rays()
    arrays["render/rays_o"], arrays["render/rays_d"] = ro, rd
    batch = make_batch(GOLDEN_STEP["rgb"], GOLDEN_STEP["depth"], seed=22)
    arrays.update({f"batch/{k}": v for k, v in batch.items()})
    key = jax.random.PRNGKey(GOLDEN_STEP["key"])
    n_rays, S = GOLDEN_STEP["rgb"] + GOLDEN_STEP["depth"], GOLDEN_STEP["samples"]
    t_rand, eps = jax_draws(key, n_rays, S, SMALL.k)
    arrays["t_rand"] = t_rand
    rng_eps = jax.random.split(key, 5)[1]
    for name in GOLDEN_MODELS:
        kind, family, _ = golden_kind(name)
        jm, params, test_eps = golden_jax(name)
        arrays.update({f"{name}/p/{path}": leaf for path, leaf in _flatten(params)})
        if kind is None:
            arrays[f"{name}/test_eps_a"], arrays[f"{name}/test_eps_r"] = test_eps
        elif test_eps is not None:
            arrays[f"{name}/test_eps"] = test_eps
        maps = _jax_render(jm, params, ro, rd)
        arrays.update({f"{name}/jax/{k}": v for k, v in maps.items()})
        if kind == "nerf_dropout":
            _store_draws(arrays, f"{name}/render_draws",
                         jax_test_draws(jm, kind, GOLDEN_RENDER["rays"] * GOLDEN_RENDER["samples"]))
        metrics, grads = _jax_golden_step(name, jm, params, batch, key)
        arrays.update({f"{name}/jax/{k}": np.float32(v) for k, v in metrics.items()})
        arrays.update({f"{name}/grad/{k}": v for k, v in grads.items()})
        _store_draws(arrays, f"{name}/step_draws",
                     eps if kind is None else jax_train_draws(jm, kind, rng_eps, n_rays * S))
    return arrays


def save_families_golden():
    np.savez_compressed(GOLDEN, **families_golden_arrays())


def golden_model(g, name):
    """The port's model of golden entry `name`, weights and test draws from
    the file (what chip_smoke.py builds on the card)."""
    params = {}
    for k in g.files:
        if k.startswith(f"{name}/p/"):
            node = params
            *parents, leaf = k[len(name) + 3:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = g[k]
    if golden_kind(name)[0] is None:
        eps = (g[f"{name}/test_eps_a"], g[f"{name}/test_eps_r"])
    else:
        eps = g[f"{name}/test_eps"] if f"{name}/test_eps" in g.files else None
    return golden_port(name, params, eps)


def test_families_golden_is_current():
    assert GOLDEN.exists(), "run: python -m tests.test_torch_families"
    assert GOLDEN.stat().st_size < 4 << 20
    fresh = families_golden_arrays()
    with np.load(GOLDEN) as saved:
        assert set(saved.files) == set(fresh)
        for k in fresh:
            if "/jax/" in k or "/grad/" in k:
                # XLA's CPU reductions are deterministic on one build; the
                # margin only absorbs a thread-count-dependent summation order
                np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-6, atol=1e-9,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


# the golden's gates, as chip_smoke.py's families_golden holds the card:
# maps and metrics rtol = atol = 1e-4 (bf16 2e-3); gradients per leaf
# relative RMS 1e-3 and cosine 0.9999 (bf16 2e-2, tests/test_torch_bf16.py's
# rule; planar 1e-2, PLANAR_GRAD_REL_RMS above: measured 2.3e-3 here); a
# leaf whose JAX gradient is rounding noise (every entry <= 1e-6: the Z = 1
# Householder / orthogonal amor_q, whose Q is +-1 whatever it gives) by its
# absolute error, <= 1e-6, the gradient atol
GOLDEN_TOL, GOLDEN_BF16_TOL = 1e-4, 2e-3
GOLDEN_REL_RMS, GOLDEN_MIN_COS = 1e-3, 0.9999
GOLDEN_BF16_REL_RMS = 2e-2
GOLDEN_NOISE = 1e-6


def golden_check(g, name, device="cpu"):
    """A test render and one step's loss and gradients of golden entry
    `name` through the port on `device`, against JAX's: (errors, failures)."""
    kind, _, bf16 = golden_kind(name)
    tol = GOLDEN_BF16_TOL if bf16 else GOLDEN_TOL
    rel_rms = (GOLDEN_BF16_REL_RMS if bf16 else
               PLANAR_GRAD_REL_RMS if name == "planar" else GOLDEN_REL_RMS)
    model = golden_model(g, name).to(device)
    n_samples, S = (int(v) for v in g["config"][6:8])
    dev = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    render = make_render_rays(model, RenderConfig(n_samples=n_samples, perturb=False,
                                                  use_viewdirs=True, white_bkgd=True,
                                                  fused="off"))
    rays = prepare_rays(dev(g["render/rays_o"]), dev(g["render/rays_d"]), **VIEW_KW)
    with torch.no_grad():
        out = render(*rays, None, is_test=True, eps=load_draws(g, f"{name}/render_draws"))
    errs, bad = {}, []
    for k in GOLDEN_MAPS:
        ref = dev(g[f"{name}/jax/{k}"])
        d = (out[k] - ref).abs()
        errs[k] = float(d.max())
        if not bool((d <= tol + tol * ref.abs()).all()):
            bad.append(k)
    step, _ = make_train_step(model, RenderConfig(n_samples=S, fused="off"),
                              TrainConfig(**{**TRAIN_KW, "loss_mode": loss_mode_for_model(kind)}))
    z_vals = port_z_vals(g["t_rand"], S).to(device)
    batch = {k[6:]: g[k] for k in g.files if k.startswith("batch/")}
    loss, metrics = step.loss_fn(batch, None, z_vals=z_vals,
                                 eps=load_draws(g, f"{name}/step_draws"))
    loss.backward()
    for k in GOLDEN_METRICS:
        ref = float(g[f"{name}/jax/{k}"])
        errs[k] = abs(float(metrics[k].detach()) - ref)
        if not errs[k] <= tol + tol * abs(ref):
            bad.append(k)
    worst = (0.0, 1.0)
    for n, p in model.named_parameters():
        want = g[f"{name}/grad/{n}"].astype(np.float64)
        got = (np.zeros_like(want) if p.grad is None
               else p.grad.detach().cpu().numpy().astype(np.float64))
        if np.abs(want).max() <= GOLDEN_NOISE:
            if np.abs(got - want).max() > GOLDEN_NOISE:
                bad.append(f"grad/{n}")
            continue
        rel = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
        cos = float(np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
        worst = (max(worst[0], rel), min(worst[1], cos))
        if not (rel <= rel_rms and cos >= GOLDEN_MIN_COS):
            bad.append(f"grad/{n}")
    errs["grad_worst_rel_rms"], errs["grad_worst_cos"] = worst
    return errs, bad


@pytest.mark.parametrize("name", GOLDEN_MODELS)
def test_families_golden_through_the_port(name):
    """What chip_smoke.py's families_golden does on the card, here through
    the plain versions."""
    with np.load(GOLDEN) as g:
        errs, bad = golden_check(g, name)
    assert not bad, (bad, errs)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_families_golden()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
