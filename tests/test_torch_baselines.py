"""The baseline models (NeRF, MC-dropout NeRF, NeRF-W) and their K-sample
adapter: the port against cfnerf_tpu's on converted weights, f32 and bf16.

JAX's dropout masks and eps come from its PRNG; the tests derive them from
JAX's keys as its modules do (cfnerf_tpu/models/nerf.py:29-32, :143-145;
baseline_adapter.py) and hand them to the port through its seams
(NeRFDropout's `masks=`, KSampleBaseline's `eps=`).

Tolerances, and why:
  * f32 outputs and maps: rtol = atol = 1e-4 (the issue's rule for the
    port's f32 maps; XLA's and PyTorch's CPU matmuls sum in other orders);
  * one training step: loss and metrics rtol 1e-5, gradients rtol 1e-4 /
    atol 1e-6 (tests/test_torch_train.py's rules) at D2/W32, where no ReLU
    input lies within rounding of 0;
  * bf16 (JAX op by op, as tests/test_torch_bf16.py runs it): the same bf16
    products of the same f32 sums, each rounded once, then the bias add:
    bitwise equal at D4/W64 (the baselines take one product a layer, the
    concatenations materialised); at D8/W256 atol 2e-3, test_torch_bf16's
    wide rule (PyTorch's and XLA's long f32 sums round now and then to the
    neighbouring bf16 value), with at least 99% of the entries bitwise
    equal.  nerf_wild's f32 tail after its bf16 network (softplus,
    mu + std * eps) rounds apart by an f32 ulp: rtol = atol = 1e-6.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.models import nerf as jnerf
from cfnerf_tpu.models.baseline_adapter import KSampleBaseline as JaxKSampleBaseline
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.convert import baseline_state_dict_from_jax, state_dict_from_jax
from cfnerf_torch.models import nerf as tnerf
from cfnerf_torch.models.baseline_adapter import BASELINE_KINDS, KSampleBaseline
from cfnerf_torch.models.factory import build_model, loss_mode_for_model
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train.step import TrainConfig, make_train_step
from tests.test_torch_common import to_np
from tests.test_torch_train import (
    LOSS_RTOL,
    TRAIN_KW,
    _grads_in_opt_state,
    jax_draws,
    make_batch,
    port_z_vals,
)

T = torch.as_tensor
F32_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_WIDE_ATOL, BF16_MIN_EQUAL = 2e-3, 0.99
KEEP = 0.8  # 1 - the dropout rate 0.2


SMALL = dict(depth=4, width=64, k=8)
STEP = dict(depth=2, width=32, k=8)
WIDE = dict(depth=8, width=256, k=8)


def jax_baseline(kind, depth, width, k, compute_dtype=jnp.float32, seed=0,
                 use_viewdirs=True):
    """(JAX KSampleBaseline, params as nested numpy dicts)."""
    model = JaxKSampleBaseline(
        kind=kind, k_samples=k, net_depth=depth, net_width=width, input_ch=63,
        input_ch_views=27 if use_viewdirs else 0, skips=(depth // 2,),
        use_viewdirs=use_viewdirs, compute_dtype=compute_dtype)
    x = jnp.zeros((2, 63 + (27 if use_viewdirs else 0)), jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), x, is_test=True)["params"]
    return model, jax.tree_util.tree_map(lambda a: np.array(a, np.float32), dict(params))


def jax_wild_test_eps(model):
    """nerf_wild's test draws: normal(PRNGKey(test_eps_seed), (K, 3))."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(model.test_eps_seed),
                                        (model.k_samples, 3)))


def port_baseline(kind, depth, width, k, params, compute_dtype=torch.float32,
                  test_eps=None, use_viewdirs=True):
    model = KSampleBaseline(kind, k, net_depth=depth, net_width=width, input_ch=63,
                            input_ch_views=27 if use_viewdirs else 0, skips=(depth // 2,),
                            use_viewdirs=use_viewdirs, compute_dtype=compute_dtype)
    model.load_state_dict(baseline_state_dict_from_jax(params, test_eps),
                          strict=test_eps is not None or kind != "nerf_wild")
    return model


def jax_dropout_masks(key, depth, width, k, n_points, use_viewdirs=True):
    """The K draws' masks JAX's MC-dropout takes from `key`: K keys, each
    split into trunk / h / hv keys, the trunk's split again before each of
    layers 2, 4, ... (cfnerf_tpu/models/nerf.py:29-32, :143-145)."""
    skips = (depth // 2,)
    draws = []
    for dk in jax.random.split(key, k):
        k_trunk, k_h, k_hv = jax.random.split(dk, 3)
        masks = []
        for i in range(depth):
            if i % 2 == 0 and i > 0:
                k_trunk, sub = jax.random.split(k_trunk)
                fan_in = width + 63 if (i - 1) in skips else width
                masks.append(jax.random.bernoulli(sub, KEEP, (n_points, fan_in)))
        if use_viewdirs:
            out = width + 63 if (depth - 1) in skips else width  # the trunk's output
            masks.append(jax.random.bernoulli(k_h, KEEP, (n_points, out)))
            masks.append(jax.random.bernoulli(k_hv, KEEP, (n_points, width // 2)))
        draws.append([np.asarray(m) for m in masks])
    return draws


def _x(n, seed=0, views=27):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 63 + views)).astype(np.float32)


def jax_test_draws(jm, kind, n_points):
    """The test-mode draws of a JAX baseline, as the port's `eps` seam
    takes them (None for nerf)."""
    if kind == "nerf_dropout":
        return jax_dropout_masks(jax.random.PRNGKey(jm.test_eps_seed), jm.net_depth,
                                 jm.net_width, jm.k_samples, n_points, jm.use_viewdirs)
    if kind == "nerf_wild":
        return jax_wild_test_eps(jm)
    return None


def jax_train_draws(jm, kind, rng_eps, n_points):
    """A training forward's draws from the renderer's eps key."""
    if kind == "nerf_dropout":
        return jax_dropout_masks(rng_eps, jm.net_depth, jm.net_width, jm.k_samples,
                                 n_points, jm.use_viewdirs)
    if kind == "nerf_wild":
        return np.asarray(jax.random.normal(rng_eps, (jm.k_samples, 3)))
    return None


# ---------------------------------------------------------------------- #
# the models
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", BASELINE_KINDS)
@pytest.mark.parametrize("is_test", [True, False])
def test_k_sample_forward_matches_jax(kind, is_test):
    """raw (B, K, 4) with JAX's draws: test mode's fixed ones, a training
    forward's from its key."""
    jm, params = jax_baseline(kind, **SMALL)
    model = port_baseline(kind, **SMALL, params=params,
                          test_eps=jax_wild_test_eps(jm) if kind == "nerf_wild" else None)
    x = _x(96, seed=1)
    rng = None if is_test else jax.random.PRNGKey(5)
    jraw, jzero = jm.apply({"params": params}, jnp.asarray(x), is_test=is_test, rng=rng)
    draws = (jax_test_draws(jm, kind, 96) if is_test
             else jax_train_draws(jm, kind, rng, 96))
    if kind == "nerf_wild" and is_test:
        draws = None  # the converted buffer
    with torch.no_grad():
        raw, zero = model(T(x), is_test=is_test, eps=draws,
                          generator=None if draws is not None or kind == "nerf"
                          else torch.Generator())
    assert tuple(raw.shape) == (96, SMALL["k"], 4) and float(zero) == float(jzero) == 0.0
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **F32_TOL)
    if kind == "nerf_dropout":
        # the draws differ: the masks are in use
        assert float((raw[:, 0] - raw[:, 1]).abs().max()) > 1e-3


@pytest.mark.parametrize("kind", ["nerf", "nerf_dropout", "nerf_wild"])
def test_base_model_matches_jax(kind):
    """The bare models (NeRF / NeRFDropout with JAX's masks / NeRFWild)."""
    jm, params = jax_baseline(kind, **SMALL)
    base_cls = {"nerf": jnerf.NeRF, "nerf_dropout": jnerf.NeRFDropout,
                "nerf_wild": jnerf.NeRFWild}[kind]
    jbase = base_cls(depth=4, width=64, skips=(2,))
    x = _x(50, seed=2)
    key = jax.random.PRNGKey(9)
    kw = {"rng": key} if kind == "nerf_dropout" else {}
    jout = jbase.apply({"params": params["base"]}, jnp.asarray(x), **kw)
    model = port_baseline(kind, **SMALL, params=params,
                          test_eps=np.zeros((8, 3), np.float32) if kind == "nerf_wild" else None)
    kw = {}
    if kind == "nerf_dropout":
        # one draw's masks: the adapter splits K keys first, the bare model
        # takes its key as one draw's
        k_trunk, k_h, k_hv = jax.random.split(key, 3)
        _, sub = jax.random.split(k_trunk)
        kw["masks"] = [np.asarray(jax.random.bernoulli(sub, KEEP, (50, 64))),
                       np.asarray(jax.random.bernoulli(k_h, KEEP, (50, 64))),
                       np.asarray(jax.random.bernoulli(k_hv, KEEP, (50, 32)))]
    with torch.no_grad():
        out = model.base(T(x), **kw)
    assert out.shape[-1] == (5 if kind == "nerf_wild" else 4)
    np.testing.assert_allclose(to_np(out), np.asarray(jout), **F32_TOL)


def test_dropout_masks_from_a_generator_and_none():
    """Without masks and generator NeRFDropout runs without dropout (JAX's
    rng=None); a generator draws masks of mask_shapes, keep rate ~0.8."""
    jm, params = jax_baseline("nerf_dropout", **SMALL)
    model = port_baseline("nerf_dropout", **SMALL, params=params)
    x = T(_x(200, seed=3))
    jout = jm.apply({"params": params}, jnp.asarray(_x(200, seed=3)),
                    method=lambda m, x: m.base(x))
    with torch.no_grad():
        np.testing.assert_allclose(to_np(model.base(x)), np.asarray(jout), **F32_TOL)
        masks = model.base.draw_masks(200, torch.Generator().manual_seed(0))
    assert [tuple(m.shape) for m in masks] == [(200, 64), (200, 64), (200, 32)]
    share = float(torch.cat([m.flatten() for m in masks]).float().mean())
    assert 0.77 < share < 0.83


def test_without_viewdirs_one_output_head():
    kind = "nerf_dropout"
    jm, params = jax_baseline(kind, **SMALL, use_viewdirs=False)
    assert "output_linear" in params["base"] and "rgb_linear" not in params["base"]
    model = port_baseline(kind, **SMALL, params=params, use_viewdirs=False)
    x = _x(40, seed=4, views=0)
    jraw, _ = jm.apply({"params": params}, jnp.asarray(x), is_test=True)
    with torch.no_grad():
        raw, _ = model(T(x), is_test=True,
                       eps=jax_dropout_masks(jax.random.PRNGKey(0), 4, 64, 8, 40,
                                             use_viewdirs=False))
    np.testing.assert_allclose(to_np(raw), np.asarray(jraw), **F32_TOL)


def test_test_mode_dropout_masks_are_fixed_and_training_needs_a_generator():
    model = KSampleBaseline("nerf_dropout", 4, net_depth=4, net_width=32, skips=(2,))
    x = torch.rand(30, 90)
    with torch.no_grad():
        a, _ = model(x, is_test=True)
        b, _ = model(x, is_test=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a[:, 0] - a[:, 1]).abs().max()) > 0  # K distinct draws
    for kind in ("nerf_dropout", "nerf_wild"):
        with pytest.raises(ValueError, match="Generator"):
            KSampleBaseline(kind, 4, net_depth=2, net_width=16, skips=(1,))(x, is_test=False)
    with torch.no_grad():  # nerf is deterministic: no generator needed
        raw, _ = KSampleBaseline("nerf", 4, net_depth=2, net_width=16, skips=(1,))(x)
    assert raw.stride(1) == 0  # one prediction broadcast over K


def test_wild_test_mode_zeroes_the_last_draw_and_at_k_rebuilds_it():
    model = KSampleBaseline("nerf_wild", 6, net_depth=2, net_width=16, skips=(1,))
    assert float(model.test_eps[-1].abs().sum()) == 0.0
    x = torch.rand(9, 90)
    eps = torch.randn(6, 3)
    with torch.no_grad():
        raw, _ = model(x, is_test=True, eps=eps)
        mu = model.base(x)[:, :3]
    torch.testing.assert_close(raw[:, -1, :3], mu, rtol=0, atol=0)  # the mean sample
    view = model.at_k(3)
    assert view.k_samples == 3 and tuple(view.test_eps.shape) == (3, 3)
    assert tuple(model.test_eps.shape) == (6, 3)
    assert view.base is model.base


def test_unknown_kind_raises_jax_message():
    with pytest.raises(ValueError, match="unknown baseline model 'nerf_x'"):
        KSampleBaseline("nerf_x", 4)


# ---------------------------------------------------------------------- #
# bf16
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", BASELINE_KINDS)
@pytest.mark.parametrize("size", ["small", "wide"])
def test_bf16_matches_jax_op_by_op(kind, size):
    """JAX's bf16 baseline, op by op (model.apply, no jit), with the same
    draws: bitwise at D4/W64; at D8/W256 atol 2e-3 and >= 99% bitwise.
    nerf_wild: its network's outputs so, its f32 draws within 1e-6."""
    cfg = SMALL if size == "small" else WIDE
    jm, params = jax_baseline(kind, **cfg, compute_dtype=jnp.bfloat16)
    wild_eps = jax_wild_test_eps(jm) if kind == "nerf_wild" else None
    model = port_baseline(kind, **cfg, params=params, compute_dtype=torch.bfloat16,
                          test_eps=wild_eps)
    x = _x(128, seed=5)
    with jax.disable_jit():
        jraw, _ = jm.apply({"params": params}, jnp.asarray(x), is_test=True)
    draws = jax_test_draws(jm, kind, 128) if kind == "nerf_dropout" else None
    with torch.no_grad():
        raw, _ = model(T(x), is_test=True, eps=draws)
    got, want = to_np(raw), np.asarray(jraw)
    if kind == "nerf_wild":
        # the f32 tail (softplus, mu + std * eps) rounds apart by an ulp:
        # hold it at 1e-6, and the bf16 network's outputs by the bf16 rule
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 if size == "small"
                                   else BF16_WIDE_ATOL)
        with jax.disable_jit():
            want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                       method=lambda m, x: m.base(x)))
        with torch.no_grad():
            got = to_np(model.base(T(x)))
    if size == "small":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_WIDE_ATOL)
        assert np.mean(got == want) >= BF16_MIN_EQUAL


def test_bf16_keeps_f32_parameters_and_returns_f32():
    model = KSampleBaseline("nerf_wild", 4, net_depth=4, net_width=32, skips=(2,),
                            compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        raw, _ = model(torch.rand(5, 90), is_test=True)
    assert raw.dtype == torch.float32


# ---------------------------------------------------------------------- #
# load_weights_from_keras
# ---------------------------------------------------------------------- #


def _keras_weights(depth, width, seed=0):
    """Random arrays in the bmild/nerf release's order and (in, out) shapes."""
    rng = np.random.RandomState(seed)
    shapes, fan_in = [], 63
    for i in range(depth):
        shapes.append((fan_in, width))
        fan_in = width + 63 if i == depth // 2 else width
    shapes += [(fan_in, width), (width + 27, width // 2), (width // 2, 3), (fan_in, 1)]
    weights = []
    for s in shapes:
        weights += [rng.randn(*s).astype(np.float32) * 0.1,
                    rng.randn(s[1]).astype(np.float32) * 0.1]
    return weights


def test_load_weights_from_keras_matches_jax():
    jm, params = jax_baseline("nerf", **SMALL)
    weights = _keras_weights(4, 64)
    jparams = jnerf.load_weights_from_keras(params["base"], weights, depth=4)
    model = port_baseline("nerf", **SMALL, params=params)
    assert tnerf.load_weights_from_keras(model.base, weights) is model.base
    x = _x(64, seed=6)
    jout = jnerf.NeRF(depth=4, width=64, skips=(2,)).apply({"params": jparams}, jnp.asarray(x))
    with torch.no_grad():
        out = model.base(T(x))
    np.testing.assert_allclose(to_np(out), np.asarray(jout), **F32_TOL)
    np.testing.assert_array_equal(to_np(model.base.trunk.pts_linears[3].weight),
                                  weights[6].T)


@pytest.mark.parametrize("bad", ["kernel", "bias"])
def test_load_weights_from_keras_shape_errors_match_jax(bad):
    _, params = jax_baseline("nerf", **SMALL)
    weights = _keras_weights(4, 64)
    j = 2 if bad == "kernel" else 3
    weights[j] = weights[j][..., :-1]  # one column short
    with pytest.raises(ValueError) as jerr:
        jnerf.load_weights_from_keras(params["base"], weights, depth=4)
    model = port_baseline("nerf", **SMALL, params=params)
    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(ValueError) as terr:
        tnerf.load_weights_from_keras(model.base, weights)
    assert str(terr.value) == str(jerr.value)
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))  # untouched


# ---------------------------------------------------------------------- #
# one training step against JAX's make_train_step
# ---------------------------------------------------------------------- #


def jax_baseline_step(kind, params, batch, key, n_samples, compute_dtype=jnp.float32):
    """One cfnerf_tpu step of a STEP-size baseline (unfused, its loss mode).
    Returns metrics and gradients under the port's names."""
    jm, _ = jax_baseline(kind, **STEP, compute_dtype=compute_dtype)
    cfg = jstep.TrainConfig(**{**TRAIN_KW, "loss_mode": loss_mode_for_model(kind)})
    rc = jrender.RenderConfig(n_samples=n_samples, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    _, state, metrics = step(p, tx.init(p), batch, key)
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state[0]), kind)
    return jm, {k: float(v) for k, v in metrics.items()}, {k: v.numpy() for k, v in grads.items()}


def port_step_grads(model, batch, t_rand, draws, n_samples, loss_mode):
    cfg = TrainConfig(**{**TRAIN_KW, "loss_mode": loss_mode})
    step, _ = make_train_step(model, RenderConfig(n_samples=n_samples, fused="off"), cfg)
    loss, metrics = step.loss_fn(batch, None, z_vals=port_z_vals(t_rand, n_samples),
                                 eps=draws)
    loss.backward()
    grads = {n: (np.zeros(tuple(p.shape), np.float32) if p.grad is None else to_np(p.grad))
             for n, p in model.named_parameters()}
    return step, {k: float(v.detach()) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_train_step_matches_jax(kind):
    """nerf and nerf_dropout on MSE (loss_mode 'mse'), nerf_wild on the KDE
    NLL, from the same batch, jitter and draws."""
    _, params = jax_baseline(kind, **STEP)
    n_rgb, n_depth, S = 20, 7, 13
    batch = make_batch(n_rgb, n_depth, seed=0)
    key = jax.random.PRNGKey(3)
    jm, jmetrics, jgrads = jax_baseline_step(kind, params, batch, key, S)
    t_rand, _ = jax_draws(key, n_rgb + n_depth, S, STEP["k"])
    rng_eps = jax.random.split(key, 5)[1]
    draws = jax_train_draws(jm, kind, rng_eps, (n_rgb + n_depth) * S)
    model = port_baseline(kind, **STEP, params=params,
                          test_eps=jax_wild_test_eps(jm) if kind == "nerf_wild" else None)
    _, tmetrics, tgrads = port_step_grads(model, batch, t_rand, draws, S,
                                          loss_mode_for_model(kind))
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(tmetrics[k], jmetrics[k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    if kind != "nerf_wild":
        assert tmetrics["loss_nll"] == 0.0  # the mse family
    assert set(tgrads) == set(jgrads)
    for name in jgrads:
        np.testing.assert_allclose(tgrads[name], jgrads[name], err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["nerf_dropout", "nerf_wild"])
def test_remat_replays_the_baseline_draws(kind):
    """Under remat the recompute sees the step's masks / eps: the same
    gradients as without it."""
    out = []
    for remat in (False, True):
        model = KSampleBaseline(kind, 4, net_depth=2, net_width=16, skips=(1,))
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.uniform_(p, -0.3, 0.3)
        step, _ = make_train_step(model, RenderConfig(n_samples=8, fused="off"),
                                  TrainConfig(**{**TRAIN_KW, "k_samples": 4,
                                                 "loss_mode": loss_mode_for_model(kind)},
                                              remat=remat))
        loss, _ = step.loss_fn(make_batch(6, 2, seed=1), torch.Generator().manual_seed(4))
        loss.backward()
        out.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_build_model_and_a_cpu_step(kind):
    """--model builds the adapter for coarse and fine; --trunk_impl and
    --flow_impl do not reach it; a step on the CPU trains."""
    args = types.SimpleNamespace(
        multires=10, multires_views=4, i_embed=0, use_viewdirs=True, netdepth=4,
        netwidth=32, h_alpha_size=8, h_rgb_size=8, n_flows=2, K_samples=4,
        type_flows="no_flow", N_importance=4, N_samples=8, netdepth_fine=2,
        netwidth_fine=16, perturb=1.0, white_bkgd=False, raw_noise_std=0.0, seed=0,
        model=kind, trunk_impl="pallas", flow_impl="pallas")
    model, fine, rc = build_model(args, device="cpu")
    assert isinstance(model, KSampleBaseline) and isinstance(fine, KSampleBaseline)
    assert model.kind == fine.kind == kind and rc.fused == "off"
    assert len(fine.base.trunk.pts_linears) == 2
    step, _ = make_train_step(model, rc, TrainConfig(**{**TRAIN_KW, "k_samples": 4,
                                                        "loss_mode": loss_mode_for_model(kind)}),
                              model_fine=fine)
    metrics = step(make_batch(6, 2, seed=2), torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values()) and "loss_nll0" in metrics
