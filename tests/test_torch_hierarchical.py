"""Hierarchical sampling in the port against cfnerf_tpu: sample_pdf, the
coarse + fine render (a coarse/fine pair, and one net shared by both
passes), applied density noise, one hierarchical training step, the factory;
plus the golden file that lets chip_smoke.py hold the card's kernel path
against JAX numbers.

JAX's models run their flow stacks through the Pallas kernel's interpreter
(flow_impl="interpret"), as flow_impl="pallas" runs them on a TPU; its
renderer and step are jitted.  JAX's draws are recomputed from its key as
its renderer splits it (renderer.py:172-174) and injected into the port.

Tolerances: maps and metrics rtol 2e-5 / atol 2e-5 and gradients rtol 1e-4 /
atol 1e-6, the rules of tests/test_torch_render.py and
tests/test_torch_train.py; sample_pdf as stated at its test.

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_hierarchical
(test_hier_golden_is_current fails while the committed file is stale).
"""
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops import sampling as jsampling
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.convert import nerf_flows_pair_state_dicts_from_jax
from cfnerf_torch.models.factory import build_model
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.ops import sampling
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays
from cfnerf_torch.train.step import TrainConfig, make_train_step
from tests.test_torch_common import Tiny, jax_nerf_flows, to_np
from tests.test_torch_train import (
    GRAD_TOL,
    _grads_in_opt_state,
    _port_names,
    assert_grads_close,
    assert_params_after_update_close,
    make_batch,
    port_z_vals,
)

GOLDEN = Path(__file__).parent / "fixtures" / "torch_port_hier_golden.npz"
COARSE = Tiny(depth=2, width=32, k=8, flows=2, h_alpha=16, h_rgb=16)
FINE = Tiny(depth=2, width=48, k=8, flows=2, h_alpha=16, h_rgb=16)
N_SAMPLES, N_IMPORTANCE = 16, 8
RAYS = (24, 8)  # rgb + depth rays of the training step
KEY = 11
# configs/africa_ds.txt's loss on a small view (tests/test_torch_train.py)
TRAIN_KW = dict(H=10, W=10, focal=10.0, ndc=False, near=2.0, far=6.0, k_samples=COARSE.k,
                lrate=5e-4, beta1=0.01, colmap_depth=True, depth_lambda=0.01)
TRAIN_FIELDS = ("H", "W", "focal", "near", "far", "beta1", "depth_lambda", "lrate")
METRICS = ("loss", "loss_nll", "loss_entropy", "depth_loss", "loss_nll0", "mse", "psnr")
MAPS = ("rgb_map", "disp_map", "depth_map", "acc_map", "rgb0", "disp0", "depth0")
MAP_TOL = dict(rtol=2e-5, atol=2e-5)
T = torch.as_tensor


def _apply(model):
    def apply(p, x, *, is_test, rng):
        return model.apply({"params": p}, x, is_test=is_test, rng=rng)
    return apply


@functools.lru_cache(maxsize=None)
def _pair():
    """The JAX coarse/fine pair: models (interpreted flow stacks), params
    {"coarse", "fine"} and each net's test eps; the fine net seeded + 1, as
    create_nerf seeds it."""
    jm, pc, ec = jax_nerf_flows(COARSE, 0, "interpret")
    jmf, pf, ef = jax_nerf_flows(FINE, 1, "interpret")
    return jm, jmf, {"coarse": pc, "fine": pf}, ec, ef


def _port_pair():
    _, _, params, ec, ef = _pair()
    sd, sd_fine = nerf_flows_pair_state_dicts_from_jax(params, ec, ef)
    models = []
    for cfg, state in ((COARSE, sd), (FINE, sd_fine)):
        model = NeRFFlows(net_depth=cfg.depth, net_width=cfg.width, skips=(cfg.depth // 2,),
                          h_alpha_size=cfg.h_alpha, h_rgb_size=cfg.h_rgb,
                          n_flows=cfg.flows, k_samples=cfg.k)
        model.load_state_dict(state)
        models.append(model)
    return models


def _rays(n, seed):
    """Rays from around (0, 0, 4) towards the origin: (rays_o, rays_d,
    viewdirs, near, far) as numpy."""
    b = make_batch(n, 1, seed)
    ro, rd = b["rays_o"], b["rays_d"]
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    return (ro, rd, vd.astype(np.float32), np.full((n, 1), 2.0, np.float32),
            np.full((n, 1), 6.0, np.float32))


def jax_draws(key, n_rays, k, noise_k=None):
    """The draws of JAX's train-mode hierarchical render from `key`
    (renderer.py:172-174): stratified uniforms, both nets' eps, the pdf
    uniforms and, with `noise_k`, the density noise of both passes."""
    rng_z, rng_eps, rng_noise, rng_pdf, rng_eps_f = jax.random.split(key, 5)

    def eps(kk):
        ka, kr = jax.random.split(kk)
        return (np.asarray(jax.random.normal(ka, (k, 1))),
                np.asarray(jax.random.normal(kr, (k, 3))))

    draws = dict(
        t_rand=np.asarray(jax.random.uniform(rng_z, (n_rays, N_SAMPLES))),
        eps=eps(rng_eps), eps_fine=eps(rng_eps_f),
        pdf_u=np.asarray(jax.random.uniform(rng_pdf, (n_rays, N_IMPORTANCE))))
    if noise_k is not None:
        draws["noise"] = tuple(
            np.asarray(jax.random.normal(rng_noise, (n_rays, s, noise_k)))
            for s in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE))
    return draws


def _port_draws(draws):
    """The port's keywords for JAX's draws."""
    out = dict(z_vals=port_z_vals(draws["t_rand"], N_SAMPLES), eps=draws["eps"],
               eps_fine=draws["eps_fine"], pdf_u=T(draws["pdf_u"]))
    if "noise" in draws:
        out["noise"] = tuple(T(n) for n in draws["noise"])
    return out


# ---------------------------------------------------------------------- #
# sample_pdf
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("det", [True, False], ids=["det", "injected_u"])
def test_sample_pdf_matches_jax(det):
    """The cdf by cumsum against the TPU's triangular-ones matmul differs by
    a few f32 ulps of 1 (~2e-7); a sample moves by that over its bin's pdf,
    times the bin width.  With pdf >= 7.6e-4 per bin (weights >= 0.05 over
    63 bins; a row of zero weights, whose pdf is 1/63) and widths ~0.06 on
    depths in [2, 6], that is <= ~2e-5: atol 2e-5 (measured 6.7e-6)."""
    rng = np.random.RandomState(3)
    R, M, n = 12, 63, 40
    bins = np.sort(2.0 + 4.0 * rng.rand(R, M + 1), -1).astype(np.float32)
    weights = (0.05 + rng.rand(R, M)).astype(np.float32)
    weights[0] = 0.0  # an empty ray: weights + 1e-5 make its pdf uniform
    key = jax.random.PRNGKey(4)
    ref = jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n, key, det=det)
    u = np.array(jax.random.uniform(key, (R, n)))
    out = sampling.sample_pdf(T(bins), T(weights), n, det=det, u=None if det else T(u))
    assert tuple(out.shape) == (R, n)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=0, atol=2e-5)
    assert np.all(to_np(out) >= bins[:, :1]) and np.all(to_np(out) <= bins[:, -1:])


def test_sample_pdf_top_of_the_cdf_and_its_draws():
    """u = 1 lands on the top edge (JAX's clipped index); draws without u
    come from the generator, the same for the same seed."""
    bins = torch.linspace(2.0, 6.0, 9).expand(3, 9)
    weights = torch.rand(3, 8, generator=torch.Generator().manual_seed(0))
    det = sampling.sample_pdf(bins, weights, 5, det=True)
    torch.testing.assert_close(det[:, -1], bins[:, -1])
    torch.testing.assert_close(det[:, 0], bins[:, 0])
    a = sampling.sample_pdf(bins, weights, 5, torch.Generator().manual_seed(2), det=False)
    b = sampling.sample_pdf(bins, weights, 5, torch.Generator().manual_seed(2), det=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, det)


# ---------------------------------------------------------------------- #
# the coarse + fine render
# ---------------------------------------------------------------------- #


def jax_render_hier(mode, rays, key=None, **over):
    """cfnerf_tpu's hierarchical render, jitted; `mode` "pair" (coarse and
    fine nets) or "shared" (the coarse net serves both passes)."""
    jm, jmf, params, _, _ = _pair()
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE,
                              perturb=key is not None, use_viewdirs=True, **over)
    if mode == "pair":
        fn = jrender.make_render_rays(_apply(jm), rc, _apply(jmf))
    else:
        fn, params = jrender.make_render_rays(_apply(jm), rc), params["coarse"]
    fn = jax.jit(fn, static_argnames=("is_test",))
    out = fn(params, *map(jnp.asarray, rays), key, is_test=key is None)
    return {k: np.asarray(v) for k, v in out.items()}


def port_render_hier(mode, rays, is_test=True, draws=None, **over):
    model, model_fine = _port_pair()
    rc = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE,
                      perturb=not is_test, use_viewdirs=True, **over)
    fn = make_render_rays(model, rc, model_fine=model_fine if mode == "pair" else None)
    with torch.no_grad():
        out = fn(*map(T, rays), None, is_test=is_test, **(draws or {}))
    return {k: to_np(v) for k, v in out.items()}


def _assert_maps_close(out, ref, keys=MAPS):
    for k in keys:
        np.testing.assert_allclose(out[k], ref[k], err_msg=k, **MAP_TOL)


@pytest.mark.parametrize("mode", ["pair", "shared"])
def test_hierarchical_render_matches_jax(mode):
    rays = _rays(16, seed=1)
    ref = jax_render_hier(mode, rays)
    out = port_render_hier(mode, rays)
    assert set(out) == set(ref)
    assert out["rgb_map"].shape == out["rgb0"].shape == (16, 3, COARSE.k)
    _assert_maps_close(out, ref)
    # the fine pass changed the composite
    assert np.abs(out["rgb_map"] - out["rgb0"]).max() > 1e-6


def test_shared_mode_is_pair_mode_with_the_coarse_net_as_the_fine_one():
    """--N_importance_eval: one net serving both passes is the pair whose
    fine net is the coarse one (tests/test_hierarchical.py's check)."""
    model, _ = _port_pair()
    rays = [T(a) for a in _rays(16, seed=2)]
    rc = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=False)
    with torch.no_grad():
        shared = make_render_rays(model, rc)(*rays, None, is_test=True)
        pair = make_render_rays(model, rc, model_fine=model)(*rays, None, is_test=True)
    for k in MAPS:
        torch.testing.assert_close(shared[k], pair[k], rtol=0, atol=0)


@pytest.mark.parametrize("noise", [True, False], ids=["applied_noise", "no_noise"])
def test_train_mode_render_with_injected_draws_matches_jax(noise):
    """Every seam at once: JAX's stratified uniforms, both nets' eps, the
    pdf uniforms and, with apply_noise, the density noise of both passes."""
    rays = _rays(16, seed=3)
    key = jax.random.PRNGKey(5)
    over = dict(apply_noise=True, raw_noise_std=1.0) if noise else {}
    ref = jax_render_hier("pair", rays, key, **over)
    draws = jax_draws(key, 16, COARSE.k, noise_k=COARSE.k if noise else None)
    out = port_render_hier("pair", rays, is_test=False, draws=_port_draws(draws), **over)
    _assert_maps_close(out, ref, MAPS + ("weights", "loss_entropy", "loss_entropy0"))
    if noise:  # the noise moved the render
        quiet = port_render_hier("pair", rays, is_test=False,
                                 draws={**_port_draws(draws), "noise": None})
        assert np.abs(quiet["acc_map"] - out["acc_map"]).max() > 1e-4


def test_applied_noise_draws_from_the_generator():
    """Without injected noise the generator draws it: the same seed gives
    the same render, and test mode without a generator adds none."""
    model, model_fine = _port_pair()
    rays = [T(a) for a in _rays(8, seed=4)]
    rc = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE,
                      apply_noise=True, raw_noise_std=1.0)
    fn = make_render_rays(model, rc, model_fine=model_fine)
    with torch.no_grad():
        a, b = (fn(*rays, torch.Generator().manual_seed(6), is_test=False)
                for _ in range(2))
        quiet = make_render_rays(model, RenderConfig(n_samples=N_SAMPLES,
                                                     n_importance=N_IMPORTANCE),
                                 model_fine=model_fine)(*rays, None, is_test=True)
        test_mode = fn(*rays, None, is_test=True)
    torch.testing.assert_close(a["rgb_map"], b["rgb_map"], rtol=0, atol=0)
    torch.testing.assert_close(test_mode["rgb_map"], quiet["rgb_map"], rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# one hierarchical training step against JAX's make_train_step
# ---------------------------------------------------------------------- #


def _pair_names(tree):
    return {side: _port_names(tree[side]) for side in ("coarse", "fine")}


@functools.lru_cache(maxsize=None)
def jax_hier_step():
    """One cfnerf_tpu hierarchical step on the pair: (batch, draws,
    metrics, gradients, parameters after the update), the last two per
    net under the port's names."""
    jm, jmf, params, _, _ = _pair()
    batch = make_batch(*RAYS, seed=6)
    key = jax.random.PRNGKey(KEY)
    cfg = jstep.TrainConfig(**TRAIN_KW)
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE,
                              perturb=True, use_viewdirs=True)
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, cfg, model_fine=jmf)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    new_params, state, metrics = step(p, tx.init(p), batch, key)
    return (batch, jax_draws(key, sum(RAYS), COARSE.k),
            {k: float(v) for k, v in metrics.items()},
            _pair_names(state[0]), _pair_names(new_params))


def port_hier_step(models, batch, draws, remat=False):
    """The loss half of the port's hierarchical step; returns (step,
    metrics, gradients per net)."""
    model, model_fine = models
    step, _ = make_train_step(
        model, RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE),
        TrainConfig(**TRAIN_KW, remat=remat), model_fine=model_fine)
    loss, metrics = step.loss_fn(batch, None, **_port_draws(draws))
    loss.backward()
    grads = {side: {n: to_np(p.grad) for n, p in m.named_parameters()}
             for side, m in (("coarse", model), ("fine", model_fine))}
    return step, {k: float(v.detach()) for k, v in metrics.items()}, grads


def _assert_step_matches(models, step, metrics, grads, ref_metrics, ref_grads, ref_after):
    assert set(metrics) == set(ref_metrics) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=1e-5, err_msg=k)
    for side in ("coarse", "fine"):
        assert_grads_close(grads[side], ref_grads[side], GRAD_TOL)
    step.update()
    for side, model in zip(("coarse", "fine"), models):
        assert_params_after_update_close(model, ref_after[side], ref_grads[side],
                                         TRAIN_KW["lrate"])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_hierarchical_train_step_matches_jax(remat):
    batch, draws, jm, jg, jafter = jax_hier_step()
    models = _port_pair()
    step, tm, tg = port_hier_step(models, batch, draws, remat=remat)
    _assert_step_matches(models, step, tm, tg, jm, jg, jafter)


def test_hierarchical_mse_mode_adds_the_coarse_mse():
    batch, draws, _, _, _ = jax_hier_step()
    model, model_fine = _port_pair()
    step, _ = make_train_step(
        model, RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE),
        TrainConfig(**TRAIN_KW, loss_mode="mse"), model_fine=model_fine)
    with torch.no_grad():
        _, m = step.loss_fn(batch, None, **_port_draws(draws))
    assert m["loss_nll"] == 0.0
    torch.testing.assert_close(m["loss"], m["mse"] + 0.01 * m["depth_loss"] + m["loss_nll0"])


def test_hierarchical_step_updates_both_nets_from_one_generator():
    model, model_fine = _port_pair()
    start = [p.detach().clone() for m in (model, model_fine) for p in m.parameters()]
    step, optimizer = make_train_step(
        model, RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE),
        TrainConfig(**TRAIN_KW), model_fine=model_fine)
    assert len(optimizer.param_groups[0]["params"]) == len(start)
    metrics = step(make_batch(*RAYS, seed=7), torch.Generator().manual_seed(3))
    assert all(torch.isfinite(v) for v in metrics.values()) and "loss_nll0" in metrics
    moved = [not torch.equal(a, p.detach()) for a, p in
             zip(start, [p for m in (model, model_fine) for p in m.parameters()])]
    n_coarse = len(list(model.parameters()))
    assert any(moved[:n_coarse]) and any(moved[n_coarse:])


# ---------------------------------------------------------------------- #
# the factory
# ---------------------------------------------------------------------- #


def test_build_model_with_n_importance_builds_the_fine_net():
    args = types.SimpleNamespace(
        multires=10, multires_views=4, i_embed=0, use_viewdirs=True, netdepth=4,
        netwidth=32, netdepth_fine=2, netwidth_fine=48, h_alpha_size=8, h_rgb_size=8,
        n_flows=2, K_samples=4, type_flows="triangular", N_importance=12, N_samples=16,
        perturb=1.0, white_bkgd=False, raw_noise_std=0.0, seed=3)
    model, model_fine, rc = build_model(args, device="cpu")
    assert rc.n_importance == 12
    assert (model.net_depth, model.net_width) == (4, 32)
    assert (model_fine.net_depth, model_fine.net_width) == (2, 48)
    assert model_fine.skips == (1,) and model_fine.k_samples == 4
    # the fine net is seeded + 1: the seed-4 net's first layer at its width
    twin, _, _ = build_model(types.SimpleNamespace(
        **{**vars(args), "seed": 4, "netdepth": 2, "netwidth": 48, "N_importance": 0}),
        device="cpu")
    torch.testing.assert_close(model_fine.pts_linears[0].weight, twin.pts_linears[0].weight,
                               rtol=0, atol=0)
    _, none, _ = build_model(types.SimpleNamespace(**{**vars(args), "N_importance": 0}),
                             device="cpu")
    assert none is None


# ---------------------------------------------------------------------- #
# golden for the card: a JAX test-mode render and one training step of
# the tiny pair, with their inputs
# ---------------------------------------------------------------------- #


def hier_golden_arrays():
    _, _, params, ec, ef = _pair()
    rays = _rays(16, seed=1)
    render = jax_render_hier("pair", rays)
    batch, draws, metrics, grads, after = jax_hier_step()
    arrays = {f"p/{path}": leaf for path, leaf in _flatten(params)}
    arrays["test_eps_a"], arrays["test_eps_r"] = ec
    arrays["test_eps_fine_a"], arrays["test_eps_fine_r"] = ef
    arrays["config"] = np.array(
        [COARSE.depth, COARSE.width, FINE.depth, FINE.width, COARSE.k, COARSE.flows,
         COARSE.h_alpha, COARSE.h_rgb, N_SAMPLES, N_IMPORTANCE], np.int64)
    arrays["train"] = np.array([TRAIN_KW[k] for k in TRAIN_FIELDS], np.float64)
    arrays.update({f"rays/{k}": v for k, v in
                   zip(("rays_o", "rays_d", "viewdirs", "near", "far"), rays)})
    arrays.update({f"jax/render/{k}": render[k] for k in MAPS})
    arrays.update({f"batch/{k}": v for k, v in batch.items()})
    arrays["t_rand"], arrays["pdf_u"] = draws["t_rand"], draws["pdf_u"]
    arrays["eps_a"], arrays["eps_r"] = draws["eps"]
    arrays["eps_fine_a"], arrays["eps_fine_r"] = draws["eps_fine"]
    arrays.update({f"jax/{k}": np.float32(v) for k, v in metrics.items()})
    for side in ("coarse", "fine"):
        arrays.update({f"grad/{side}/{k}": v for k, v in grads[side].items()})
        arrays.update({f"after/{side}/{k}": v for k, v in after[side].items()})
    return arrays


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val, np.float32)


def save_hier_golden():
    np.savez_compressed(GOLDEN, **hier_golden_arrays())


def test_hier_golden_is_current():
    assert GOLDEN.exists(), "run: python -m tests.test_torch_hierarchical"
    assert GOLDEN.stat().st_size < 1 << 20
    fresh = hier_golden_arrays()
    with np.load(GOLDEN) as saved:
        assert set(saved.files) == set(fresh)
        for k in fresh:
            if k.startswith(("jax/", "grad/", "after/")):
                # XLA's CPU reductions are deterministic on one build; the
                # margin only absorbs a thread-count-dependent summation order
                np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-6, atol=1e-9,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_hier_golden_renders_and_steps_through_the_port():
    """What chip_smoke.py does on the card, here through the plain versions."""
    with np.load(GOLDEN) as g:
        g = {k: g[k] for k in g.files}
    D, Wd, Df, Wf, K, F, ha, hr, S, NI = (int(v) for v in g["config"])
    params = {}
    for k, v in g.items():
        if k.startswith("p/"):
            node = params
            *parents, leaf = k[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    sd, sd_fine = nerf_flows_pair_state_dicts_from_jax(
        params, (g["test_eps_a"], g["test_eps_r"]),
        (g["test_eps_fine_a"], g["test_eps_fine_r"]))

    def nets():
        out = []
        for (d, w), state in (((D, Wd), sd), ((Df, Wf), sd_fine)):
            m = NeRFFlows(net_depth=d, net_width=w, skips=(d // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K)
            m.load_state_dict(state)
            out.append(m)
        return out

    model, model_fine = nets()
    rays = [T(g[f"rays/{k}"]) for k in ("rays_o", "rays_d", "viewdirs", "near", "far")]
    with torch.no_grad():
        out = make_render_rays(model, RenderConfig(n_samples=S, n_importance=NI, perturb=False),
                               model_fine=model_fine)(*rays, None, is_test=True)
    _assert_maps_close({k: to_np(v) for k, v in out.items()},
                       {k: g[f"jax/render/{k}"] for k in MAPS})

    models = nets()
    batch = {k[6:]: v for k, v in g.items() if k.startswith("batch/")}
    draws = dict(t_rand=g["t_rand"], pdf_u=g["pdf_u"], eps=(g["eps_a"], g["eps_r"]),
                 eps_fine=(g["eps_fine_a"], g["eps_fine_r"]))
    step, tm, tg = port_hier_step(models, batch, draws)
    per_side = {pre: {side: {k[len(pre) + len(side) + 2:]: v for k, v in g.items()
                             if k.startswith(f"{pre}/{side}/")}
                      for side in ("coarse", "fine")} for pre in ("grad", "after")}
    _assert_step_matches(models, step, tm, tg, {k: float(g[f"jax/{k}"]) for k in METRICS},
                         per_side["grad"], per_side["after"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_hier_golden()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
