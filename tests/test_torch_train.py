"""The training slice: the port's losses, optimizer and train step against
cfnerf_tpu's, plus the golden file that lets chip_smoke.py hold the card's
training step against JAX numbers.

One training step is compared with JAX's real make_train_step on converted
weights.  JAX's key is split as its renderer and model split it, and the
port is handed the same stratified uniforms and shared-K eps.  JAX's
gradients are read from the step by chaining a transform in front of Adam
that keeps them in the optimizer state.

The trunk is D=2/W=32.  At D=4/W=64, 8192 points put a ReLU input within
rounding of zero; the two frameworks then switch it differently, which moves
one weight gradient past the tolerance.

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_train
(test_train_golden_is_current fails while the committed file is stale).
"""
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import loss as jloss
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.ops.sampling import sample_z_vals, stratified_perturb
from cfnerf_torch.parallel.mesh import create_mesh
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train import loss as tloss
from cfnerf_torch.train.step import (
    TrainConfig,
    make_optimizer,
    make_train_loop,
    make_train_step,
)
from tests.test_torch_common import Tiny, jax_nerf_flows, port_nerf_flows, to_np

GOLDEN = Path(__file__).parent / "fixtures" / "torch_port_train_golden.npz"
CFG = Tiny(depth=2, width=32, k=8, flows=2, h_alpha=16, h_rgb=16)
# the flagship's loss settings (configs/africa_ds.txt), a small view
TRAIN_KW = dict(H=10, W=10, focal=10.0, ndc=False, near=2.0, far=6.0, k_samples=CFG.k,
                lrate=5e-4, beta1=0.01, colmap_depth=True, depth_lambda=0.01)
METRICS = ("loss", "loss_nll", "loss_entropy", "depth_loss", "mse", "psnr")
# loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6, the rule of
# tests/test_torch_render_core.py's gradient checks
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# parameters after one Adam step, where |g| >= 1e-5 (so its sign and the
# ratio g / (|g| + 1e-8) agree between the two gradients): 1e-6, a few f32
# ulps of the weights.  Elsewhere one step moves a weight by at most lr.
ADAM_G_MIN, ADAM_ATOL = 1e-5, 1e-6

T = torch.as_tensor


def make_batch(n_rgb, n_depth, seed):
    """Rays from around (0, 0, 4) towards the origin, random colours and
    COLMAP-style depths in (near, far)."""
    rng = np.random.RandomState(seed)

    def rays(n):
        o = rng.randn(n, 3) * 0.3 + [0.0, 0.0, 4.0]
        d = -o / np.linalg.norm(o, axis=-1, keepdims=True) + rng.randn(n, 3) * 0.2
        return o.astype(np.float32), d.astype(np.float32)

    ro, rd = rays(n_rgb)
    dro, drd = rays(n_depth)
    return dict(rays_o=ro, rays_d=rd, target=rng.rand(n_rgb, 3).astype(np.float32),
                depth_rays_o=dro, depth_rays_d=drd,
                target_depth=(2.0 + 4.0 * rng.rand(n_depth)).astype(np.float32))


def jax_draws(key, n_rays, n_samples, k):
    """The uniforms and eps that JAX's train-mode render draws from `key`
    (renderer.py:172-182, nerf_flows.py:296-298, sampling.py:69)."""
    rng_z, rng_eps = jax.random.split(key, 5)[:2]
    t_rand = jax.random.uniform(rng_z, (n_rays, n_samples))
    ka, kr = jax.random.split(rng_eps)
    eps = (jax.random.normal(ka, (k, 1)), jax.random.normal(kr, (k, 3)))
    return np.asarray(t_rand), tuple(np.asarray(e) for e in eps)


def _keep_grads():
    """An optax transform that passes updates on and keeps them as state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))


@contextlib.contextmanager
def _grads_in_opt_state():
    real = jstep.make_optimizer
    jstep.make_optimizer = lambda cfg: optax.chain(_keep_grads(), real(cfg))
    try:
        yield
    finally:
        jstep.make_optimizer = real


def _port_names(tree):
    return {k: v.numpy() for k, v in nerf_flows_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def jax_step(params, batch, key, n_samples, fused, **over):
    """One cfnerf_tpu make_train_step step.  Returns metrics, gradients and
    parameters after the update, the last two under the port's names."""
    cfg = jstep.TrainConfig(**{**TRAIN_KW, **over})
    rc = jrender.RenderConfig(n_samples=n_samples, perturb=True, use_viewdirs=True,
                              fused=fused)
    jm, _, _ = jax_nerf_flows(CFG)
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    new_params, state, metrics = step(p, tx.init(p), batch, key)
    return ({k: float(v) for k, v in metrics.items()}, _port_names(state[0]),
            _port_names(new_params))


def port_z_vals(t_rand, n_samples):
    R = t_rand.shape[0]
    near = torch.full((R, 1), TRAIN_KW["near"])
    far = torch.full((R, 1), TRAIN_KW["far"])
    z = sample_z_vals(near, far, n_samples).expand(R, n_samples)
    return stratified_perturb(z, t_rand=T(np.array(t_rand)))


def port_grads(model, batch, t_rand, eps, n_samples, remat=False, **over):
    """The loss half of the port's step; returns (step, metrics, grads)."""
    cfg = TrainConfig(**{**TRAIN_KW, **over}, remat=remat)
    step, _ = make_train_step(model, RenderConfig(n_samples=n_samples), cfg)
    loss, metrics = step.loss_fn(batch, None, z_vals=port_z_vals(t_rand, n_samples),
                                 eps=eps)
    loss.backward()
    grads = {n: to_np(p.grad) for n, p in model.named_parameters()}
    return step, {k: float(v.detach()) for k, v in metrics.items()}, grads


def assert_grads_close(grads, ref, tol=GRAD_TOL):
    assert set(grads) == set(ref)
    for name in ref:
        np.testing.assert_allclose(grads[name], ref[name], err_msg=name, **tol)


def assert_params_after_update_close(model, after, grads, lr):
    for name, p in model.named_parameters():
        got, want, g = to_np(p), after[name], np.abs(grads[name])
        diff = np.abs(got - want)
        assert np.all(diff[g >= ADAM_G_MIN] <= ADAM_ATOL), name
        assert np.all(diff <= 2 * lr + ADAM_ATOL), name


# ---------------------------------------------------------------------- #
# losses and optimizer
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("beta1", [0.0, 0.01])
def test_losses_match_jax_values_and_gradients(beta1):
    rng = np.random.RandomState(0)
    R, D, K = 24, 8, 8
    rgbs = rng.rand(R, 3, K).astype(np.float32)
    rgbs[0] = 0.5  # a ray whose draws agree: zero std, bandwidth KDE_EPS
    target = rng.rand(R, 3).astype(np.float32)
    depth_k = (2 + 4 * rng.rand(D, K)).astype(np.float32)
    target_depth = (2 + 4 * rng.rand(D)).astype(np.float32)
    entropy = np.float32(3.7)

    def jfun(r, d, e):
        loss, m = jloss.total_loss(r, target, e, k_samples=K, beta1=beta1, depth_k=d,
                                   target_depth=target_depth, depth_lambda=0.01)
        return loss, m

    (jl, jm), jg = jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(rgbs), jnp.asarray(depth_k), jnp.asarray(entropy))
    tr, td, te = (T(x).requires_grad_() for x in (rgbs, depth_k, entropy))
    tl, tm = tloss.total_loss(tr, T(target), te, k_samples=K, beta1=beta1, depth_k=td,
                              target_depth=T(target_depth), depth_lambda=0.01)
    tl.backward()
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    for name, t, j in zip(("rgbs", "depth_k"), (tr, td), jg):
        np.testing.assert_allclose(to_np(t.grad), np.asarray(j), err_msg=name, **GRAD_TOL)
    assert float(jg[2]) == pytest.approx(beta1)
    if beta1:
        assert float(te.grad) == pytest.approx(beta1)
    else:  # beta1 = 0 drops the entropy term: it has no gradient at all
        assert te.grad is None
    np.testing.assert_allclose(float(tloss.kde_nll(T(rgbs), T(target), K)),
                               float(jloss.kde_nll(jnp.asarray(rgbs), jnp.asarray(target), K)),
                               rtol=LOSS_RTOL)


def test_kde_bandwidth_is_detached():
    """The gradient is d/drgb of the Gaussian kernels at a fixed bandwidth."""
    rng = np.random.RandomState(1)
    rgbs = T(rng.rand(5, 3, 8).astype(np.float32)).requires_grad_()
    target = T(rng.rand(5, 3).astype(np.float32))
    tloss.kde_nll(rgbs, target, 8).backward()
    n = 8
    h = (torch.std(rgbs.detach(), -1, correction=1) * n / (n - 1)
         * (0.8 / n) ** (-1 / 7) + tloss.KDE_EPS)[..., None]
    r = rgbs.detach().requires_grad_()
    kern = torch.exp(-((r - target[..., None]) ** 2) / (2 * h * h)) * (2 * np.pi) ** -1.5 / h
    (-torch.log(kern.mean(-1) + tloss.KDE_EPS).mean()).backward()
    torch.testing.assert_close(rgbs.grad, r.grad)


def test_optimizer_matches_optax_with_a_start_step():
    cfg = TrainConfig(**TRAIN_KW, start_step=200_000)
    jcfg = jstep.TrainConfig(**TRAIN_KW, start_step=200_000)
    rng = np.random.RandomState(2)
    p0 = {"w": rng.randn(7, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-6, 0, v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]

    tx = jstep.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in p0.items()}
    opt, sched = make_optimizer(list(tp.values()), cfg)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = T(g[k])
        opt.step()
        sched.step()
        for k in p0:
            np.testing.assert_allclose(to_np(tp[k]), np.asarray(jp[k]), rtol=0, atol=1e-6)
    # the schedule: lrate * 0.1^((start + t) / (decay * 1000)) at update t = 3
    want = TRAIN_KW["lrate"] * 0.1 ** ((200_000 + 3) / 250_000)
    assert opt.param_groups[0]["lr"] == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------- #
# one training step against JAX's make_train_step
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("fused,n_rgb,n_depth,n_samples", [
    ("interpret", 96, 32, 64),  # the Pallas backward, through its interpreter
    ("off", 20, 7, 13),         # a shape the TPU kernel cannot take
], ids=["pallas_interpret", "unfused_awkward"])
def test_train_step_matches_jax(fused, n_rgb, n_depth, n_samples):
    _, params, test_eps = jax_nerf_flows(CFG)
    batch = make_batch(n_rgb, n_depth, seed=0)
    key = jax.random.PRNGKey(3)
    jm, jg, jafter = jax_step(params, batch, key, n_samples, fused)
    t_rand, eps = jax_draws(key, n_rgb + n_depth, n_samples, CFG.k)

    model = port_nerf_flows(CFG, params, test_eps)
    step, tm, tg = port_grads(model, batch, t_rand, eps, n_samples)
    assert set(tm) == set(jm) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert_grads_close(tg, jg)
    step.update()
    assert_params_after_update_close(model, jafter, jg, TRAIN_KW["lrate"])


def test_mse_loss_mode_matches_jax():
    _, params, test_eps = jax_nerf_flows(CFG)
    batch = make_batch(20, 7, seed=1)
    key = jax.random.PRNGKey(4)
    jm, jg, _ = jax_step(params, batch, key, 13, "off", loss_mode="mse")
    t_rand, eps = jax_draws(key, 27, 13, CFG.k)
    model = port_nerf_flows(CFG, params, test_eps)
    _, tm, tg = port_grads(model, batch, t_rand, eps, 13, loss_mode="mse")
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, atol=0, err_msg=k)
    assert tm["loss_nll"] == 0.0
    assert_grads_close(tg, jg)


def test_remat_gives_the_same_gradients():
    _, params, test_eps = jax_nerf_flows(CFG)
    batch = make_batch(20, 7, seed=2)
    t_rand, eps = jax_draws(jax.random.PRNGKey(5), 27, 13, CFG.k)
    out = [port_grads(port_nerf_flows(CFG, params, test_eps), batch, t_rand, eps, 13,
                      remat=remat)[1:] for remat in (False, True)]
    assert out[0][0] == out[1][0]
    for name in out[0][1]:
        np.testing.assert_array_equal(out[1][1][name], out[0][1][name], err_msg=name)


def test_remat_draws_from_the_generator_once_per_step():
    """Under remat the recompute reuses the step's eps: two models stepped
    from one seed, with and without remat, stay equal."""
    _, params, test_eps = jax_nerf_flows(CFG)
    batch = make_batch(20, 7, seed=3)
    models = []
    for remat in (False, True):
        model = port_nerf_flows(CFG, params, test_eps)
        step, _ = make_train_step(model, RenderConfig(n_samples=13),
                                  TrainConfig(**TRAIN_KW, remat=remat))
        g = torch.Generator().manual_seed(11)
        for _ in range(2):
            step(batch, g)
        models.append(model)
    for (name, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------------- #
# the step's surface
# ---------------------------------------------------------------------- #


def _port_model():
    _, params, test_eps = jax_nerf_flows(CFG)
    return port_nerf_flows(CFG, params, test_eps)


@pytest.mark.parametrize("render_config", [RenderConfig(n_samples=13)], ids=["mesh"])
def test_later_slices_raise(render_config, tmp_path):
    """The device mesh, which the step refused before it was ported: over a
    one-rank gloo group (create_mesh(1)) the step takes the one-device
    step bitwise, its draws, gradient all-reduce and metric means
    included."""
    batch = make_batch(16, 8, seed=4)
    runs = []
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        for mesh in (None, create_mesh(1)):
            model = _port_model()
            step, _ = make_train_step(model, render_config, TrainConfig(**TRAIN_KW), mesh=mesh)
            metrics = step(batch, torch.Generator().manual_seed(3))
            runs.append((metrics, {k: p.detach().clone() for k, p in model.named_parameters()}))
    finally:
        dist.destroy_process_group()
    (m0, p0), (m1, p1) = runs
    assert set(m0) == set(m1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_occ_step_trains_on_cpu():
    """Proposal-placed training (slice 5): an occ step runs on the CPU, with
    finite metrics and prop_loss, and moves the field."""
    from cfnerf_torch.train.step import OccTrainConfig

    model = _port_model()
    step, _ = make_train_step(model, RenderConfig(n_samples=12), TrainConfig(**TRAIN_KW),
                              occ=OccTrainConfig(lo=(-1.5, -1.5, -2.0), hi=(1.5, 1.5, 5.0),
                                                 n_candidates=32, cotrain_points=128))
    start = [p.detach().clone() for p in model.parameters()]
    metrics = step(make_batch(12, 4, seed=6), torch.Generator().manual_seed(3))
    assert "prop_loss" in metrics and all(torch.isfinite(v) for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(start, model.parameters()))


def test_a_fine_net_without_a_fine_pass_is_refused():
    with pytest.raises(ValueError, match="n_importance"):
        make_train_step(_port_model(), RenderConfig(n_samples=13), TrainConfig(**TRAIN_KW),
                        model_fine=_port_model())


def test_shared_net_hierarchical_step_trains_the_one_net():
    """N_importance without a fine net: both passes through the model, the
    coarse loss added (the JAX step's shared-net case)."""
    model = _port_model()
    step, optimizer = make_train_step(model, RenderConfig(n_samples=8, n_importance=4),
                                      TrainConfig(**TRAIN_KW))
    start = [p.detach().clone() for p in model.parameters()]
    metrics = step(make_batch(12, 4, seed=5), torch.Generator().manual_seed(2))
    assert "loss_nll0" in metrics and all(torch.isfinite(v) for v in metrics.values())
    assert len(optimizer.param_groups[0]["params"]) == len(start)
    assert any(not torch.equal(a, p) for a, p in zip(start, model.parameters()))


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_one_generator_on_another_device_drives_both_draws():
    """The jitter is drawn on the generator's device and moved to the
    depths' device; the eps is drawn on the generator's device and moved to
    the model's.  A CPU generator serves tensors that live on the card."""
    z = sample_z_vals(torch.full((4, 1), 2.0), torch.full((4, 1), 6.0), 16).expand(4, 16)
    on_card = z.contiguous().as_subclass(_OnCuda)
    got = stratified_perturb(on_card, torch.Generator().manual_seed(3))
    want = stratified_perturb(z, t_rand=torch.rand(4, 16, generator=torch.Generator().manual_seed(3)))
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want, rtol=0, atol=0)

    model = _port_model()
    g = torch.Generator().manual_seed(4)
    eps_a, eps_r = model._draw_eps(False, g, None)
    g2 = torch.Generator().manual_seed(4)
    torch.testing.assert_close(eps_a, torch.randn(CFG.k, 1, generator=g2))
    torch.testing.assert_close(eps_r, torch.randn(CFG.k, 3, generator=g2))


def test_step_follows_the_model_device_and_the_generator():
    batch = make_batch(12, 4, seed=4)
    runs = []
    for seed in (7, 7, 8):
        model = _port_model()
        step, _ = make_train_step(model, RenderConfig(n_samples=8), TrainConfig(**TRAIN_KW))
        metrics = step(batch, torch.Generator().manual_seed(seed))
        assert {v.device for v in metrics.values()} == {model.alpha_mean.device}
        assert all(torch.isfinite(v) for v in metrics.values())
        runs.append(metrics["loss"])
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_train_loop_is_n_steps():
    batches = [make_batch(12, 4, seed=s) for s in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    m1 = _port_model()
    loop, _ = make_train_loop(m1, RenderConfig(n_samples=8), TrainConfig(**TRAIN_KW), n_inner=3)
    out = loop(stacked, torch.Generator().manual_seed(9))
    m2 = _port_model()
    step, _ = make_train_step(m2, RenderConfig(n_samples=8), TrainConfig(**TRAIN_KW))
    g = torch.Generator().manual_seed(9)
    losses = [step(b, g)["loss"] for b in batches]
    assert out["loss"].shape == (3,)
    torch.testing.assert_close(out["loss"], torch.stack(losses), rtol=0, atol=0)
    for (name, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------------- #
# golden for the card: one JAX step of a tiny model, with its inputs
# ---------------------------------------------------------------------- #

GOLDEN_RAYS = (48, 16)  # rgb + depth rays
GOLDEN_SAMPLES = 32
GOLDEN_KEY = 7
# TrainConfig fields stored in the golden's "train" array, in this order
GOLDEN_TRAIN_FIELDS = ("H", "W", "focal", "near", "far", "beta1", "depth_lambda", "lrate")


def train_golden_arrays():
    _, params, test_eps = jax_nerf_flows(CFG)
    batch = make_batch(*GOLDEN_RAYS, seed=5)
    key = jax.random.PRNGKey(GOLDEN_KEY)
    metrics, grads, after = jax_step(params, batch, key, GOLDEN_SAMPLES, "off")
    t_rand, eps = jax_draws(key, sum(GOLDEN_RAYS), GOLDEN_SAMPLES, CFG.k)
    arrays = {f"p/{path}": leaf for path, leaf in _flatten(params)}
    arrays["test_eps_a"], arrays["test_eps_r"] = test_eps
    arrays["config"] = np.array([CFG.depth, CFG.width, CFG.k, CFG.flows, CFG.h_alpha,
                                 CFG.h_rgb, GOLDEN_SAMPLES], np.int64)
    arrays["train"] = np.array([TRAIN_KW[k] for k in GOLDEN_TRAIN_FIELDS], np.float64)
    arrays.update({f"batch/{k}": v for k, v in batch.items()})
    arrays["t_rand"], arrays["eps_a"], arrays["eps_r"] = t_rand, eps[0], eps[1]
    arrays.update({f"jax/{k}": np.float32(v) for k, v in metrics.items()})
    arrays.update({f"grad/{k}": v for k, v in grads.items()})
    arrays.update({f"after/{k}": v for k, v in after.items()})
    return arrays


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val, np.float32)


def save_train_golden():
    np.savez_compressed(GOLDEN, **train_golden_arrays())


def test_train_golden_is_current():
    assert GOLDEN.exists(), "run: python -m tests.test_torch_train"
    assert GOLDEN.stat().st_size < 1 << 20
    fresh = train_golden_arrays()
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


def test_train_golden_steps_through_the_port():
    """What chip_smoke.py does on the card, here through the plain version."""
    with np.load(GOLDEN) as g:
        D, W, K, F, ha, hr, S = (int(v) for v in g["config"])
        params = {}
        for k in g.files:
            if k.startswith("p/"):
                node = params
                *parents, leaf = k[2:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = g[k]
        model = NeRFFlows(net_depth=D, net_width=W, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K)
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            params, (g["test_eps_a"], g["test_eps_r"])))
        batch = {k[6:]: g[k] for k in g.files if k.startswith("batch/")}
        step, tm, tg = port_grads(model, batch, g["t_rand"], (g["eps_a"], g["eps_r"]), S)
        for k in METRICS:
            np.testing.assert_allclose(tm[k], float(g[f"jax/{k}"]), rtol=LOSS_RTOL, err_msg=k)
        assert_grads_close(tg, {k[5:]: g[k] for k in g.files if k.startswith("grad/")})
        step.update()
        assert_params_after_update_close(
            model, {k[6:]: g[k] for k in g.files if k.startswith("after/")},
            {k[5:]: g[k] for k in g.files if k.startswith("grad/")},
            float(g["train"][GOLDEN_TRAIN_FIELDS.index("lrate")]))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_train_golden()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
