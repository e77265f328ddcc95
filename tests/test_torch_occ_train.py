"""Proposal-placed training (the occ stage) in the port against cfnerf_tpu's
make_train_step(occ=...), the stage schedules of train/loop.py, and the
golden file that lets chip_smoke.py hold the card's occ step against JAX.

JAX's step runs op by op, as its source rounds each bf16 product and add
(see jax_occ_steps).  JAX's draws are recomputed from its key as its occ
step splits it
(cfnerf_tpu/train/step.py:318-322, :218-219; renderer.py:172-174) and
injected into the port: the placement's u (place_u), the base draws (eps)
and the co-training points (prop_pts).  JAX's gradients are read from the
step by chaining a transform in front of Adam (tests/test_torch_train.py).

Tolerances:
  * loss and metrics rtol 1e-5 (measured <= 3.2e-7), the field's weights
    after Adam 1e-6 where |g| >= 1e-5: tests/test_torch_train.py's rules;
  * the field's gradients per leaf: relative RMS <= 1e-2, cosine >= 0.9999.
    The placed depths differ from JAX's by a few f32 ulp (cumsum against a
    triangular matmul, bf16 products summed in another order), and a trunk
    ReLU input within rounding of 0 then switches the other way, which
    moves a few first-layer gradient entries by their own size: measured
    <= 3.2e-3 / >= 0.999995, where the elementwise rule of
    tests/test_torch_train.py fails on 0.3% of one layer's entries;
  * prop_loss rtol 1e-4: the bf16 proposal against the f32 field's density;
  * the proposal after its Adam step: 1e-6 where its |g| >= 1e-5, as the
    field; elsewhere one step's reach, 2 lr (its gradients come through bf16
    products, which XLA and PyTorch may round apart, and Adam's first step
    turns a gradient near 0 into a step of up to lr either way);
  * a second step starts from weights that agree to those tolerances; its
    loss and metrics are held to rtol 1e-4, its prop_loss to rtol 1e-3 (the
    proposal's entries with |g| < 1e-5 may sit 2 lr apart after the first
    step).  Adam's second update divides by the root of two steps' squared
    gradients, so the first step's ReLU switches reach the weights: each
    leaf's two-step update (after minus start) is held by relative RMS
    <= 0.1 and cosine >= 0.999 (measured <= 3.6e-2 / >= 0.9993 on the
    first trunk layers, <= 1.3e-3 on the proposal).

Regenerate the golden after an intended change with
    JAX_PLATFORMS=cpu python -m tests.test_torch_occ_train
(test_occ_golden_is_current fails while the committed file is stale).
"""
import contextlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops import occupancy as jocc
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import loop as jloop
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax, proposal_state_dict_from_jax
from cfnerf_torch.ops import occupancy as tocc
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train import loop as tloop
from cfnerf_torch.train.step import OccTrainConfig, TrainConfig, make_train_loop, make_train_step
from tests.test_torch_common import Tiny, jax_nerf_flows, port_nerf_flows, to_np
from tests.test_torch_train import (
    ADAM_ATOL,
    ADAM_G_MIN,
    GRAD_TOL,
    LOSS_RTOL,
    TRAIN_KW,
    _flatten,
    _grads_in_opt_state,
    _port_names,
    assert_params_after_update_close,
    make_batch,
)

GOLDEN = Path(__file__).parent / "fixtures" / "torch_port_occ_golden.npz"
CFG = Tiny(depth=2, width=32, k=8, flows=2, h_alpha=16, h_rgb=16)
N_PLACED, N_CAND, COTRAIN = 12, 32, 256
RAYS = (48, 16)  # rgb + depth rays
OCC = dict(lo=(-1.5, -1.5, -2.0), hi=(1.5, 1.5, 5.0), n_candidates=N_CAND, floor=0.3,
           cotrain_points=COTRAIN)
PROP_LR = 2e-3
METRICS = ("loss", "loss_nll", "loss_entropy", "depth_loss", "mse", "psnr", "prop_loss")
T = torch.as_tensor


def _jax_proposal_params(seed=1):
    prop = jocc.ProposalMLP()
    return jax.tree_util.tree_map(np.asarray, prop.init(jax.random.PRNGKey(seed)))


def jax_occ_steps(params, prop_params, batches, keys, cfg=CFG):
    """cfnerf_tpu's occ step, once per batch, op by op (the step's `_update`
    without its jit: under jit XLA may skip the bf16 roundings of the
    proposal's hidden layers, xla_allow_excess_precision, which moves the
    placed depths by ~4e-5).  Returns per step: metrics,
    the field's gradients, the field's and the proposal's weights after it,
    the field's under the port's names."""
    jm, _, _ = jax_nerf_flows(cfg)
    cfg = jstep.TrainConfig(**TRAIN_KW)
    rc = jrender.RenderConfig(n_samples=N_PLACED, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, cfg, occ=jstep.OccTrainConfig(**OCC))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = step._wrap_state(tx.init(p), jax.tree_util.tree_map(jnp.asarray, prop_params))
    out = []
    for batch, key in zip(batches, keys):
        p, state, metrics = step._update(p, state, batch, key)
        out.append(({k: float(v) for k, v in metrics.items()}, _port_names(state[0][0]),
                    _port_names(p), proposal_state_dict_from_jax(
                        jax.tree_util.tree_map(np.asarray, state[1]))))
    return out


def jax_occ_draws(key, n_rays):
    """The draws of one JAX occ step: place_u (R, N), eps, prop_pts."""
    rng, rng_pts = jax.random.split(key)
    rng, rng_place = jax.random.split(rng)
    rng_eps = jax.random.split(rng, 5)[1]
    ka, kr = jax.random.split(rng_eps)
    return dict(place_u=np.asarray(jax.random.uniform(rng_place, (n_rays, N_PLACED))),
                eps=(np.asarray(jax.random.normal(ka, (CFG.k, 1))),
                     np.asarray(jax.random.normal(kr, (CFG.k, 3)))),
                prop_pts=np.asarray(jax.random.uniform(rng_pts, (COTRAIN, 3), jnp.float32)))


def port_occ_step(model, prop_params):
    step, _ = make_train_step(model, RenderConfig(n_samples=N_PLACED), TrainConfig(**TRAIN_KW),
                              occ=OccTrainConfig(**OCC))
    step.install_proposal(proposal_state_dict_from_jax(prop_params))
    return step


def port_step_once(step, model, batch, draws, z_vals=None):
    """One port occ step split as the JAX step runs it, placed from
    draws["place_u"] or at `z_vals` where given; returns (metrics, the
    field's gradients)."""
    model.zero_grad(set_to_none=True)
    loss, metrics = step.loss_fn(batch, None, eps=draws["eps"], place_u=T(draws["place_u"]),
                                 z_vals=None if z_vals is None else T(z_vals))
    loss.backward()
    grads = {n: to_np(p.grad) for n, p in model.named_parameters()}
    step.update()
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    metrics["prop_loss"] = float(step.cotrain(None, prop_pts=T(draws["prop_pts"])))
    return metrics, grads


GRAD_REL_RMS, GRAD_MIN_COS = 1e-2, 0.9999
UPDATE_REL_RMS, UPDATE_MIN_COS = 0.1, 0.999


def assert_grads_rms_close(grads, ref):
    assert set(grads) == set(ref)
    for name, want in ref.items():
        got = grads[name]
        if not np.any(want):
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        cos = np.sum(got * want) / np.linalg.norm(got) / np.linalg.norm(want)
        assert rel <= GRAD_REL_RMS and cos >= GRAD_MIN_COS, (name, rel, cos)


def assert_updates_close(state, want, start):
    """Each leaf's update since `start` against JAX's: relative RMS and
    cosine (UPDATE_REL_RMS, UPDATE_MIN_COS)."""
    for name, ref in want.items():
        got, ref = (to_np(v) - to_np(start[name]) for v in (state[name], ref))
        if not np.any(ref):
            continue
        rel = np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))
        cos = np.sum(got * ref) / np.linalg.norm(got) / np.linalg.norm(ref)
        assert rel <= UPDATE_REL_RMS and cos >= UPDATE_MIN_COS, (name, rel, cos)


def assert_proposal_close(prop, want, prop_grads, lr=PROP_LR):
    for name, p in prop.state_dict().items():
        got, ref, g = to_np(p), to_np(want[name]), np.abs(prop_grads[name])
        diff = np.abs(got - ref)
        assert np.all(diff[g >= ADAM_G_MIN] <= ADAM_ATOL), name
        assert np.all(diff <= 2 * lr + ADAM_ATOL), name


def _prop_grads(step):
    return {n: to_np(p.grad) for n, p in step.proposal.named_parameters()}


# ---------------------------------------------------------------------- #
# the occ step against JAX's
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("n_steps", [1, 2])
def test_occ_steps_match_jax(n_steps):
    _, params, test_eps = jax_nerf_flows(CFG)
    prop_params = _jax_proposal_params()
    batches = [make_batch(*RAYS, seed=10 + i) for i in range(n_steps)]
    keys = [jax.random.PRNGKey(20 + i) for i in range(n_steps)]
    ref = jax_occ_steps(params, prop_params, batches, keys)

    model = port_nerf_flows(CFG, params, test_eps)
    step = port_occ_step(model, prop_params)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        jm, jg, jafter, jprop = ref[i]
        metrics, grads = port_step_once(step, model, batch, jax_occ_draws(key, sum(RAYS)))
        assert set(metrics) == set(jm) == set(METRICS)
        for k in METRICS:
            if k == "prop_loss":
                rtol = 1e-4 if i == 0 else 1e-3
            else:
                rtol = LOSS_RTOL if i == 0 else 1e-4
            np.testing.assert_allclose(metrics[k], jm[k], rtol=rtol, err_msg=k)
        if i == 0:
            assert_grads_rms_close(grads, jg)
            assert_params_after_update_close(model, jafter, grads, TRAIN_KW["lrate"])
            assert_proposal_close(step.proposal, jprop, _prop_grads(step))
        else:
            assert_updates_close(model.state_dict(), jafter, nerf_flows_state_dict_from_jax(params))
            assert_updates_close(step.proposal.state_dict(), jprop,
                                 proposal_state_dict_from_jax(prop_params))


# the occ step on JAX's own depths, at the size of the tests above and at
# D4/W64: JAX's placement, recorded as its step runs, is handed to the port
# through z_vals, so the step is held at the unfused step's gates (gradients
# rtol 1e-4 / atol 1e-6, tests/test_torch_train.py) and the placement apart
# at its own atol, 1e-3 (PERF.md section 2: 0.8% of a candidate bin).  The
# inputs are those that spread most (model seed 0, proposal seed 80, batch
# seed 190, key 500): placed by each side, a first-layer gradient of the
# D4/W64 step reads ~1.4e-2 relative RMS from JAX's, as a ReLU input within
# rounding of 0 switches.
OCC_SIZES = {"D2W32": CFG, "D4W64": Tiny(depth=4, width=64, k=8, flows=2, h_alpha=16,
                                           h_rgb=16)}
PLACE_ATOL = 1e-3


@contextlib.contextmanager
def recorded_jax_depths():
    """JAX's placed depths, each call's (per member under jax.vmap) appended
    to the yielded list as its step places them."""
    seen, real = [], jocc.place_from_sigma

    def spy(*args, **kwargs):
        z = real(*args, **kwargs)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), z)
        return z

    jocc.place_from_sigma = spy
    try:
        yield seen
    finally:
        jocc.place_from_sigma = real


def port_placement(proposal, batch, place_u, floor=OCC["floor"]):
    """The port's placed depths of the batch's rays through `proposal`, at
    the stratified draws place_u."""
    from cfnerf_torch.train.step import batch_rays

    _, (ro, rd, _, near, far) = batch_rays(batch, TrainConfig(**TRAIN_KW),
                                           RenderConfig(n_samples=N_PLACED), "cpu")
    sigma_fn = tocc.make_proposal_sigma_fn(proposal, T(OCC["lo"]), T(OCC["hi"]))
    with torch.no_grad():
        return to_np(tocc.place_from_sigma(sigma_fn, ro, rd, near, far, N_PLACED,
                                           n_candidates=N_CAND, floor=floor, u=T(place_u)))


@pytest.mark.parametrize("size", list(OCC_SIZES))
def test_occ_step_on_jax_depths_matches_jax(size):
    cfg = OCC_SIZES[size]
    _, params, test_eps = jax_nerf_flows(cfg)
    prop_params = _jax_proposal_params(seed=80)
    batch = make_batch(*RAYS, seed=190)
    key = jax.random.PRNGKey(500)
    with recorded_jax_depths() as seen:
        (jm, jg, jafter, jprop), = jax_occ_steps(params, prop_params, [batch], [key], cfg)
    (z_jax,) = seen
    draws = jax_occ_draws(key, sum(RAYS))

    model = port_nerf_flows(cfg, params, test_eps)
    step = port_occ_step(model, prop_params)
    z_port = port_placement(step.proposal, batch, draws["place_u"])
    assert np.abs(z_port - z_jax).max() <= PLACE_ATOL
    metrics, grads = port_step_once(step, model, batch, draws, z_vals=z_jax)
    for k in METRICS:
        np.testing.assert_allclose(metrics[k], jm[k], rtol=1e-4 if k == "prop_loss" else
                                   LOSS_RTOL, err_msg=k)
    assert set(grads) == set(jg)
    for name, want in jg.items():
        np.testing.assert_allclose(grads[name], want, err_msg=name, **GRAD_TOL)
    assert_params_after_update_close(model, jafter, grads, TRAIN_KW["lrate"])
    assert_proposal_close(step.proposal, jprop, _prop_grads(step))


PLACEMENT_SCRIPT = """
import hashlib, sys
import numpy as np, torch
from cfnerf_torch.ops import occupancy as tocc
g = torch.Generator().manual_seed(80)
prop = tocc.ProposalMLP(generator=g)
rng = np.random.RandomState(0)
R, C, N = 640, 128, 12
ro = torch.as_tensor(rng.randn(R, 3).astype(np.float32) * 0.3 + [0.0, 0.0, 4.0]).float()
rd = torch.as_tensor(-ro.numpy() + rng.randn(R, 3).astype(np.float32) * 0.2)
u = torch.as_tensor(rng.rand(R, N).astype(np.float32))
sigma_fn = tocc.make_proposal_sigma_fn(prop, torch.tensor([-1.5, -1.5, -2.0]),
                                       torch.tensor([1.5, 1.5, 5.0]))
with torch.no_grad():
    z = tocc.place_from_sigma(sigma_fn, ro, rd, 2.0, 6.0, N, n_candidates=C, floor=0.3, u=u)
print(hashlib.sha256(z.numpy().tobytes()).hexdigest())
"""


def test_placement_repeats_across_processes():
    """The proposal's placement of 640 rays x 128 candidates (ATen's CPU
    parallel loops split it over the threads) gives the same bytes in three
    fresh processes: the first call of ATen's vector math in a process no
    longer races (cfnerf_torch/__init__.py)."""
    root = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", PLACEMENT_SCRIPT], cwd=root,
                              stdout=subprocess.PIPE, text=True) for _ in range(3)]
    digests = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(digests[0]) == 64 and digests == digests[:1] * 3, digests


def test_floor_is_read_from_the_batch(monkeypatch):
    """batch["occ_floor"] overrides occ.floor: a floor of 1e6 places the
    uniform stratified schedule, and the default floor does not."""
    from cfnerf_torch.train import step as tstep

    _, params, test_eps = jax_nerf_flows(CFG)
    model = port_nerf_flows(CFG, params, test_eps)
    step = port_occ_step(model, _jax_proposal_params())
    batch = make_batch(*RAYS, seed=3)
    u = np.random.RandomState(4).rand(sum(RAYS), N_PLACED).astype(np.float32)
    eps = jax_occ_draws(jax.random.PRNGKey(0), sum(RAYS))["eps"]
    seen = []

    def spy(*a, **kw):
        z = tocc.place_from_sigma(*a, **kw)
        seen.append((kw["floor"], z))
        return z

    monkeypatch.setattr(tstep, "place_from_sigma", spy)
    with torch.no_grad():
        step.loss_fn(batch, None, place_u=T(u), eps=eps)
        step.loss_fn({**batch, "occ_floor": np.float32(1e6)}, None, place_u=T(u), eps=eps)
    (f0, z0), (f1, z1) = seen
    assert f0 == 0.3 and float(f1) == 1e6
    near, far = TRAIN_KW["near"], TRAIN_KW["far"]
    uniform = near + (np.arange(N_PLACED) + u) / N_PLACED * (far - near)
    np.testing.assert_allclose(to_np(z1), np.sort(uniform, -1), atol=2e-3)
    assert np.abs(to_np(z0) - np.sort(uniform, -1)).max() > 1e-2


def test_occ_refuses_a_fine_pass():
    _, params, test_eps = jax_nerf_flows(CFG)
    with pytest.raises(ValueError, match="hierarchical fine pass"):
        make_train_step(port_nerf_flows(CFG, params, test_eps),
                        RenderConfig(n_samples=8, n_importance=4), TrainConfig(**TRAIN_KW),
                        occ=OccTrainConfig(**OCC))


def test_occ_step_from_the_generator_trains_both():
    """Drawn from one generator: finite metrics with prop_loss, the field
    and the proposal both move, the same seed gives the same step, and
    make_train_loop is n steps of it."""
    _, params, test_eps = jax_nerf_flows(CFG)
    batches = [make_batch(*RAYS, seed=s) for s in range(2)]
    runs = []
    for seed in (5, 5):
        model = port_nerf_flows(CFG, params, test_eps)
        step = port_occ_step(model, _jax_proposal_params())
        prop0 = {k: v.clone() for k, v in step.proposal.state_dict().items()}
        g = torch.Generator().manual_seed(seed)
        metrics = [step(b, g) for b in batches]
        assert all(torch.isfinite(v) for m in metrics for v in m.values())
        assert set(metrics[0]) == set(METRICS)
        assert any(not torch.equal(prop0[k], v) for k, v in step.proposal.state_dict().items())
        runs.append((metrics, model))
    assert [float(m["loss"]) for m in runs[0][0]] == [float(m["loss"]) for m in runs[1][0]]

    model = port_nerf_flows(CFG, params, test_eps)
    loop, _ = make_train_loop(model, RenderConfig(n_samples=N_PLACED),
                              TrainConfig(**TRAIN_KW), n_inner=2, occ=OccTrainConfig(**OCC))
    loop.install_proposal(proposal_state_dict_from_jax(_jax_proposal_params()))
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    out = loop(stacked, torch.Generator().manual_seed(5))
    for k in METRICS:
        torch.testing.assert_close(out[k], torch.stack([m[k] for m in runs[0][0]]),
                                   rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------------- #
# the stage schedules (cfnerf_tpu/train/loop.py:54-113)
# ---------------------------------------------------------------------- #


def test_k_schedule_matches():
    for spec in ("8:0,16:2000,32:5000", "32:5000,8:0", "4:0"):
        assert tloop.parse_k_schedule(spec) == jloop.parse_k_schedule(spec)
    stages = tloop.parse_k_schedule("8:0,16:2000,32:5000")
    for step in (0, 1999, 2000, 4999, 5000, 99999):
        assert tloop.k_for_step(stages, step) == jloop.k_for_step(stages, step)
    assert [tloop.k_for_step(stages, s) for s in (0, 1999, 2000, 99999)] == [8, 8, 16, 32]


@pytest.mark.parametrize("spec,match", [
    ("8:100,16:2000", "starting at step 0"),
    ("abc", "bad --k_schedule entry"),
    ("0:0", "must be >= 2"),
    ("1:0,8:1000", "must be >= 2"),
    ("8:0,16:0", "duplicate start_step"),
])
def test_k_schedule_refuses_as_jax_does(spec, match):
    with pytest.raises(ValueError) as port:
        tloop.parse_k_schedule(spec)
    with pytest.raises(ValueError) as ref:
        jloop.parse_k_schedule(spec)
    assert str(port.value) == str(ref.value)
    assert match in str(port.value)


@pytest.mark.parametrize("args,want", [
    ((0, 100, 0, 1.0, 0.3), 0.3), ((50, 100, 10, 1.0, 0.3), 1.0),
    ((100, 100, 10, 1.0, 0.3), 1.0), ((105, 100, 10, 1.0, 0.3), 0.65),
    ((110, 100, 10, 1.0, 0.3), 0.3), ((9999, 100, 10, 1.0, 0.3), 0.3)])
def test_occ_floor_for_step_matches(args, want):
    assert tloop.occ_floor_for_step(*args) == jloop.occ_floor_for_step(*args)
    assert tloop.occ_floor_for_step(*args) == pytest.approx(want)


# ---------------------------------------------------------------------- #
# golden for the card: one JAX occ step of a tiny model, with its draws
# ---------------------------------------------------------------------- #

GOLDEN_KEY = 31
GOLDEN_TRAIN_FIELDS = ("H", "W", "focal", "near", "far", "beta1", "depth_lambda", "lrate")


def occ_golden_arrays():
    _, params, test_eps = jax_nerf_flows(CFG)
    prop_params = _jax_proposal_params()
    batch = make_batch(*RAYS, seed=6)
    key = jax.random.PRNGKey(GOLDEN_KEY)
    (metrics, grads, after, prop_after), = jax_occ_steps(params, prop_params, [batch], [key])
    draws = jax_occ_draws(key, sum(RAYS))
    arrays = {f"p/{path}": leaf for path, leaf in _flatten(params)}
    arrays.update({f"prop/{k}": np.asarray(v, np.float32) for k, v in prop_params.items()})
    arrays["test_eps_a"], arrays["test_eps_r"] = test_eps
    arrays["config"] = np.array([CFG.depth, CFG.width, CFG.k, CFG.flows, CFG.h_alpha,
                                 CFG.h_rgb, N_PLACED, N_CAND, COTRAIN], np.int64)
    arrays["train"] = np.array([TRAIN_KW[k] for k in GOLDEN_TRAIN_FIELDS], np.float64)
    arrays["occ"] = np.array([*OCC["lo"], *OCC["hi"], OCC["floor"], PROP_LR], np.float64)
    arrays.update({f"batch/{k}": v for k, v in batch.items()})
    arrays["place_u"], arrays["prop_pts"] = draws["place_u"], draws["prop_pts"]
    arrays["eps_a"], arrays["eps_r"] = draws["eps"]
    arrays.update({f"jax/{k}": np.float32(v) for k, v in metrics.items()})
    arrays.update({f"grad/{k}": v for k, v in grads.items()})
    arrays.update({f"after/{k}": v for k, v in after.items()})
    arrays.update({f"prop_after/{k}": to_np(v) for k, v in prop_after.items()})
    return arrays


def save_occ_golden():
    np.savez_compressed(GOLDEN, **occ_golden_arrays())


def test_occ_golden_is_current():
    assert GOLDEN.exists(), "run: python -m tests.test_torch_occ_train"
    assert GOLDEN.stat().st_size < 1 << 20
    fresh = occ_golden_arrays()
    with np.load(GOLDEN) as saved:
        assert set(saved.files) == set(fresh)
        for k in fresh:
            if k.startswith(("jax/", "grad/", "after/", "prop_after/")):
                # XLA's CPU reductions are deterministic on one build; the
                # margin only absorbs a thread-count-dependent summation order
                np.testing.assert_allclose(saved[k], fresh[k], rtol=1e-6, atol=1e-9,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_occ_golden_steps_through_the_port():
    """What chip_smoke.py does on the card, here through the plain versions."""
    with np.load(GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    D, Wd, K, F, ha, hr, n_placed, n_cand, cotrain = (int(v) for v in g["config"])
    params = {}
    for k, v in g.items():
        if k.startswith("p/"):
            node = params
            *parents, leaf = k[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                      h_rgb_size=hr, n_flows=F, k_samples=K)
    model.load_state_dict(nerf_flows_state_dict_from_jax(
        params, (g["test_eps_a"], g["test_eps_r"])))
    step = port_occ_step(model, {k[5:]: v for k, v in g.items() if k.startswith("prop/")})
    metrics, grads = port_step_once(step, model, {k[6:]: v for k, v in g.items()
                                                  if k.startswith("batch/")},
                                    dict(place_u=g["place_u"], prop_pts=g["prop_pts"],
                                         eps=(g["eps_a"], g["eps_r"])))
    for k in METRICS:
        np.testing.assert_allclose(metrics[k], float(g[f"jax/{k}"]),
                                   rtol=1e-4 if k == "prop_loss" else LOSS_RTOL, err_msg=k)
    assert_grads_rms_close(grads, {k[5:]: v for k, v in g.items() if k.startswith("grad/")})
    assert_params_after_update_close(model, {k[6:]: v for k, v in g.items()
                                             if k.startswith("after/")}, grads,
                                     float(g["train"][GOLDEN_TRAIN_FIELDS.index("lrate")]))
    assert_proposal_close(step.proposal, {k[11:]: T(v) for k, v in g.items()
                                          if k.startswith("prop_after/")}, _prop_grads(step))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    save_occ_golden()
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
