"""The member axis of the flow-stack kernels (cfnerf_torch/ops/kernels/
flow_stack.py) and the member-batched ensemble step on the occ stage and the
unfused render (cfnerf_torch/parallel/ensemble.py, train/step.py), against
the JAX package's member axis: jax.vmap of its step
(cfnerf_tpu/parallel/ensemble.py:make_ensemble_train_step, occ= and
fused="off") and of its Pallas flow stack (run by its interpreter), which
vmap batches with a leading member axis in the grid.

  * the flow stack with z0 (M, K, Z), M = 3: forward and backward (Z = 1
    and 3, test and train mode, F = 2 and 4) against JAX's fused_flow_stack
    per member and under jax.vmap, and bitwise the one-member plain version
    on each member's share, through autograd too;
  * the kernel route through stand-in entries: one launch each way for all
    members, the member count passed, each member's z0 gradient summed over
    its own points;
  * the batched occ step (per-member floors, installed proposals) against
    JAX's vmapped occ step run op by op, and the batched unfused step
    (fused="off", and applied density noise) against JAX's vmapped step,
    JAX's draws through the seams; both bitwise against the per-member
    steps (fields, proposals, both Adams, the generators);
  * the member-batched val render: each member's maps bitwise its own
    render's;
  * cli.ensemble train --parallel with --occ_train and with --fused_render
    off on the checked-in capture (tests/fixtures/minicapture, LLFF with
    COLMAP depth): every member's checkpoint bitwise its serial run's.

Tolerances, and why: the flow stack as tests/test_torch_flow_stack.py holds
it against JAX's kernel (z, ldj rtol = atol = 1e-5; gradients rtol = atol =
1e-5); JAX's vmap of its forward kernel equals its per-member calls
bitwise (its vmapped gradients sum over the draws in another order).  The
steps at the gates tests/test_torch_ensemble_parallel.py (occ: the first
step's metrics at rtol 1e-5 and prop_loss 1e-4, gradients by relative RMS
1e-2 and cosine 0.9999, weights after Adam 1e-6 where |g| >= 1e-5, the
proposal the same) and tests/test_torch_ensemble_batched.py (unfused f32:
metrics rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, weights after Adam at
JAX's vmapped-vs-serial rtol 2e-5 / atol 2e-6 where |g| >= 1e-5, elsewhere
2 lr) use.  Against the port's own per-member steps: bitwise.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops.pallas.flow_stack import fused_flow_stack as jax_flow_stack
from cfnerf_tpu.parallel import ensemble as jpar
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.cli import ensemble as tens
from cfnerf_torch.convert import proposal_state_dict_from_jax
from cfnerf_torch.ops.kernels import _build, flow_stack
from cfnerf_torch.ops.kernels.flow_stack import (
    fused_flow_stack,
    fused_flow_stack_bwd,
    fused_flow_stack_bwd_plain,
    fused_flow_stack_plain,
)
from cfnerf_torch.ops.metrics import img2mse
from cfnerf_torch.parallel.ensemble import make_ensemble_train_step, member_generators
from cfnerf_torch.render.renderer import (
    RenderConfig,
    make_render_rays,
    prepare_rays,
    render_members_test,
)
from cfnerf_torch.train.loss import kde_nll
from cfnerf_torch.train.step import OccTrainConfig, TrainConfig, make_train_step
from tests.test_torch_common import Tiny, jax_nerf_flows, port_nerf_flows, to_np
from tests.test_torch_ensemble_parallel import _assert_trees_equal, _load, _stacked
from tests.test_torch_flow_stack import (
    FWD_TOL,
    GRAD_TOL as FLOW_GRAD_TOL,
    _Entry,
    _floats,
    _Lib,
    _jax_fwd_vjp,
    _no_cuda_context,
    _no_plain,
    _OnCuda,
    _z0_of,
    flow_inputs,
)
from tests.test_torch_occ_train import (
    N_PLACED,
    OCC,
    OCC_SIZES,
    PLACE_ATOL,
    _jax_proposal_params,
    assert_grads_rms_close,
    assert_proposal_close,
    jax_occ_draws,
    port_placement,
    recorded_jax_depths,
)
from tests.test_torch_train import (
    ADAM_G_MIN,
    CFG as TRAIN_CFG,
    GRAD_TOL,
    LOSS_RTOL,
    TRAIN_KW,
    _grads_in_opt_state,
    _port_names,
    assert_params_after_update_close,
    jax_draws,
    make_batch,
    port_z_vals,
)

M = 3
T = torch.as_tensor
GRAD_NAMES = ("g_z0", "g_r1", "g_r2", "g_b")

# ---------------------------------------------------------------------- #
# the flow stack with a member axis
# ---------------------------------------------------------------------- #

PER, K = 40, 8  # points a member, draws


def _flow_members(Z, F):
    """Each member's numpy inputs: its own (K, Z) draws and points."""
    return [flow_inputs(PER, K, Z, F, seed=100 * Z + 10 * F + m, shared_z0=True)
            for m in range(M)]


def _stack_flow(per):
    """The member-batched call's arguments: z0 stacked (M, K, Z), the points
    joined."""
    return [T(np.stack([p[0] for p in per]))] + [
        T(np.concatenate([p[i] for p in per])) for i in (1, 2, 3)]


def _flow_cotangents(Z, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(PER, K, Z).astype(np.float32), rng.randn(PER, K).astype(np.float32))


@pytest.mark.parametrize("F", [2, 4])
@pytest.mark.parametrize("Z", [1, 3])
@pytest.mark.parametrize("compute_log_det", [True, False], ids=["train", "test"])
def test_member_flow_stack_matches_jax_per_member_and_vmapped(compute_log_det, Z, F):
    per = _flow_members(Z, F)
    x = _stack_flow(per)
    cots = [_flow_cotangents(Z, 60 + 10 * Z + m) for m in range(M)]
    stacked_cots = [T(np.concatenate([c[i] for c in cots])) for i in range(2)]
    z, ldj = fused_flow_stack_plain(*x, compute_log_det)
    assert tuple(z.shape) == (M * PER, K, Z) and tuple(ldj.shape) == (M * PER, K)
    grads = fused_flow_stack_bwd_plain(x, stacked_cots, compute_log_det)
    assert tuple(grads[0].shape) == (M * PER, K, Z)  # per point, as the kernel gives it

    def fwd_vjp(z0, r1, r2, b, g_z, g_ldj):
        out, vjp = jax.vjp(lambda *a: jax_flow_stack(*a, compute_log_det, True),
                           jnp.broadcast_to(z0, (PER, K, Z)), r1, r2, b)
        return out, vjp((g_z, g_ldj))

    vmapped, vgrads = jax.vmap(fwd_vjp)(
        *[jnp.asarray(np.stack([p[i] for p in per])) for i in range(4)],
        *[jnp.asarray(np.stack([c[i] for c in cots])) for i in range(2)])
    # autograd through the member axis: each member's z0 gradient is the sum
    # its own call's expand makes, bitwise
    z0 = x[0].clone().requires_grad_()
    params = [t.clone().requires_grad_() for t in x[1:]]
    zz, ll = fused_flow_stack(z0, *params, compute_log_det)
    torch.autograd.backward([zz, ll] if compute_log_det else [zz],
                            stacked_cots if compute_log_det else stacked_cots[:1])
    for m, (args, c) in enumerate(zip(per, cots)):
        pts = slice(m * PER, (m + 1) * PER)
        alone_in = [_z0_of(args[0], PER), *(T(a) for a in args[1:])]
        alone = fused_flow_stack_plain(*alone_in, compute_log_det)
        assert torch.equal(z[pts], alone[0]) and torch.equal(ldj[pts], alone[1])
        alone_grads = fused_flow_stack_bwd_plain(alone_in, [T(a) for a in c], compute_log_det)
        for name, a, b in zip(GRAD_NAMES, grads, alone_grads):
            assert torch.equal(a[pts], b), name
        shared = T(args[0]).clone().requires_grad_()
        mine = [T(a).clone().requires_grad_() for a in args[1:]]
        za, la = fused_flow_stack(shared[None].expand(PER, K, Z), *mine, compute_log_det)
        torch.autograd.backward([za, la] if compute_log_det else [za],
                                [T(a) for a in c][:2 if compute_log_det else 1])
        assert torch.equal(z0.grad[m], shared.grad)
        for name, a, b in zip(GRAD_NAMES[1:], params, mine):
            assert torch.equal(a.grad[pts], b.grad), name

        (jz, jldj), jgrads = _jax_fwd_vjp(*args, compute_log_det, c)
        np.testing.assert_allclose(to_np(z[pts]), np.asarray(jz), err_msg="z", **FWD_TOL)
        np.testing.assert_allclose(to_np(ldj[pts]), np.asarray(jldj), err_msg="ldj", **FWD_TOL)
        for name, a, j in zip(GRAD_NAMES, grads, jgrads):
            np.testing.assert_allclose(to_np(a[pts]), np.asarray(j), err_msg=name,
                                       **FLOW_GRAD_TOL)
        # JAX's vmap: its per-member forward calls, bitwise; its gradients
        # sum over the draws in another order than one call's
        np.testing.assert_array_equal(np.asarray(vmapped[0][m]), np.asarray(jz))
        np.testing.assert_array_equal(np.asarray(vmapped[1][m]), np.asarray(jldj))
        for name, a, v in zip(GRAD_NAMES, grads, vgrads):
            np.testing.assert_allclose(to_np(a[pts]), np.asarray(v[m]), err_msg=name,
                                       **FLOW_GRAD_TOL)


def test_member_flow_stack_kernel_route_is_one_launch(monkeypatch):
    """CUDA tensors with a member axis: one forward and one backward launch
    for all members, each told the member count (the last int before the
    stream) and z0's stride 0; the per-point z0 gradient comes back summed
    over each member's own points, (M, K, Z)."""
    n, k, Z, F = 4, 3, 3, 2
    B = M * n
    seen = {}

    def fwd(*a):  # z0, stride, r1, r2, b, z, ldj, B, K, Z, F, cld, members, stream
        seen["fwd"] = (a[1], *a[7:13])
        _floats(a[5], B * k * Z)[:] = 0.5
        _floats(a[6], B * k)[:] = 0.25

    def bwd(*a):  # z0, stride, r1, r2, b, g_z, g_ldj, g_z0, g_r1, g_r2, g_b, ints
        seen["bwd"] = (a[1], *a[11:17])
        g_z0 = _floats(a[7], B * k * Z).reshape(B, k * Z)
        g_z0[:] = np.arange(B, dtype=np.float32)[:, None]  # point p's gradient: p
        for ptr, size in zip(a[8:11], (B * Z * Z * F, B * Z * Z * F, B * Z * F)):
            _floats(ptr, size)[:] = 7.0

    entries = {"flow_stack": _Lib(flow_stack_fwd=_Entry(fwd)),
               "flow_stack_bwd": _Lib(flow_stack_bwd=_Entry(bwd))}
    monkeypatch.setattr(_build, "load", lambda name: entries[name])
    monkeypatch.setattr(flow_stack, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(flow_stack, "fused_flow_stack_plain", _no_plain)
    monkeypatch.setattr(flow_stack, "fused_flow_stack_bwd_plain", _no_plain)
    per = [flow_inputs(n, k, Z, F, seed=m, shared_z0=True) for m in range(M)]
    x = [t.as_subclass(_OnCuda).requires_grad_() for t in _stack_flow(per)]
    before = fused_flow_stack.launches, fused_flow_stack_bwd.launches
    z, ldj = fused_flow_stack(*x, True)
    (z.sum() + ldj.sum()).backward()
    assert (fused_flow_stack.launches, fused_flow_stack_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert seen["fwd"] == seen["bwd"] == (0, B, k, Z, F, 1, M)
    assert tuple(x[0].grad.shape) == (M, k, Z)
    for m in range(M):
        assert bool((x[0].grad[m] == float(sum(range(m * n, (m + 1) * n)))).all())
    assert all(bool((t.grad == 7.0).all()) for t in x[1:])
    with torch.no_grad():
        with pytest.raises(ValueError, match="12 points do not split over z0's 5 members"):
            fused_flow_stack(torch.cat([x[0], x[0][:2]]), *x[1:], True)
        with pytest.raises(ValueError, match="contiguous"):
            flow_stack._launch((x[0].transpose(0, 1).contiguous().transpose(0, 1),
                                *x[1:]), True)
    with pytest.raises(ValueError, match="do not split"):
        fused_flow_stack_bwd([T(np.stack([p[0] for p in per] * 2)[:5]), *_stack_flow(per)[1:]],
                             [None, None], True)


# ---------------------------------------------------------------------- #
# the batched occ and unfused steps
# ---------------------------------------------------------------------- #

# the steps at the size the gates below were set at (tests/test_torch_train.py
# and tests/test_torch_occ_train.py: D2/W32, K8, F2); at D4/W64 the
# frameworks' f32 roundings sum over more layers (measured: a first-layer
# gradient 1.28e-2 relative RMS from JAX's in the occ step)
CFG = TRAIN_CFG
N_SAMPLES = 12
RAYS = (24, 8)  # rgb + COLMAP depth rays a member
FLOORS = (0.3, 0.6, 0.45)
NOISE = dict(apply_noise=True, raw_noise_std=1.0)


def _step_members(cfg: Tiny = CFG):
    """Each member's JAX params and test eps, the JAX model, the port's."""
    made = [jax_nerf_flows(cfg, seed=m) for m in range(M)]
    return ([(p, e) for _, p, e in made], made[0][0],
            [port_nerf_flows(cfg, p, e) for _, p, e in made])


def _member_tree(tree, m):
    return jpar.unstack_member(jax.tree_util.tree_map(np.asarray, tree), m)


def _assert_after_adam(model, after, jg, lr):
    for n, q in model.named_parameters():
        steady = np.abs(jg[n]) >= ADAM_G_MIN
        np.testing.assert_allclose(to_np(q)[steady], after[n][steady], rtol=2e-5, atol=2e-6,
                                   err_msg=n)
        assert np.all(np.abs(to_np(q) - after[n]) <= 2 * lr + 2e-6), n


@pytest.mark.parametrize("over", [{}, NOISE], ids=["fused_off", "applied_noise"])
def test_batched_unfused_step_matches_jax_vmapped_step(over):
    """One step of M = 3 members on the unfused render against JAX's
    make_ensemble_train_step(fused="off"), each member's draws from its JAX
    step key: the jitter and eps (tests/test_torch_train.py's jax_draws)
    and, with applied noise, the density noise (renderer.py's rng_noise)."""
    members, jm, models = _step_members()
    batches = [make_batch(*RAYS, seed=170 + m) for m in range(M)]
    keys = jpar.member_keys([jax.random.PRNGKey(400 + m) for m in range(M)])
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, perturb=True, use_viewdirs=True,
                              fused="off", **over)
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW), None)
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members([q for q, _ in members]))
    jp, jopt, jmetrics = estep(p, jax.vmap(tx.init)(p),
                               {k: jnp.asarray(v) for k, v in _stacked(batches).items()}, keys)

    port_rc = RenderConfig(n_samples=N_SAMPLES, **(over or {"fused": "off"}))
    step, _ = make_ensemble_train_step(models, port_rc, TrainConfig(**TRAIN_KW), M)
    assert step.batched
    n_rays = sum(RAYS)
    draws = [jax_draws(keys[m], n_rays, N_SAMPLES, CFG.k) for m in range(M)]
    seams = dict(z_vals=torch.stack([port_z_vals(t, N_SAMPLES) for t, _ in draws]),
                 eps=tuple(T(np.stack([e[i] for _, e in draws])) for i in range(2)))
    if over:
        seams["noise"] = (T(np.stack([np.asarray(jax.random.normal(
            jax.random.split(keys[m], 5)[2], (n_rays, N_SAMPLES, CFG.k))) for m in range(M)])),)
    metrics = step(_stacked(batches), [None] * M, **seams)
    for m, model in enumerate(models):
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k][m]), float(jmetrics[k][m]),
                                       rtol=LOSS_RTOL, err_msg=k)
        jg = _port_names(_member_tree(jopt[0], m))
        got = {n: to_np(q.grad) for n, q in model.named_parameters()}
        assert set(got) == set(jg)
        for n in jg:
            np.testing.assert_allclose(got[n], jg[n], err_msg=n, **GRAD_TOL)
        _assert_after_adam(model, _port_names(_member_tree(jp, m)), jg, TRAIN_KW["lrate"])


def test_batched_occ_step_matches_jax_vmapped_occ_step():
    """One occ step of M = 3 members, per-member floors and installed
    proposals, against JAX's vmapped occ step run op by op (as
    tests/test_torch_ensemble_parallel.py runs it), each member's draws
    (place_u, eps, prop_pts) from its JAX step key."""
    members, jm, models = _step_members()
    props = [_jax_proposal_params(seed=80 + m) for m in range(M)]
    batches = [make_batch(*RAYS, seed=190 + m) for m in range(M)]
    keys = jpar.member_keys([jax.random.PRNGKey(500 + m) for m in range(M)])
    rc = jrender.RenderConfig(n_samples=N_PLACED, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW), None,
                                                  occ=jstep.OccTrainConfig(**OCC))
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members([q for q, _ in members]))
    wrapped = estep._wrap_state(jax.vmap(tx.init)(p), jax.tree_util.tree_map(
        jnp.asarray, jpar.stack_members(props)))
    b = {k: jnp.asarray(v) for k, v in _stacked(batches).items()}
    b["occ_floor"] = jnp.asarray(FLOORS, jnp.float32)
    jp, jstate, jmetrics = estep._vupdate(p, wrapped, b, keys)

    step, _ = make_ensemble_train_step(models, RenderConfig(n_samples=N_PLACED),
                                       TrainConfig(**TRAIN_KW), M, occ=OccTrainConfig(**OCC))
    assert step.batched
    step.install_proposals([proposal_state_dict_from_jax(q) for q in props])
    draws = [jax_occ_draws(keys[m], sum(RAYS)) for m in range(M)]
    metrics = step(dict(_stacked(batches), occ_floor=np.asarray(FLOORS, np.float32)),
                   [None] * M, place_u=T(np.stack([d["place_u"] for d in draws])),
                   eps=tuple(T(np.stack([d["eps"][i] for d in draws])) for i in range(2)),
                   prop_pts=T(np.stack([d["prop_pts"] for d in draws])))
    for m, model in enumerate(models):
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k][m]), float(jmetrics[k][m]),
                                       rtol=1e-4 if k == "prop_loss" else LOSS_RTOL, err_msg=k)
        grads = {n: to_np(q.grad) for n, q in model.named_parameters()}
        assert_grads_rms_close(grads, _port_names(_member_tree(jstate[0][0], m)))
        assert_params_after_update_close(model, _port_names(_member_tree(jp, m)), grads,
                                         TRAIN_KW["lrate"])
        prop_grads = {n: to_np(q.grad) for n, q in step.proposals[m].named_parameters()}
        assert_proposal_close(step.proposals[m],
                              proposal_state_dict_from_jax(_member_tree(jstate[1], m)),
                              prop_grads)


@pytest.mark.parametrize("size", list(OCC_SIZES))
def test_batched_occ_step_on_jax_depths_matches_jax(size):
    """The batched occ step on JAX's own depths: JAX's vmapped occ step
    (jitted; its placement, recorded per member as it runs, is whatever its
    rounding of the proposal gives) hands each member's depths to the port
    through z_vals, so every member is held at the unfused step's gates
    (gradients rtol 1e-4 / atol 1e-6, the weights after Adam as
    test_batched_unfused_step_matches_jax_vmapped_step holds them), at
    D2/W32 and D4/W64; each member's own placement apart, at PLACE_ATOL;
    the co-training as test_batched_occ_step_matches_jax_vmapped_occ_step
    holds it."""
    members, jm, models = _step_members(OCC_SIZES[size])
    props = [_jax_proposal_params(seed=80 + m) for m in range(M)]
    batches = [make_batch(*RAYS, seed=190 + m) for m in range(M)]
    keys = jpar.member_keys([jax.random.PRNGKey(500 + m) for m in range(M)])
    rc = jrender.RenderConfig(n_samples=N_PLACED, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW), None,
                                                  occ=jstep.OccTrainConfig(**OCC))
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members([q for q, _ in members]))
    wrapped = estep._wrap_state(jax.vmap(tx.init)(p), jax.tree_util.tree_map(
        jnp.asarray, jpar.stack_members(props)))
    b = {k: jnp.asarray(v) for k, v in _stacked(batches).items()}
    b["occ_floor"] = jnp.asarray(FLOORS, jnp.float32)
    with recorded_jax_depths() as seen:
        jp, jstate, jmetrics = estep(p, wrapped, b, keys)
        jax.block_until_ready(jp)
    assert len(seen) == M
    z_jax = np.stack(seen)

    step, _ = make_ensemble_train_step(models, RenderConfig(n_samples=N_PLACED),
                                       TrainConfig(**TRAIN_KW), M, occ=OccTrainConfig(**OCC))
    assert step.batched
    step.install_proposals([proposal_state_dict_from_jax(q) for q in props])
    draws = [jax_occ_draws(keys[m], sum(RAYS)) for m in range(M)]
    for m in range(M):
        z_port = port_placement(step.proposals[m], batches[m], draws[m]["place_u"], FLOORS[m])
        assert np.abs(z_port - z_jax[m]).max() <= PLACE_ATOL, m
    metrics = step(dict(_stacked(batches), occ_floor=np.asarray(FLOORS, np.float32)),
                   [None] * M, z_vals=T(z_jax),
                   eps=tuple(T(np.stack([d["eps"][i] for d in draws])) for i in range(2)),
                   prop_pts=T(np.stack([d["prop_pts"] for d in draws])))
    for m, model in enumerate(models):
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k][m]), float(jmetrics[k][m]),
                                       rtol=1e-4 if k == "prop_loss" else LOSS_RTOL, err_msg=k)
        jg = _port_names(_member_tree(jstate[0][0], m))
        got = {n: to_np(q.grad) for n, q in model.named_parameters()}
        assert set(got) == set(jg)
        for n in jg:
            np.testing.assert_allclose(got[n], jg[n], err_msg=n, **GRAD_TOL)
        _assert_after_adam(model, _port_names(_member_tree(jp, m)), jg, TRAIN_KW["lrate"])
        prop_grads = {n: to_np(q.grad) for n, q in step.proposals[m].named_parameters()}
        assert_proposal_close(step.proposals[m],
                              proposal_state_dict_from_jax(_member_tree(jstate[1], m)),
                              prop_grads)


def _adam_state(optimizer):
    return [{k: v.clone() for k, v in optimizer.state[q].items()}
            for g in optimizer.param_groups for q in g["params"]]


PATHS = {  # render config, occ
    "occ": (RenderConfig(n_samples=N_PLACED), OccTrainConfig(**OCC)),
    "occ_fused_off": (RenderConfig(n_samples=N_PLACED, fused="off"), OccTrainConfig(**OCC)),
    "fused_off": (RenderConfig(n_samples=N_SAMPLES, fused="off"), None),
    "applied_noise": (RenderConfig(n_samples=N_SAMPLES, **NOISE), None),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_batched_step_is_the_per_member_steps_bitwise(path):
    """Two steps from each member's generator: the batched step's metrics,
    gradients, parameters and Adam state, and in the occ stage each
    member's proposal and its Adam state, are those of each member's own
    make_train_step, bit for bit, and the generators end in the same
    state."""
    rc, occ = PATHS[path]
    _, _, models = _step_members()
    _, _, serial_models = _step_members()
    tc = TrainConfig(**TRAIN_KW)
    step, optimizers = make_ensemble_train_step(models, rc, tc, M, occ=occ)
    assert step.batched
    singles = [make_train_step(model, rc, tc, occ=occ) for model in serial_models]
    if occ is not None:
        props = [proposal_state_dict_from_jax(_jax_proposal_params(seed=90 + m))
                 for m in range(M)]
        step.install_proposals(props)
        for (single, _), prop in zip(singles, props):
            single.install_proposal(prop)
    gens, serial_gens = member_generators([5, 6, 7], "cpu"), member_generators([5, 6, 7], "cpu")
    for s in range(2):
        batch = _stacked([make_batch(*RAYS, seed=210 + 10 * s + m) for m in range(M)])
        if occ is not None:
            batch["occ_floor"] = np.asarray(FLOORS, np.float32)
        metrics = step(batch, gens)
        for m, (single, _) in enumerate(singles):
            one = {k: v[m] for k, v in batch.items()}
            want = single(one, serial_gens[m])
            assert set(want) == set(metrics)
            for k in want:
                assert torch.equal(metrics[k][m], want[k]), (m, k)
    for m, (single, opt) in enumerate(singles):
        for (n, a), b in zip(models[m].named_parameters(), serial_models[m].parameters()):
            assert torch.equal(a, b) and torch.equal(a.grad, b.grad), n
        for a, b in zip(_adam_state(optimizers[m]), _adam_state(opt)):
            assert all(torch.equal(a[k], b[k]) for k in b)
        if occ is not None:
            for (n, a), b in zip(step.proposals[m].named_parameters(),
                                 single.proposal.parameters()):
                assert torch.equal(a, b) and torch.equal(a.grad, b.grad), n
            for a, b in zip(_adam_state(step.prop_optimizers[m]),
                            _adam_state(single.prop_optimizer)):
                assert all(torch.equal(a[k], b[k]) for k in b)
        assert torch.equal(gens[m].get_state(), serial_gens[m].get_state())


@pytest.mark.parametrize("fused", ["on", "off"])
def test_member_val_render_is_each_members_own(fused):
    """The --parallel val batch (render_members_test): one test-mode render
    for all members, each member's maps, mse and KDE NLL bitwise its own
    make_render_rays render's."""
    _, _, models = _step_members()
    rc = RenderConfig(n_samples=N_SAMPLES, fused=fused)
    b = make_batch(16, 0, seed=7)
    ro, rd, vd, near, far = prepare_rays(
        T(b["rays_o"]), T(b["rays_d"]), H=TRAIN_KW["H"], W=TRAIN_KW["W"],
        focal=TRAIN_KW["focal"], ndc=False, use_viewdirs=True, near=TRAIN_KW["near"],
        far=TRAIN_KW["far"])
    target = T(b["target"])
    with torch.inference_mode():
        outs = render_members_test(models, rc, ro, rd, vd, near, far)
        for model, out in zip(models, outs):
            alone = make_render_rays(model, rc)(ro, rd, vd, near, far, None, is_test=True)
            for key in ("rgb_map", "disp_map", "depth_map", "acc_map"):
                assert torch.equal(out[key], alone[key]), key
            assert torch.equal(img2mse(out["rgb_map"].mean(-1), target),
                               img2mse(alone["rgb_map"].mean(-1), target))
            assert torch.equal(kde_nll(out["rgb_map"], target, CFG.k),
                               kde_nll(alone["rgb_map"], target, CFG.k))


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #


CAPTURE = Path(__file__).parent / "fixtures" / "minicapture"
# scripts/train_NF.sh's flags (configs/africa_ds.txt: LLFF, COLMAP depth
# rays) at test size, 2 members x 4 steps
CAPTURE_FLAGS = ["--config", str(Path(__file__).parent.parent / "configs" / "africa_ds.txt"),
                 "--expname", "ens", "--dataname", "minicapture", "--N_rand", "32",
                 "--N_samples", "8", "--K_samples", "4", "--n_flows", "2",
                 "--h_alpha_size", "8", "--h_rgb_size", "8", "--netdepth", "2",
                 "--netwidth", "16", "--type_flows", "triangular", "--model", "NeRF_Flows",
                 "--n_iters", "4", "--i_print", "2", "--i_weights", "4", "--i_img", "0",
                 "--i_testset", "0", "--i_video", "0", "--n_members", "2"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A copy of the checked-in capture (the loader writes its minified
    images and depth cache into the datadir)."""
    return shutil.copytree(CAPTURE, tmp_path_factory.mktemp("occ_unfused") / "minicapture")


@pytest.mark.parametrize("extra", [
    ["--occ_train", "6", "--occ_candidates", "16", "--occ_train_from", "2"],
    ["--fused_render", "off"],
], ids=["occ_train", "fused_render_off"])
def test_parallel_cli_gives_the_serial_checkpoints(capture, extra, capsys):
    """--parallel on the occ stage (each member's proposal distilled at the
    boundary from its training generator, as its serial run does) and on
    the unfused render, on the checked-in capture: the member-batched step,
    each member's checkpoint (weights, eps buffers, Adam state) bitwise its
    serial run's."""
    base = Path(capture).parent / extra[0].strip("-")
    flags = [*CAPTURE_FLAGS, "--datadir", str(capture), *extra]
    tens.main(["train", *flags, "--basedir", str(base / "serial"), "--is_train"], device="cpu")
    capsys.readouterr()
    tens.main(["train", *flags, "--basedir", str(base / "parallel"), "--is_train",
               "--parallel"], device="cpu")
    assert "ensemble step: 2 members batched" in capsys.readouterr().out
    for m in (1, 2):
        name = f"000004_{m:02d}"
        serial, parallel = (_load(base / run / "minicapture" / "triangular" / "ens" / name)
                            for run in ("serial", "parallel"))
        assert serial["global_step"] == parallel["global_step"] == 4
        _assert_trees_equal(parallel["params"], serial["params"], f"member {m} params")
        _assert_trees_equal(parallel["opt_state"], serial["opt_state"], f"member {m} Adam")
