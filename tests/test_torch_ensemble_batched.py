"""The member-batched ensemble step (cfnerf_torch/parallel/ensemble.py) and
the member axis of the render-core and trunk kernels' plain versions, against
the JAX package's member axis: jax.vmap of its step
(cfnerf_tpu/parallel/ensemble.py:make_ensemble_train_step) and of its Pallas
kernels (run by their interpreter), which vmap batches with a leading member
axis in the grid.

  * the render core with z0 (M, K, .): forward and backward against JAX's
    fused_flow_composite per member and under jax.vmap (M = 3, F = 4), and
    bitwise the one-member plain version on each member's share;
  * the trunk with stacked members: forward, the training route (`_Trunk`)
    and backward against pallas_encode(interpret=True) per member and under
    jax.vmap, and bitwise the one-member plain version;
  * both wrappers' kernel routes, through stand-in entries: one launch for
    all members, the member count passed to the kernel;
  * the batched step against JAX's vmapped step (f32, bf16 and interpret
    trunks; JAX's draws through the eps= and z_vals= seams), and bitwise
    against the port's per-member steps; which configurations it takes;
  * --parallel on the single-image path gives the serial checkpoints.

Tolerances, and why: the kernels' plain versions as their own files hold
them against JAX (tests/test_torch_render_core.py: forward rtol 2e-5 / atol
2e-4, log-dets 2e-5 relative, backward rtol 1e-4 / atol 1e-6;
tests/test_torch_trunk.py and tests/test_torch_trunk_bwd.py: encode rtol
1e-2 / atol 1e-3, gradients relative RMS and cosine); JAX's vmap of its
kernels equals its per-member calls bitwise.  The step: JAX's own
vmapped-vs-serial gate (tests/test_ensemble_parallel.py), rtol 2e-5 / atol
2e-6, on each member's parameters after one Adam step wherever |g| >=
ADAM_G_MIN (elsewhere an Adam first step moves a weight by at most lr, and
two gradients of opposite sign there part by 2 lr); loss and metrics, and
the gradients, as each trunk's one-step test holds them
(tests/test_torch_train.py, tests/test_torch_bf16.py,
tests/test_torch_trunk_bwd.py: the interpreted trunk's leaves at the flat
step's relative RMS 1e-2).  The bf16 and interpreted trunks' references
are JAX's vmapped update run op by op: under jit XLA rounds the
interpreted kernels' bf16 products otherwise: the port's step sat 1.02e-2
(relative RMS, member 0's first layer) from JAX's jitted step, and sits
3.5e-4 from the op-by-op one.  Against the port's own per-member steps:
bitwise.
"""
import contextlib
import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.ops.pallas.render_core import fused_flow_composite as jax_fused
from cfnerf_tpu.ops.pallas.trunk import pallas_encode
from cfnerf_tpu.parallel import ensemble as jpar
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.cli import ensemble as tens
from cfnerf_torch.models.baseline_adapter import KSampleBaseline
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.ops.kernels import _build, render_core, trunk
from cfnerf_torch.ops.kernels.render_core import (
    fused_flow_composite,
    fused_flow_composite_bwd,
    fused_flow_composite_bwd_plain,
    fused_flow_composite_plain,
)
from cfnerf_torch.ops.kernels.trunk import (
    pack_member_trunk_weights,
    pack_trunk_weights,
    trunk_encode,
    trunk_encode_bwd_plain,
    trunk_encode_plain,
)
from cfnerf_torch.parallel.ensemble import (
    batched_step_refusal,
    make_ensemble_train_step,
    member_generators,
)
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train.step import OccTrainConfig, TrainConfig, make_train_step
from tests.test_torch_bf16 import GRAD_MIN_COS, GRAD_REL_RMS, jax_bf16, port_bf16
from tests.test_torch_common import (
    Tiny,
    dists_np,
    jax_nerf_flows,
    port_nerf_flows,
    render_core_inputs,
    to_np,
)
from tests.test_torch_ensemble_parallel import (
    _assert_trees_equal,
    _flags,
    _load,
    _rundir,
    _stacked,
    scene,  # noqa: F401  (the module's tiny Blender scene, a fixture)
)
from tests.test_torch_render_core import (
    _Entry,
    _floats,
    _Lib,
    _model_like,
    _no_cuda_context,
    _OnCuda,
)
from tests.test_torch_train import (
    ADAM_G_MIN,
    CFG,
    GRAD_TOL,
    LOSS_RTOL,
    TRAIN_KW,
    _grads_in_opt_state,
    _port_names,
    jax_draws,
    make_batch,
    port_z_vals,
)
from tests.test_torch_trunk import ENC_TOL, IN_CH, V_CH, _trunk_params
from tests.test_torch_trunk_bwd import (
    MIN_COS,
    STEP_REL_RMS,
    _failing,
    jax_trunk_grads,
    leaf_errors,
)

ORDER = ("z0_a", "r1_a", "r2_a", "b_a", "z0_r", "r1_r", "r2_r", "b_r")
NAMES = ("rgb", "depth", "acc", "ldj")
T = torch.as_tensor

# ---------------------------------------------------------------------- #
# the render core with a member axis
# ---------------------------------------------------------------------- #

M_CORE = 3
R, S, K, F = 128, 8, 4, 4  # JAX's kernel takes whole blocks of 128 rays


def _core_members():
    """Each member's ten numpy arguments (its own draws and points), the
    flow parameters bounded as a model's (tests/test_torch_render_core.py)."""
    out = []
    for m in range(M_CORE):
        args, z_vals, rays_d = render_core_inputs(R, S, K, F, seed=40 + m)
        args = _model_like(args)
        out.append([args[k] for k in ORDER] + [z_vals.ravel(), dists_np(z_vals, rays_d).ravel()])
    return out


def _stack_core(per_member):
    """The member-batched call's arguments: z0 stacked, the points joined."""
    return [T(np.stack([a[i] for a in per_member])) if i in (0, 4)
            else T(np.concatenate([a[i] for a in per_member])) for i in range(10)]


def _core_cotangents(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(R, 3, K).astype(np.float32), rng.randn(R, K).astype(np.float32),
            rng.randn(R, K).astype(np.float32), (rng.randn(2, R) * 1e-2).astype(np.float32)]


def _assert_core_close(out, ref):
    for name, a, b in zip(NAMES, out, ref):
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape, name
        if name == "ldj":
            scale = np.maximum(np.abs(b), 1.0)
            np.testing.assert_array_less(np.abs(a - b) / scale, 2e-5, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("compute_log_det", [True, False])
def test_member_render_core_matches_jax_per_member_and_vmapped(compute_log_det):
    members = _core_members()
    out = fused_flow_composite_plain(*_stack_core(members), S, compute_log_det)
    assert [tuple(o.shape) for o in out] == [(M_CORE * R, 3, K), (M_CORE * R, K),
                                             (M_CORE * R, K), (2, M_CORE * R)]
    vmapped = jax.vmap(lambda *a: jax_fused(*a, S, compute_log_det, True))(
        *[jnp.asarray(np.stack([a[i] for a in members])) for i in range(10)])
    for m, args in enumerate(members):
        rays = slice(m * R, (m + 1) * R)
        mine = [o[:, rays] if name == "ldj" else o[rays] for name, o in zip(NAMES, out)]
        alone = fused_flow_composite_plain(*[T(a) for a in args], S, compute_log_det)
        for name, a, b in zip(NAMES, mine, alone):
            assert torch.equal(a, b), name
        ref = jax_fused(*[jnp.asarray(a) for a in args], S, compute_log_det, True)
        _assert_core_close(mine, ref)
        for a, b in zip(ref, vmapped):  # JAX's vmap: its per-member calls, bitwise
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b[m]))
        _assert_core_close(mine, [v[m] for v in vmapped])
    # the wrapper on CPU tensors: the plain version, and autograd through it
    # gives the plain backward's gradients
    x = [t.requires_grad_(i < 8) for i, t in enumerate(_stack_core(members))]
    routed = fused_flow_composite(*x, S, compute_log_det)
    for a, b in zip(routed, out):
        assert torch.equal(a.detach(), b)
    cots = [T(np.concatenate(c, int(i == 3))) for i, c in
            enumerate(zip(*[_core_cotangents(60 + m) for m in range(M_CORE)]))]
    pairs = [(o, g) for o, g in zip(routed, cots) if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], x[:8], [g for _, g in pairs],
                              allow_unused=True)
    want = fused_flow_composite_bwd_plain(_stack_core(members), cots, S, compute_log_det)
    for name, a, b in zip(ORDER, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("compute_log_det", [True, False])
def test_member_render_core_backward_matches_jax_vjp(compute_log_det):
    members = _core_members()
    cots = [_core_cotangents(60 + m) for m in range(M_CORE)]
    stacked_cots = [T(np.concatenate(c, int(i == 3))) for i, c in enumerate(zip(*cots))]
    out = fused_flow_composite_bwd_plain(_stack_core(members), stacked_cots, S,
                                         compute_log_det)
    assert tuple(out[0].shape) == (M_CORE, K, 1) and tuple(out[4].shape) == (M_CORE, K, 3)

    def vjp(*args_and_cots):
        args, c = args_and_cots[:10], args_and_cots[10:]
        _, back = jax.vjp(lambda *a: jax_fused(*a, S, compute_log_det, True), *args)
        return back(tuple(c))

    vmapped = jax.vmap(vjp)(*[jnp.asarray(np.stack([a[i] for a in members])) for i in range(10)],
                            *[jnp.asarray(np.stack([c[i] for c in cots])) for i in range(4)])
    B = R * S
    for m, (args, c) in enumerate(zip(members, cots)):
        pts = slice(m * B, (m + 1) * B)
        mine = [g[m] if i in (0, 4) else g[pts] for i, g in enumerate(out)]
        alone = fused_flow_composite_bwd_plain([T(a) for a in args], [T(x) for x in c], S,
                                               compute_log_det)
        for name, a, b in zip(ORDER, mine, alone):
            assert torch.equal(a, b), name
        ref = vjp(*[jnp.asarray(a) for a in args], *[jnp.asarray(x) for x in c])
        for i, (name, a, b) in enumerate(zip(ORDER, mine, ref)):
            assert np.all(np.isfinite(to_np(a))), name
            for want in (b, vmapped[i][m]):  # JAX's vmap sums its z0 gradients apart
                np.testing.assert_allclose(to_np(a), np.asarray(want), rtol=1e-4, atol=1e-6,
                                           err_msg=name)


def test_member_render_core_kernel_route_is_one_launch(monkeypatch):
    """CUDA tensors with a member axis: one forward and one backward launch
    for all members, each told the member count (the last int before the
    stream); the z0 gradients come back (M, K, .)."""
    r, s, k, f = 6, 5, 3, 2
    calls = {}

    def fwd(*a):
        calls["fwd"] = a[14:20]
        for ptr, n in zip(a[10:14], (r * 3 * k, r * k, r * k, 2 * r)):
            _floats(ptr, n)[:] = 0.0

    def bwd(*a):
        calls["bwd"] = a[23:29]
        b = r * s
        for ptr, n in zip(a[14:22], (M_CORE * k, b * f, b * f, b * f, M_CORE * 3 * k,
                                     9 * b * f, 9 * b * f, 3 * b * f)):
            _floats(ptr, n)[:] = 7.0

    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran for a CUDA tensor")

    entries = {"render_core": _Lib(render_core_fwd=_Entry(fwd)),
               "render_core_bwd": _Lib(render_core_bwd=_Entry(bwd))}
    monkeypatch.setattr(_build, "load", lambda name: entries[name])
    monkeypatch.setattr(render_core, "_on_device", lambda dev: _no_cuda_context())
    monkeypatch.setattr(render_core, "fused_flow_composite_plain", no_plain)
    monkeypatch.setattr(render_core, "fused_flow_composite_bwd_plain", no_plain)
    per = []
    for m in range(M_CORE):
        args, z_vals, rays_d = render_core_inputs(r // M_CORE, s, k, f, seed=m)
        per.append([args[n] for n in ORDER] + [z_vals.ravel(), dists_np(z_vals, rays_d).ravel()])
    x = [t.as_subclass(_OnCuda).requires_grad_(i < 8) for i, t in enumerate(_stack_core(per))]
    before = fused_flow_composite.launches, fused_flow_composite_bwd.launches
    rgb, depth, _, _ = fused_flow_composite(*x, s, True)
    (rgb.sum() + depth.sum()).backward()
    assert (fused_flow_composite.launches, fused_flow_composite_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert calls["fwd"] == calls["bwd"] == (r, s, k, f, 1, M_CORE)
    assert tuple(x[0].grad.shape) == (M_CORE, k, 1) and bool((x[0].grad == 7.0).all())
    assert tuple(x[4].grad.shape) == (M_CORE, k, 3) and bool((x[4].grad == 7.0).all())
    four = [torch.cat([t, t[:1]]).detach() if i in (0, 4) else t.detach()
            for i, t in enumerate(x)]  # 6 rays, 4 members' draws
    with pytest.raises(ValueError, match="6 rays do not split over 4 members"):
        fused_flow_composite(*four, s, True)


# ---------------------------------------------------------------------- #
# the trunk with stacked members
# ---------------------------------------------------------------------- #

M_TRUNK = 2
TRUNK = Tiny(depth=4, width=256, k=4, flows=2, h_alpha=64, h_rgb=64)
ROWS = 77  # not a whole tile of 64


def _trunk_members():
    """Each member's JAX params and test eps, and its port model with an
    interpreted trunk."""
    out = []
    for m in range(M_TRUNK):
        _, params, eps = jax_nerf_flows(TRUNK, seed=m, trunk_impl="interpret")
        out.append((params, eps, port_nerf_flows(TRUNK, params, eps, trunk_impl="interpret")))
    return out


def _trunk_x(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(M_TRUNK, ROWS, IN_CH + V_CH).astype(np.float32)


def _pallas_encode(params, x):
    return pallas_encode(params, x, depth=TRUNK.depth, width=TRUNK.width, input_ch=IN_CH,
                         views_ch=V_CH, interpret=True)


def test_member_trunk_matches_pallas_encode_per_member_and_vmapped():
    members = _trunk_members()
    x = _trunk_x(5)
    with torch.no_grad():
        packed = pack_member_trunk_weights([model for _, _, model in members])
    assert packed.members == M_TRUNK and tuple(packed.w.shape)[0] == M_TRUNK
    out = trunk_encode_plain(packed, T(x))
    assert [tuple(o.shape) for o in out] == [(M_TRUNK, ROWS, 64)] * 2
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                     *[_trunk_params(p, TRUNK.depth) for p, _, _ in members])
    vmapped = jax.vmap(_pallas_encode)(stacked, jnp.asarray(x))
    # the training route (`_Trunk`, plain on the CPU): the same outputs
    models = [model for _, _, model in members]
    routed = trunk_encode(pack_member_trunk_weights(models), T(x))
    for m, (params, _, model) in enumerate(members):
        with torch.no_grad():
            alone = trunk_encode_plain(pack_trunk_weights(model), T(x[m]))
        ref = _pallas_encode(_trunk_params(params, TRUNK.depth), jnp.asarray(x[m]))
        for name, a, b, r, v, t in zip(("h_alpha", "h_rgb"), out, alone, ref, vmapped, routed):
            assert torch.equal(a[m], b), name
            assert torch.equal(t[m].detach(), b), name
            np.testing.assert_allclose(to_np(a[m]), np.asarray(r), err_msg=name, **ENC_TOL)
            np.testing.assert_array_equal(np.asarray(r), np.asarray(v[m]))


def test_member_trunk_backward_matches_jax_vjp_and_reaches_each_member():
    members = _trunk_members()
    x = _trunk_x(6)
    rng = np.random.RandomState(7)
    g_ha, g_hr = (rng.randn(M_TRUNK, ROWS, 64).astype(np.float32) for _ in range(2))
    models = [model for _, _, model in members]
    with torch.no_grad():
        packed = pack_member_trunk_weights(models)
    dw, db = trunk_encode_bwd_plain(packed, T(x), T(g_ha), T(g_hr))
    assert tuple(dw.shape) == tuple(packed.w.shape) and tuple(db.shape) == tuple(packed.b.shape)
    # through autograd (`_Trunk`): each member's own nn.Linear leaves get
    # its gradients, bitwise those of a one-member call
    ha, hr = trunk_encode(pack_member_trunk_weights(models), T(x))
    torch.autograd.backward([ha, hr], [T(g_ha), T(g_hr)])
    for m, (params, eps, model) in enumerate(members):
        one = port_nerf_flows(TRUNK, params, eps, trunk_impl="interpret")
        a, b = trunk_encode(pack_trunk_weights(one), T(x[m]))
        torch.autograd.backward([a, b], [T(g_ha[m]), T(g_hr[m])])
        single_dw, single_db = trunk_encode_bwd_plain(
            pack_trunk_weights(one), T(x[m]), T(g_ha[m]), T(g_hr[m]))
        assert torch.equal(dw[m], single_dw) and torch.equal(db[m], single_db)
        mine = {n: q.grad for n, q in model.named_parameters() if q.grad is not None}
        theirs = {n: q.grad for n, q in one.named_parameters() if q.grad is not None}
        assert set(mine) == set(theirs) and mine
        for n in theirs:
            assert torch.equal(mine[n], theirs[n]), n
        ref = jax_trunk_grads(TRUNK, params, x[m], g_ha[m], g_hr[m])
        assert not _failing(leaf_errors({n: to_np(g) for n, g in mine.items()}, ref))


# ---------------------------------------------------------------------- #
# the batched step
# ---------------------------------------------------------------------- #

M = 2
# rgb + COLMAP depth rays a member, and samples: the one-member interpret
# step's (tests/test_torch_trunk_bwd.py), whose bf16 gates rest on as many
# points (the first layers' gradients sum over them)
N_SAMPLES = 16
RAYS = (24, 8)
INTERP = Tiny(depth=4, width=256, k=8, flows=2, h_alpha=16, h_rgb=16)
IMPLS = {  # trunk -> (config, metrics rtol)
    "f32": (CFG, LOSS_RTOL),
    "bf16": (CFG, LOSS_RTOL),
    "interpret": (INTERP, 1e-4),
}


def _step_members(impl):
    """Each member's JAX params and test eps, the JAX model, the port's
    models."""
    cfg = IMPLS[impl][0]
    if impl == "bf16":
        made = [jax_bf16(cfg, seed=m) for m in range(M)]
        return [(p, e) for _, p, e in made], made[0][0], [port_bf16(cfg, p, e)
                                                          for _, p, e in made]
    trunk_impl = "interpret" if impl == "interpret" else "xla"
    made = [jax_nerf_flows(cfg, seed=m, trunk_impl=trunk_impl) for m in range(M)]
    return ([(p, e) for _, p, e in made], made[0][0],
            [port_nerf_flows(cfg, p, e, trunk_impl=trunk_impl) for _, p, e in made])


def _grad_errors(impl, got, want):
    """The leaves past the trunk's one-step gradient gate."""
    if impl == "f32":
        bad = {}
        for n in want:
            if not np.allclose(got[n], want[n], **GRAD_TOL):
                bad[n] = float(np.max(np.abs(got[n] - want[n])))
        return bad
    rms, cos = (GRAD_REL_RMS, GRAD_MIN_COS) if impl == "bf16" else (STEP_REL_RMS, MIN_COS)
    return {n: v for n, v in leaf_errors(got, want).items()
            if not (v[0] <= rms and (v[1] >= cos or v == (0.0, 0.0)))}


@pytest.mark.parametrize("impl", list(IMPLS))
def test_batched_step_matches_jax_vmapped_step(impl):
    """One step of M = 2 members against JAX's make_ensemble_train_step,
    each member's draws from its JAX step key (the eps= and z_vals= seams
    with the member axis first); bf16 and interpret run JAX's vmapped
    update op by op, as tests/test_torch_bf16.py does (under jit XLA may
    skip or move bf16 roundings)."""
    members, jm, models = _step_members(impl)
    cfg = IMPLS[impl][0]
    batches = [make_batch(*RAYS, seed=70 + m) for m in range(M)]
    keys = jpar.member_keys([jax.random.PRNGKey(300 + m) for m in range(M)])
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW), None)
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members([q for q, _ in members]))
    run = estep._vupdate if impl in ("bf16", "interpret") else estep
    jp, jopt, jmetrics = run(p, jax.vmap(tx.init)(p),
                             {k: jnp.asarray(v) for k, v in _stacked(batches).items()}, keys)

    step, _ = make_ensemble_train_step(models, RenderConfig(n_samples=N_SAMPLES),
                                       TrainConfig(**TRAIN_KW), M)
    assert step.batched
    draws = [jax_draws(keys[m], sum(RAYS), N_SAMPLES, cfg.k) for m in range(M)]
    metrics = step(_stacked(batches), [None] * M,
                   z_vals=torch.stack([port_z_vals(t, N_SAMPLES) for t, _ in draws]),
                   eps=tuple(T(np.stack([e[i] for _, e in draws])) for i in range(2)))
    lr = TRAIN_KW["lrate"]
    for m, model in enumerate(models):
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k][m]), float(jmetrics[k][m]),
                                       rtol=IMPLS[impl][1], err_msg=k)
        jg = _port_names(jpar.unstack_member(jax.tree_util.tree_map(np.asarray, jopt[0]), m))
        after = _port_names(jpar.unstack_member(jax.tree_util.tree_map(np.asarray, jp), m))
        got = {n: to_np(q.grad) for n, q in model.named_parameters()}
        assert set(got) == set(jg)
        assert not _grad_errors(impl, got, jg)
        for n, q in model.named_parameters():
            steady = np.abs(jg[n]) >= ADAM_G_MIN
            np.testing.assert_allclose(to_np(q)[steady], after[n][steady], rtol=2e-5, atol=2e-6,
                                       err_msg=n)
            assert np.all(np.abs(to_np(q) - after[n]) <= 2 * lr + 2e-6), n


def _adam_state(optimizer):
    return [{k: v.clone() for k, v in optimizer.state[q].items()}
            for g in optimizer.param_groups for q in g["params"]]


@pytest.mark.parametrize("impl", list(IMPLS))
def test_batched_step_is_the_per_member_steps_bitwise(impl):
    """Two steps from each member's generator: the batched step's metrics,
    gradients, parameters and Adam state are those of each member's own
    make_train_step, bit for bit."""
    _, _, models = _step_members(impl)
    _, _, serial_models = _step_members(impl)
    batches = [_stacked([make_batch(*RAYS, seed=90 + 10 * s + m) for m in range(M)])
               for s in range(2)]
    rc, tc = RenderConfig(n_samples=N_SAMPLES), TrainConfig(**TRAIN_KW)
    step, optimizers = make_ensemble_train_step(models, rc, tc, M)
    assert step.batched
    singles = [make_train_step(model, rc, tc) for model in serial_models]
    gens, serial_gens = member_generators([5, 6], "cpu"), member_generators([5, 6], "cpu")
    for batch in batches:
        metrics = step(batch, gens)
        for m, (single, _) in enumerate(singles):
            want = single({k: v[m] for k, v in batch.items()}, serial_gens[m])
            assert set(want) == set(metrics)
            for k in want:
                assert torch.equal(metrics[k][m], want[k]), k
    for m, (single, opt) in enumerate(singles):
        for (n, a), b in zip(models[m].named_parameters(), serial_models[m].parameters()):
            assert torch.equal(a, b) and torch.equal(a.grad, b.grad), n
        for a, b in zip(_adam_state(optimizers[m]), _adam_state(opt)):
            for k in b:
                assert torch.equal(a[k], b[k]), k
        assert torch.equal(gens[m].get_state(), serial_gens[m].get_state())


def test_the_step_batches_only_the_flagship_fused_path(capsys):
    """The choice, made once and printed: the member-batched step for
    NeRFFlows of any flow family (planar here; tests/test_torch_ensemble_
    families.py steps every family), fused or unfused (applied noise
    included), placed (the occ stage) or not, with or without remat, and
    for baselines of one kind (tests/test_torch_ensemble_baselines.py steps
    them); the per-member loop for hierarchical sampling and members of
    different configurations (another family, another flow_impl, a
    NeRFFlows beside a baseline, two baseline kinds, another dropout rate);
    the batched step refuses seams it has no draws for."""
    models = [port_nerf_flows(CFG, p, e) for p, e in
              (jax_nerf_flows(CFG, seed=m)[1:] for m in range(M))]
    rc, tc = RenderConfig(n_samples=8), TrainConfig(**TRAIN_KW)
    occ = OccTrainConfig(lo=(-1.0,) * 3, hi=(1.0,) * 3)
    assert batched_step_refusal(models, rc, tc) is None
    assert batched_step_refusal(models, rc, tc, occ=occ) is None
    assert batched_step_refusal(models, RenderConfig(n_samples=8, fused="off"), tc) is None
    assert batched_step_refusal(models, RenderConfig(n_samples=8, fused="off"), tc,
                                occ=occ) is None
    assert batched_step_refusal(models, RenderConfig(n_samples=8, apply_noise=True,
                                                     raw_noise_std=1.0), tc) is None
    assert batched_step_refusal(models, RenderConfig(n_samples=8, n_importance=4),
                                tc) == "hierarchical sampling"
    assert batched_step_refusal(models, rc, tc, model_fine=models) == "hierarchical sampling"
    assert batched_step_refusal(models, rc, TrainConfig(**TRAIN_KW, remat=True)) is None
    assert batched_step_refusal(models, rc, TrainConfig(**TRAIN_KW, remat=True),
                                occ=occ) is None
    planar = [NeRFFlows(net_depth=2, net_width=32, type_flows="planar", k_samples=8)
              for _ in range(M)]
    assert batched_step_refusal(planar, RenderConfig(n_samples=8, fused="off"), tc) is None
    assert batched_step_refusal([models[0], planar[0]], rc, tc) == \
        "members of different configurations"
    baselines = [KSampleBaseline("nerf", 8, net_depth=2, net_width=32) for _ in range(M)]
    unfused_rc = RenderConfig(n_samples=8, fused="off")
    assert batched_step_refusal(baselines, unfused_rc, tc) is None
    assert batched_step_refusal(baselines, unfused_rc, tc, occ=occ) is None
    assert batched_step_refusal(baselines, unfused_rc, TrainConfig(**TRAIN_KW, remat=True)) \
        is None
    assert batched_step_refusal(baselines, RenderConfig(n_samples=8, n_importance=4,
                                                        fused="off"),
                                tc) == "hierarchical sampling"
    assert batched_step_refusal([planar[0], baselines[0]], unfused_rc, tc) == \
        "members of different configurations"
    wild = KSampleBaseline("nerf_wild", 8, net_depth=2, net_width=32, test_eps_seed=3)
    assert batched_step_refusal([baselines[0], wild], unfused_rc, tc) == \
        "members of different configurations"
    dropouts = [KSampleBaseline("nerf_dropout", 8, net_depth=2, net_width=32,
                                dropout_rate=rate, test_eps_seed=m)
                for m, rate in enumerate((0.2, 0.2, 0.5))]
    assert batched_step_refusal(dropouts[:2], unfused_rc, tc) is None  # own test seeds
    assert batched_step_refusal(dropouts[1:], unfused_rc, tc) == \
        "members of different configurations"
    plain_flows = port_nerf_flows(CFG, *jax_nerf_flows(CFG, seed=2)[1:])
    plain_flows.flow_impl = "xla"
    assert batched_step_refusal([models[0], plain_flows], rc, tc) == \
        "members of different configurations"

    step, _ = make_ensemble_train_step(baselines, unfused_rc,
                                       TrainConfig(**TRAIN_KW, loss_mode="mse"), M)
    assert step.batched
    assert ("2 members batched (the nerf nets member by member, no kernel)"
            in capsys.readouterr().out)
    step, _ = make_ensemble_train_step(planar, RenderConfig(n_samples=8, fused="off"),
                                       TrainConfig(**TRAIN_KW, remat=True), M)
    assert step.batched
    assert ("2 members batched (remat, the forward recomputed in the backward; the planar "
            "flows once on the joined points; one trunk launch a pass for all)"
            in capsys.readouterr().out)
    step, _ = make_ensemble_train_step(models, RenderConfig(n_samples=8, n_importance=4),
                                       tc, M)
    assert not step.batched
    assert "2 members one after another (hierarchical sampling)" in capsys.readouterr().out
    step, _ = make_ensemble_train_step(models, RenderConfig(n_samples=8, fused="off"), tc, M)
    assert step.batched
    assert ("2 members batched (one trunk and flow-stack launch a chain and pass for all)"
            in capsys.readouterr().out)
    step, _ = make_ensemble_train_step(models, rc, tc, M, occ=occ)
    assert step.batched and "density query" in capsys.readouterr().out
    step, _ = make_ensemble_train_step(models, rc, tc, M)
    assert step.batched and "2 members batched" in capsys.readouterr().out
    batch = _stacked([make_batch(*RAYS, seed=m) for m in range(M)])
    with pytest.raises(ValueError, match="no draws for the seams"):
        step(batch, member_generators([1, 2], "cpu"), pdf_u=torch.zeros(M, 17, 4))


def test_parallel_single_image_path_gives_the_serial_checkpoints(scene):
    """--no_batching (the single-image sampler): each --parallel member's
    checkpoint is its serial run's, params and Adam state bitwise."""
    extra = ("--no_batching", "--precrop_iters", "2", "--precrop_frac", "0.5")
    tens.main(["train", *_flags(scene, "serial_single", *extra)], device="cpu")
    tens.main(["train", *_flags(scene, "parallel_single", *extra), "--parallel"], device="cpu")
    for m in (1, 2):
        name = f"000004_{m:02d}"
        serial = _load(_rundir(scene, "serial_single") / name)
        parallel = _load(_rundir(scene, "parallel_single") / name)
        _assert_trees_equal(parallel["params"], serial["params"], f"member {m} params")
        _assert_trees_equal(parallel["opt_state"], serial["opt_state"], f"member {m} Adam")
    assert os.path.isdir(_rundir(scene, "parallel_single"))
