"""The member-batched ensemble step for the baselines (nerf, nerf_dropout,
nerf_wild: cfnerf_torch/train/step.py:make_batched_loss,
cfnerf_torch/models/baseline_adapter.py:baseline_forward_members,
cfnerf_torch/parallel/ensemble.py), against the port's own per-member steps
and against the JAX package's vmapped step
(cfnerf_tpu/parallel/ensemble.py:make_ensemble_train_step, jax.vmap of its
step), JAX's masks and eps through the seams.

  * M = 3 members, two steps from each member's generator: metrics,
    gradients, parameters, Adam state (in the occ stage the proposals and
    their Adam state too) and the generators' states bitwise each member's
    own make_train_step; nerf, nerf_dropout and nerf_wild, nerf_wild in
    bf16, nerf_dropout and nerf_wild under remat, nerf_wild in the occ
    stage;
  * M = 2 members at D2/W32, K8 (tests/test_torch_baselines.py's STEP size)
    against JAX's vmapped step, one step, each member's draws from its JAX
    step key (jitter, dropout masks or eps): the gates of
    tests/test_torch_baselines.py's one-step test (metrics rtol 1e-5 / atol
    1e-7, gradients rtol 1e-4 / atol 1e-6);
  * render_members_test (the val batch of cli.ensemble) bitwise each
    member's own test-mode render;
  * cli.ensemble train --parallel --model nerf_wild on the checked-in
    capture: the member-batched step, every member's checkpoint bitwise its
    serial run's.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.parallel import ensemble as jpar
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.cli import ensemble as tens
from cfnerf_torch.convert import proposal_state_dict_from_jax, state_dict_from_jax
from cfnerf_torch.models.baseline_adapter import BASELINE_KINDS, wild_test_eps
from cfnerf_torch.models.factory import loss_mode_for_model
from cfnerf_torch.parallel.ensemble import make_ensemble_train_step, member_generators
from cfnerf_torch.render.renderer import (
    RenderConfig,
    make_render_rays,
    prepare_rays,
    render_members_test,
)
from cfnerf_torch.train.step import OccTrainConfig, TrainConfig, make_train_step
from tests.test_torch_baselines import (
    GRAD_TOL,
    STEP,
    jax_baseline,
    jax_train_draws,
    port_baseline,
)
from tests.test_torch_common import to_np
from tests.test_torch_ensemble_occ_unfused import CAPTURE_FLAGS
from tests.test_torch_ensemble_occ_unfused import capture  # noqa: F401  (a fixture)
from tests.test_torch_ensemble_parallel import _assert_trees_equal, _load, _stacked
from tests.test_torch_occ_train import N_PLACED, OCC, _jax_proposal_params
from tests.test_torch_train import (
    LOSS_RTOL,
    TRAIN_KW,
    _grads_in_opt_state,
    jax_draws,
    make_batch,
    port_z_vals,
)

T = torch.as_tensor
N_SAMPLES = 13
RAYS = (20, 7)  # rgb + COLMAP depth rays a member
FLOORS = (0.3, 0.6, 0.45)


@dataclasses.dataclass(frozen=True)
class Case:
    kind: str
    bf16: bool = False
    remat: bool = False
    occ: bool = False


CASES = {
    "nerf": Case("nerf"),
    "nerf_dropout": Case("nerf_dropout"),
    "nerf_wild": Case("nerf_wild"),
    "nerf_wild_bf16": Case("nerf_wild", bf16=True),
    "nerf_dropout_remat": Case("nerf_dropout", remat=True),
    "nerf_wild_remat": Case("nerf_wild", remat=True),
    "nerf_wild_occ": Case("nerf_wild", occ=True),
}


def _configs(case: Case):
    """The port's render, training and occ configurations of a case."""
    return (RenderConfig(n_samples=N_PLACED if case.occ else N_SAMPLES, fused="off"),
            TrainConfig(**{**TRAIN_KW, "loss_mode": loss_mode_for_model(case.kind)},
                        remat=case.remat),
            OccTrainConfig(**OCC) if case.occ else None)


def _members(kind: str, M: int, bf16: bool = False):
    """M STEP-size baselines on JAX's inits from seeds 0.. M-1, each with
    test draws of its own (nerf_wild's test_eps, nerf_dropout's mask seed);
    and the JAX params."""
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    params = [jax_baseline(kind, **STEP, compute_dtype=jdtype, seed=m)[1] for m in range(M)]
    models = []
    for m, p in enumerate(params):
        test_eps = wild_test_eps(STEP["k"], 30 + m).numpy() if kind == "nerf_wild" else None
        model = port_baseline(kind, **STEP, params=p, compute_dtype=tdtype, test_eps=test_eps)
        model.test_eps_seed = 30 + m
        models.append(model)
    return params, models


def _adam_state(optimizer):
    return [{k: v.clone() for k, v in optimizer.state[q].items()}
            for g in optimizer.param_groups for q in g["params"]]


def _assert_same_leaves(a: torch.nn.Module, b: torch.nn.Module):
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
        assert (p.grad is None) == (q.grad is None), n
        assert p.grad is None or torch.equal(p.grad, q.grad), n


@pytest.mark.parametrize("name", list(CASES))
def test_batched_step_is_the_per_member_steps_bitwise(name):
    """Two steps from each member's generator, M = 3: the batched step's
    metrics, gradients, parameters and Adam state (the occ stage: the
    proposals and their Adam state too) are each member's own
    make_train_step's, bit for bit, and the generators end in the same
    state."""
    case, M = CASES[name], 3
    _, models = _members(case.kind, M, case.bf16)
    _, serial_models = _members(case.kind, M, case.bf16)
    rc, tc, occ = _configs(case)
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
        batch = _stacked([make_batch(*RAYS, seed=330 + 10 * s + m) for m in range(M)])
        if occ is not None:
            batch["occ_floor"] = np.asarray(FLOORS, np.float32)
        metrics = step(batch, gens)
        for m, (single, _) in enumerate(singles):
            want = single({k: v[m] for k, v in batch.items()}, serial_gens[m])
            assert set(want) == set(metrics)
            for k in want:
                assert torch.equal(metrics[k][m], want[k]), (m, k)
            assert all(bool(torch.isfinite(v)) for v in want.values())
    for m, (single, opt) in enumerate(singles):
        _assert_same_leaves(models[m], serial_models[m])
        for a, b in zip(_adam_state(optimizers[m]), _adam_state(opt)):
            assert all(torch.equal(a[k], b[k]) for k in b)
        if occ is not None:
            _assert_same_leaves(step.proposals[m], single.proposal)
            for a, b in zip(_adam_state(step.prop_optimizers[m]),
                            _adam_state(single.prop_optimizer)):
                assert all(torch.equal(a[k], b[k]) for k in b)
        assert torch.equal(gens[m].get_state(), serial_gens[m].get_state())


@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_batched_step_matches_jax_vmapped_step(kind):
    """One step of M = 2 members against JAX's make_ensemble_train_step,
    each member's jitter and masks or eps from its JAX step key through
    the seams, at tests/test_torch_baselines.py's one-step gates."""
    M, S = 2, N_SAMPLES
    params, models = _members(kind, M)
    jm, _ = jax_baseline(kind, **STEP)
    n_rays = sum(RAYS)
    batches = [make_batch(*RAYS, seed=350 + m) for m in range(M)]
    keys = jpar.member_keys([jax.random.PRNGKey(700 + m) for m in range(M)])
    rc, tc, _ = _configs(Case(kind))
    jrc = jrender.RenderConfig(n_samples=S, perturb=True, use_viewdirs=True, fused="off")
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(
            jm, jrc, jstep.TrainConfig(**{**TRAIN_KW, "loss_mode": tc.loss_mode}), None)
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members(params))
    _, jstate, jmetrics = estep(p, jax.vmap(tx.init)(p),
                                {k: jnp.asarray(v) for k, v in _stacked(batches).items()},
                                keys)

    step, _ = make_ensemble_train_step(models, rc, tc, M)
    assert step.batched
    z_vals, draws = [], []
    for m in range(M):
        t_rand, _ = jax_draws(keys[m], n_rays, S, STEP["k"])
        z_vals.append(port_z_vals(t_rand, S))
        draws.append(jax_train_draws(jm, kind, jax.random.split(keys[m], 5)[1], n_rays * S))
    seams = {"z_vals": torch.stack(z_vals)}
    if kind == "nerf_wild":
        seams["eps"] = T(np.stack(draws))
    elif kind == "nerf_dropout":  # K mask lists, each mask (M, n_points, width)
        seams["eps"] = [[np.stack(masks) for masks in zip(*lists)] for lists in zip(*draws)]
    metrics = step(_stacked(batches), [None] * M, **seams)
    for m, model in enumerate(models):
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k][m]), float(jmetrics[k][m]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        jg = {k: v.numpy() for k, v in state_dict_from_jax(
            jpar.unstack_member(jax.tree_util.tree_map(np.asarray, jstate[0]), m),
            kind).items()}
        got = {n: (np.zeros(tuple(q.shape), np.float32) if q.grad is None else to_np(q.grad))
               for n, q in model.named_parameters()}
        assert set(got) == set(jg)
        for n in jg:
            np.testing.assert_allclose(got[n], jg[n], err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("kind", BASELINE_KINDS)
def test_val_render_is_each_members_own_render_bitwise(kind):
    """render_members_test, the val batch of cli.ensemble for all members
    at once, against each member's own make_render_rays test render: every
    map bitwise; nerf_dropout's fixed masks and nerf_wild's test eps are
    each member's own."""
    M = 3
    _, models = _members(kind, M)
    rc = RenderConfig(n_samples=N_SAMPLES, fused="off")
    b = make_batch(*RAYS, seed=370)
    with torch.inference_mode():
        rays = prepare_rays(T(b["rays_o"]), T(b["rays_d"]), H=10, W=10, focal=10.0,
                            ndc=False, use_viewdirs=True, near=2.0, far=6.0)
        together = render_members_test(models, rc, *rays)
        for m, model in enumerate(models):
            alone = make_render_rays(model, rc)(*rays, None, is_test=True)
            assert set(together[m]) == {"rgb_map", "disp_map", "depth_map", "acc_map",
                                        "loss_entropy"}
            for k, v in together[m].items():
                assert torch.equal(v, alone[k]), (m, k)
    spread = (together[0]["rgb_map"] - together[1]["rgb_map"]).abs().max()
    assert float(spread) > 0  # the members differ
    if kind != "nerf":  # the K draws differ
        assert float(together[0]["rgb_map"].std(-1).max()) > 0


def test_parallel_cli_gives_the_serial_checkpoints(capture, capsys):
    """cli.ensemble train --parallel --model nerf_wild on the checked-in
    capture (2 members x 4 steps, its val batch rendered for both members
    at once): the member-batched step, each member's checkpoint (weights,
    test eps, Adam state) bitwise its serial run's."""
    base = Path(capture).parent / "baselines_nerf_wild"
    flags = [*CAPTURE_FLAGS, "--datadir", str(capture), "--model", "nerf_wild"]
    tens.main(["train", *flags, "--basedir", str(base / "serial"), "--is_train"], device="cpu")
    capsys.readouterr()
    tens.main(["train", *flags, "--basedir", str(base / "parallel"), "--is_train",
               "--parallel"], device="cpu")
    out = capsys.readouterr().out
    assert ("ensemble step: 2 members batched (the nerf_wild nets member by member, "
            "no kernel)") in out
    for m in (1, 2):
        ckpt = f"000004_{m:02d}"
        serial, parallel = (_load(next((base / run).rglob(ckpt)))
                            for run in ("serial", "parallel"))
        assert serial["global_step"] == parallel["global_step"] == 4
        _assert_trees_equal(parallel["params"], serial["params"], f"member {m} params")
        _assert_trees_equal(parallel["opt_state"], serial["opt_state"], f"member {m} Adam")
