"""The member-batched ensemble step for every NeRFFlows flow family and for
remat (cfnerf_torch/train/step.py:make_batched_loss,
cfnerf_torch/models/nerf_flows.py:forward_members,
cfnerf_torch/parallel/ensemble.py), against the port's own per-member steps
and against the JAX package's vmapped step
(cfnerf_tpu/parallel/ensemble.py:make_ensemble_train_step, jax.vmap of its
step), JAX's draws through the seams.

The cases: householder (also with the `interpret` trunk, the trunk
kernels' plain versions with a member axis), orthogonal, planar, IAF and
no_flow on the unfused render; the triangular model under remat, fused,
unfused and in the occ stage.

  * M = 3 members, two steps from each member's generator: metrics,
    gradients, parameters, Adam state (and in the occ stage the proposals
    and their Adam state) bitwise each member's own make_train_step;
  * M = 2 members at D4/W64, K8, F2 (the `interpret` trunk D4/W256, its
    domain) against JAX's vmapped step, one step: the metrics at rtol =
    atol = 1e-4 (planar's entropy rtol 1e-3), each gradient leaf by
    relative RMS <= 1e-3 and cosine >= 0.9999, the gates of the families'
    golden (tests/test_torch_families.py: at D4/W64 XLA's and PyTorch's f32
    matmuls sum over more terms than the one-step test's D2/W32; planar
    1e-2, as its one-step test: u^ divides by |w|^2; a leaf whose JAX
    gradient is rounding noise, every entry <= 1e-6, by its absolute error
    <= 1e-6); the `interpret` trunk at its one-step gates (relative RMS
    1e-2, cosine 0.9998, tests/test_torch_trunk_bwd.py: bf16 products), JAX
    op by op there; the occ stage on JAX's own depths, recorded as its
    vmapped step places them and handed over through z_vals
    (tests/test_torch_occ_train.py), its co-training at
    tests/test_torch_ensemble_occ_unfused.py's gates;
  * cli.ensemble train --parallel on the checked-in capture: the
    member-batched step, every member's checkpoint bitwise its serial
    run's.
"""
import dataclasses
from pathlib import Path
from typing import Optional

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
from cfnerf_torch.parallel.ensemble import make_ensemble_train_step, member_generators
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train.step import OccTrainConfig, TrainConfig, make_train_step
from tests.test_torch_common import Tiny, to_np
from tests.test_torch_ensemble_occ_unfused import CAPTURE_FLAGS
from tests.test_torch_ensemble_occ_unfused import capture  # noqa: F401  (a fixture)
from tests.test_torch_ensemble_parallel import _assert_trees_equal, _load, _stacked
from tests.test_torch_families import (
    GOLDEN_MIN_COS,
    GOLDEN_NOISE,
    GOLDEN_REL_RMS,
    PLANAR_ENTROPY_RTOL,
    PLANAR_GRAD_REL_RMS,
    jax_family,
    port_family,
)
from tests.test_torch_occ_train import (
    N_PLACED,
    OCC,
    _jax_proposal_params,
    assert_proposal_close,
    jax_occ_draws,
    recorded_jax_depths,
)
from tests.test_torch_train import (
    TRAIN_KW,
    _grads_in_opt_state,
    jax_draws,
    make_batch,
    port_z_vals,
)
from tests.test_torch_trunk_bwd import MIN_COS, STEP_REL_RMS

T = torch.as_tensor
STEP = Tiny(depth=2, width=32, k=8, flows=2, h_alpha=16, h_rgb=16)
SMALL = Tiny()  # D4/W64, K8, F2, h 16/16
INTERP = Tiny(depth=4, width=256, k=8, flows=2, h_alpha=16, h_rgb=16)
N_SAMPLES = 12
RAYS = (24, 8)  # rgb + COLMAP depth rays a member
FLOORS = (0.3, 0.6, 0.45)
METRIC_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class Case:
    family: str = "triangular"
    trunk_impl: str = "xla"
    fused: str = "off"
    remat: bool = False
    occ: bool = False
    cfg: Tiny = STEP        # the bitwise test's size
    jax_cfg: Tiny = SMALL   # the size held against JAX


CASES = {
    "householder": Case("householder"),
    "householder_interpret": Case("householder", trunk_impl="interpret", cfg=INTERP,
                                  jax_cfg=INTERP),
    "orthogonal": Case("orthogonal"),
    "planar": Case("planar"),
    "IAF": Case("IAF"),
    "no_flow": Case("no_flow"),
    "remat_fused": Case(fused="on", remat=True),
    "remat_unfused": Case(remat=True),
    "remat_occ": Case(fused="on", remat=True, occ=True),
}


def _configs(case: Case):
    """The port's render, training and occ configurations of a case."""
    n = N_PLACED if case.occ else N_SAMPLES
    return (RenderConfig(n_samples=n, fused=case.fused),
            TrainConfig(**TRAIN_KW, remat=case.remat),
            OccTrainConfig(**OCC) if case.occ else None)


def _members(case: Case, cfg: Tiny, M: int):
    """Each member's JAX params and test eps, the JAX model, the port's."""
    made = [jax_family(case.family, cfg, seed=m, trunk_impl=case.trunk_impl)
            for m in range(M)]
    return ([(p, e) for _, p, e in made], made[0][0],
            [port_family(case.family, cfg, p, e, trunk_impl=case.trunk_impl)
             for _, p, e in made])


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
    _, _, models = _members(case, case.cfg, M)
    _, _, serial_models = _members(case, case.cfg, M)
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
        batch = _stacked([make_batch(*RAYS, seed=230 + 10 * s + m) for m in range(M)])
        if occ is not None:
            batch["occ_floor"] = np.asarray(FLOORS, np.float32)
        metrics = step(batch, gens)
        for m, (single, _) in enumerate(singles):
            want = single({k: v[m] for k, v in batch.items()}, serial_gens[m])
            assert set(want) == set(metrics)
            for k in want:
                assert torch.equal(metrics[k][m], want[k]), (m, k)
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


def _grad_failures(case: Case, got: dict, want: dict) -> dict:
    """The gradient leaves past the case's gate against JAX's: (relative
    RMS, cosine), or the absolute error of a rounding-noise leaf."""
    rel_rms, min_cos = ((STEP_REL_RMS, MIN_COS) if case.trunk_impl == "interpret" else
                        (PLANAR_GRAD_REL_RMS if case.family == "planar" else GOLDEN_REL_RMS,
                         GOLDEN_MIN_COS))
    bad = {}
    for n, w in want.items():
        w = w.astype(np.float64)
        g = got[n].astype(np.float64)
        if np.abs(w).max() <= GOLDEN_NOISE:
            if np.abs(g - w).max() > GOLDEN_NOISE:
                bad[n] = float(np.abs(g - w).max())
            continue
        rel = float(np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2)))
        cos = float(np.sum(g * w) / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-30))
        if not (rel <= rel_rms and cos >= min_cos):
            bad[n] = (rel, cos)
    return bad


def _jax_names(tree, family: str) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), None, family).items()}


@pytest.mark.parametrize("name", list(CASES))
def test_batched_step_matches_jax_vmapped_step(name):
    """One step of M = 2 members against JAX's make_ensemble_train_step,
    each member's draws from its JAX step key through the seams (the jitter
    and eps; in the occ stage JAX's depths and its co-training points)."""
    case, M = CASES[name], 2
    cfg = case.jax_cfg
    members, jm, models = _members(case, cfg, M)
    n_rays = sum(RAYS)
    batches = [make_batch(*RAYS, seed=250 + m) for m in range(M)]
    keys = jpar.member_keys([jax.random.PRNGKey(600 + m) for m in range(M)])
    rc, tc, occ = _configs(case)
    jrc = jrender.RenderConfig(n_samples=rc.n_samples, perturb=True, use_viewdirs=True,
                               fused="off")
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(
            jm, jrc, jstep.TrainConfig(**TRAIN_KW, remat=case.remat), None,
            occ=None if occ is None else jstep.OccTrainConfig(**OCC))
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members([q for q, _ in members]))
    state = jax.vmap(tx.init)(p)
    b = {k: jnp.asarray(v) for k, v in _stacked(batches).items()}
    props: Optional[list] = None
    if occ is not None:
        props = [_jax_proposal_params(seed=80 + m) for m in range(M)]
        state = estep._wrap_state(state, jax.tree_util.tree_map(
            jnp.asarray, jpar.stack_members(props)))
        b["occ_floor"] = jnp.asarray(FLOORS[:M], jnp.float32)
    # the interpret trunk's bf16 products run op by op, as
    # tests/test_torch_ensemble_batched.py runs them (under jit XLA may
    # move a bf16 rounding)
    run = estep._vupdate if case.trunk_impl == "interpret" else estep
    with recorded_jax_depths() as seen:
        jp, jstate, jmetrics = run(p, state, b, keys)
        jax.block_until_ready(jp)

    step, _ = make_ensemble_train_step(models, rc, tc, M, occ=occ)
    assert step.batched
    batch = _stacked(batches)
    if occ is None:
        draws = [jax_draws(keys[m], n_rays, rc.n_samples, cfg.k) for m in range(M)]
        seams = dict(z_vals=torch.stack([port_z_vals(t, rc.n_samples) for t, _ in draws]),
                     eps=tuple(T(np.stack([e[i] for _, e in draws])) for i in range(2)))
    else:
        step.install_proposals([proposal_state_dict_from_jax(q) for q in props])
        draws = [jax_occ_draws(keys[m], n_rays) for m in range(M)]
        assert len(seen) == M
        batch["occ_floor"] = np.asarray(FLOORS[:M], np.float32)
        seams = dict(z_vals=T(np.stack(seen)),
                     eps=tuple(T(np.stack([d["eps"][i] for d in draws])) for i in range(2)),
                     prop_pts=T(np.stack([d["prop_pts"] for d in draws])))
    metrics = step(batch, [None] * M, **seams)
    grads_state = jstate[0][0] if occ is not None else jstate[0]
    for m, model in enumerate(models):
        for k in jmetrics:
            got, want = float(metrics[k][m]), float(jmetrics[k][m])
            if case.family == "planar" and k == "loss_entropy":
                np.testing.assert_allclose(got, want, rtol=PLANAR_ENTROPY_RTOL, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=METRIC_TOL, atol=METRIC_TOL,
                                           err_msg=k)
        jg = _jax_names(jpar.unstack_member(jax.tree_util.tree_map(np.asarray, grads_state), m),
                        case.family)
        got = {n: (np.zeros(tuple(q.shape), np.float32) if q.grad is None else to_np(q.grad))
               for n, q in model.named_parameters()}
        assert set(got) == set(jg)
        assert not _grad_failures(case, got, jg), _grad_failures(case, got, jg)
        if occ is not None:
            prop_grads = {n: to_np(q.grad) for n, q in step.proposals[m].named_parameters()}
            assert_proposal_close(step.proposals[m], proposal_state_dict_from_jax(
                jpar.unstack_member(jax.tree_util.tree_map(np.asarray, jstate[1]), m)),
                prop_grads)


CLI_FAMILIES = ("householder", "orthogonal", "planar", "IAF", "no_flow")


@pytest.mark.parametrize("family", CLI_FAMILIES)
def test_parallel_cli_gives_the_serial_checkpoints(capture, family, capsys):
    """cli.ensemble train --parallel with each family on the checked-in
    capture (2 members x 4 steps, the unfused render): the member-batched
    step, each member's checkpoint (weights, eps buffers, Adam state)
    bitwise its serial run's.  (remat has no flag in either package's CLI:
    TrainConfig.remat is the library's, stepped above.)"""
    base = Path(capture).parent / f"families_{family}"
    flags = [*CAPTURE_FLAGS, "--datadir", str(capture), "--type_flows", family,
             "--fused_render", "off"]
    tens.main(["train", *flags, "--basedir", str(base / "serial"), "--is_train"], device="cpu")
    capsys.readouterr()
    tens.main(["train", *flags, "--basedir", str(base / "parallel"), "--is_train",
               "--parallel"], device="cpu")
    assert "ensemble step: 2 members batched" in capsys.readouterr().out
    for m in (1, 2):
        ckpt = f"000004_{m:02d}"
        serial, parallel = (_load(base / run / "minicapture" / family / "ens" / ckpt)
                            for run in ("serial", "parallel"))
        assert serial["global_step"] == parallel["global_step"] == 4
        _assert_trees_equal(parallel["params"], serial["params"], f"member {m} params")
        _assert_trees_equal(parallel["opt_state"], serial["opt_state"], f"member {m} Adam")
