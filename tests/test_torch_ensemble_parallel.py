"""Ensemble-parallel training in the port (cfnerf_torch/parallel/ensemble.py,
cli/ensemble.py:train_ensemble_parallel) against the JAX package's vmapped
member axis (cfnerf_tpu/parallel/ensemble.py), at tests/test_ensemble_parallel.py's
small widths:

  * the ensemble step, M = 2, two steps, against JAX's
    make_ensemble_train_step(mesh=None): each member's draws recomputed from
    its JAX key (tests/test_torch_train.py's jax_draws) and injected through
    the seams, with a member axis;
  * the loop (n_inner = 3) against three ensemble steps;
  * the occ step with per-member floors 0.3 and 0.6 and installed proposals
    against JAX's vmapped occ step, run op by op (un-jitted, as
    tests/test_torch_occ_train.py runs JAX's occ step);
  * the CLI on a tiny Blender scene: --parallel gives the serial CLI's
    checkpoints, member by member, and logs the tagged scalars; the
    refusals;
  * stack_members / unstack_member against JAX's on converted state dicts.

Tolerances: the first step as tests/test_torch_train.py (dense) and
tests/test_torch_occ_train.py (occ) hold one step.  The second step: loss
and metrics rtol 1e-5 dense (measured 1.1e-6), 1e-4 occ (its rule), and
each leaf's two-step update by relative RMS and cosine, as
tests/test_torch_occ_train.py holds its second step.  Adam's second update
divides by both steps' gradients, so an entry whose first gradient sat below
1e-5, where the two frameworks' first Adam steps may part by up to 2 lr,
moves the second: measured 4.6e-6 where the second gradient is >= 1e-5,
past the first step's 1e-6."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.cli import ensemble as jens
from cfnerf_tpu.data import sampler as jsampler
from cfnerf_tpu.parallel import ensemble as jpar
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_tpu.utils.config import config_parser as jparser
from cfnerf_torch.cli import ensemble as tens
from cfnerf_torch.convert import nerf_flows_state_dict_from_jax, proposal_state_dict_from_jax
from cfnerf_torch.data.sampler import RayBatcher
from cfnerf_torch.parallel.ensemble import (
    make_ensemble_train_loop,
    make_ensemble_train_step,
    member_generators,
    stack_members,
    unstack_member,
)
from cfnerf_torch.render.renderer import RenderConfig
from cfnerf_torch.train import checkpoint as tckpt
from cfnerf_torch.train.step import OccTrainConfig, TrainConfig
from tests.datagen import make_blender_dataset
from tests.test_torch_common import jax_nerf_flows, port_nerf_flows, to_np
from tests.test_torch_occ_train import (
    N_PLACED,
    OCC,
    RAYS,
    _jax_proposal_params,
    _prop_grads,
    assert_grads_rms_close,
    assert_proposal_close,
    assert_updates_close,
    jax_occ_draws,
)
from tests.test_torch_train import (
    CFG,
    GRAD_TOL,
    LOSS_RTOL,
    TRAIN_KW,
    _grads_in_opt_state,
    _port_names,
    assert_grads_close,
    assert_params_after_update_close,
    jax_draws,
    make_batch,
    port_z_vals,
)

M = 2
N_SAMPLES = 13
DENSE_RAYS = (20, 7)  # rgb + COLMAP depth rays
SECOND_STEP_RTOL = 1e-4
FLOORS = (0.3, 0.6)
T = torch.as_tensor


def _members():
    """Each member's JAX params and test eps (jax_nerf_flows at seeds 0, 1)."""
    return [jax_nerf_flows(CFG, seed=m)[1:] for m in range(M)]


def _stacked(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _jax_steps(estep, p, opt, batches, keys0, floors=None, eager=False):
    """Ensemble steps of JAX's make_ensemble_train_step, the keys split as
    its CLI splits them; returns per step the metrics, the (stacked) opt
    state, params and each member's step key."""
    keys = jpar.member_keys(keys0)
    run = estep._vupdate if eager else estep
    out = []
    for step_batches in batches:
        b = {k: jnp.asarray(v) for k, v in _stacked(step_batches).items()}
        if floors is not None:
            b["occ_floor"] = jnp.asarray(floors, jnp.float32)
        kk = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
        keys, step_keys = kk[:, 0], kk[:, 1]
        p, opt, metrics = run(p, opt, b, step_keys)
        out.append((jax.tree_util.tree_map(np.asarray, metrics), opt, p, step_keys))
    return out


def _member_tree(tree, m):
    return jpar.unstack_member(jax.tree_util.tree_map(np.asarray, tree), m)


def _metrics_close(got, want, m, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k][m]), float(want[k][m]), rtol=rtol, err_msg=k)


def test_ensemble_step_matches_jax_vmapped_step():
    members = _members()
    batches = [[make_batch(*DENSE_RAYS, seed=10 * m + s) for m in range(M)] for s in range(2)]
    keys0 = [jax.random.PRNGKey(100 + m) for m in range(M)]
    jm, _, _ = jax_nerf_flows(CFG)
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW), None)
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members([p for p, _ in members]))
    ref = _jax_steps(estep, p, jax.vmap(tx.init)(p), batches, keys0)

    models = [port_nerf_flows(CFG, p, e) for p, e in members]
    start = [{k: v.clone() for k, v in model.state_dict().items()} for model in models]
    step, optimizers = make_ensemble_train_step(models, RenderConfig(n_samples=N_SAMPLES),
                                                TrainConfig(**TRAIN_KW), M)
    assert len(optimizers) == M and len(step.members) == M
    for s, (jmetrics, jopt, jp, step_keys) in enumerate(ref):
        draws = [jax_draws(step_keys[m], sum(DENSE_RAYS), N_SAMPLES, CFG.k) for m in range(M)]
        z_vals = torch.stack([port_z_vals(t, N_SAMPLES) for t, _ in draws])
        eps = tuple(T(np.stack([e[i] for _, e in draws])) for i in range(2))
        metrics = step(_stacked(batches[s]), [None] * M, z_vals=z_vals, eps=eps)
        assert all(v.shape == (M,) for v in metrics.values())
        for m, model in enumerate(models):
            _metrics_close(metrics, jmetrics, m, LOSS_RTOL)
            after = _port_names(_member_tree(jp, m))
            if s == 0:
                jg = _port_names(_member_tree(jopt[0], m))
                assert_grads_close({n: to_np(q.grad) for n, q in model.named_parameters()},
                                   jg, GRAD_TOL)
                assert_params_after_update_close(model, after, jg, TRAIN_KW["lrate"])
            else:
                assert_updates_close(model.state_dict(), after, start[m])


def test_ensemble_loop_is_n_ensemble_steps():
    members = _members()
    n_inner = 3
    steps = [_stacked([make_batch(12, 4, seed=100 + 10 * m + s) for m in range(M)])
             for s in range(n_inner)]
    cfg, rc = TrainConfig(**TRAIN_KW), RenderConfig(n_samples=8)

    models_loop = [port_nerf_flows(CFG, p, e) for p, e in members]
    loop, _ = make_ensemble_train_loop(models_loop, rc, cfg, M, n_inner=n_inner)
    out = loop(_stacked(steps), member_generators([7, 8], "cpu"))
    assert all(v.shape == (n_inner, M) for v in out.values())

    models_step = [port_nerf_flows(CFG, p, e) for p, e in members]
    step, _ = make_ensemble_train_step(models_step, rc, cfg, M)
    gens = member_generators([7, 8], "cpu")
    want = [step(b, gens) for b in steps]
    for k in out:
        torch.testing.assert_close(out[k], torch.stack([w[k] for w in want]), rtol=0, atol=0,
                                   msg=k)
    for a, b in zip(models_loop, models_step):
        for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)


def test_ensemble_occ_step_matches_jax_vmapped_occ_step():
    members = _members()
    props = [_jax_proposal_params(seed=50 + m) for m in range(M)]
    batches = [[make_batch(*RAYS, seed=30 * m + s) for m in range(M)] for s in range(2)]
    keys0 = [jax.random.PRNGKey(200 + m) for m in range(M)]
    jm, _, _ = jax_nerf_flows(CFG)
    rc = jrender.RenderConfig(n_samples=N_PLACED, perturb=True, use_viewdirs=True,
                              fused="off")
    with _grads_in_opt_state():
        estep, tx = jpar.make_ensemble_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW), None,
                                                  occ=jstep.OccTrainConfig(**OCC))
    p = jax.tree_util.tree_map(jnp.asarray, jpar.stack_members([p for p, _ in members]))
    wrapped = estep._wrap_state(jax.vmap(tx.init)(p), jax.tree_util.tree_map(
        jnp.asarray, jpar.stack_members(props)))
    ref = _jax_steps(estep, p, wrapped, batches, keys0, floors=FLOORS, eager=True)

    models = [port_nerf_flows(CFG, p, e) for p, e in members]
    start = [{k: v.clone() for k, v in model.state_dict().items()} for model in models]
    step, _ = make_ensemble_train_step(models, RenderConfig(n_samples=N_PLACED),
                                       TrainConfig(**TRAIN_KW), M, occ=OccTrainConfig(**OCC))
    step.install_proposals([proposal_state_dict_from_jax(q) for q in props])
    prop_start = [{k: v.clone() for k, v in q.state_dict().items()} for q in step.proposals]
    for s, (jmetrics, jstate, jp, step_keys) in enumerate(ref):
        draws = [jax_occ_draws(step_keys[m], sum(RAYS)) for m in range(M)]
        batch = dict(_stacked(batches[s]), occ_floor=np.asarray(FLOORS, np.float32))
        metrics = step(batch, [None] * M,
                       place_u=T(np.stack([d["place_u"] for d in draws])),
                       eps=tuple(T(np.stack([d["eps"][i] for d in draws])) for i in range(2)),
                       prop_pts=T(np.stack([d["prop_pts"] for d in draws])))
        for m, model in enumerate(models):
            for k in jmetrics:
                if k == "prop_loss":
                    rtol = 1e-4 if s == 0 else 1e-3
                else:
                    rtol = LOSS_RTOL if s == 0 else SECOND_STEP_RTOL
                np.testing.assert_allclose(float(metrics[k][m]), float(jmetrics[k][m]),
                                           rtol=rtol, err_msg=k)
            after = _port_names(_member_tree(jp, m))
            prop_after = proposal_state_dict_from_jax(_member_tree(jstate[1], m))
            if s == 0:
                grads = {n: to_np(q.grad) for n, q in model.named_parameters()}
                assert_grads_rms_close(grads, _port_names(_member_tree(jstate[0][0], m)))
                assert_params_after_update_close(model, after, grads, TRAIN_KW["lrate"])
                assert_proposal_close(step.proposals[m], prop_after,
                                      _prop_grads(step.members[m]))
            else:
                assert_updates_close(model.state_dict(), after, start[m])
                assert_updates_close(step.proposals[m].state_dict(), prop_after, prop_start[m])


def test_floors_reach_each_member():
    """An (M,) occ_floor gives member m floor [m]: a floor of 1e6 places the
    uniform stratified schedule, 0.3 does not."""
    from cfnerf_torch.train import step as tstep

    members = _members()
    models = [port_nerf_flows(CFG, p, e) for p, e in members]
    step, _ = make_ensemble_train_step(models, RenderConfig(n_samples=N_PLACED),
                                       TrainConfig(**TRAIN_KW), M, occ=OccTrainConfig(**OCC))
    seen = []
    real = tstep.place_from_sigma

    def spy(*a, **kw):
        seen.append(float(kw["floor"]))
        return real(*a, **kw)

    tstep.place_from_sigma = spy
    try:
        batch = dict(_stacked([make_batch(*RAYS, seed=m) for m in range(M)]),
                     occ_floor=np.asarray([0.3, 1e6], np.float32))
        step(batch, member_generators([1, 2], "cpu"))
    finally:
        tstep.place_from_sigma = real
    assert seen == [pytest.approx(0.3), 1e6]


def test_stack_members_round_trips_jax_on_converted_state_dicts():
    members = _members()
    jstack = jpar.stack_members([p for p, _ in members])
    port = [nerf_flows_state_dict_from_jax(p, e) for p, e in members]
    stacked = stack_members([{"coarse": sd} for sd in port])
    for name, t in stacked["coarse"].items():
        assert t.shape == (M, *port[0][name].shape), name
    for m, (_, eps) in enumerate(members):
        want = nerf_flows_state_dict_from_jax(jpar.unstack_member(jstack, m), eps)
        got = unstack_member(stacked, m)["coarse"]
        assert set(got) == set(want) == set(port[m])
        for name in want:
            assert torch.equal(got[name], want[name]) and torch.equal(got[name], port[m][name])
            # a copy of its own, so a saved member holds only its own tensors
            assert got[name].untyped_storage().nbytes() == got[name].nbytes


def test_ray_batcher_mesh_divisor_refuses_as_jax_does():
    rays = np.zeros((64, 3, 3), np.float32)
    with pytest.raises(ValueError) as port:
        RayBatcher(rays, 10, mesh_divisor=4)
    with pytest.raises(ValueError) as ref:
        jsampler.RayBatcher(rays, 10, mesh_divisor=4)
    assert str(port.value) == str(ref.value)
    assert RayBatcher(rays, 12, mesh_divisor=4).next()["rays_o"].shape == (12, 3)


# ---------------------------------------------------------------------- #
# the CLI on a tiny Blender scene
# ---------------------------------------------------------------------- #

TINY = ["--expname", "ensp", "--dataname", "tiny", "--dataset_type", "blender",
        "--N_rand", "16", "--N_samples", "8", "--K_samples", "4", "--n_flows", "2",
        "--h_alpha_size", "8", "--h_rgb_size", "8", "--netdepth", "2", "--netwidth", "16",
        "--type_flows", "triangular", "--use_viewdirs", "--white_bkgd", "--no_ndc",
        "--testskip", "1", "--n_iters", "4", "--i_print", "2", "--i_weights", "4",
        "--i_img", "0", "--chunk", "64", "--n_members", "2", "--is_train"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ensemble_parallel")
    return tmp, make_blender_dataset(str(tmp / "lego"), H=8, W=8, n_val=1)


def _flags(scene, basedir, *extra):
    tmp, datadir = scene
    return TINY + ["--datadir", datadir, "--basedir", str(tmp / basedir), *extra]


def _rundir(scene, basedir):
    return scene[0] / basedir / "tiny" / "triangular" / "ensp"


def _records(scene, basedir):
    with open(scene[0] / basedir / "tiny" / "summaries" / "ensp" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _load(path):
    return torch.load(os.path.join(path, tckpt.STATE_FILE), map_location="cpu",
                      weights_only=True)


def _assert_trees_equal(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_parallel_cli_gives_the_serial_checkpoints(scene):
    tens.main(["train", *_flags(scene, "serial")], device="cpu")
    tens.main(["train", *_flags(scene, "parallel"), "--parallel"], device="cpu")
    for m in (1, 2):
        name = f"000004_{m:02d}"
        serial = _load(_rundir(scene, "serial") / name)
        parallel = _load(_rundir(scene, "parallel") / name)
        assert serial["global_step"] == parallel["global_step"] == 4
        _assert_trees_equal(parallel["params"], serial["params"], f"member {m} params")
        _assert_trees_equal(parallel["opt_state"], serial["opt_state"], f"member {m} Adam")

    recs = _records(scene, "parallel")
    assert [r["step"] for r in recs] == [2, 4]
    tagged = {f"{k}_m{m:02d}" for k in ("train/psnr", "val/psnr", "val/nll") for m in (1, 2)}
    for r in recs:
        assert tagged | {"train/loss", "train/psnr", "val/mse", "val/psnr", "iter_time"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
    # the same trajectories: each member's train PSNR as its serial run logged it
    serial = _records(scene, "serial")
    for m in (1, 2):
        assert [r[f"train/psnr_m{m:02d}"] for r in recs] == [
            r["train/psnr"] for r in serial[2 * (m - 1):2 * m]]
    summary = tens.eval_ensemble(tens.parser().parse_args(_flags(scene, "parallel")), 2,
                                 device="cpu")
    assert summary["members"] == [1, 2] and all(
        np.isfinite(summary[k]) for k in ("psnr", "ssim", "nll", "ause"))

    # the loop flavour across a K-schedule boundary, resumed from step 4
    tens.main(["train", *_flags(scene, "parallel", "--n_inner", "2", "--n_iters", "8",
                                "--k_schedule", "2:0,4:6"), "--parallel"], device="cpu")
    assert {"000008_01", "000008_02"} <= set(os.listdir(_rundir(scene, "parallel")))
    assert [r["step"] for r in _records(scene, "parallel")] == [2, 4, 6, 8]


def test_parallel_cli_occ_stage(scene, capsys):
    """The occ stage: each member's proposal distilled at the boundary, the
    floor annealed, the dense cooldown after --occ_train_until."""
    tens.main(["train", *_flags(scene, "occ", "--n_iters", "5", "--occ_train", "6",
                                "--occ_candidates", "16", "--occ_train_from", "2",
                                "--occ_train_until", "4", "--occ_floor_anneal", "2"),
               "--parallel"], device="cpu")
    out = capsys.readouterr().out
    assert "occ stage: 2 proposals distilled" in out
    assert "occ stage ended at step 4: dense cooldown" in out
    assert {"000004_01", "000004_02"} <= set(os.listdir(_rundir(scene, "occ")))
    assert all(np.isfinite(v) for r in _records(scene, "occ") for v in r.values())


@pytest.mark.parametrize("extra,error,match", [
    (["--N_importance", "4"], ValueError, "hierarchical"),
    (["--render_only"], ValueError, "--render_only has no parallel-ensemble mode"),
], ids=["N_importance", "render_only"])
def test_parallel_cli_refuses_as_jax_does(scene, extra, error, match):
    flags = _flags(scene, "refused", *extra)
    with pytest.raises(error, match=match) as port:
        tens.train_ensemble_parallel(tens.parser().parse_args(flags), 2, device="cpu")
    jp = jparser()
    jp.add_argument("--n_members", type=int, default=2)
    with pytest.raises(error) as ref:
        jens.train_ensemble_parallel(jp.parse_args(flags), 2)
    assert str(port.value) == str(ref.value)


def test_parallel_refuses_a_mesh_and_straggling_members(scene):
    # a mesh whose data axis does not divide N_rand: JAX's refusal, before
    # any rank is launched ((ensemble 2, data 2) over 4 devices)
    flags = _flags(scene, "refused", "--mesh_devices", "4", "--N_rand", "15")
    with pytest.raises(ValueError) as port:
        tens.train_ensemble_parallel(tens.parser().parse_args(flags), 2, device="cpu")
    jp = jparser()
    jp.add_argument("--n_members", type=int, default=2)
    with pytest.raises(ValueError) as ref:
        jens.train_ensemble_parallel(jp.parse_args(flags), 2)
    assert str(port.value) == str(ref.value)
    assert "ensemble axis took 2" in str(port.value)
    members = _members()
    models = [port_nerf_flows(CFG, p, e) for p, e in members]
    with pytest.raises(ValueError, match="1 given for 2 members"):
        make_ensemble_train_step(models[:1], RenderConfig(n_samples=8), TrainConfig(**TRAIN_KW),
                                 M)

    # member 2 one checkpoint behind member 1: the lockstep trainer refuses
    tens.main(["train", *_flags(scene, "straggler", "--n_iters", "2", "--i_weights", "2"),
               "--parallel"], device="cpu")
    os.rename(_rundir(scene, "straggler") / "000002_02",
              _rundir(scene, "straggler") / "old_02")
    with pytest.raises(ValueError, match=r"resume at different steps \[2, 0\]"):
        tens.main(["train", *_flags(scene, "straggler"), "--parallel"], device="cpu")
