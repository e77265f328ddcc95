"""The port's several-device paths (cfnerf_torch/parallel/mesh.py and the
mesh branches of the step, the renderer and the ensemble) on the CPU: gloo
ranks in spawned processes, launched twice for the whole file (module
fixtures), each launch with a deadline and a file store of its own.

  * dryrun_multichip(4), the counterpart of JAX's: each of its checks (the
    data-parallel, hierarchical, n_inner, fused, occ and tensor-parallel
    steps, the mesh renders, the --k_schedule trajectory with a checkpoint,
    the ensemble step) against the same work on one device, at
    tests/test_sharding.py's tolerances;
  * create_mesh's and create_ensemble_mesh's shapes against JAX's;
  * the 4-rank data-parallel step against JAX's make_train_step over
    create_mesh(4), JAX's draws fed through the seams as
    tests/test_torch_train.py feeds them, at that file's tolerances;
  * the leaves shard_params_tp splits, flat and hierarchical, against the
    leaves JAX's shard_params_tp puts on the model axis (through
    cfnerf_torch/convert.py's names), and its refusal of the trunk kernels;
  * each member's step on the (2, 2) and (1, 4) ensemble meshes against its
    serial step, and a nerf_dropout member set's on the (2, 2) mesh (its
    masks drawn at the whole batch's shape, cut to each rank's rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship as jax_flagship
from cfnerf_tpu.parallel import ensemble as jens
from cfnerf_tpu.parallel import mesh as jmesh
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import step as jstep
from cfnerf_torch.convert import (
    nerf_flows_pair_state_dicts_from_jax,
    nerf_flows_state_dict_from_jax,
)
from cfnerf_torch.entry import DRYRUN_CHECKS, dryrun_multichip
from cfnerf_torch.parallel import mesh as tmesh
from tests.test_torch_common import jax_nerf_flows
from tests.test_torch_train import (
    ADAM_ATOL,
    ADAM_G_MIN,
    CFG,
    LOSS_RTOL,
    TRAIN_KW,
    _grads_in_opt_state,
    _port_names,
    assert_grads_close,
    jax_draws,
    make_batch,
    port_z_vals,
)
from tests.torch_mesh_ranks import checks

# each launch's deadline (the whole file takes ~60 s under xdist)
LAUNCH_S = 300
N_SAMPLES = 16
STEP_TOL = dict(rtol=2e-5, atol=2e-6)  # tests/test_sharding.py:74-78


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    return dryrun_multichip(4, timeout=LAUNCH_S, init_dir=str(tmp_path_factory.mktemp("pg")))


@pytest.mark.parametrize("check", DRYRUN_CHECKS)
def test_dryrun_multichip(dryrun, check):
    assert check in dryrun and dryrun[check] == "", dryrun.get(check)


def _jax_mesh_step():
    """JAX's step over create_mesh(4) (8 virtual CPU devices, conftest.py)
    with its gradients kept, and what the port's ranks need to take it."""
    jm, params, test_eps = jax_nerf_flows(CFG)
    batch = make_batch(32, 16, seed=3)
    key = jax.random.PRNGKey(5)
    t_rand, eps = jax_draws(key, 32 + 16, N_SAMPLES, CFG.k)
    mesh = jmesh.create_mesh(4)
    rc = jrender.RenderConfig(n_samples=N_SAMPLES, perturb=True, use_viewdirs=True, fused="off")
    with _grads_in_opt_state():
        step, tx = jstep.make_train_step(jm, rc, jstep.TrainConfig(**TRAIN_KW), mesh=mesh)
    p = jmesh.replicate(mesh, jax.tree_util.tree_map(jnp.asarray, params))
    new_params, state, metrics = step(p, tx.init(p), jmesh.shard_batch(mesh, batch), key)
    ref = ({k: float(v) for k, v in metrics.items()}, _port_names(state[0]),
           _port_names(new_params))
    model_kw = dict(net_depth=CFG.depth, net_width=CFG.width, input_ch=63,
                    input_ch_views=CFG.views_ch, skips=(CFG.depth // 2,),
                    h_alpha_size=CFG.h_alpha, h_rgb_size=CFG.h_rgb, n_flows=CFG.flows,
                    k_samples=CFG.k)
    jax_in = dict(model_kw=model_kw, params=params, test_eps=test_eps, batch=batch,
                  n_samples=N_SAMPLES, train_kw=dict(TRAIN_KW),
                  z_vals=port_z_vals(t_rand, N_SAMPLES).numpy(), eps=eps)
    return jax_in, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jax_in, jax_ref = _jax_mesh_step()
    rng = np.random.RandomState(9)
    ens_batch = dict(rays_o=rng.randn(16, 3).astype(np.float32),
                     rays_d=np.concatenate([rng.randn(16, 2) * 0.05, -np.ones((16, 1))],
                                           -1).astype(np.float32),
                     target=rng.rand(16, 3).astype(np.float32))
    out = tmesh.launch(checks, 4, jax_in, ens_batch, device="cpu", timeout=LAUNCH_S,
                       init_dir=str(tmp_path_factory.mktemp("pg")))[0]
    out["jax_ref"] = jax_ref
    return out


def test_create_mesh_refuses_an_uneven_model_axis():
    with pytest.raises(ValueError, match="4 devices not divisible by model_parallel=3"):
        tmesh.create_mesh(4, model_parallel=3)
    with pytest.raises(ValueError) as ref:
        jmesh.create_mesh(4, model_parallel=3)
    with pytest.raises(ValueError) as port:
        tmesh.check_mesh_size(4, 3)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("name,jax_shape", [
    ("default", lambda: jmesh.create_mesh(4).shape),
    ("four", lambda: jmesh.create_mesh(4).shape),
    ("model_parallel_2", lambda: jmesh.create_mesh(4, model_parallel=2).shape),
    ("ensemble_2", lambda: jens.create_ensemble_mesh(2, 4).shape),
    ("ensemble_3", lambda: jens.create_ensemble_mesh(3, 4).shape),
    ("ensemble_4", lambda: jens.create_ensemble_mesh(4, 4).shape),
])
def test_mesh_shapes_match_jax(ranks, name, jax_shape):
    assert dict(ranks["shapes"][name]) == dict(jax_shape())


@pytest.mark.parametrize("part", ["metrics", "grads", "params"])
def test_dp_step_matches_jax_mesh_step(ranks, part):
    (m, g, p), (jm, jg, jp) = ranks["jax_dp"], ranks["jax_ref"]
    if part == "metrics":
        for k in ("loss", "loss_nll", "loss_entropy", "depth_loss", "mse", "psnr"):
            np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    elif part == "grads":
        assert_grads_close(g, jg)
    else:
        # test_torch_train's rule: where |g| >= ADAM_G_MIN the first Adam
        # step agrees to ADAM_ATOL; elsewhere it moves a weight by <= lr
        for k in jp:
            diff = np.abs(p[k] - jp[k])
            assert np.all(diff[np.abs(jg[k]) >= ADAM_G_MIN] <= ADAM_ATOL), k
            assert np.all(diff <= 2 * TRAIN_KW["lrate"] + ADAM_ATOL), k


def _jax_tp_leaves(hierarchical):
    """The port's names of the leaves JAX's shard_params_tp puts on the
    model axis: a tree of ones where it does, zeros elsewhere, mapped
    through convert.py."""
    model, _ = jax_flagship(k_samples=4, n_samples=16, depth=2, width=32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 90)), is_test=True)["params"]
    tree = {"coarse": params, "fine": params} if hierarchical else params
    placed = jmesh.shard_params_tp(jmesh.create_mesh(4, model_parallel=2), tree)
    marks = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float("model" in str(x.sharding.spec)), np.float32), placed)
    if hierarchical:
        dicts = nerf_flows_pair_state_dicts_from_jax(marks)
    else:
        dicts = (nerf_flows_state_dict_from_jax(marks),)
    return [sorted(k for k, v in d.items() if bool(torch.all(v == 1))) for d in dicts]


@pytest.mark.parametrize("tree", ["flat", "hierarchical"])
def test_tp_splits_the_leaves_jax_splits(ranks, tree):
    got = ranks["tp_leaves"]
    want = _jax_tp_leaves(tree == "hierarchical")
    if tree == "flat":
        assert got["flat"] == want[0]
    else:
        assert [got["coarse"], got["fine"]] == want
    assert any("pts_linears" in k for k in got["flat"])


def test_tp_refuses_the_trunk_kernels(ranks):
    assert "trunk_impl='pallas'" in ranks["tp_leaves"]["pallas_refused"]
    with pytest.raises(ValueError, match="takes packed whole widths"):
        tmesh.check_tensor_parallel(2, "interpret")
    tmesh.check_tensor_parallel(1, "pallas")


@pytest.mark.parametrize("members,shape", [(2, {"ensemble": 2, "data": 2}),
                                           (3, {"ensemble": 1, "data": 4}),
                                           ("nerf_dropout", {"ensemble": 2, "data": 2})])
def test_ensemble_members_match_their_serial_steps(ranks, members, shape):
    """`members`: the count of tiny NeRFFlows members, or two nerf_dropout
    ones."""
    run = ranks["ensemble"][members]
    assert dict(run["shape"]) == shape
    assert sorted(run["mesh"]) == sorted(run["serial"]) == list(range(run["n"]))
    for m, (metrics, params) in run["serial"].items():
        got_metrics, got_params = run["mesh"][m]
        for k in metrics:
            np.testing.assert_allclose(got_metrics[k], metrics[k], rtol=1e-5, err_msg=k)
        for a, b in zip(got_params, params):
            np.testing.assert_allclose(a, b, **STEP_TOL)
