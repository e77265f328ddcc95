"""The port's checkpoints and resume against cfnerf_tpu's semantics: the run
dir layout and names, the save/restore round trip (test-mode eps buffers
included), the filtered merge under width drift, which checkpoint resume
picks (latest, --index_step, --ft_path, the ensemble member), create_nerf's
resume with the lr schedule continuing, and a JAX Orbax checkpoint carried
into the port by scripts/jax_checkpoint_to_torch.py: its test-mode render
and one step after resume against JAX's, at the golden gates."""
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfnerf_tpu.models import factory as jfactory
from cfnerf_tpu.render import renderer as jrender
from cfnerf_tpu.train import checkpoint as jckpt
from cfnerf_tpu.train import step as jstep
from cfnerf_tpu.utils.config import parse_args as jparse
from cfnerf_torch.models.factory import build_model, create_nerf
from cfnerf_torch.render.renderer import RenderConfig, make_render_rays, render_image
from cfnerf_torch.train import checkpoint as tckpt
from cfnerf_torch.train.step import TrainConfig, make_train_step
from cfnerf_torch.utils.config import parse_args as tparse
from tests.test_torch_common import to_np
from tests.test_torch_train import (
    _grads_in_opt_state,
    _port_names,
    assert_params_after_update_close,
    jax_draws,
    make_batch,
    port_z_vals,
)

ROOT = Path(__file__).resolve().parents[1]
# a tiny flagship: D2/W32, K4, two triangular flows
FLAGS = ["--netdepth", "2", "--netwidth", "32", "--K_samples", "4", "--n_flows", "2",
         "--h_alpha_size", "16", "--h_rgb_size", "16", "--type_flows", "triangular",
         "--use_viewdirs", "--N_samples", "16", "--dataname", "scene", "--expname", "exp"]
# the loss of configs/africa_ds.txt + scripts/train_NF.sh on a small view
STEP_KW = dict(H=10, W=10, focal=10.0, ndc=False, near=2.0, far=6.0, k_samples=4,
               lrate=5e-4, lrate_decay=250, beta1=0.01, colmap_depth=True,
               depth_lambda=0.01)
VIEW = dict(H=8, W=8, focal=10.0, ndc=False, use_viewdirs=True, near=2.0, far=6.0)
# the golden gate of the port against JAX (chip_smoke.py's E2E rule)
E2E_RTOL = E2E_ATOL = 1e-4


def _args(parse, basedir, *extra):
    return parse(FLAGS + ["--basedir", str(basedir)] + list(extra))


def _state(*nets):
    return {name: {k: v.detach().clone() for k, v in net.state_dict().items()}
            for name, net in zip(("coarse", "fine"), nets) if net is not None}


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            torch.testing.assert_close(got[name][k], want[name][k], rtol=0, atol=0,
                                       msg=f"{name}/{k}")


def _perturb(*nets, seed=0):
    """Move every entry, the test-mode eps buffers too, off its init."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in filter(None, nets):
            for t in net.state_dict().values():
                t.add_(torch.randn(t.shape, generator=g) * 0.1)


def _c2w():
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 3] = [0.3, -0.2, 4.0]
    return c2w


# ---------------------------------------------------------------------- #
# layout and resume choice
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("step,ensemble", [(0, 1), (10000, 1), (50000, 2), (1234567, 3)])
def test_layout_matches_jax(step, ensemble):
    assert tckpt.run_dir("./logs", "africa", "triangular", "e") == \
        jckpt.run_dir("./logs", "africa", "triangular", "e") == "./logs/africa/triangular/e"
    assert tckpt.checkpoint_path("/x", step, ensemble) == \
        jckpt.checkpoint_path("/x", step, ensemble)


def _tree_dirs(rundir, names):
    for name in names:
        os.makedirs(os.path.join(rundir, name))


@pytest.mark.parametrize("kw", [
    {}, {"index_step": 200}, {"index_step": 999}, {"ensemble": 2},
    {"ensemble": 2, "index_step": 100}, {"ensemble": 3}, {"ft_path": "/some/explicit"},
    {"ft_path": "None"}, {"index_step": 1234567},
], ids=["latest", "index", "missing_index", "ensemble", "ensemble_index", "no_member",
        "ft_path", "ft_path_None", "seven_digits"])
def test_find_resume_checkpoint_matches_jax(kw, tmp_path):
    rundir = str(tmp_path / "run")
    _tree_dirs(rundir, ["000100_01", "000200_01", "000300_01", "000100_02", "1234567_01",
                        "args.txt.d", "00010_01"])
    got = tckpt.find_resume_checkpoint(rundir, **kw)
    assert got == jckpt.find_resume_checkpoint(rundir, **kw)
    assert tckpt.list_checkpoints(rundir) == jckpt.list_checkpoints(rundir)
    assert tckpt.find_resume_checkpoint(str(tmp_path / "empty"), **kw) == \
        jckpt.find_resume_checkpoint(str(tmp_path / "empty"), **kw)


def test_latest_resume_reaches_seven_digit_steps(tmp_path):
    rundir = str(tmp_path / "run")
    _tree_dirs(rundir, ["999999_01", "1000000_01"])
    assert tckpt.find_resume_checkpoint(rundir).endswith("1000000_01")


# ---------------------------------------------------------------------- #
# save / restore
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hierarchical"])
def test_save_restore_round_trip(hier, tmp_path):
    extra = ["--N_importance", "8", "--netdepth_fine", "2", "--netwidth_fine", "32"] if hier \
        else []
    args = _args(tparse, tmp_path, *extra)
    model, fine, _ = build_model(args, device="cpu")
    _perturb(model, fine)
    opt = torch.optim.Adam([p for n in (model, fine) if n is not None for p in n.parameters()])
    for p in opt.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    opt.step()
    want = _state(model, fine)
    path = tckpt.save_checkpoint(str(tmp_path / "run"), 10, want, opt.state_dict())
    assert path.endswith("000010_01")
    raw = torch.load(os.path.join(path, tckpt.STATE_FILE), weights_only=True)
    assert type(raw["global_step"]) is int and raw["global_step"] == 10
    assert raw["opt_state"]["state"], "the optimizer state is saved"

    fresh_model, fresh_fine, _ = build_model(args, device="cpu")
    params, step = tckpt.restore_checkpoint(path, _state(fresh_model, fresh_fine))
    assert step == 10 and type(step) is int
    _assert_state_equal(params, want)
    assert "test_eps_a" in params["coarse"] and not torch.equal(
        params["coarse"]["test_eps_a"], fresh_model.test_eps_a)


def test_filtered_merge_tolerates_width_drift(tmp_path):
    """A W32 checkpoint into a W64 model: entries of another shape and
    entries the checkpoint lacks (a fine net) keep their fresh init, entries
    the model lacks are dropped, the rest load (cast to the fresh dtype)."""
    model, _, _ = build_model(_args(tparse, tmp_path), device="cpu")
    _perturb(model)
    saved = _state(model)
    saved["coarse"]["bogus"] = torch.ones(3)
    saved["coarse"]["alpha_mean"] = saved["coarse"]["alpha_mean"].double()
    path = tckpt.save_checkpoint(str(tmp_path / "run"), 5, saved)

    wide_args = _args(tparse, tmp_path, "--netwidth", "64", "--N_importance", "8",
                      "--netdepth_fine", "2", "--netwidth_fine", "32")
    wide, wide_fine, _ = build_model(wide_args, device="cpu")
    fresh = _state(wide, wide_fine)
    params, step = tckpt.restore_checkpoint(path, fresh)
    assert step == 5 and set(params) == {"coarse", "fine"}
    assert "bogus" not in params["coarse"]
    _assert_state_equal({"fine": params["fine"]}, {"fine": fresh["fine"]})
    n_loaded = 0
    for k, v in params["coarse"].items():
        same_shape = saved["coarse"][k].shape == fresh["coarse"][k].shape
        want = saved["coarse"][k].float() if same_shape else fresh["coarse"][k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
        assert v.dtype == fresh["coarse"][k].dtype
        n_loaded += same_shape
    assert 0 < n_loaded < len(params["coarse"])
    assert torch.equal(params["coarse"]["test_eps_r"], saved["coarse"]["test_eps_r"])


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hierarchical"])
def test_create_nerf_resumes(hier, tmp_path, capsys):
    extra = ["--N_importance", "8", "--netdepth_fine", "2", "--netwidth_fine", "32"] if hier \
        else []
    args = _args(tparse, tmp_path / "logs", *extra)
    model, fine, rc, start = create_nerf(args, device="cpu")
    assert start == 0 and capsys.readouterr().out.strip() == "No reloading"
    assert (fine is not None) == hier and rc.n_importance == (8 if hier else 0)
    fresh = _state(model, fine)

    rundir = tckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    assert rundir == str(tmp_path / "logs" / "scene" / "triangular" / "exp")
    _perturb(model, fine, seed=1)
    tckpt.save_checkpoint(rundir, 5, _state(model, fine))
    _perturb(model, fine, seed=2)
    trained = _state(model, fine)
    path = tckpt.save_checkpoint(rundir, 10, trained)

    model2, fine2, _, start = create_nerf(args, device="cpu")
    assert capsys.readouterr().out.strip() == f"Reloading from {path}"
    assert start == 10
    _assert_state_equal(_state(model2, fine2), trained)
    # the resumed schedule: lrate * 0.1^(start / (lrate_decay * 1000))
    _, opt = make_train_step(model2, rc, TrainConfig(**STEP_KW, start_step=start),
                             model_fine=fine2)
    assert opt.param_groups[0]["lr"] == pytest.approx(5e-4 * 0.1 ** (10 / 250000), rel=1e-12)

    model3, fine3, _, start = create_nerf(
        _args(tparse, tmp_path / "logs", *extra, "--index_step", "5"), device="cpu")
    assert start == 5 and capsys.readouterr().out.startswith("Reloading from")
    model4, fine4, _, start = create_nerf(
        _args(tparse, tmp_path / "logs", *extra, "--no_reload"), device="cpu")
    assert start == 0 and capsys.readouterr().out.strip() == "No reloading"
    _assert_state_equal(_state(model4, fine4), fresh)
    _, _, _, start = create_nerf(
        _args(tparse, tmp_path / "logs", *extra, "--index_ensembles", "2"), device="cpu")
    assert start == 0 and capsys.readouterr().out.strip() == "No reloading"


def test_restore_names_a_jax_checkpoint(tmp_path):
    os.makedirs(tmp_path / "000003_01")
    with pytest.raises(FileNotFoundError, match="jax_checkpoint_to_torch"):
        tckpt.restore_checkpoint(str(tmp_path / "000003_01"), {})


# ---------------------------------------------------------------------- #
# a JAX checkpoint carried into the port
# ---------------------------------------------------------------------- #


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", ROOT / "scripts" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_checkpoint_converts_and_resumes_in_the_port(tmp_path, capsys):
    jargs = _args(jparse, tmp_path / "jax_logs")
    jm, _, jrc, params, start = jfactory.create_nerf(jargs)
    assert start == 0
    cfg = jstep.TrainConfig(**STEP_KW)
    step, tx = jstep.make_train_step(jm, jrc, cfg)
    opt_state = tx.init(params)
    for i in range(3):
        params, opt_state, _ = step(params, opt_state, make_batch(24, 8, seed=10 + i),
                                    jax.random.PRNGKey(100 + i))
    jrundir = jckpt.run_dir(jargs.basedir, jargs.dataname, jargs.type_flows, jargs.expname)
    jpath = jckpt.save_checkpoint(jrundir, 3, params, opt_state)

    assert _converter().main(["--jax_ckpt", jpath] + FLAGS
                             + ["--basedir", str(tmp_path / "port_logs")]) == 0
    targs = _args(tparse, tmp_path / "port_logs")
    model, _, rc, start = create_nerf(targs, device="cpu")
    out = capsys.readouterr().out
    assert start == 3 and f"Reloading from {tmp_path / 'port_logs'}" in out
    jm, _, jrc, jparams, jstart = jfactory.create_nerf(jargs)  # JAX's own resume
    assert jstart == 3

    # the test-mode render: the trained weights and JAX's fixed eps
    def apply(p, x, *, is_test, rng):
        return jm.apply({"params": p}, x, is_test=is_test, rng=rng)

    jout = jrender.render_image(
        jrender.make_render_rays(apply, jrender.RenderConfig(
            n_samples=16, perturb=False, use_viewdirs=True)),
        jparams, jnp.asarray(_c2w()), tile=64, **VIEW)
    tout = render_image(make_render_rays(model, RenderConfig(
        n_samples=16, perturb=False, use_viewdirs=True)), _c2w(), tile=64, device="cpu",
        **VIEW)
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(to_np(tout[k]), np.asarray(jout[k]), rtol=E2E_RTOL,
                                   atol=E2E_ATOL, err_msg=k)

    # one step after resume, JAX's and the port's, from the same batch and draws
    batch, key = make_batch(24, 8, seed=20), jax.random.PRNGKey(7)
    with _grads_in_opt_state():
        jstep_fn, jtx = jstep.make_train_step(jm, jrc, jstep.TrainConfig(**STEP_KW,
                                                                          start_step=jstart))
    jafter, jstate, jmetrics = jstep_fn(jparams, jtx.init(jparams), batch, key)
    jgrads, jafter = _port_names(jstate[0]), _port_names(jafter)
    t_rand, eps = jax_draws(key, 32, 16, 4)
    tstep, opt = make_train_step(model, rc, TrainConfig(**STEP_KW, start_step=start))
    lr = opt.param_groups[0]["lr"]
    assert lr == pytest.approx(5e-4 * 0.1 ** (3 / 250000), rel=1e-12)
    loss, tmetrics = tstep.loss_fn(batch, None, z_vals=port_z_vals(t_rand, 16), eps=eps)
    loss.backward()
    tstep.update()
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(jmetrics[k]),
                                   rtol=E2E_RTOL, atol=E2E_ATOL, err_msg=k)
    assert_params_after_update_close(model, jafter, jgrads, lr)
