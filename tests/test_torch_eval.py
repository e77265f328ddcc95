"""The slice as a whole: a JAX checkpoint (JAX's seeded init, saved by
cfnerf_tpu's save_checkpoint) converted by
scripts/jax_checkpoint_to_torch.py, then JAX's cli.eval.evaluate against
the port's evaluate(device="cpu") on the same two held-out views: the
per-view PSNR, SSIM, NLL and AUSE and the files written, plain, with
--N_importance_eval and with --render_factor 2."""
import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import optax
import pytest

from cfnerf_tpu.cli.eval import evaluate as jax_evaluate
from cfnerf_tpu.models import factory as jfactory
from cfnerf_tpu.train import checkpoint as jckpt
from cfnerf_tpu.utils.config import parse_args as jparse
from cfnerf_torch.cli.eval import evaluate, main
from cfnerf_torch.utils.config import parse_args as tparse
from tests.datagen import make_blender_dataset

ROOT = Path(__file__).resolve().parents[1]
STEP = 7
FLAGS = ["--expname", "e", "--dataname", "tiny", "--dataset_type", "blender",
         "--N_samples", "16", "--K_samples", "4", "--n_flows", "2", "--h_alpha_size", "8",
         "--h_rgb_size", "8", "--netdepth", "2", "--netwidth", "32",
         "--type_flows", "triangular", "--use_viewdirs", "--white_bkgd", "--no_ndc",
         "--testskip", "1", "--chunk", "64"]
# f32 sums run in another order (JAX's unfused CPU path, the port's render
# core plain version; XLA's and PyTorch's matmuls and convolutions); the
# test eps are JAX's _test_eps, carried by the converter
METRIC_ATOL = 1e-4
METRICS = ("psnr", "ssim", "nll", "ause", "mse")


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", ROOT / "scripts" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(datadir, basedir, *extra):
    return FLAGS + ["--datadir", str(datadir), "--basedir", str(basedir), *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A JAX run dir holding one checkpoint at STEP (the seeded init, its base
    distribution moved off 0/1), and the port's run dir holding it
    converted."""
    tmp = tmp_path_factory.mktemp("eval")
    datadir = make_blender_dataset(str(tmp / "lego"), H=8, W=8, n_val=2)
    jargs = jparse(_flags(datadir, tmp / "jax"))
    _, _, _, params, start = jfactory.create_nerf(jargs)
    assert start == 0
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    rng = np.random.RandomState(11)
    params["alpha_mean"] = (rng.randn(1) * 0.3).astype(np.float32)
    params["alpha_std"] = (0.5 + rng.rand(1)).astype(np.float32)
    params["rgb_mean"] = (rng.randn(3) * 0.3).astype(np.float32)
    params["rgb_std"] = (0.5 + rng.rand(3)).astype(np.float32)
    jrundir = jckpt.run_dir(jargs.basedir, jargs.dataname, jargs.type_flows, jargs.expname)
    jpath = jckpt.save_checkpoint(jrundir, STEP, params, optax.adam(1e-3).init(params))
    path = _converter().convert(jpath, jparse(_flags(datadir, tmp / "port")))
    assert os.path.basename(path) == f"{STEP:06d}_01"
    return {"datadir": datadir, "jax": tmp / "jax", "port": tmp / "port"}


def _outdir(basedir):
    return os.path.join(basedir, "tiny", "triangular", "e", f"eval_{STEP:06d}")


@pytest.mark.parametrize("extra", [[], ["--N_importance_eval", "8"], ["--render_factor", "2"]],
                         ids=["plain", "N_importance_eval", "render_factor"])
def test_evaluate_matches_jax(run, extra):
    want = jax_evaluate(jparse(_flags(run["datadir"], run["jax"], *extra)))
    jax_files = sorted(os.listdir(_outdir(run["jax"])))
    got = evaluate(tparse(_flags(run["datadir"], run["port"], *extra)), device="cpu")
    assert got["step"] == want["step"] == STEP
    assert [v["view"] for v in got["views"]] == [v["view"] for v in want["views"]] == [3, 4]
    for g, w in zip(got["views"], want["views"]):
        for k in METRICS:
            assert np.isfinite(g[k]) and abs(g[k] - w[k]) <= METRIC_ATOL, (extra, g["view"], k,
                                                                           g[k], w[k])
    for k in ("psnr", "ssim", "nll", "ause"):
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (extra, k, got[k], want[k])
    assert sorted(os.listdir(_outdir(run["port"]))) == jax_files
    with open(os.path.join(_outdir(run["port"]), "metrics.json")) as f:
        saved = json.load(f)
    assert saved["views"] == got["views"] and saved["psnr"] == got["psnr"]


def test_cli_main_prints_the_summary_last(run, capsys):
    main(_flags(run["datadir"], run["port"]), device="cpu")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"step", "psnr", "ssim", "nll", "ause"} and last["step"] == STEP
