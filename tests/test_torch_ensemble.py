"""The port's ensemble CLI (cfnerf_torch/cli/ensemble.py) against the JAX
package's (cfnerf_tpu/cli/ensemble.py) on the same inputs: the member
flags, the gates read from a run's metrics.jsonl (tests/test_ensemble.py's
scenarios, run through both packages), the mixture eval of two members from
converted JAX checkpoints, and main's train / eval --members auto / usage
paths.  The port runs with device="cpu"."""
import importlib.util
import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest

from cfnerf_tpu.cli import ensemble as jens
from cfnerf_tpu.models import factory as jfactory
from cfnerf_tpu.train import checkpoint as jckpt
from cfnerf_tpu.utils.config import config_parser as jparser
from cfnerf_torch.cli import ensemble as tens
from tests.datagen import make_blender_dataset

ROOT = Path(__file__).resolve().parents[1]
STEP = 7
FLAGS = ["--expname", "e", "--dataname", "tiny", "--dataset_type", "blender",
         "--N_samples", "16", "--K_samples", "4", "--n_flows", "2", "--h_alpha_size", "8",
         "--h_rgb_size", "8", "--netdepth", "2", "--netwidth", "32",
         "--type_flows", "triangular", "--use_viewdirs", "--white_bkgd", "--no_ndc",
         "--testskip", "1", "--chunk", "64"]
# tests/test_torch_eval.py's rule: f32 sums in another order (JAX's unfused
# CPU path against the render core's plain version; XLA's and PyTorch's
# matmuls and convolutions)
METRIC_ATOL = 1e-4
METRICS = ("psnr", "ssim", "nll", "ause")


# ---------------------------------------------------------------------- #
# the member flags
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("seed,member", [(0, 1), (0, 3), (7, 2), (123, 10)])
def test_member_args_match(seed, member):
    args = SimpleNamespace(seed=seed, index_ensembles=1, expname="e")
    got, want = tens._member_args(args, member), jens._member_args(args, member)
    assert vars(got) == vars(want)
    assert got.seed == seed + 1000 * member and got.index_ensembles == member
    assert args.seed == seed and args.index_ensembles == 1  # a copy


# ---------------------------------------------------------------------- #
# the gates, on the same metrics.jsonl (tests/test_ensemble.py's scenarios)
# ---------------------------------------------------------------------- #


def _write(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _tagged(tmp):
    path = os.path.join(tmp, "metrics.jsonl")
    _write(path, [{"step": s, "train/psnr_m01": 30.0 + 0.01 * s, "train/psnr_m02": 26.0,
                   "train/psnr_m03": 30.5} for s in range(20)])
    return path


def _serial(tmp):
    path = os.path.join(tmp, "metrics.jsonl")
    recs = []
    for psnr in (29.0, 24.5, 30.2):  # three members in launch order
        recs += [{"step": s, "train/psnr": psnr + 0.001 * s} for s in range(0, 50, 10)]
    _write(path, recs)
    return path


def _partial(tmp):
    path = os.path.join(tmp, "metrics.jsonl")
    _write(path, [{"step": s, "train/psnr_m01": 30.0, "train/psnr_m02": 29.0}
                  for s in range(5)])
    return path


def _val_tags(tmp):
    path = os.path.join(tmp, "metrics.jsonl")
    _write(path, [{"step": s,
                   "train/psnr_m01": 30.0, "train/psnr_m02": 30.1, "train/psnr_m03": 29.9,
                   "val/psnr_m01": 28.0, "val/psnr_m02": 24.0, "val/psnr_m03": 28.2,
                   "val/nll_m01": -6.1, "val/nll_m02": -4.3, "val/nll_m03": -6.2}
                  for s in range(0, 100, 10)])
    return path


def _bare(tmp):
    path = os.path.join(tmp, "bare.jsonl")
    _write(path, [{"step": s, "train/psnr": 30.0} for s in range(5)])
    return path


def _run(tmp, expname, records):
    """A run's args whose metrics.jsonl holds `records`."""
    basedir = os.path.join(tmp, "logs")
    _write(os.path.join(basedir, "spheres", "summaries", expname, "metrics.jsonl"), records)
    return SimpleNamespace(basedir=basedir, dataname="spheres", expname=expname)


def _outlier_run(tmp):
    # member 2 trains ~4 dB below its peers
    return _run(tmp, "e", [{"step": s, "train/psnr_m01": 30.3, "train/psnr_m02": 26.4,
                            "train/psnr_m03": 30.1} for s in range(0, 100, 10)])


def _gate_run(tmp):
    # member 2 matches its peers on train PSNR but sits ~1.8 nat worse on
    # held-out NLL; member 3 sits 4 dB low on held-out PSNR
    return _run(tmp, "g", [{"step": s,
                            "train/psnr_m01": 33.4, "train/psnr_m02": 32.2,
                            "train/psnr_m03": 32.5,
                            "val/psnr_m01": 28.4, "val/psnr_m02": 28.0, "val/psnr_m03": 24.2,
                            "val/nll_m01": -6.13, "val/nll_m02": -4.34, "val/nll_m03": -6.16}
                           for s in range(0, 100, 10)])


# name -> (make the input in a directory, call a package's module on it)
GATE_CASES = {
    "tagged_train_psnrs": (_tagged, lambda mod, p: mod.member_train_psnrs(p, 3)),
    "serial_segments": (_serial, lambda mod, p: mod.member_train_psnrs(p, 3)),
    "serial_wrong_member_count": (_serial, lambda mod, p: mod.member_train_psnrs(p, 2)),
    "serial_window_3": (_serial, lambda mod, p: mod.member_train_psnrs(p, 3, window=3)),
    "partial_tagged_log": (_partial, lambda mod, p: mod.member_metric_medians(p, 3)),
    "val_nll_tags": (_val_tags, lambda mod, p: mod.member_metric_medians(p, 3, "val/nll")),
    "val_psnr_tags": (_val_tags, lambda mod, p: mod.member_metric_medians(p, 3, "val/psnr")),
    "no_val_stream": (_bare, lambda mod, p: mod.member_metric_medians(p, 1, "val/nll")),
    "no_train_records": (_bare, lambda mod, p: mod.member_metric_medians(p, 1, "train/mse")),
    "auto_drops_outlier": (_outlier_run, lambda mod, a: mod.auto_member_subset(a, 3)),
    "auto_permissive": (_outlier_run,
                        lambda mod, a: mod.auto_member_subset(a, 3, threshold_db=10.0)),
    "gate_train_psnr": (_gate_run, lambda mod, a: mod.auto_member_subset(a, 3)),
    "gate_val_nll": (_gate_run,
                     lambda mod, a: mod.auto_member_subset(a, 3, gate_metric="val_nll")),
    "gate_val_psnr": (_gate_run,
                      lambda mod, a: mod.auto_member_subset(a, 3, gate_metric="val_psnr")),
    "gate_val_nll_permissive": (_gate_run, lambda mod, a: mod.auto_member_subset(
        a, 3, gate_metric="val_nll", threshold_nat=10.0)),
    "gate_unknown_metric": (_gate_run,
                            lambda mod, a: mod.auto_member_subset(a, 3, gate_metric="train_nll")),
}
# tests/test_ensemble.py's expectations, where a case returns
EXPECTED = {"auto_drops_outlier": [1, 3], "auto_permissive": [1, 2, 3],
            "gate_train_psnr": [1, 2, 3], "gate_val_nll": [1, 3], "gate_val_psnr": [1, 2],
            "gate_val_nll_permissive": [1, 2, 3]}
RAISES = {"serial_wrong_member_count": "segment into 3", "partial_tagged_log": "partial",
          "no_val_stream": "train_psnr instead", "no_train_records": "no train/mse records",
          "gate_unknown_metric": "gate_metric"}


def _outcome(fn, mod, arg, capsys):
    try:
        result = ("returned", fn(mod, arg))
    except ValueError as e:
        result = ("raised", str(e))
    return result, capsys.readouterr().out


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gates_match_jax(case, tmp_path, capsys):
    make, fn = GATE_CASES[case]
    arg = make(str(tmp_path))
    got, got_out = _outcome(fn, tens, arg, capsys)
    want, want_out = _outcome(fn, jens, arg, capsys)
    assert got == want and got_out == want_out, (got, want, got_out, want_out)
    if case in RAISES:
        assert got[0] == "raised" and RAISES[case] in got[1]
    else:
        assert got[0] == "returned"
    if case in EXPECTED:
        assert got[1] == EXPECTED[case]


def test_gate_registry_matches_jax():
    assert tens.GATE_METRICS == jens.GATE_METRICS


# ---------------------------------------------------------------------- #
# the mixture eval of two members from converted JAX checkpoints
# ---------------------------------------------------------------------- #


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", ROOT / "scripts" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(package, datadir, basedir, *extra):
    p = (jparser() if package == "jax" else tens.parser())
    if package == "jax":
        p.add_argument("--n_members", type=int, default=2)
    return p.parse_args(FLAGS + ["--datadir", str(datadir), "--basedir", str(basedir), *extra])


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """A JAX run dir holding members 1 and 2 at STEP (each JAX's seeded init
    at seed + 1000*m, its base distribution moved off 0/1), and the port's
    run dir holding them converted."""
    tmp = tmp_path_factory.mktemp("ensemble")
    datadir = make_blender_dataset(str(tmp / "lego"), H=8, W=8, n_val=2)
    jargs = _args("jax", datadir, tmp / "jax")
    jrundir = jckpt.run_dir(jargs.basedir, jargs.dataname, jargs.type_flows, jargs.expname)
    convert = _converter().convert
    for m in (1, 2):
        margs = jens._member_args(jargs, m)
        _, _, _, params, start = jfactory.create_nerf(margs)
        assert start == 0
        params = jax.tree_util.tree_map(np.asarray, dict(params))
        rng = np.random.RandomState(10 + m)
        params["alpha_mean"] = (rng.randn(1) * 0.3).astype(np.float32)
        params["alpha_std"] = (0.5 + rng.rand(1)).astype(np.float32)
        params["rgb_mean"] = (rng.randn(3) * 0.3).astype(np.float32)
        params["rgb_std"] = (0.5 + rng.rand(3)).astype(np.float32)
        jpath = jckpt.save_checkpoint(jrundir, STEP, params, optax.adam(1e-3).init(params), m)
        path = convert(jpath, jens._member_args(_args("jax", datadir, tmp / "port"), m))
        assert os.path.basename(path) == f"{STEP:06d}_{m:02d}"
    return {"datadir": datadir, "jax": tmp / "jax", "port": tmp / "port"}


def _files(basedir, tag):
    return sorted(os.listdir(os.path.join(basedir, "tiny", "triangular", "e",
                                          f"{tag}_{STEP:06d}")))


@pytest.mark.parametrize("subset,extra,tag", [
    (None, [], "eval_ensemble2"),
    ([2], [], "eval_ensemble_m2"),
    (None, ["--render_factor", "2"], "eval_ensemble2"),
], ids=["all", "member_2", "render_factor"])
def test_eval_ensemble_matches_jax(members, subset, extra, tag):
    want = jens.eval_ensemble(_args("jax", members["datadir"], members["jax"], *extra), 2,
                              members=subset)
    jax_files = _files(members["jax"], tag)
    got = tens.eval_ensemble(_args("port", members["datadir"], members["port"], *extra), 2,
                             members=subset, device="cpu")
    assert got["members"] == want["members"] and got["n_members"] == want["n_members"]
    assert [v["view"] for v in got["views"]] == [v["view"] for v in want["views"]] == [3, 4]
    for g, w in zip(got["views"], want["views"]):
        for k in METRICS:
            assert np.isfinite(g[k]) and abs(g[k] - w[k]) <= METRIC_ATOL, (
                subset, extra, g["view"], k, g[k], w[k])
    for k in METRICS:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
    assert _files(members["port"], tag) == jax_files
    with open(os.path.join(members["port"], "tiny", "triangular", "e",
                           f"{tag}_{STEP:06d}", "metrics.json")) as f:
        assert json.load(f)["views"] == got["views"]


@pytest.mark.parametrize("n_members,subset,error", [
    (2, [3], ValueError), (2, [], ValueError), (3, None, FileNotFoundError),
], ids=["out_of_range", "empty", "member_without_checkpoint"])
def test_eval_ensemble_refuses_as_jax_does(members, n_members, subset, error):
    with pytest.raises(error) as port:
        tens.eval_ensemble(_args("port", members["datadir"], members["port"]), n_members,
                           members=subset, device="cpu")
    with pytest.raises(error) as ref:
        jens.eval_ensemble(_args("jax", members["datadir"], members["jax"]), n_members,
                           members=subset)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------- #
# main: serial training, --members auto, usage
# ---------------------------------------------------------------------- #

TINY = ["--expname", "ens", "--dataname", "tiny", "--dataset_type", "blender",
        "--N_rand", "16", "--N_samples", "8", "--K_samples", "4", "--n_flows", "2",
        "--h_alpha_size", "8", "--h_rgb_size", "8", "--netdepth", "2", "--netwidth", "16",
        "--type_flows", "triangular", "--use_viewdirs", "--white_bkgd", "--no_ndc",
        "--testskip", "1", "--n_iters", "4", "--i_print", "2", "--i_weights", "4",
        "--i_img", "0", "--chunk", "64", "--n_members", "2"]


def test_main_trains_members_then_evaluates_the_auto_subset(tmp_path, capsys):
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=1)
    flags = TINY + ["--datadir", datadir, "--basedir", str(tmp_path / "logs")]
    tens.main(["train", *flags, "--is_train"], device="cpu")
    rundir = tmp_path / "logs" / "tiny" / "triangular" / "ens"
    assert {"000004_01", "000004_02"} <= set(os.listdir(rundir))
    with open(tmp_path / "logs" / "tiny" / "summaries" / "ens" / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [2, 4, 2, 4]  # two serial runs, appended
    capsys.readouterr()

    summary = tens.main(["eval", *flags, "--members", "auto"], device="cpu")
    out = capsys.readouterr().out
    assert "--members auto: train/psnr medians m01=" in out
    assert summary["members"] in ([1, 2], [1], [2])
    assert all(np.isfinite(summary[k]) for k in METRICS)
    tag = ("eval_ensemble2" if summary["members"] == [1, 2]
           else f"eval_ensemble_m{summary['members'][0]}")
    view = summary["views"][0]["view"]
    assert len(summary["views"]) == 1 and sorted(os.listdir(rundir / f"{tag}_000004")) == [
        f"{view:03d}_pred.png", f"{view:03d}_std.png", "metrics.json"]
    assert json.loads(out.strip().splitlines()[-1])["members"] == summary["members"]


@pytest.mark.parametrize("argv", [[], ["serve"], ["--n_members", "2"]])
def test_main_without_a_subcommand_prints_the_usage(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tens.main(argv, device="cpu")
    assert e.value.code == 2
    assert capsys.readouterr().out.startswith("usage: python -m cfnerf_torch.cli.ensemble")
