"""The port's CLIs over several ranks on the CPU (gloo): a tiny Blender
scene (D2/W16, N8, K4, 4 steps) through cli.train, cli.eval and
cli.ensemble with --mesh_devices 2 against the same runs on one device, and
the mesh flags' refusals, which come before any rank is launched.  Every
launch has a deadline (parallel/mesh.py:DEFAULT_TIMEOUT_S, set here)."""
import json
import os

import numpy as np
import pytest
import torch

from cfnerf_tpu.train import loop as jloop
from cfnerf_tpu.utils.config import parse_args as jparse
from cfnerf_torch.cli import ensemble as tens
from cfnerf_torch.cli import eval as teval
from cfnerf_torch.cli import train as ttrain
from cfnerf_torch.parallel import mesh as tmesh
from cfnerf_torch.train import checkpoint as tckpt
from tests.datagen import make_blender_dataset

LAUNCH_S = 240
CKPT_RTOL = 2e-5  # tests/test_sharding.py's parameter tolerance
EVAL_TOL = 1e-4
TINY = ["--expname", "e", "--dataname", "tiny", "--dataset_type", "blender",
        "--N_rand", "32", "--N_samples", "8", "--K_samples", "4", "--n_flows", "2",
        "--h_alpha_size", "8", "--h_rgb_size", "8", "--netdepth", "2", "--netwidth", "16",
        "--type_flows", "triangular", "--use_viewdirs", "--white_bkgd", "--no_ndc",
        "--testskip", "1", "--chunk", "64"]
# every cadence fires in 4 steps: print at 2 and 4, an image panel at 3, the
# checkpoint, the test set and the spiral video at 4
CADENCES = ["--n_iters", "4", "--i_print", "2", "--i_weights", "4", "--i_img", "3",
            "--i_testset", "4", "--i_video", "4"]


@pytest.fixture(scope="module", autouse=True)
def deadline():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmesh, "DEFAULT_TIMEOUT_S", LAUNCH_S)
        yield


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    return tmp, make_blender_dataset(str(tmp / "lego"), H=8, W=8, n_val=1)


def _flags(scene, basedir, *extra):
    tmp, datadir = scene
    return TINY + ["--datadir", datadir, "--basedir", str(tmp / basedir), *extra]


def _files(root):
    """(the relative paths of the files under root but tensorboard's event
    files, whose names hold the pid; the number of event files)."""
    paths, events = set(), 0
    for d, _, names in os.walk(root):
        for n in names:
            if "tfevents" in n:
                events += 1
            else:
                paths.add(os.path.relpath(os.path.join(d, n), root))
    return paths, events


def _state(path):
    return torch.load(os.path.join(path, tckpt.STATE_FILE), map_location="cpu",
                      weights_only=True)


def _assert_close(a, b, where, rtol):
    """Tensors of two state trees within rtol of each tensor's largest
    magnitude."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_close(a[k], b[k], f"{where}/{k}", rtol)
    elif isinstance(a, torch.Tensor):
        scale = float(b.abs().max()) if b.numel() else 0.0
        assert float((a - b).abs().max() if a.numel() else 0.0) <= rtol * max(scale, 1e-30), where
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def runs(scene):
    """cli.train on one device and on 2 ranks, from the same flags."""
    for n in ("1", "2"):
        ttrain.main(_flags(scene, f"n{n}", *CADENCES, "--mesh_devices", n, "--is_train"),
                    device="cpu")
    return {n: scene[0] / f"n{n}" for n in ("1", "2")}


def test_train_two_ranks_gives_the_one_rank_checkpoint(runs):
    path = os.path.join("tiny", "triangular", "e", "000004_01")
    one, two = _state(runs["1"] / path), _state(runs["2"] / path)
    _assert_close(two["params"], one["params"], "params", CKPT_RTOL)
    assert two["global_step"] == one["global_step"] == 4


def test_train_rank_zero_alone_writes(runs):
    # the same files, one of each (a second writer would double the
    # metrics stream and the event files)
    (paths_2, events_2), (paths_1, events_1) = _files(runs["2"]), _files(runs["1"])
    assert paths_2 == paths_1
    assert events_2 == events_1 <= 1
    records = {n: [json.loads(line) for line in open(
        runs[n] / "tiny" / "summaries" / "e" / "metrics.jsonl")] for n in runs}
    assert [r["step"] for r in records["2"]] == [r["step"] for r in records["1"]] == [2, 4]
    for a, b in zip(records["2"], records["1"]):
        for k in ("train/loss", "train/psnr", "val/psnr", "val/nll"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


def test_eval_two_ranks_gives_the_one_rank_metrics(runs, scene):
    summaries = {n: teval.main(_flags(scene, "n1", "--mesh_devices", n), device="cpu")
                 for n in ("1", "2")}
    for k in ("psnr", "ssim", "nll", "ause"):
        np.testing.assert_allclose(summaries["2"][k], summaries["1"][k], rtol=EVAL_TOL,
                                   atol=EVAL_TOL, err_msg=k)
    assert summaries["2"]["step"] == summaries["1"]["step"] == 4


def test_n_rand_not_divisible_raises_jax_message(scene, tmp_path):
    flags = _flags(scene, "odd", "--N_rand", "31", "--mesh_devices", "2", "--is_train")
    with pytest.raises(ValueError) as port:
        ttrain.main(flags, device="cpu")
    with pytest.raises(ValueError) as ref:
        jloop.train(jparse(flags))
    assert str(port.value) == str(ref.value)
    assert "must be divisible by the mesh data axis (2)" in str(port.value)


def test_tensor_parallel_refuses_the_trunk_kernels(scene):
    flags = _flags(scene, "tp", "--netdepth", "4", "--netwidth", "64", "--mesh_devices", "2",
                   "--model_parallel", "2", "--trunk_impl", "pallas", "--is_train")
    with pytest.raises(ValueError, match="takes packed whole widths"):
        ttrain.main(flags, device="cpu")


def test_ensemble_parallel_two_ranks_gives_the_serial_checkpoints(scene):
    ens = ["--n_members", "2", "--n_iters", "4", "--i_print", "2", "--i_weights", "4",
           "--i_img", "0", "--i_testset", "0", "--i_video", "0", "--is_train"]
    tens.main(["train", *_flags(scene, "ens_serial", *ens)], device="cpu")
    tens.main(["train", *_flags(scene, "ens_mesh", *ens, "--parallel", "--mesh_devices", "2")],
              device="cpu")
    for m in (1, 2):
        path = os.path.join("tiny", "triangular", "e", f"000004_{m:02d}")
        serial = _state(scene[0] / "ens_serial" / path)
        mesh = _state(scene[0] / "ens_mesh" / path)
        _assert_close(mesh["params"], serial["params"], f"member {m}", CKPT_RTOL)
    records = [json.loads(line) for line in open(
        scene[0] / "ens_mesh" / "tiny" / "summaries" / "e" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [2, 4]
    assert all(f"train/psnr_m{m:02d}" in r for r in records for m in (1, 2))
