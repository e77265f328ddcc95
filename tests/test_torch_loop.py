"""The port's training loop (cfnerf_torch/train/loop.py: train,
ValEarlyStop; cfnerf_torch/cli/train.py) against the JAX package's on the
same flags and scene: the run dir it writes, the metrics stream, resume,
the early-stop rule, the --colmap_depth --no_batching refusal, and Adam's
state and lr count carried across a --k_schedule boundary.  The port runs
with device="cpu"; one JAX training run is shared by the module."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cfnerf_tpu.train import checkpoint as jckpt
from cfnerf_tpu.train import loop as jloop
from cfnerf_tpu.utils.config import parse_args as jparse
from cfnerf_torch.cli.train import main as port_main
from cfnerf_torch.data.image_io import imread_png
from cfnerf_torch.data.sampler import RayBatcher, precompute_rays
from cfnerf_torch.models.factory import create_nerf
from cfnerf_torch.ops.metrics import to8b
from cfnerf_torch.parallel import mesh as tmesh
from cfnerf_torch.render.renderer import make_render_rays
from cfnerf_torch.train import checkpoint as tckpt
from cfnerf_torch.train import loop as tloop
from cfnerf_torch.train.step import TrainConfig, make_optimizer, make_train_step
from cfnerf_torch.utils.config import parse_args as tparse
from tests.datagen import make_blender_dataset

ROOT = Path(__file__).resolve().parents[1]
CAPTURE = ROOT / "tests" / "fixtures" / "minicapture"
# a tiny flagship on an 8x8 Blender scene: 3 train, 2 val, 2 test views
TINY = ["--expname", "e", "--dataname", "tiny", "--dataset_type", "blender",
        "--N_rand", "32", "--N_samples", "16", "--K_samples", "4", "--n_flows", "2",
        "--h_alpha_size", "8", "--h_rgb_size", "8", "--netdepth", "2", "--netwidth", "32",
        "--type_flows", "triangular", "--use_viewdirs", "--white_bkgd", "--no_ndc",
        "--testskip", "1", "--chunk", "64"]
# every cadence fires in 6 steps: print and weights at 5, an image panel at
# 3, the test set at 5, the spiral video at 6
CADENCES = ["--n_iters", "6", "--i_print", "5", "--i_weights", "5", "--i_img", "3",
            "--i_testset", "5", "--i_video", "6"]
# Adam's update carried across the K boundary against one optimizer driven
# by hand: the same arithmetic in the same order, so only f32 reassociation
# inside the library calls could differ
CARRY_ATOL = 1e-6


def _flags(datadir, basedir, *extra):
    return TINY + ["--datadir", str(datadir), "--basedir", str(basedir), *extra]


def _tree(rundir):
    """The run dir's entries a user sees: checkpoint names, files, and the
    contents of the render directories; a checkpoint's inside is each
    package's own format."""
    out = set()
    for name in os.listdir(rundir):
        path = os.path.join(rundir, name)
        if os.path.isdir(path) and not tckpt._CKPT_RE.match(name):
            out.update(f"{name}/{f}" for f in os.listdir(path))
        else:
            out.add(name)
    return out


def _videos_by_name(tree):
    """A video is an mp4 or, without an mp4 writer, a directory of PNG
    frames of the same name (the JAX package writes it with cv2 where
    imageio has no ffmpeg, as here; the port writes the frames)."""
    return {f.split("/")[0] + ".mp4" if "_spiral_" in f and "/" in f else f for f in tree}


def _jsonl(basedir):
    with open(os.path.join(basedir, "tiny", "summaries", "e", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _args_lines(rundir, basedir):
    with open(os.path.join(rundir, "args.txt")) as f:
        return [line for line in f.read().splitlines() if not line.startswith("basedir =")]


def _first_poses(load_dataset, n=2):
    """load_dataset with the render path cut to its first n poses: each of
    the JAX loop's video renders compiles anew (~6 s apiece on this CPU,
    40 poses for a Blender scene), and the files' names do not depend on
    the count."""
    def load(args):
        scene = load_dataset(args)
        scene["render_poses"] = scene["render_poses"][:n]
        return scene
    return load


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port training run on the same flags and scene, both
    with the render path cut to 2 poses."""
    tmp = tmp_path_factory.mktemp("loop")
    datadir = make_blender_dataset(str(tmp / "lego"), H=8, W=8, n_val=2)
    out = {"datadir": datadir}
    for name, parse, mod, kw in (("jax", jparse, jloop, {}),
                                 ("port", tparse, tloop, {"device": "cpu"})):
        basedir = tmp / name
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "load_dataset", _first_poses(mod.load_dataset))
            mod.train(parse(_flags(datadir, basedir, *CADENCES, "--is_train")), **kw)
        out[name] = basedir
    return out


def _rundir(basedir):
    return os.path.join(basedir, "tiny", "triangular", "e")


def test_run_dir_tree_matches_jax(runs):
    jax_dir, port_dir = _rundir(runs["jax"]), _rundir(runs["port"])
    want = _videos_by_name(_tree(jax_dir))
    assert _videos_by_name(_tree(port_dir)) == want
    # checkpoint at i_weights, 2 test-set views (mean + std), the spiral
    # videos at i_video
    assert {"000005_01", "args.txt", "testset_000005/000.png", "testset_000005/001_std.png",
            "e_spiral_000006_rgb.mp4", "e_spiral_000006_disp.mp4"} <= want
    assert _args_lines(port_dir, runs["port"]) == _args_lines(jax_dir, runs["jax"])


def test_metrics_stream_matches_jax(runs):
    jax_recs, port_recs = _jsonl(runs["jax"]), _jsonl(runs["port"])
    assert [r["step"] for r in port_recs] == [r["step"] for r in jax_recs] == [5]
    assert [sorted(r) for r in port_recs] == [sorted(r) for r in jax_recs]
    assert {"val/mse", "val/psnr", "val/nll", "train/pnsr", "iter_time"} <= set(port_recs[0])
    assert all(np.isfinite(v) for v in port_recs[0].values())


def test_resume_starts_at_jax_step(runs, capsys):
    jax_ckpt = jckpt.find_resume_checkpoint(_rundir(runs["jax"]))
    port_ckpt = tckpt.find_resume_checkpoint(_rundir(runs["port"]))
    assert os.path.basename(port_ckpt) == os.path.basename(jax_ckpt) == "000005_01"
    # a longer run resumes there: steps 6-8, a print at each
    tloop.train(tparse(_flags(runs["datadir"], runs["port"], "--n_iters", "8",
                              "--i_print", "1", "--i_weights", "100", "--is_train")),
                device="cpu")
    assert f"Reloading from {port_ckpt}" in capsys.readouterr().out
    assert [r["step"] for r in _jsonl(runs["port"])] == [5, 6, 7, 8]


def test_render_only_through_the_cli(runs, capsys):
    # without --is_train the CLI renders the spiral path from the checkpoint
    port_main(_flags(runs["datadir"], runs["port"], "--index_step", "5"), device="cpu")
    out = capsys.readouterr().out
    assert "--is_train not set: running evaluation (--render_only)." in out
    savedir = os.path.join(_rundir(runs["port"]), "renderonly_path_000005")
    assert f"Done rendering {savedir}" in out
    args = tparse(_flags(runs["datadir"], runs["port"], "--index_step", "5"))
    scene = tloop.load_dataset(args)
    n = len(scene["render_poses"])
    files = set(os.listdir(savedir))
    assert {f"{i:03d}.png" for i in range(n)} | {f"{i:03d}_std.png" for i in range(n)} <= files
    # the frames are the checkpoint's test-mode renders
    model, fine, rc, start = create_nerf(args, "cpu")
    rgbs, _, _ = tloop.render_path(scene["render_poses"][:2], scene, args,
                                   make_render_rays(model, rc, fine), device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(imread_png(os.path.join(savedir, f"{i:03d}.png")),
                                      to8b(rgbs[i]))


@pytest.mark.parametrize("patience,delta,seq", [
    (2, 0.01, [10.0, 10.005, 10.02, 11.0, 11.0, 11.001]),
    (1, 0.0, [5.0, 4.0]),
    (3, 0.5, [1.0, 1.2, 1.6, 1.7, 1.9, 2.0, 2.05]),
])
def test_val_early_stop_decisions_match_jax(patience, delta, seq):
    j, t = jloop.ValEarlyStop(patience, delta), tloop.ValEarlyStop(patience, delta)
    assert [t.update(v) for v in seq] == [j.update(v) for v in seq]
    assert (t.best, t.stale) == (j.best, j.stale)
    with pytest.raises(ValueError):
        tloop.ValEarlyStop(0)


def test_colmap_depth_needs_batching(tmp_path):
    datadir = shutil.copytree(CAPTURE, tmp_path / "minicapture")
    args = tparse(["--expname", "e", "--dataset_type", "llff", "--datadir", str(datadir),
                   "--basedir",
                   str(tmp_path / "logs"), "--dataname", "minicapture", "--factor", "2",
                   "--colmap_depth", "--no_batching", "--netdepth", "2", "--netwidth", "32",
                   "--type_flows", "triangular",
                   "--K_samples", "4", "--N_samples", "8", "--n_flows", "2", "--is_train"])
    with pytest.raises(ValueError, match="--colmap_depth requires the batching path"):
        tloop.train(args, device="cpu")


@pytest.mark.parametrize("flag", [["--mesh_devices", "2"], ["--model_parallel", "2"]])
def test_more_than_one_device_waits_for_slice_8(tmp_path, monkeypatch, flag):
    """The flags that asked for several devices before they were ported:
    --mesh_devices 2 now trains on 2 gloo ranks (rank 0 writing the one
    metrics stream), --model_parallel 2 on the CPU's one device raises
    JAX's ValueError."""
    monkeypatch.setattr(tmesh, "DEFAULT_TIMEOUT_S", 240)
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=1)
    args = tparse(_flags(datadir, tmp_path / "logs", *flag, "--n_iters", "2", "--i_print",
                         "2", "--i_weights", "2", "--i_img", "0", "--i_testset", "0",
                         "--i_video", "0", "--is_train"))
    if flag[0] == "--model_parallel":
        with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
            tloop.train(args, device="cpu")
        return
    tloop.train(args, device="cpu")
    assert [r["step"] for r in _jsonl(tmp_path / "logs")] == [2]
    assert os.path.exists(tmp_path / "logs" / "tiny" / "triangular" / "e" / "000002_01")


def _hand_run(args, k_schedule, carry):
    """Steps 1-3 of `args`'s run by hand: the loop's batches and generator,
    each stage's gradients from that stage's loss_fn, one Adam and schedule
    stepped by hand (carry=False: a fresh one at the K boundary)."""
    scene = tloop.load_dataset(args)
    model, _, rc, start = create_nerf(args, "cpu")
    tc = TrainConfig(H=scene["H"], W=scene["W"], focal=scene["focal"], ndc=False,
                     near=scene["near"], far=scene["far"], k_samples=args.K_samples,
                     lrate=args.lrate, lrate_decay=args.lrate_decay, beta1=args.beta1)
    batches = RayBatcher(precompute_rays(scene["images"], scene["poses"], scene["focal"],
                                         scene["i_train"], seed=args.seed),
                         args.N_rand, seed=args.seed)
    generator = torch.Generator().manual_seed(args.seed + start)
    params = list(model.parameters())
    optimizer, scheduler = make_optimizer(params, tc)
    for step in (1, 2, 3):
        k = tloop.k_for_step(k_schedule, step)
        if step == k_schedule[1][0] and not carry:
            optimizer, scheduler = make_optimizer(
                params, TrainConfig(**{**tc.__dict__, "start_step": step - 1}))
        stage_step, _ = make_train_step(tloop._at_k(model, k), rc,
                                        TrainConfig(**{**tc.__dict__, "k_samples": k}))
        optimizer.zero_grad(set_to_none=True)
        loss, _ = stage_step.loss_fn(batches.next(), generator)
        loss.backward()
        optimizer.step()
        scheduler.step()
    return model, optimizer


def test_k_schedule_carries_adam_state_and_lr_count(tmp_path):
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=2)
    flags = _flags(datadir, tmp_path / "logs", "--n_iters", "3", "--i_weights", "3",
                   "--k_schedule", "2:0,4:2", "--lrate", "1e-2", "--is_train")
    tloop.train(tparse(flags), device="cpu")
    saved = torch.load(os.path.join(_rundir(tmp_path / "logs"), "000003_01", "state.pt"),
                       weights_only=True)
    k_schedule = tloop.parse_k_schedule("2:0,4:2")
    hand_args = tparse(_flags(datadir, tmp_path / "hand", "--lrate", "1e-2"))
    model, optimizer = _hand_run(hand_args, k_schedule, carry=True)
    for name, value in model.state_dict().items():
        torch.testing.assert_close(saved["params"]["coarse"][name], value, rtol=0,
                                   atol=CARRY_ATOL, msg=name)
    hand_state = optimizer.state_dict()
    assert saved["opt_state"]["param_groups"][0]["lr"] == hand_state["param_groups"][0]["lr"]
    for idx, st in hand_state["state"].items():
        assert float(saved["opt_state"]["state"][idx]["step"]) == float(st["step"]) == 3.0
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(saved["opt_state"]["state"][idx][key], st[key],
                                       rtol=0, atol=CARRY_ATOL)
    # a fresh Adam at the boundary takes another step: the carry is what
    # the comparison above holds
    fresh, _ = _hand_run(hand_args, k_schedule, carry=False)
    moved = max(float((fresh.state_dict()[k] - v).abs().max())
                for k, v in model.state_dict().items())
    assert moved > 100 * CARRY_ATOL


def test_n_inner_steps_take_the_same_trajectory(tmp_path):
    # --n_inner 2 (make_train_loop, no prefetcher) draws the same batches and
    # eps in the same order as single steps
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=2)
    states = []
    for name, extra in (("one", []), ("two", ["--n_inner", "2"])):
        tloop.train(tparse(_flags(datadir, tmp_path / name, "--n_iters", "4",
                                  "--i_weights", "4", "--i_print", "2", "--is_train",
                                  "--profile_dir", str(tmp_path / name / "trace"),
                                  "--profile_start", "1", "--profile_steps", "2", *extra)),
                    device="cpu")
        states.append(torch.load(os.path.join(_rundir(tmp_path / name), "000004_01",
                                              "state.pt"), weights_only=True))
        with open(tmp_path / name / "trace" / "trace.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        # the step's phases; the prefetcher's worker's spans where it runs
        # (one step a call: not under --n_inner 2)
        assert {"cfnerf.train.forward", "cfnerf.train.backward"} <= names
        assert ("cfnerf.feed.make" in names) == (not extra)
    for k, v in states[0]["params"]["coarse"].items():
        torch.testing.assert_close(states[1]["params"]["coarse"][k], v, rtol=0, atol=0, msg=k)


def test_occ_stage_distills_trains_and_ends(tmp_path, capsys):
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=2)
    tloop.train(tparse(_flags(datadir, tmp_path / "logs", "--n_iters", "5", "--i_print", "1",
                              "--occ_train", "8", "--occ_candidates", "16",
                              "--occ_train_from", "2", "--occ_train_until", "4",
                              "--occ_floor_anneal", "2", "--is_train")), device="cpu")
    out = capsys.readouterr().out
    assert "occ stage: proposal distilled" in out and "occ stage ended at step 4" in out
    recs = _jsonl(tmp_path / "logs")
    assert ["train/prop_loss" in r for r in recs] == [False, True, True, False, False]


def _proposal_state(step_fn):
    """The occ step's proposal weights and its Adam's step counts, copied."""
    weights = {k: v.clone() for k, v in step_fn.proposal.state_dict().items()}
    return weights, [float(st["step"]) for st in step_fn.prop_optimizer.state.values()]


def test_k_stage_view_shares_parameters_with_its_own_test_eps(tmp_path):
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=2)
    model, _, _, _ = create_nerf(tparse(_flags(datadir, tmp_path / "logs")), "cpu")
    base_eps = model.test_eps_a.clone()
    view = tloop._at_k(model, 2)
    assert view.k_samples == 2 and model.k_samples == 4
    assert all(a is b for a, b in zip(view.parameters(), model.parameters()))
    # K=2 test-mode draws, the mean draw last; the model's own stay at K=4
    assert view.test_eps_a.shape[0] == view.test_eps_r.shape[0] == 2
    assert not view.test_eps_a[-1].any() and not view.test_eps_r[-1].any()
    assert torch.equal(model.test_eps_a, base_eps)
    raw, _ = view(torch.zeros(3, model.input_ch + model.input_ch_views), is_test=True)
    assert raw.shape[:2] == (3, 2)


def test_occ_proposal_survives_a_k_boundary(tmp_path, monkeypatch, capsys):
    # steps 2-4 are placed, step 3 starts the K=4 stage: its step must go on
    # from the proposal (and its Adam) that step 2 co-trained, as JAX's
    # opt_state carries (prop_params, prop_opt) through every stage
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=2)
    log = []
    real = tloop.make_train_step

    def recording(*args, **kwargs):
        fn, optimizer = real(*args, **kwargs)
        if kwargs.get("occ") is None:
            return fn, optimizer

        def step(batch, generator, **kw):
            before = _proposal_state(fn)
            metrics = fn(batch, generator, **kw)
            log.append((before, _proposal_state(fn)))
            return metrics
        step.__dict__.update(fn.__dict__)
        return step, optimizer

    monkeypatch.setattr(tloop, "make_train_step", recording)
    tloop.train(tparse(_flags(datadir, tmp_path / "logs", "--n_iters", "4", "--i_print", "1",
                              "--k_schedule", "2:0,4:3", "--occ_train", "8",
                              "--occ_candidates", "16", "--occ_train_from", "2",
                              "--is_train")), device="cpu")
    assert capsys.readouterr().out.count("occ stage: proposal distilled") == 1
    assert len(log) == 3  # steps 2 (K=2), 3 and 4 (K=4)
    (_, after_2), (before_3, after_3), _ = log
    assert before_3[1] == after_2[1] == [1.0] * len(after_2[1])  # Adam went on
    for name, value in after_2[0].items():
        assert torch.equal(before_3[0][name], value), name
    # the co-training step moves the proposal: the equality above is the carry
    assert any(not torch.equal(after_3[0][k], v) for k, v in before_3[0].items())


def test_debug_nans_names_the_bad_inner_step(tmp_path, monkeypatch):
    # --n_inner 3: the first update leaves NaN weights, so step 2's loss is
    # NaN, and the error names step 2, not the block's last step
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=2)
    real_step, calls = torch.optim.Adam.step, []

    def poisoning_step(self, *args, **kwargs):
        out = real_step(self, *args, **kwargs)
        calls.append(None)
        if len(calls) == 1:
            with torch.no_grad():
                for group in self.param_groups:
                    for p in group["params"]:
                        p.fill_(float("nan"))
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", poisoning_step)
    args = tparse(_flags(datadir, tmp_path / "logs", "--n_iters", "3", "--n_inner", "3",
                         "--debug_nans", "--is_train"))
    with pytest.raises(FloatingPointError, match="at step 2 "):
        tloop.train(args, device="cpu")


def test_debug_nans_raises_at_the_first_bad_step():
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([0.0, float("nan"), 1.0])
    with pytest.raises(FloatingPointError, match="step 7"):
        tloop._check_finite(7, torch.tensor(1.0), [p], nans=True, infs=False)
    p.grad = torch.tensor([0.0, float("inf"), 1.0])
    tloop._check_finite(7, torch.tensor(1.0), [p], nans=True, infs=False)
    with pytest.raises(FloatingPointError, match="inf"):
        tloop._check_finite(7, torch.tensor(1.0), [p], nans=False, infs=True)


RUN_WITHOUT = r"""
import importlib.abc, sys
BLOCKED = ("imageio", "PIL", "cv2", "matplotlib", "tensorboard", "tensorboardX")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
from cfnerf_torch.cli import eval as ev, train as tr
flags = sys.argv[1:]
tr.main(flags + ["--is_train"], device="cpu")
tr.main(flags, device="cpu")
ev.main(flags, device="cpu")
"""


def test_slice_runs_without_image_and_logging_libraries(tmp_path):
    # the port needs none of imageio, Pillow, cv2, matplotlib or
    # tensorboard (the card has no imageio and no matplotlib): train
    # (videos as PNG frames, JSONL only), render only and evaluate all
    # complete without them
    datadir = make_blender_dataset(str(tmp_path / "lego"), H=8, W=8, n_val=2)
    proc = subprocess.run([sys.executable, "-c", RUN_WITHOUT,
                           *_flags(datadir, tmp_path / "logs", *CADENCES)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rundir = _rundir(tmp_path / "logs")
    tree = _tree(rundir)
    # the last checkpoint is step 5's: render only and eval resume there
    assert {"e_spiral_000006_rgb/000.png", "e_spiral_000006_disp/000.png",
            "renderonly_path_000005/video", "eval_000005/metrics.json",
            "eval_000005/003_panel.png", "eval_000005/004_uncertainty.ply"} <= tree
    assert not any(f.startswith("events.") for f in
                   os.listdir(os.path.join(tmp_path / "logs", "tiny", "summaries", "e")))
