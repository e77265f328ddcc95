"""The port's colour maps, figures, point clouds, logger and video writer
(cfnerf_torch/utils/colormap.py, utils/visualization.py,
utils/pointcloud.py, train/logging.py, train/loop.py:_save_video) against
cv2, matplotlib and the JAX package on the same inputs.  The port draws
without cv2 or matplotlib (the card has no matplotlib); here both are
installed and serve as oracles."""
import json
import os
import sys

import cv2
import matplotlib.colors as mcolors
import numpy as np
import pytest

from cfnerf_tpu.train import logging as jlogging
from cfnerf_tpu.utils import pointcloud as jpc
from cfnerf_torch.data.image_io import imread_png
from cfnerf_torch.ops.metrics import to8b
from cfnerf_torch.train import logging as tlogging
from cfnerf_torch.train.loop import _save_video
from cfnerf_torch.utils import pointcloud as tpc
from cfnerf_torch.utils.colormap import COLORMAPS, apply_colormap
from cfnerf_torch.utils.visualization import (
    CANVAS_H,
    CANVAS_W,
    MidpointNormalize,
    save_sparsification_figure,
    save_uncertainty_figure,
)

CV2_MAPS = {"jet": cv2.COLORMAP_JET, "magma": cv2.COLORMAP_MAGMA}
# TwoSlopeNorm's np.interp in float64 against the same np.interp
NORM_ATOL = 1e-7


def _cv2_rgb(u8, name):
    return cv2.cvtColor(cv2.applyColorMap(u8, CV2_MAPS[name]), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("name", ["jet", "magma"])
def test_tables_equal_cv2_at_every_level(name):
    levels = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(COLORMAPS[name], _cv2_rgb(levels, name)[:, 0])
    np.testing.assert_array_equal(apply_colormap(levels, name), _cv2_rgb(levels, name))


@pytest.mark.parametrize("name", ["jet", "magma"])
def test_apply_colormap_equals_cv2_on_one_and_three_channels(name):
    # three channels go through cv2's BGR2GRAY first: every (B, G, R) triple
    v = np.arange(256)
    bgr = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    bgr = bgr.astype(np.uint8)
    np.testing.assert_array_equal(apply_colormap(bgr, name), _cv2_rgb(bgr, name))
    u8 = np.random.RandomState(0).randint(0, 256, (31, 17, 1)).astype(np.uint8)
    np.testing.assert_array_equal(apply_colormap(u8, name), _cv2_rgb(u8, name))


def test_apply_colormap_refuses_other_inputs():
    with pytest.raises(ValueError):
        apply_colormap(np.zeros((4, 4), np.float32), "jet")
    with pytest.raises(ValueError):
        apply_colormap(np.zeros((4, 4), np.uint8), "viridis")


@pytest.mark.parametrize("kw", [dict(), dict(vmin=-5.0, vmax=9.0, midpoint=1.0),
                                dict(midpoint=20.0), dict(midpoint=-20.0),
                                dict(vmin=-1.0, midpoint=0.5)])
def test_midpoint_normalize_is_two_slope_norm(kw):
    x = (np.random.RandomState(3).randn(7, 9) * 3).astype(np.float32)
    got = MidpointNormalize(**kw)(x)
    want = np.ma.getdata(mcolors.TwoSlopeNorm(vcenter=kw.get("midpoint", 0.0),
                                              vmin=kw.get("vmin"), vmax=kw.get("vmax"))(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=NORM_ATOL)
    # a scalar stays a scalar
    norm = MidpointNormalize(vmin=-2.0, vmax=4.0, midpoint=0.0)
    assert np.ndim(norm(1.0)) == 0 and abs(norm(1.0) - 0.625) <= NORM_ATOL
    with pytest.raises(ValueError):
        MidpointNormalize(vmin=1.0, vmax=2.0, midpoint=3.0)


def _cloud_inputs(H=12, W=16, seed=0):
    rng = np.random.RandomState(seed)
    depth = (rng.rand(H, W) * 3 + 1).astype(np.float32)
    unc = rng.rand(H, W).astype(np.float32)
    c2w = rng.randn(3, 4).astype(np.float32)
    rgb = rng.rand(H, W, 3).astype(np.float32)
    mask = rng.rand(H, W) > 0.3
    return depth, unc, c2w, rgb, mask


@pytest.mark.parametrize("extra", ["heat", "rgb", "mask"])
def test_pointcloud_bytes_equal_jax(tmp_path, extra):
    depth, unc, c2w, rgb, mask = _cloud_inputs()
    kw = {"heat": {}, "rgb": {"rgb": rgb}, "mask": {"mask": mask}}[extra]
    jpc.depth_uncertainty_pointcloud(str(tmp_path / "jax.ply"), depth, unc, c2w, 20.0, **kw)
    tpc.depth_uncertainty_pointcloud(str(tmp_path / "port.ply"), depth, unc, c2w, 20.0, **kw)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    xyz, cols = tpc.read_pointcloud(str(tmp_path / "port.ply"))
    jxyz, jcols = jpc.read_pointcloud(str(tmp_path / "jax.ply"))
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(cols, jcols)


def test_write_pointcloud_default_white(tmp_path):
    xyz = np.random.RandomState(1).randn(5, 3)
    jpc.write_pointcloud(str(tmp_path / "jax.ply"), xyz)
    tpc.write_pointcloud(str(tmp_path / "port.ply"), xyz)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def _panel_inputs(H=6, W=7, seed=0):
    rng = np.random.RandomState(seed)
    gt = rng.rand(H, W, 3).astype(np.float32)
    mean = np.clip(gt + 0.1 * rng.randn(H, W, 3), -0.1, 1.1).astype(np.float32)
    std = (rng.rand(H, W, 3) * 0.2).astype(np.float32)
    disp = (rng.rand(H, W) * 3).astype(np.float32)
    return gt, mean, std, disp


@pytest.mark.parametrize("with_disp", [True, False])
def test_uncertainty_panel_decodes_to_its_tiles(tmp_path, with_disp):
    gt, mean, std, disp = _panel_inputs()
    H, W = gt.shape[:2]
    path = str(tmp_path / "sub" / "panel.png")
    save_uncertainty_figure(path, gt=gt, rgb_mean=mean, rgb_std=std,
                            disp=disp if with_disp else None, title="view 0")
    panel = imread_png(path)
    n = 5 if with_disp else 4
    assert panel.shape == (H, n * W, 3)
    tiles = [panel[:, i * W:(i + 1) * W] for i in range(n)]
    # the arrays JAX's figure plots, each heat map over its maximum, through cv2
    err = np.abs(mean - gt).mean(-1)
    unc = std.mean(-1)
    want = [to8b(gt), to8b(mean),
            _cv2_rgb(to8b(err / (err.max() + 1e-8)), "jet"),
            _cv2_rgb(to8b(unc / (unc.max() + 1e-8)), "jet")]
    if with_disp:
        want.append(_cv2_rgb(to8b(disp / (disp.max() + 1e-8)), "magma"))
    for i, (t, w) in enumerate(zip(tiles, want)):
        np.testing.assert_array_equal(t, w, err_msg=f"tile {i}")


def test_sparsification_figure_draws_both_curves_and_the_band(tmp_path):
    oracle = np.linspace(0.5, 0.0, 100)
    by_var = oracle + 0.2 * np.linspace(1.0, 0.0, 100)
    path = str(tmp_path / "ause.png")
    save_sparsification_figure(path, oracle, by_var)
    img = imread_png(path)
    assert img.shape == (CANVAS_H, CANVAS_W, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    assert {(31, 119, 180), (214, 39, 40), (244, 204, 204), (0, 0, 0)} <= colours
    # the by-variance curve lies above the oracle curve: in each plotted
    # column its red pixel sits at or above the blue one
    for col in range(60, 300, 40):
        red = np.where((img[:, col] == (214, 39, 40)).all(-1))[0]
        band = np.where((img[:, col] == (244, 204, 204)).all(-1))[0]
        assert red.size and (band.size == 0 or red.min() <= band.min())


def test_logger_heat_maps_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    for img in (rng.rand(6, 7, 3), rng.rand(6, 7), rng.rand(6, 7, 1)):
        img = img.astype(np.float32)
        for name in ("jet", "magma"):
            np.testing.assert_array_equal(tlogging._colormap(img, name),
                                          jlogging._colormap(img, name))


def test_logger_jsonl_and_console(tmp_path, capsys):
    logs = {}
    for name, mod in (("jax", jlogging), ("port", tlogging)):
        log = mod.MetricsLogger(str(tmp_path / name), "scene", "exp", use_tb=False)
        scalars = {"train/loss": 1.5, "train/loss_entropy": 0.25, "train/depth_loss": 0.5,
                   "train/loss_nll": 1.0, "train/psnr": 12.5, "iter_time": 0.1}
        log.scalars(3, scalars)
        log.console(3, scalars, colmap_depth=True)
        log.image_panel(3, "val/", gt=np.zeros((4, 4, 3)), rgb_k=np.zeros((4, 4, 3, 2)),
                        disp_k=np.zeros((4, 4, 2)))  # no writer: skipped
        log.close()
        with open(os.path.join(log.summary_dir, "metrics.jsonl")) as f:
            logs[name] = [json.loads(line) for line in f]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("[TRAIN] Iter: 3 Loss: 1.500000 entropy")
    assert [sorted(r) for r in logs["port"]] == [sorted(r) for r in logs["jax"]]
    assert all(logs["port"][0][k] == logs["jax"][0][k] for k in logs["jax"][0] if k != "t")


def _without(monkeypatch, *names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)  # import raises ImportError


@pytest.mark.parametrize("grey", [False, True])
def test_save_video_writes_png_frames_without_imageio(tmp_path, monkeypatch, capsys, grey):
    _without(monkeypatch, "imageio", "imageio.v2")
    rng = np.random.RandomState(2)
    frames = rng.rand(3, 5, 6) if grey else rng.rand(3, 5, 6, 3)
    path = str(tmp_path / "exp_spiral_000010_rgb.mp4")
    _save_video(frames, path)
    base = tmp_path / "exp_spiral_000010_rgb"
    assert sorted(os.listdir(base)) == ["000.png", "001.png", "002.png"]
    assert not os.path.exists(path)
    for i in range(3):
        np.testing.assert_array_equal(imread_png(str(base / f"{i:03d}.png")), to8b(frames[i]))
    assert f"wrote PNG frames to {base}/" in capsys.readouterr().out
