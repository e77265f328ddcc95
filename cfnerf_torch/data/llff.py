"""LLFF dataset loading (host-side, numpy); counterpart of
cfnerf_tpu/data/llff.py.  Images are read by data/image_io.imread (PNG and
JPEG, the pixels imageio / Pillow give) and minified by
image_io.resize_lanczos + imwrite_png, which give the bytes of the JAX
loader's Pillow Lanczos resize and PNG save, so no image library is needed
for a capture as released (full-size JPGs in images/).  The first image's
shape comes from its header (image_io.image_shape): a scene whose
images_{factor}/ exists decodes no original.

Capability parity with the reference's load_llff.py:
  * poses_bounds.npy parsing (:66-123), axis swap [-y x z] -> [x y z] (:284),
    world rescale by 1/(bds.min * bd_factor) (:291-293);
  * on-demand image downsampling — the reference shells out to ImageMagick
    `mogrify` (:12-61); here Pillow's Lanczos resampling is computed
    in-process (no subprocess, no ImageMagick dependency), writing the same
    images_{factor}/ cache layout so datasets minified by either tool
    interoperate;
  * pose recentering (:171-183), spherification (:219-275), spiral render
    path (:158-167,311-338), nearest-to-mean holdout (:354-356);
  * COLMAP sparse-depth supervision (load_colmap_depth, :374-421) with the
    same reprojection-error weights 2*exp(-(err/err_mean)^2) and near/far
    depth filtering.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from cfnerf_torch.data.colmap import read_images_binary, read_points3d_binary
from cfnerf_torch.data.image_io import image_shape, imread, imwrite_png, resize_lanczos
from cfnerf_torch.data.poses import (
    _unit,
    average_pose,
    recenter_poses,
    spherify_poses,
    spiral_path,
)


# --------------------------- image I/O ------------------------------------ #

def _imread(path) -> np.ndarray:
    return imread(path)


def _minify(basedir, factors=(), resolutions=()) -> None:
    """Create images_{factor}/ (or images_{W}x{H}/) caches: Pillow's
    convert("RGB") + Lanczos resize, saved as PNG."""
    todo = []
    for r in factors:
        if not os.path.exists(os.path.join(basedir, f"images_{r}")):
            todo.append(("factor", r))
    for r in resolutions:
        if not os.path.exists(os.path.join(basedir, f"images_{r[1]}x{r[0]}")):
            todo.append(("res", r))
    if not todo:
        return

    imgdir = os.path.join(basedir, "images")
    exts = ("JPG", "jpg", "png", "jpeg", "PNG")
    files = sorted(
        f for f in os.listdir(imgdir) if any(f.endswith(e) for e in exts)
    )

    for kind, r in todo:
        if kind == "factor":
            out = os.path.join(basedir, f"images_{r}")
        else:
            out = os.path.join(basedir, f"images_{r[1]}x{r[0]}")
        os.makedirs(out, exist_ok=True)
        print(f"Minifying x{r} -> {out} (Lanczos)")
        for fname in files:
            im = _imread(os.path.join(imgdir, fname))
            height, width = im.shape[:2]
            if kind == "factor":
                new_size = (round(width / r), round(height / r))
            else:
                new_size = (r[1], r[0])
            stem = os.path.splitext(fname)[0]
            imwrite_png(os.path.join(out, stem + ".png"), resize_lanczos(im, *new_size))


def _load_data(basedir, factor=None, width=None, height=None, load_imgs=True):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])  # (3, 5, N)
    bds = poses_arr[:, -2:].transpose([1, 0])  # (2, N)

    imgdir0 = os.path.join(basedir, "images")
    img0 = next(
        os.path.join(imgdir0, f)
        for f in sorted(os.listdir(imgdir0))
        if f.endswith(("JPG", "jpg", "png"))
    )
    sh = image_shape(img0)

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factors=[factor])
    elif height is not None:
        factor = sh[0] / float(height)
        width = int(sh[1] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    elif width is not None:
        factor = sh[1] / float(width)
        height = int(sh[0] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(f"{imgdir} does not exist")

    imgfiles = [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.endswith(("JPG", "jpg", "png"))
    ]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}"
        )

    sh = _imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    if not load_imgs:
        return poses, bds

    imgs = [_imread(f)[..., :3] / 255.0 for f in imgfiles]
    imgs = np.stack(imgs, -1)
    return poses, bds, imgs


# --------------------------- public entry points --------------------------- #

def load_llff_data(
    basedir,
    factor=8,
    recenter=True,
    bd_factor=0.75,
    spherify=False,
    path_zflat=False,
):
    """Returns (images (N,H,W,3), poses (N,3,5), bds (N,2),
    render_poses (M,3,5), i_test)."""
    poses, bds, imgs = _load_data(basedir, factor=factor)

    # Axis convention fix: [down, right, back] -> [right, up, back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = average_pose(poses)
        up = _unit(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 30, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views //= 2
        render_poses = spiral_path(
            c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=N_rots,
            n_frames=N_views,
        )

    render_poses = np.array(render_poses).astype(np.float32)
    c2w = average_pose(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return imgs.astype(np.float32), poses.astype(np.float32), bds, render_poses, i_test


def _colmap_poses(images):
    """Camera-to-world poses KEYED BY IMAGE ID.  COLMAP serializes
    images.bin from an unordered map, so file order need not match id
    order — positional pairing (which the reference's get_poses /
    poses[id_im-1] assumes, load_llff.py:383,397) silently computes each
    image's keypoint depths against another camera when it doesn't."""
    poses = {}
    for i in images:
        R = images[i].qvec2rotmat()
        t = images[i].tvec.reshape([3, 1])
        bottom = np.array([0, 0, 0, 1.0]).reshape([1, 4])
        w2c = np.concatenate([np.concatenate([R, t], 1), bottom], 0)
        poses[i] = np.linalg.inv(w2c)
    return poses


def load_colmap_depth(basedir, factor=8, bd_factor=0.75, cache=True):
    """Per-train-image sparse depths from COLMAP keypoints, with
    reprojection-error-based confidence weights.

    Returns a DENSE list of dicts {"depth": (M,), "coord": (M, 2),
    "weight": (M,)} — one entry per image in id order, with M == 0 when an
    image has no valid keypoint.  (The reference compacts empty images
    away, load_llff.py:415-417, but its train loop indexes the result with
    GLOBAL image indices (:888-912) — a silent pose/depth misalignment
    whenever any image is empty.  Dense return keeps global indexing
    valid; precompute_depth_rays skips the empty entries.)
    """
    basedir = Path(basedir)
    images = read_images_binary(basedir / "sparse" / "0" / "images.bin")
    points = read_points3d_binary(basedir / "sparse" / "0" / "points3D.bin")

    errs = np.array([p.error for p in points.values()])
    err_mean = errs.mean()

    poses = _colmap_poses(images)
    poses_raw, bds_raw = _load_data(str(basedir), factor=factor, load_imgs=False)
    bds_raw = np.moveaxis(bds_raw, -1, 0).astype(np.float32)
    sc = 1.0 if bd_factor is None else 1.0 / (bds_raw.min() * bd_factor)

    data_list = []
    for idx, id_im in enumerate(sorted(images.keys())):
        im = images[id_im]
        pose = poses[id_im]  # id-keyed: immune to images.bin file order
        depth_list, coord_list, weight_list = [], [], []
        for xy, id_3d in zip(im.xys, im.point3D_ids):
            if id_3d == -1:
                continue
            pt = points[id_3d].xyz
            depth = (pose[:3, 2].T @ (pt - pose[:3, 3])) * sc
            if depth < bds_raw[idx, 0] * sc or depth > bds_raw[idx, 1] * sc:
                continue
            err = points[id_3d].error
            weight = 2 * np.exp(-((err / err_mean) ** 2))
            depth_list.append(depth)
            coord_list.append(xy / factor)
            weight_list.append(weight)
        data_list.append(
            {
                "depth": np.array(depth_list),
                "coord": np.array(coord_list).reshape(-1, 2),
                "weight": np.array(weight_list),
            }
        )
    if cache:
        np.save(basedir / "colmap_depth.npy", np.array(data_list, dtype=object), allow_pickle=True)
    return data_list
