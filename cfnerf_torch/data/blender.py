"""Blender synthetic dataset loading (host-side, numpy); counterpart of
cfnerf_tpu/data/blender.py.  PNGs are read by data/image_io.imread_png and
half_res shrinks by image_io.resize_area, the port's own equals of the
imageio read and cv2.resize(..., INTER_AREA) of the JAX loader, so no image
library is needed.

Capability parity with the reference's load_blender.py:37-95:
transforms_{train,val,test}.json + RGBA PNGs (alpha kept; white-background
compositing happens in train/loop.py:load_dataset, matching
run_nerf_uncertainty_NF.py:793-796), spherical render-pose ring at six
elevations (-10/-20/-30/-45/-60/-80 degrees), half_res via area resampling.
"""
from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from cfnerf_torch.data.image_io import imread_png, resize_area


def trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float32
    )


def rot_phi(phi):
    return np.array(
        [
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def rot_theta(th):
    return np.array(
        [
            [np.cos(th), 0, -np.sin(th), 0],
            [0, 1, 0, 0],
            [np.sin(th), 0, np.cos(th), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
        @ c2w
    )
    return c2w


def spherical_render_ring() -> np.ndarray:
    """Six-elevation ring of render poses (load_blender.py:75-81)."""
    specs = [(-10.0, 50), (-20.0, 40), (-30.0, 30), (-45.0, 30), (-60.0, 20), (-80.0, 10)]
    poses = []
    for phi, n in specs:
        for angle in np.linspace(-180, 180, n + 1)[:-1]:
            poses.append(pose_spherical(angle, phi, 4.0))
    return np.stack(poses, 0)


def load_blender_data(
    basedir: str, half_res: bool = False, testskip: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List, List[np.ndarray]]:
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imread_png(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # RGBA kept
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = spherical_render_ring()

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs_half = np.zeros((imgs.shape[0], H, W, imgs.shape[-1]), dtype=np.float32)
        for i, img in enumerate(imgs):
            imgs_half[i] = resize_area(img, W, H)
        imgs = imgs_half

    return imgs, poses, render_poses, [H, W, focal], i_split
