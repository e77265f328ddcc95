"""Host-side ray precompute and shuffled epoch batching; counterpart of
cfnerf_tpu/data/sampler.py (reference use_batching pipeline,
run_nerf_uncertainty_NF.py:859-919, 938-977), in numpy.

  * one-time precompute of all rays of the training poses with their pixel
    colours as a flat shuffled [(N*H*W), 3, 3] (ro, rd, rgb) array;
  * sequential slicing per step, reshuffled at each epoch boundary;
  * the same for COLMAP depth rays [(M), 4, 3] (ro, rd, depth, weight),
    N_DEPTH rays per step;
  * the single-image sampler of --no_batching and the LF few-view splits
    (:750-772).

The same seeds give the same batches as the JAX package's sampler.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from cfnerf_torch.ops.rays import get_rays_by_coord_np, get_rays_np
from cfnerf_torch.utils.trace import span

N_DEPTH = 128  # depth rays per step (reference :855)


def lf_scene_splits(dataname: str, n_images: int, llffhold: int = 8,
                    i_test: Optional[np.ndarray] = None):
    """Train/val splits: LF few-view scenes use hardcoded index ranges
    (run_nerf_uncertainty_NF.py:750-772); otherwise every-llffhold holdout,
    falling back to the loader's test view when llffhold == 0.  Returns
    (i_train, i_val, i_val_internal); i_val_internal is i_val (the reference
    leaves it undefined for generic scenes)."""
    if dataname == "basket":
        i_train = list(np.arange(43, 50, 2))
        i_val = list(np.arange(44, 50, 2))
    elif dataname == "africa":
        i_train = list(np.arange(5, 14, 2))
        i_val = list(np.arange(6, 14, 2))
    elif dataname == "statue":
        i_train = list(np.arange(67, 76, 2))
        i_val = list(np.arange(68, 76, 2))
    elif dataname == "torch":
        i_train = list(np.arange(8, 17, 2))
        i_val = list(np.arange(9, 17, 2))
    else:
        if llffhold > 0:
            holdout = np.arange(n_images)[::llffhold]
        elif i_test is not None:
            holdout = np.atleast_1d(np.asarray(i_test, int))
        else:
            holdout = np.array([], int)
        i_val = [int(i) for i in holdout]
        i_train = [i for i in range(n_images) if i not in i_val]
    return i_train, i_val, list(i_val)


def precompute_rays(
    images: np.ndarray,   # (N, H, W, 3)
    poses: np.ndarray,    # (N, 3, 4) or (N, 3, 5)
    focal: float,
    indices: List[int],
    seed: int = 0,
) -> np.ndarray:
    """All rays of the given images as shuffled [(n*H*W), 3, 3] float32
    (ro, rd, rgb)."""
    rays = np.stack(
        [np.stack(get_rays_np(images.shape[1], images.shape[2], focal, poses[i, :3, :4]), 0)
         for i in indices], 0
    )  # (n, 2, H, W, 3)
    rgb = images[indices][:, None]  # (n, 1, H, W, 3)
    rays_rgb = np.concatenate([rays, rgb], 1)  # (n, 3, H, W, 3)
    rays_rgb = np.transpose(rays_rgb, [0, 2, 3, 1, 4])  # (n, H, W, 3, 3)
    rays_rgb = rays_rgb.reshape(-1, 3, 3).astype(np.float32)
    np.random.RandomState(seed).shuffle(rays_rgb)
    return rays_rgb


def precompute_depth_rays(
    depth_gts: List[Dict[str, np.ndarray]],
    poses: np.ndarray,
    H: int,
    W: int,
    focal: float,
    i_train: List[int],
    seed: int = 0,
) -> np.ndarray:
    """COLMAP depth-supervision rays as shuffled [(M), 4, 3]: (ro, rd,
    depth*ones(3), weight*ones(3)) (reference :888-912).  depth_gts[i] holds
    'depth' (M_i,), 'coord' (M_i, 2) as (x, y) and 'weight' (M_i,); images
    without keypoints contribute no rays."""
    rays_depth_list = []
    for i in i_train:
        if i >= len(depth_gts):
            continue
        gt = depth_gts[i]
        if gt["depth"].size == 0:
            continue
        rd = np.stack(
            get_rays_by_coord_np(H, W, focal, poses[i, :3, :4], gt["coord"]), 0
        )  # (2, M, 3)
        rd = np.transpose(rd, [1, 0, 2])  # (M, 2, 3)
        depth_value = np.repeat(gt["depth"][:, None, None], 3, axis=2)
        weights = np.repeat(gt["weight"][:, None, None], 3, axis=2)
        rays_depth_list.append(np.concatenate([rd, depth_value, weights], axis=1))
    rays_depth = np.concatenate(rays_depth_list, 0).astype(np.float32)
    np.random.RandomState(seed).shuffle(rays_depth)
    return rays_depth


class RayBatcher:
    """Sequential epoch batcher over a shuffled flat ray array.

    next() yields dict(rays_o (B,3), rays_d (B,3), target (B,3)) and
    reshuffles at each epoch boundary (reference :946-951).  Reshuffles
    permute an index array, never the data, so batches already handed out
    stay as they were; every batch is an owned copy.  batch_size must be a
    multiple of mesh_divisor, the ray axis's share count (1 on one card; the
    ensemble trainer passes its data axis, as the JAX package does)."""

    def __init__(self, rays_rgb: np.ndarray, batch_size: int, *, seed: int = 0,
                 mesh_divisor: int = 1):
        if batch_size % mesh_divisor != 0:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the mesh data "
                f"axis size ({mesh_divisor}) so the ray axis shards evenly"
            )
        self.data = rays_rgb
        self.batch_size = batch_size
        self.i = 0
        self.epoch = 0
        self._rng = np.random.RandomState(seed + 12345)
        self._order = np.arange(rays_rgb.shape[0])

    def next(self) -> Dict[str, np.ndarray]:
        with span("cfnerf.feed.sample"):
            idx = self._order[self.i : self.i + self.batch_size]
            if idx.shape[0] < self.batch_size:
                # epoch boundary: reshuffle and take a full fresh batch (the
                # reference's post-increment wraparound)
                self._rng.shuffle(self._order)
                self.i = 0
                self.epoch += 1
                idx = self._order[: self.batch_size]
            b = self.data[idx]  # before the shuffle below mutates idx's base
            self.i += self.batch_size
            if self.i >= self.data.shape[0]:
                self._rng.shuffle(self._order)
                self.i = 0
                self.epoch += 1
            return {"rays_o": b[:, 0], "rays_d": b[:, 1], "target": b[:, 2]}


class SingleImageSampler:
    """--no_batching: each step samples batch_size random pixels of ONE
    random training image, with the optional central-crop warmup
    (reference :979-1007, precrop_iters/precrop_frac)."""

    def __init__(
        self,
        images: np.ndarray,     # (N, H, W, 3)
        poses: np.ndarray,      # (N, 3, 4+)
        focal: float,
        i_train: List[int],
        batch_size: int,
        *,
        precrop_iters: int = 0,
        precrop_frac: float = 0.5,
        seed: int = 0,
    ):
        self.images = images
        self.poses = poses
        self.focal = focal
        self.i_train = list(i_train)
        self.batch_size = batch_size
        self.precrop_iters = precrop_iters
        self.precrop_frac = precrop_frac
        self._rng = np.random.RandomState(seed + 777)
        self._ray_cache = {}
        self.H, self.W = images.shape[1:3]

    def _rays_for(self, img_i: int):
        if img_i not in self._ray_cache:
            self._ray_cache[img_i] = get_rays_np(
                self.H, self.W, self.focal, self.poses[img_i, :3, :4]
            )
        return self._ray_cache[img_i]

    def next(self, step: int) -> Dict[str, np.ndarray]:
        with span("cfnerf.feed.sample"):
            img_i = self._rng.choice(self.i_train)
            rays_o, rays_d = self._rays_for(img_i)
            H, W = self.H, self.W
            if step < self.precrop_iters:
                dH = int(H // 2 * self.precrop_frac)
                dW = int(W // 2 * self.precrop_frac)
                ys = np.arange(H // 2 - dH, H // 2 + dH)
                xs = np.arange(W // 2 - dW, W // 2 + dW)
            else:
                ys = np.arange(H)
                xs = np.arange(W)
            yy, xx = np.meshgrid(ys, xs, indexing="ij")
            coords = np.stack([yy.reshape(-1), xx.reshape(-1)], -1)
            sel = self._rng.choice(
                coords.shape[0], size=self.batch_size,
                replace=coords.shape[0] < self.batch_size,
            )
            c = coords[sel]
            return {
                "rays_o": rays_o[c[:, 0], c[:, 1]].astype(np.float32),
                "rays_d": rays_d[c[:, 0], c[:, 1]].astype(np.float32),
                "target": self.images[img_i][c[:, 0], c[:, 1]].astype(np.float32),
            }


class DepthRayBatcher:
    """RayBatcher's walk over [(M), 4, 3] depth rays; yields depth_rays_o/d,
    target_depth and ray_weights (loaded but unused by the reference loss)."""

    def __init__(self, rays_depth: np.ndarray, batch_size: int = N_DEPTH, *,
                 seed: int = 0):
        self.data = rays_depth
        self.batch_size = batch_size
        self.i = 0
        self._rng = np.random.RandomState(seed + 54321)
        self._order = np.arange(rays_depth.shape[0])

    def next(self) -> Dict[str, np.ndarray]:
        with span("cfnerf.feed.sample"):
            idx = self._order[self.i : self.i + self.batch_size]
            if idx.shape[0] < self.batch_size:
                self._rng.shuffle(self._order)
                self.i = 0
                idx = self._order[: self.batch_size]
            b = self.data[idx]  # before the shuffle below mutates idx's base
            self.i += self.batch_size
            if self.i >= self.data.shape[0]:
                self._rng.shuffle(self._order)
                self.i = 0
            return {
                "depth_rays_o": b[:, 0],
                "depth_rays_d": b[:, 1],
                "target_depth": b[:, 2, 0],
                "ray_weights": b[:, 3, 0],
            }
