"""Ray generation and NDC reparameterization; counterpart of cfnerf_tpu/ops/rays.py.

Convention: pinhole camera looking down -z, x right, y up.  Pixel (i, j)
(column i, row j) maps to camera-space direction
[(i - W/2)/f, -(j - H/2)/f, -1], rotated into world space by c2w[:3,:3];
all rays share origin c2w[:3,-1].  The numpy variants feed the host-side
ray precompute of the batch sampler (cfnerf_torch/data/sampler.py).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_rays(
    H: int, W: int, focal: float, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image rays on c2w's device.  Returns (rays_o, rays_d), each (H, W, 3)."""
    dev = c2w.device
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    dirs = torch.stack(
        [(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)], dim=-1
    )  # (H, W, 3)
    c2w = c2w.to(torch.float32)
    # elementwise sum over c, as the reference's broadcast-multiply-sum
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, focal: float, c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side full-image rays (reference run_nerf_helpers.py:350-357)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -np.ones_like(i)], -1)
    rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def get_rays_by_coord_np(
    H: int, W: int, focal: float, c2w: np.ndarray, coords: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Rays through pixel coordinates (N, 2) = (x, y), for COLMAP sparse-depth
    supervision (reference run_nerf_helpers.py:440-445)."""
    i = (coords[:, 0] - W * 0.5) / focal
    j = -(coords[:, 1] - H * 0.5) / focal
    dirs = np.stack([i, j, -np.ones_like(i)], -1)
    rays_d = np.einsum("nc,rc->nr", dirs, c2w[:3, :3])
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def get_ray_directions(H: int, W: int, K: np.ndarray) -> np.ndarray:
    """Camera-space directions (H, W, 3) from a full 3x3 intrinsics matrix (no
    +0.5 pixel centering, matching the reference)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], -1)


def get_rays_phototourism(
    directions: np.ndarray, c2w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """World-space rays from camera-space `directions` (get_ray_directions) and
    a 3x4 c2w, the per-image-intrinsics rig of phototourism-style captures
    (reference run_nerf_helpers.py:324-347).  Unlike get_rays the directions
    are unit-norm, and both outputs are flattened to (H*W, 3) float32."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return (
        rays_o.reshape(-1, 3).astype(np.float32),
        rays_d.reshape(-1, 3).astype(np.float32),
    )


def ndc_rays(
    H: int, W: int, focal: float, near: float, rays_o: torch.Tensor, rays_d: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterize forward-facing rays into NDC space [-1, 1]^3: shift
    origins to the near plane, then apply the projective map (LLFF)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
