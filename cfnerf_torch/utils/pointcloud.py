"""PLY point-cloud export; counterpart of cfnerf_tpu/utils/pointcloud.py
(the reference's write_pointcloud, plot_snippets.py:39-67: binary
little-endian PLY with uint8 colours per vertex, and the uncertainty cloud:
a rendered depth map back-projected to world space, coloured by its
per-pixel uncertainty through JET).

The files are byte for byte the JAX package's.  The vertices are packed
with one numpy structured array instead of a struct.pack per vertex, and
the JET colours come from utils/colormap.py instead of cv2.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from cfnerf_torch.utils.colormap import apply_colormap

_VERTEX = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])  # 15 bytes, packed


def write_pointcloud(filename: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None) -> None:
    """Binary PLY writer. xyz: (N, 3) float; rgb: (N, 3) uint8 (default white)."""
    assert xyz.ndim == 2 and xyz.shape[1] == 3, "xyz must be (N, 3)"
    if rgb is None:
        rgb = np.full(xyz.shape, 255, dtype=np.uint8)
    assert rgb.shape == xyz.shape
    vertices = np.empty(xyz.shape[0], _VERTEX)
    vertices["xyz"] = xyz
    vertices["rgb"] = rgb.astype(np.uint8)

    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(f"element vertex {xyz.shape[0]}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(b"end_header\n")
        f.write(vertices.tobytes())


def read_pointcloud(filename: str):
    """Minimal binary-PLY reader of write_pointcloud's layout; returns
    (xyz (N, 3) float32, rgb (N, 3) uint8)."""
    with open(filename, "rb") as f:
        n = None
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            if line == b"end_header":
                break
        data = np.frombuffer(f.read(n * _VERTEX.itemsize), dtype=_VERTEX)
    return data["xyz"].copy(), data["rgb"].copy()


def depth_uncertainty_pointcloud(
    filename: str,
    depth: np.ndarray,        # (H, W)
    uncertainty: np.ndarray,  # (H, W)
    c2w: np.ndarray,          # (3, 4)
    focal: float,
    *,
    rgb: Optional[np.ndarray] = None,  # (H, W, 3) in [0,1]; overrides heatmap
    mask: Optional[np.ndarray] = None,
) -> None:
    """Back-project a rendered depth map to world space and write a PLY whose
    colours encode per-pixel uncertainty (JET) or the rendered RGB."""
    H, W = depth.shape
    i, j = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -np.ones_like(i)], -1)
    rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    xyz = c2w[:3, -1] + rays_d * depth[..., None]

    if rgb is not None:
        colors = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    else:
        u8 = (np.clip(uncertainty / (uncertainty.max() + 1e-8), 0, 1) * 255).astype(np.uint8)
        colors = apply_colormap(u8, "jet")

    xyz = xyz.reshape(-1, 3)
    colors = colors.reshape(-1, 3)
    if mask is not None:
        keep = mask.reshape(-1)
        xyz, colors = xyz[keep], colors[keep]
    write_pointcloud(filename, xyz, colors)
