"""Camera-pose geometry for LLFF-style capture rigs (host-side numpy).

A copy of cfnerf_tpu/data/poses.py (plain numpy), kept in the port so that it
imports nothing of the JAX package.

Functional parity with the pose math in the reference's load_llff.py
(normalize/viewmatrix/poses_avg :120-156, recenter_poses :171-183,
render_path_spiral :158-167, spherify_poses :219-275) — that code is
upstream LLFF/nerf-pytorch math whose numeric outputs must match exactly
for pose parity, so the FORMULAS are pinned (by golden tests in
tests/test_pose_parity.py against the live reference), while the
implementation here is restructured: homogeneous-matrix helpers, vectorized
ring/spiral generation (the reference builds 120 ring poses in a Python
loop), and explicit naming of the two distinct orthonormal-frame
conventions the original interleaves.

Pose convention throughout: (3, 4) or (3, 5) camera-to-world matrices with
columns [right | up | backward | origin (| hwf)] (OpenGL-style, the
convention nerf-pytorch inherits from the original LLFF release).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def to_homogeneous(p: np.ndarray) -> np.ndarray:
    """(..., 3, 4) -> (..., 4, 4) by appending the [0 0 0 1] row."""
    bottom = np.broadcast_to(
        np.array([0.0, 0.0, 0.0, 1.0], p.dtype), (*p.shape[:-2], 1, 4)
    )
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def camera_frame(backward: np.ndarray, up_hint: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """Orthonormal c2w frame from a view direction and an approximate up.

    right = up_hint x backward, then up re-orthogonalized — the 'viewmatrix'
    convention used for averaging and spiral paths.
    Returns (3, 4) [right | up | backward | origin].
    """
    bwd = _unit(backward)
    right = _unit(np.cross(up_hint, bwd))
    up = _unit(np.cross(bwd, right))
    return np.stack([right, up, bwd, origin], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Central tendency of a pose set: mean origin, summed view/up axes.

    poses: (N, 3, 5); returns (3, 5) with the hwf column of pose 0.
    """
    hwf = poses[0, :3, -1:]
    origin = poses[:, :3, 3].mean(0)
    backward = _unit(poses[:, :3, 2].sum(0))
    up_hint = poses[:, :3, 1].sum(0)
    return np.concatenate([camera_frame(backward, up_hint, origin), hwf], 1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Re-express all poses relative to their average (world frame moves to
    the rig centroid).  poses: (N, 3, 5); hwf column preserved."""
    out = poses.copy()
    ref = to_homogeneous(average_pose(poses)[None, :3, :4])
    world_fix = np.linalg.inv(ref)
    out[:, :3, :4] = (world_fix @ to_homogeneous(poses[:, :3, :4]))[:, :3, :4]
    return out


def spiral_path(
    c2w: np.ndarray,
    up: np.ndarray,
    radii: np.ndarray,
    focal: float,
    zdelta: float,
    zrate: float,
    rots: int,
    n_frames: int,
) -> List[np.ndarray]:
    """Spiral render path around a central pose, all frames looking at a
    point `focal` units in front of the center.  (zdelta is accepted for
    signature parity; the reference computes but never uses it.)

    Camera origins are generated vectorized: offsets in the central camera's
    frame trace [cos th, -sin th, -sin(th*zrate)] * radii.
    """
    theta = np.linspace(0.0, 2.0 * np.pi * rots, n_frames + 1)[:-1]
    scale = np.asarray(list(radii) + [1.0])
    offsets = (
        np.stack(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), np.ones_like(theta)],
            axis=-1,
        )
        * scale
    )  # (n_frames, 4)
    origins = offsets @ c2w[:3, :4].T  # (n_frames, 3)
    look_at = c2w[:3, :4] @ np.array([0.0, 0.0, -focal, 1.0])
    hwf = c2w[:, 4:5]
    return [
        np.concatenate([camera_frame(o - look_at, up, o), hwf], 1) for o in origins
    ]


def nearest_point_to_rays(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares 3D point minimizing summed squared distance to a ray
    bundle.  origins, dirs: (N, 3, 1).  Used to find the 'focus' of an
    inward-facing capture."""
    proj = np.eye(3) - dirs * np.swapaxes(dirs, -1, -2)  # (N, 3, 3)
    rhs = -proj @ origins
    normal = (np.swapaxes(proj, -1, -2) @ proj).mean(0)
    return np.squeeze(-np.linalg.inv(normal) @ rhs.mean(0))


def _ring_frames(origins: np.ndarray) -> np.ndarray:
    """c2w frames for ring cameras looking at the world origin with world
    -z as up.  NOTE: this is the reference ring convention (flows from
    load_llff.py:254-260), which is a DIFFERENT cross-product order than
    camera_frame: x = backward x up, y = backward x x.  origins: (M, 3);
    returns (M, 3, 4)."""
    up = np.array([0.0, 0.0, -1.0])
    bwd = origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    x = np.cross(bwd, up)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(bwd, x)
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    return np.stack([x, y, bwd, origins], axis=2)


def spherify_poses(
    poses: np.ndarray, bds: np.ndarray, n_ring: int = 120
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalize an inward-facing (360-degree) capture onto the unit sphere
    and generate a circular render path at the captures' mean height.

    Steps: find the focus point of all view rays; rotate the world so the
    mean camera offset becomes +z; rescale so the mean camera distance is 1;
    place n_ring cameras on the horizontal circle through the camera
    centroid, looking at the origin.

    poses: (N, 3, 5); bds: (N, 2).
    Returns (poses_reset (N, 3, 5), ring_poses (n_ring, 3, 5), bds).
    """
    view_dirs = poses[:, :3, 2:3]
    origins = poses[:, :3, 3:4]
    focus = nearest_point_to_rays(origins, view_dirs)

    # world rotation: z toward the mean camera offset (arbitrary-seed cross
    # products fix the remaining in-plane rotation; the [.1 .2 .3] seed is
    # load_llff.py:241's and must match for bit parity)
    z_axis = _unit((poses[:, :3, 3] - focus).mean(0))
    x_axis = _unit(np.cross([0.1, 0.2, 0.3], z_axis))
    y_axis = _unit(np.cross(z_axis, x_axis))
    world = np.stack([x_axis, y_axis, z_axis, focus], 1)  # (3, 4)

    poses_reset = (
        np.linalg.inv(to_homogeneous(world[None])) @ to_homogeneous(poses[:, :3, :4])
    )
    mean_dist = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    scale = 1.0 / mean_dist
    poses_reset[:, :3, 3] *= scale
    bds = bds * scale

    height = poses_reset[:, :3, 3].mean(0)[2]
    ring_radius = np.sqrt(1.0 - height ** 2)  # mean camera distance is now 1
    theta = np.linspace(0.0, 2.0 * np.pi, n_ring)
    ring_origins = np.stack(
        [ring_radius * np.cos(theta), ring_radius * np.sin(theta),
         np.full_like(theta, height)], axis=-1,
    )
    ring = _ring_frames(ring_origins)  # (n_ring, 3, 4)

    hwf = poses[0, :3, -1:]
    ring_poses = np.concatenate(
        [ring, np.broadcast_to(hwf, (*ring.shape[:-1], 1))], -1
    )
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(hwf, (*poses_reset[:, :3, :1].shape[:-1], 1))],
        -1,
    )
    return poses_reset, ring_poses, bds
