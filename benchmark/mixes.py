"""The general traffic generator: everything a cell's mix needs, made from
the seed.  A mix is a data file, benchmark/traffic/<mix>.json (its "kind"
names the loop that drives it, benchmark/cells/<kind>.py); this module reads
it and makes:

  * a scene: random images at the mix's camera, poses on a sphere around
    the origin (Blender's spherical path) and COLMAP-style sparse depth a
    view (pixel coordinates, depths in (near, far), weights);
  * the served views' poses, and the rays of each view that the check
    compares.

Every seed gives the same sizes; the seed changes the values and the order
of the views.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

def sub_seeds(seed: int, n: int) -> List[int]:
    """n independent 32-bit seeds from one seed of any size."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def focal(camera: Dict) -> float:
    """The pinhole focal length of the camera's width and horizontal angle."""
    return 0.5 * camera["W"] / math.tan(0.5 * camera["camera_angle_x"])


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Blender-style camera-to-world on a sphere around the origin."""
    t = np.eye(4, dtype=np.float64)
    t[2, 3] = radius
    p, th = math.radians(phi), math.radians(theta)
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(p), -math.sin(p), 0],
                        [0, math.sin(p), math.cos(p), 0], [0, 0, 0, 1]])
    rot_theta = np.array([[math.cos(th), 0, -math.sin(th), 0], [0, 1, 0, 0],
                          [math.sin(th), 0, math.cos(th), 0], [0, 0, 0, 1]])
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
    return (flip @ rot_theta @ rot_phi @ t).astype(np.float32)


def path_poses(path: Dict) -> np.ndarray:
    """(n_poses, 4, 4): evenly spaced azimuths at one elevation and radius."""
    thetas = np.linspace(-180.0, 180.0, path["n_poses"] + 1)[:-1]
    return np.stack([pose_spherical(t, path["phi"], path["radius"]) for t in thetas])


def camera(traffic: Dict) -> Dict:
    """The mix's camera as the program takes it: H, W, focal, near, far."""
    cam = traffic["camera"]
    return dict(H=cam["H"], W=cam["W"], focal=focal(cam), near=cam["near"], far=cam["far"])


def make_scene(traffic: Dict, seed: int) -> Dict:
    """Images, poses and sparse depth of the mix's scene, from the seed,
    beside its camera."""
    cam, sc = traffic["camera"], traffic["scene"]
    H, W, n = cam["H"], cam["W"], sc["n_views"]
    rng = np.random.default_rng(seed)
    images = rng.random((n, H, W, 3), dtype=np.float32)
    poses = path_poses(dict(n_poses=n, phi=sc["phi"], radius=sc["radius"]))[:, :3, :4]
    n_pts = sc["depth_points_per_view"]
    depth = [{"coord": rng.uniform(0, [W, H], (n_pts, 2)).astype(np.float32),
              "depth": rng.uniform(cam["near"], cam["far"], n_pts).astype(np.float32),
              "weight": rng.random(n_pts, dtype=np.float32)} for _ in range(n)]
    return dict(images=images, poses=np.ascontiguousarray(poses), depth_gts=depth,
                **camera(traffic))


class Views:
    """The served views: the mix's path of poses, from a pose that the seed
    picks, one after another; and for each view the pixels that the check
    compares, drawn from the seed."""

    def __init__(self, traffic: Dict, start_seed: int, pick_seed: int):
        self.poses = path_poses(traffic["path"])
        self.start = start_seed % len(self.poses)
        self.rng = np.random.default_rng(pick_seed)
        cam = traffic["camera"]
        self.n_pixels = cam["H"] * cam["W"]
        self.per_view = traffic["compared_rays_per_view"]

    def pose(self, i: int) -> np.ndarray:
        return self.poses[(self.start + i) % len(self.poses)]

    def picks(self) -> np.ndarray:
        """The next view's compared pixels (flat indices), sorted."""
        return np.sort(self.rng.choice(self.n_pixels, self.per_view, replace=False,
                                       shuffle=False))
