"""COLMAP sparse-reconstruction binary/text parsers (host-side I/O).

A copy of cfnerf_tpu/data/colmap.py (plain numpy), kept in the port so that it
imports nothing of the JAX package.

Capability parity with the reference's colmapUtils/read_write_model.py
(cameras/images/points3D readers, qvec2rotmat) — written independently
against the public COLMAP file-format specification
(https://colmap.github.io/format.html):

  cameras.bin:  [n:u64] then per camera: id:i32, model_id:i32, w:u64, h:u64,
                params:f64[num_params(model)]
  images.bin:   [n:u64] then per image: id:i32, qvec:f64[4], tvec:f64[3],
                camera_id:i32, name:cstr, n_pts:u64, (x:f64, y:f64, id:i64)*
  points3D.bin: [n:u64] then per point: id:i64, xyz:f64[3], rgb:u8[3],
                error:f64, track_len:u64, (image_id:i32, point2D_idx:i32)*
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray          # (N, 2)
    point3D_ids: np.ndarray  # (N,)

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Hamilton-convention (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Inverse of qvec2rotmat (used by writers/tests)."""
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


def _read(fid, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fid.read(size))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            props = _read(f, "<idddddddi")
            img_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.dtype([("xy", "<f8", 2), ("id", "<i8")]))
            images[img_id] = Image(
                img_id, qvec, tvec, camera_id, name.decode("utf-8"),
                data["xy"].reshape(n_pts, 2).copy(), data["id"].copy(),
            )
    return images


def read_points3d_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid, x, y, z, r, g, b, err, track_len = _read(f, "<QdddBBBdQ")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.dtype([("im", "<i4"), ("pt", "<i4")]))
            points[pid] = Point3D(
                pid, np.array([x, y, z]), np.array([r, g, b]), err,
                track["im"].copy(), track["pt"].copy(),
            )
    return points


def read_cameras_text(path) -> Dict[int, Camera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        cams[cam_id] = Camera(cam_id, model, w, h, np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path) -> Dict[int, Image]:
    images = {}
    lines = [
        l.strip() for l in Path(path).read_text().splitlines()
        if l.strip() and not l.strip().startswith("#")
    ]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split()
        xys = np.array([[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)])
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)])
        if xys.size == 0:
            xys = xys.reshape(0, 2)
        images[img_id] = Image(img_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_points3d_text(path) -> Dict[int, Point3D]:
    points = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        p = line.split()
        pid = int(p[0])
        xyz = np.array([float(v) for v in p[1:4]])
        rgb = np.array([int(v) for v in p[4:7]])
        err = float(p[7])
        track = np.array([int(v) for v in p[8:]]).reshape(-1, 2)
        points[pid] = Point3D(pid, xyz, rgb, err, track[:, 0], track[:, 1])
    return points


def read_model(sparse_dir) -> Tuple[Dict[int, Camera], Dict[int, Image], Dict[int, Point3D]]:
    """Auto-detect binary vs text model files in a COLMAP sparse dir."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        return (
            read_cameras_binary(sparse_dir / "cameras.bin"),
            read_images_binary(sparse_dir / "images.bin"),
            read_points3d_binary(sparse_dir / "points3D.bin"),
        )
    return (
        read_cameras_text(sparse_dir / "cameras.txt"),
        read_images_text(sparse_dir / "images.txt"),
        read_points3d_text(sparse_dir / "points3D.txt"),
    )


# ---- dense workspace arrays (depth/normal maps) --------------------------- #

def read_dense_array(path) -> np.ndarray:
    """COLMAP dense .bin array (depth_maps/normal_maps): ASCII header
    "width&height&channels&" followed by row-major little-endian f32.
    Parity with the reference's colmapUtils/read_write_dense.py:40-88."""
    with open(path, "rb") as f:
        header = b""
        amps = 0
        while amps < 3:
            c = f.read(1)
            if not c:
                raise ValueError(f"truncated dense header in {path}")
            header += c
            if c == b"&":
                amps += 1
        w, h, ch = (int(x) for x in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(w * h * ch * 4), dtype="<f4")
    # stored transposed column-major relative to (h, w, ch)
    return data.reshape(ch, h, w).transpose(1, 2, 0).squeeze()


def write_dense_array(path, arr: np.ndarray) -> None:
    arr = np.atleast_3d(np.asarray(arr, dtype=np.float32))
    h, w, ch = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{ch}&".encode())
        f.write(arr.transpose(2, 0, 1).astype("<f4").tobytes())


# ---- writers (round-trip support for tests and dataset tooling) ---------- #

def write_images_binary(images: Dict[int, Image], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(points: Dict[int, Point3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<QdddBBBdQ", pt.id, *pt.xyz, *pt.rgb.astype(int), pt.error, len(pt.image_ids)))
            for im_id, p2d in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(im_id), int(p2d)))


def write_cameras_binary(cams: Dict[int, Camera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, CAMERA_MODEL_IDS[c.model], c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))
