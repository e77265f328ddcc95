"""COLMAP dense-fusion output IO: fused.ply + fused.ply.vis.

A copy of cfnerf_tpu/data/colmap_fused.py (plain numpy), kept in the port so that it
imports nothing of the JAX package.

Capability parity with the reference's colmapUtils/read_write_fused_vis.py:47-117
(dead in the reference — unimported — and dependent on pyntcloud+pandas,
neither of which this environment ships).  Reimplemented standalone and
vectorized:

  * fused.ply — binary little-endian PLY with per-point position, normal
    and uint8 color (COLMAP src/mvs/fusion.cc layout);
  * fused.ply.vis — uint64 point count, then per point a uint32 count of
    visible images followed by that many uint32 image indices
    (src/mvs/meshing.cc ReadDenseReconstruction).

Instead of the reference's per-point namedtuple list (one Python object per
point), points are returned as a struct-of-arrays dict — at dense-fusion
scale (millions of points) object lists are unusable.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def _read_ply_header(f) -> Tuple[int, List[Tuple[str, str]]]:
    """Returns (n_vertices, [(prop_name, dtype_str)]) for a binary-LE PLY."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    n = None
    props: List[Tuple[str, str]] = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.strip().decode().split()
        if not parts:
            continue
        if parts[0] == "format" and parts[1] != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {parts[1]}")
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            props.append((parts[2], _PLY_DTYPES[parts[1]][0]))
        elif parts[0] == "end_header":
            break
    if n is None:
        raise ValueError("PLY has no vertex element")
    return n, props


def read_fused(ply_path, vis_path) -> Dict[str, np.ndarray]:
    """Read a COLMAP dense reconstruction.

    Returns {"xyz" (N,3) f32, "normal" (N,3) f32, "color" (N,3) u8,
             "vis_count" (N,) i64, "vis_idx" (N,) object array of uint32
             visible-image index arrays}.
    """
    with open(ply_path, "rb") as f:
        n, props = _read_ply_header(f)
        dtype = np.dtype([(name, dt) for name, dt in props])
        rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)

    def cols(names, out_dtype):
        return np.stack([rec[c].astype(out_dtype) for c in names], -1)

    out = {
        "xyz": cols(("x", "y", "z"), np.float32),
        "normal": cols(("nx", "ny", "nz"), np.float32),
        "color": cols(("red", "green", "blue"), np.uint8),
    }

    with open(vis_path, "rb") as f:
        buf = f.read()
    (n_vis,) = struct.unpack_from("<Q", buf, 0)
    if n_vis != n:
        raise ValueError(f"fused.ply has {n} points but .vis has {n_vis}")
    # vectorized walk: the payload is uint32 words [c_0, idx..., c_1, idx...]
    # — counts sit at positions cumsum(c_i + 1); one frombuffer + np.split
    # instead of a per-point Python loop (millions of points at fusion scale)
    words = np.frombuffer(buf, dtype="<u4", offset=8)
    counts = np.empty(n, np.int64)
    pos = 0
    count_pos = np.empty(n, np.int64)
    for i in range(n):  # positions depend on prior counts — O(n) scalar walk
        count_pos[i] = pos
        counts[i] = words[pos]
        pos += 1 + counts[i]
    if pos != len(words):
        raise ValueError(
            f".vis payload has {len(words)} words, walk consumed {pos}"
        )
    keep = np.ones(len(words), bool)
    keep[count_pos] = False
    all_idx = words[keep]
    idx_lists = np.empty(n, object)
    for i, chunk in enumerate(np.split(all_idx, np.cumsum(counts)[:-1])):
        idx_lists[i] = chunk
    out["vis_count"] = counts
    out["vis_idx"] = idx_lists
    return out


def write_fused(points: Dict[str, np.ndarray], ply_path, vis_path) -> None:
    """Inverse of read_fused; writes COLMAP-compatible fused.ply(.vis)."""
    xyz = np.asarray(points["xyz"], np.float32)
    normal = np.asarray(points["normal"], np.float32)
    color = np.asarray(points["color"], np.uint8)
    n = xyz.shape[0]

    dtype = np.dtype(
        [(c, "<f4") for c in ("x", "y", "z", "nx", "ny", "nz")]
        + [(c, "u1") for c in ("red", "green", "blue")]
    )
    rec = np.empty(n, dtype)
    for j, c in enumerate(("x", "y", "z")):
        rec[c] = xyz[:, j]
    for j, c in enumerate(("nx", "ny", "nz")):
        rec[c] = normal[:, j]
    for j, c in enumerate(("red", "green", "blue")):
        rec[c] = color[:, j]

    with open(ply_path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for c in ("x", "y", "z", "nx", "ny", "nz"):
            f.write(f"property float {c}\n".encode())
        for c in ("red", "green", "blue"):
            f.write(f"property uchar {c}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())

    # vectorized interleave: counts and index runs laid out into one uint32
    # buffer (write positions are known up front, unlike the read path)
    counts = np.array([len(v) for v in points["vis_idx"]], np.int64)
    total = n + int(counts.sum())
    words = np.empty(total, "<u4")
    count_pos = np.concatenate([[0], np.cumsum(counts[:-1] + 1)]).astype(np.int64) if n else np.empty(0, np.int64)
    words[count_pos] = counts
    mask = np.ones(total, bool)
    mask[count_pos] = False
    if counts.sum():
        words[mask] = np.concatenate(
            [np.asarray(v, "<u4") for v in points["vis_idx"] if len(v)]
        )
    with open(vis_path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(words.tobytes())
