"""The port's data slice against the JAX package's and the libraries it
calls: the PNG reader and writer against imageio, the area resize against
cv2.INTER_AREA, the Lanczos resize against Pillow and the ImageMagick
goldens, the Blender and LLFF loaders, COLMAP depth and load_dataset
against cfnerf_tpu's, the COLMAP files, the pose math, the ray helpers and
the prefetcher's contract.  Every test works in tmp_path, on copies of the
fixtures."""
import dataclasses
import shutil
import struct
import sys
import time
import zlib
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from cfnerf_tpu.data import blender as jblender
from cfnerf_tpu.data import colmap as jcolmap
from cfnerf_tpu.data import colmap_fused as jfused
from cfnerf_tpu.data import llff as jllff
from cfnerf_tpu.data import poses as jposes
from cfnerf_tpu.ops import rays as jrays
from cfnerf_tpu.train import loop as jloop
from cfnerf_tpu.utils.config import parse_args as jparse
from cfnerf_torch.data import blender as tblender
from cfnerf_torch.data import colmap as tcolmap
from cfnerf_torch.data import colmap_fused as tfused
from cfnerf_torch.data import image_io
from cfnerf_torch.data import llff as tllff
from cfnerf_torch.data import poses as tposes
from cfnerf_torch.data.prefetch import BatchPrefetcher
from cfnerf_torch.ops import rays as trays
from cfnerf_torch.train import loop as tloop
from cfnerf_torch.utils.config import parse_args as tparse
from tests.datagen import make_blender_dataset

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
CAPTURE = FIXTURES / "minicapture"
# images through the two minify paths: within one LSB, the JAX package's
# own gate for its resampler (tests/test_data.py); area resize: 1e-6
IMG_ATOL = 1.0 / 255
AREA_ATOL = 1e-6


@pytest.fixture
def capture(tmp_path):
    """A fresh copy of the checked-in LLFF + COLMAP capture."""
    return Path(shutil.copytree(CAPTURE, tmp_path / "minicapture"))


def _smooth(shape, seed=0):
    """A smooth image with a little noise, as a photograph compresses."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
    c = shape[2] if len(shape) == 3 else 1
    img = np.stack([base + 20 * i for i in range(c)], -1).reshape(shape)
    return np.clip(img + rng.randint(0, 4, shape), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------- #
# PNG
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(p.name for p in (CAPTURE / "images").glob("*.png"))
                         + ["minify_src.png"])
def test_imread_png_matches_imageio_on_fixtures(name, tmp_path):
    src = CAPTURE / "images" / name if name.startswith("img_") else FIXTURES / name
    path = shutil.copy(src, tmp_path / name)
    want = imageio.imread(path)
    got = image_io.imread_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,dtype", [
    ((37, 41), np.uint8), ((37, 41, 2), np.uint8), ((37, 41, 3), np.uint8),
    ((37, 41, 4), np.uint8), ((37, 41), np.uint16),
], ids=["gray", "gray_alpha", "rgb", "rgba", "gray16"])
def test_imread_png_matches_imageio_on_what_imageio_writes(shape, dtype, tmp_path):
    img = _smooth(shape).astype(dtype)
    if dtype == np.uint16:
        img = img * 257 + np.arange(img.size, dtype=np.uint16).reshape(shape) % 200
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, img)
    got = image_io.imread_png(path)
    want = imageio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _write_with_filters(path, img, ctype, depth):
    """A PNG whose rows use the five filter types in turn (row i: type i %
    5), filtered byte by byte as the PNG specification writes it."""
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    H = img.shape[0]
    rows = rows.view(np.uint8).reshape(H, -1).astype(int)
    bpp = max(1, (img.shape[2] if img.ndim == 3 else 1) * depth // 8)
    out = bytearray()
    for r in range(H):
        t = r % 5
        out.append(t)
        for x in range(rows.shape[1]):
            a = rows[r, x - bpp] if x >= bpp else 0
            b = rows[r - 1, x] if r else 0
            c = rows[r - 1, x - bpp] if r and x >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[t]
            out.append((rows[r, x] - pred) % 256)
    W = img.shape[1]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("channels,depth", [(1, 8), (3, 8), (4, 8), (1, 16), (4, 16)])
def test_imread_png_undoes_every_filter_type(channels, depth, tmp_path):
    dtype = np.uint16 if depth == 16 else np.uint8
    img = _smooth((11, 9, channels)).astype(dtype)
    if depth == 16:
        img = img * 251 + 7
    img = img[..., 0] if channels == 1 else img
    path = str(tmp_path / "f.png")
    _write_with_filters(path, img, {1: 0, 3: 2, 4: 6}[channels], depth)
    got, want = image_io.imread_png(path), imageio.imread(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if dtype == np.uint8 or channels == 1:
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_imread_png_palette_matches_imageio(bits, tmp_path):
    path = str(tmp_path / "p.png")
    img = Image.fromarray(_smooth((29, 33, 3))).convert(
        "P", palette=Image.ADAPTIVE, colors=2 ** bits)
    img.save(path, bits=bits)
    np.testing.assert_array_equal(image_io.imread_png(path), imageio.imread(path))


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_imread_png_16_bit_colour_matches_imageio(channels, tmp_path):
    """Pillow decodes a 16-bit colour PNG to its high bytes (16-bit gray +
    alpha to RGBA): imread_png returns what imageio returns."""
    rng = np.random.RandomState(channels)
    img = (rng.rand(11, 13, channels) * 65535).astype(np.uint16)
    path = str(tmp_path / "c16.png")
    image_io.imwrite_png(path, img)
    got, want = image_io.imread_png(path), imageio.imread(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,dtype", [
    ((9, 7), np.uint8), ((9, 7, 2), np.uint8), ((9, 7, 3), np.uint8),
    ((9, 7, 4), np.uint8), ((9, 7), np.uint16),
])
def test_imwrite_png_round_trips_through_imageio(shape, dtype, tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(*shape) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "w.png")
    image_io.imwrite_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(image_io.imread_png(path), img)


def test_imread_png_refuses_interlaced_files(tmp_path):
    path = tmp_path / "i.png"
    image_io.imwrite_png(path, _smooth((8, 8, 3)))
    data = bytearray(path.read_bytes())
    ihdr = 8 + 8  # the IHDR body starts after the signature and its header
    data[ihdr + 12] = 1  # interlace method: Adam7
    data[ihdr + 13:ihdr + 17] = struct.pack(">I", zlib.crc32(bytes(data[ihdr - 4:ihdr + 13])))
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        image_io.imread_png(path)


def test_imread_reads_other_formats_through_imageio_or_names_the_file(tmp_path, monkeypatch):
    """A JPEG reads as imageio reads it, with imageio blocked on the port's
    side (the port decodes it itself); a file that is neither PNG nor JPEG
    raises, naming the file."""
    path = str(tmp_path / "photo.jpg")
    imageio.imwrite(path, _smooth((16, 24, 3)))
    want = imageio.imread(path)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)  # imageio not installed
    got = image_io.imread(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    other = tmp_path / "photo.bmp"
    Image.fromarray(_smooth((16, 24, 3))).save(other)
    with pytest.raises(ValueError, match="photo.bmp is neither a PNG nor a JPEG file"):
        image_io.imread(other)


# ---------------------------------------------------------------------- #
# resampling
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("size,new", [((800, 800), (400, 400)), ((801, 799), (400, 399)),
                                      ((90, 100), (47, 33))],
                         ids=["800_to_400", "801x799_to_400x399", "90x100_to_47x33"])
@pytest.mark.parametrize("channels", [0, 4])
def test_resize_area_matches_cv2(size, new, channels):
    W0, H0 = size
    shape = (H0, W0) + ((channels,) if channels else ())
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = image_io.resize_area(img, *new)
    want = cv2.resize(img, new, interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=AREA_ATOL)


def _pillow_lanczos(img, W, H):
    return np.asarray(Image.fromarray(img).convert("RGB").resize((W, H), Image.LANCZOS))


@pytest.mark.parametrize("size", [(64, 48), (32, 24), (128, 37), (17, 13)],
                         ids=["f2", "f4_32x24", "128x37", "17x13"])
def test_resize_lanczos_matches_pillow(size):
    src = imageio.imread(FIXTURES / "minify_src.png")
    got = image_io.resize_lanczos(src, *size)
    want = _pillow_lanczos(src, *size)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want)
    print(f"{size}: {int((diff > 0).sum())} of {diff.size} samples differ, max {diff.max()}")
    assert diff.max() <= 1


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "P", "I;16"])
def test_resize_lanczos_converts_to_rgb_as_pillow(mode, tmp_path):
    """Pillow's convert("RGB") first: gray repeated, alpha dropped, the
    palette expanded, 16-bit gray saturated; the input as imread gives it."""
    rgb = _smooth((30, 40, 3))
    if mode == "I;16":
        arr = rgb[..., 0].astype(np.uint16) * 2
        pil = Image.fromarray(arr)
    else:
        pil = Image.fromarray(rgb).convert(mode) if mode != "P" else \
            Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=64)
    path = str(tmp_path / "m.png")
    pil.save(path)
    arr = image_io.imread_png(path)
    want = np.asarray(Image.open(path).convert("RGB").resize((13, 11), Image.LANCZOS))
    np.testing.assert_array_equal(image_io.resize_lanczos(arr, 13, 11), want)


def test_minify_matches_pillow_and_the_imagemagick_goldens(tmp_path):
    """The port's _minify against the JAX package's (Pillow) and against
    the ImageMagick goldens, at the gates of tests/test_data.py."""
    outs = {}
    for name, mod in (("port", tllff), ("jax", jllff)):
        scene = tmp_path / name
        (scene / "images").mkdir(parents=True)
        shutil.copy(FIXTURES / "minify_src.png", scene / "images" / "img.png")
        mod._minify(str(scene), factors=[2, 4], resolutions=[(24, 32)])
        outs[name] = {d: imageio.imread(scene / d / "img.png")
                      for d in ("images_2", "images_4", "images_32x24")}
    for d, ours in outs["port"].items():
        diff = np.abs(ours.astype(np.int32) - outs["jax"][d])
        print(f"{d}: {int((diff > 0).sum())} samples differ from Pillow, max {diff.max()}")
        assert diff.max() <= 1
    for f, d in ((2, "images_2"), (4, "images_4"), (4, "images_32x24")):
        golden = imageio.imread(FIXTURES / f"minify_golden_f{f}.png")
        diff = np.abs(outs["port"][d].astype(np.int32) - golden)
        assert diff.max() <= 1, f"{d}: max LSB diff {diff.max()}"
        assert diff.mean() < 0.25, f"{d}: mean LSB diff {diff.mean()}"


# ---------------------------------------------------------------------- #
# loaders
# ---------------------------------------------------------------------- #


def _assert_tree_equal(got, want, atol=0.0, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_equal(got[k], want[k], atol, f"{what}/{k}")
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, atol, f"{what}[{i}]")
    elif atol:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)
        assert np.asarray(got).dtype == np.asarray(want).dtype, what


@pytest.mark.parametrize("H,W,half_res,testskip", [(16, 16, False, 1), (16, 16, True, 1),
                                                  (17, 15, True, 2)])
def test_blender_loader_matches_jax(H, W, half_res, testskip, tmp_path):
    root = make_blender_dataset(str(tmp_path / "lego"), H=H, W=W)
    got = tblender.load_blender_data(root, half_res, testskip)
    want = jblender.load_blender_data(root, half_res, testskip)
    _assert_tree_equal(got[0], want[0], atol=AREA_ATOL if half_res else 0.0, what="imgs")
    _assert_tree_equal(got[1:], want[1:], what="poses/render_poses/hwf/i_split")


def test_pose_spherical_and_ring_match_jax():
    np.testing.assert_array_equal(tblender.pose_spherical(30.0, -45.0, 4.0),
                                  jblender.pose_spherical(30.0, -45.0, 4.0))
    np.testing.assert_array_equal(tblender.spherical_render_ring(),
                                  jblender.spherical_render_ring())


@pytest.mark.parametrize("spherify", [False, True])
def test_llff_loader_matches_jax(spherify, tmp_path):
    roots = [shutil.copytree(CAPTURE, tmp_path / side) for side in ("port", "jax")]
    got = tllff.load_llff_data(str(roots[0]), factor=2, spherify=spherify)
    want = jllff.load_llff_data(str(roots[1]), factor=2, spherify=spherify)
    assert got[0].shape == (8, 48, 64, 3)
    _assert_tree_equal(got[0], want[0], atol=IMG_ATOL, what="images")
    _assert_tree_equal(got[1:], want[1:], what="poses/bds/render_poses/i_test")


def test_colmap_depth_matches_jax(capture, tmp_path):
    jroot = shutil.copytree(CAPTURE, tmp_path / "jax")
    got = tllff.load_colmap_depth(str(capture), factor=2)
    want = jllff.load_colmap_depth(str(jroot), factor=2)
    assert sum(len(d["depth"]) for d in got) > 0
    _assert_tree_equal(got, want, what="depth_gts")
    cached = np.load(capture / "colmap_depth.npy", allow_pickle=True)
    _assert_tree_equal(list(cached), got, what="colmap_depth.npy")
    np.testing.assert_array_equal(
        list(tllff._colmap_poses(tcolmap.read_images_binary(
            capture / "sparse" / "0" / "images.bin")).values()),
        list(jllff._colmap_poses(jcolmap.read_images_binary(
            capture / "sparse" / "0" / "images.bin")).values()))


@pytest.mark.parametrize("config", ["minicapture_ds.txt", "africa_ds.txt"])
def test_load_dataset_matches_jax(config, tmp_path):
    out = {}
    for side, parse, mod in (("port", tparse, tloop), ("jax", jparse, jloop)):
        root = shutil.copytree(CAPTURE, tmp_path / side)
        args = parse(["--config", str(ROOT / "configs" / config), "--datadir", str(root)])
        out[side] = mod.load_dataset(args)
    assert out["port"]["images"].shape[1:3] == (48, 64)
    if config == "africa_ds.txt":  # no_ndc: near and far from the bounds
        assert 0.0 < out["port"]["near"] < out["port"]["far"]
    else:  # NDC
        assert (out["port"]["near"], out["port"]["far"]) == (0.0, 1.0)
    assert sum(len(d["depth"]) for d in out["port"]["depth_gts"]) > 0
    _assert_tree_equal(out["port"]["images"], out["jax"]["images"], atol=IMG_ATOL)
    rest = lambda d: {k: v for k, v in d.items() if k != "images"}  # noqa: E731
    _assert_tree_equal(rest(out["port"]), rest(out["jax"]), what="scene")


def test_load_dataset_blender_white_background_matches_jax(tmp_path):
    root = make_blender_dataset(str(tmp_path / "lego"), H=12, W=12)
    out = []
    for parse, mod in ((tparse, tloop), (jparse, jloop)):
        args = parse(["--dataset_type", "blender", "--datadir", root, "--white_bkgd",
                      "--half_res", "--testskip", "1"])
        out.append(mod.load_dataset(args))
    _assert_tree_equal(out[0]["images"], out[1]["images"], atol=AREA_ATOL)
    rest = lambda d: {k: v for k, v in d.items() if k != "images"}  # noqa: E731
    _assert_tree_equal(rest(out[0]), rest(out[1]))


# ---------------------------------------------------------------------- #
# COLMAP files, poses, rays
# ---------------------------------------------------------------------- #


def _colmap_model(mod):
    rng = np.random.RandomState(1)
    cams = {1: mod.Camera(1, "PINHOLE", 640, 480, np.array([500.0, 500.0, 320.0, 240.0]))}
    images = {i: mod.Image(i, rng.randn(4), rng.randn(3), 1, f"img_{i}.png",
                           rng.rand(3, 2) * 100, np.array([10, -1, 11], dtype=np.int64))
              for i in (2, 1)}
    points = {10: mod.Point3D(10, rng.randn(3), np.array([10, 20, 30]), 0.5,
                              np.array([1, 2]), np.array([0, 0])),
              11: mod.Point3D(11, rng.randn(3), np.array([1, 2, 3]), 1.5,
                              np.array([1]), np.array([2]))}
    return cams, images, points


@pytest.mark.parametrize("writer,reader", [(tcolmap, jcolmap), (jcolmap, tcolmap)],
                         ids=["port_writes", "jax_writes"])
def test_colmap_binary_files_cross_read(writer, reader, tmp_path):
    cams, images, points = _colmap_model(writer)
    writer.write_cameras_binary(cams, tmp_path / "cameras.bin")
    writer.write_images_binary(images, tmp_path / "images.bin")
    writer.write_points3d_binary(points, tmp_path / "points3D.bin")
    rng = np.random.RandomState(3)
    depth = rng.rand(6, 9).astype(np.float32)
    writer.write_dense_array(tmp_path / "depth.bin", depth)
    got = reader.read_model(tmp_path)
    for want_map, got_map in zip((cams, images, points), got):
        assert set(got_map) == set(want_map)
        for k, w in want_map.items():
            for field in dataclasses.fields(w):
                np.testing.assert_array_equal(getattr(got_map[k], field.name),
                                              getattr(w, field.name), err_msg=field.name)
    np.testing.assert_array_equal(reader.read_dense_array(tmp_path / "depth.bin"), depth)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qvec_rotmat_match_jax(seed):
    q = np.random.RandomState(seed).randn(4)
    q /= np.linalg.norm(q)
    R = tcolmap.qvec2rotmat(q)
    np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
    np.testing.assert_array_equal(tcolmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))


@pytest.mark.parametrize("writer,reader", [(tfused, jfused), (jfused, tfused)],
                         ids=["port_writes", "jax_writes"])
def test_fused_ply_cross_read(writer, reader, tmp_path):
    rng = np.random.RandomState(0)
    pts = {"xyz": rng.randn(13, 3).astype(np.float32),
           "normal": rng.randn(13, 3).astype(np.float32),
           "color": rng.randint(0, 256, (13, 3), dtype=np.uint8),
           "vis_idx": np.array([rng.randint(0, 40, rng.randint(0, 6)).astype(np.uint32)
                                for _ in range(13)], object)}
    ply, vis = str(tmp_path / "fused.ply"), str(tmp_path / "fused.ply.vis")
    writer.write_fused(pts, ply, vis)
    got, want = reader.read_fused(ply, vis), jfused.read_fused(ply, vis)
    assert set(got) == set(want)
    for k in ("xyz", "normal", "color", "vis_count"):
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(got["vis_idx"], pts["vis_idx"]):
        np.testing.assert_array_equal(a, b)


def _random_poses(n=9, seed=0):
    """Plausible c2w (N, 3, 5) poses: orthonormal rotations, offsets, hwf."""
    rng = np.random.RandomState(seed)
    mats = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        origin = rng.randn(3) * 2 + np.array([0.0, 0.0, 4.0])
        mats.append(np.concatenate([q, origin[:, None], [[24.0], [32.0], [30.0]]], 1))
    return np.stack(mats)


def _ring_poses(n=11, seed=3):
    """An inward-facing ring (what spherify_poses expects) and its bounds."""
    rng = np.random.RandomState(seed)
    mats = []
    for i in range(n):
        th = 2 * np.pi * i / n + rng.randn() * 0.05
        origin = np.array([3.1 * np.cos(th), 3.1 * np.sin(th), 1.2 + rng.randn() * 0.1])
        bwd = origin / np.linalg.norm(origin)
        x = np.cross([0.0, 0.0, -1.0], bwd)
        x /= np.linalg.norm(x)
        mats.append(np.concatenate([np.stack([x, np.cross(bwd, x), bwd], 1),
                                    origin[:, None], [[24.0], [32.0], [30.0]]], 1))
    return np.stack(mats), np.abs(rng.randn(n, 2)) + np.array([1.0, 6.0])


def _spiral_args(mod):
    p = _random_poses(seed=2)
    up = mod._unit(p[:, :3, 1].sum(0))
    return (mod.average_pose(p), up, np.percentile(np.abs(p[:, :3, 3]), 90, 0), 2.5, 0.3,
            0.5, 2, 30)


POSE_CASES = {
    "unit": lambda m: m._unit(np.array([3.0, -4.0, 12.0])),
    "to_homogeneous": lambda m: m.to_homogeneous(_random_poses()),
    "camera_frame": lambda m: m.camera_frame(np.array([0.2, 0.1, 1.0]),
                                             np.array([0.0, 1.0, 0.1]), np.ones(3)),
    "average_pose": lambda m: m.average_pose(_random_poses()),
    "recenter_poses": lambda m: m.recenter_poses(_random_poses(seed=1)),
    "recenter_poses_f32": lambda m: m.recenter_poses(_random_poses(seed=1).astype(np.float32)),
    "spiral_path": lambda m: m.spiral_path(*_spiral_args(m)),
    "nearest_point_to_rays": lambda m: m.nearest_point_to_rays(
        _random_poses()[:, :3, 3:4], _random_poses()[:, :3, 2:3]),
    "spherify_poses": lambda m: m.spherify_poses(*_ring_poses()),
}


@pytest.mark.parametrize("case", list(POSE_CASES))
def test_pose_functions_match_jax(case):
    _assert_tree_equal(POSE_CASES[case](tposes), POSE_CASES[case](jposes), what=case)


def test_ray_helpers_match_jax():
    K = np.array([[50.0, 0, 15.5], [0, 52.0, 11.0], [0, 0, 1]], np.float32)
    got, want = trays.get_ray_directions(23, 31, K), jrays.get_ray_directions(23, 31, K)
    assert got.dtype == want.dtype and got.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, want)
    c2w = _random_poses()[0, :3, :4].astype(np.float32)
    for a, b in zip(trays.get_rays_phototourism(got, c2w),
                    jrays.get_rays_phototourism(want, c2w)):
        assert a.dtype == b.dtype == np.float32 and a.shape == (23 * 31, 3)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------- #
# prefetch (tests/test_prefetch.py's contract, on the CPU)
# ---------------------------------------------------------------------- #


def test_prefetch_order_and_values():
    pf = BatchPrefetcher(lambda step: {"x": np.full(3, step)}, start_step=10, device="cpu")
    try:
        for want in (11, 12, 13, 14):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["x"], np.full(3, want))
    finally:
        pf.close()


def test_prefetch_overlap_hides_host_latency():
    def slow_make(step):
        time.sleep(0.02)
        return step

    pf = BatchPrefetcher(slow_make, start_step=0, device="cpu")
    try:
        pf.next()
        t0 = time.perf_counter()
        for _ in range(10):
            pf.next()
            time.sleep(0.02)
        elapsed = time.perf_counter() - t0
    finally:
        pf.close()
    assert elapsed < 10 * 0.04 * 0.8, f"no overlap: {elapsed:.3f}s"


def test_prefetch_worker_error_surfaces():
    def bad(step):
        raise RuntimeError("boom")

    pf = BatchPrefetcher(bad, start_step=0, device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        pf.next()
    pf.close()


def test_prefetch_close_joins():
    pf = BatchPrefetcher(lambda s: s, start_step=0, device="cpu")
    pf.next()
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchPrefetcher(lambda s: s, start_step=0)
