"""Generate the JPEG fixtures of the port's JPEG decoder and its LLFF path.

Writes, with Pillow (libjpeg-turbo) and deterministically:

  tests/fixtures/jpeg/*.jpg          small renders of the minicapture scene
                                     (scripts/make_fixture_capture.py) as
                                     JPEG variants: 4:4:4 / 4:2:2 / 4:2:0 x
                                     baseline / progressive at an odd and an
                                     even size, quality 50 and 95; grayscale;
                                     restart intervals; optimized Huffman
                                     tables; 16-bit quantization tables
                                     (SOF1); RGB without YCbCr (Adobe APP14
                                     transform 0); EXIF orientation 6; and
                                     photo_1mp.jpg, a 1152x864 render at
                                     quality 95 with a little sensor noise,
                                     for timing
  tests/fixtures/jpeg/golden.npz     imageio.v2.imread of each, by file stem;
                                     for the photo (1.1 MB compressed, past
                                     the fixtures' budget) its shape and the
                                     SHA-256 of its bytes instead
                                     (golden_digest)
  tests/fixtures/minicapture_jpg/    the minicapture scene built by the same
                                     generator, its 8 views saved as quality
                                     95 4:2:0 JPGs (images/img_NNN.jpg, named
                                     so in sparse/0/images.bin)
  tests/fixtures/minicapture_jpg_golden/images_2/
                                     the JAX loader's minify of it
                                     (cfnerf_tpu/data/llff.py:_minify,
                                     Pillow's Lanczos), kept outside the
                                     capture so that loading it still minifies

Regenerate (imports the JAX package for the capture's self-checks and the
golden minify):

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/make_jpeg_fixtures.py
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import make_fixture_capture as capture  # noqa: E402

JPEG_DIR = os.path.join(REPO, "tests", "fixtures", "jpeg")
CAPTURE_JPG = os.path.join(REPO, "tests", "fixtures", "minicapture_jpg")
CAPTURE_GOLDEN = os.path.join(REPO, "tests", "fixtures", "minicapture_jpg_golden")
PHOTO_SIZE = (864, 1152)  # (H, W): ~1 MP
PHOTO = "photo_1mp"
CAPTURE_QUALITY = 95


def render(H, W, view=0, noise=0.0, seed=0):
    """The minicapture scene from the rig's view, H x W pixels, focal scaled
    with the width; uint8 RGB."""
    from cfnerf_tpu.ops.rays import get_rays_np

    c2w = capture.rig_poses()[view]
    focal = capture.FOCAL * W / capture.W
    ro, rd = get_rays_np(H, W, focal, c2w)
    rgb, _ = capture.trace(ro, rd)
    rgb = rgb * 255
    if noise:
        rgb = rgb + np.random.RandomState(seed).normal(0, noise, rgb.shape)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def variants():
    """(stem, image, Pillow save options) of every small fixture."""
    from PIL import Image

    out = []
    for h, w in ((37, 53), (48, 64)):
        img = render(h, w, view=1)
        for sub in ("4:4:4", "4:2:2", "4:2:0"):
            for prog in (False, True):
                for q in (50, 95):
                    stem = (f"s{sub.replace(':', '')}_{'prog' if prog else 'base'}"
                            f"_q{q}_{w}x{h}")
                    out.append((stem, img, dict(quality=q, subsampling=sub, progressive=prog)))
    img = render(37, 53, view=2)
    gray = img.mean(-1).round().astype(np.uint8)
    out += [("gray_base_q75_53x37", gray, dict(quality=75)),
            ("gray_prog_q75_53x37", gray, dict(quality=75, progressive=True)),
            ("restart_blocks3_q80_53x37", img, dict(quality=80, restart_marker_blocks=3)),
            ("restart_rows1_420_q80_53x37", img,
             dict(quality=80, restart_marker_rows=1, subsampling="4:2:0")),
            ("restart_blocks2_prog_q80_53x37", img,
             dict(quality=80, restart_marker_blocks=2, progressive=True)),
            ("optimized_q90_53x37", img, dict(quality=90, optimize=True)),
            ("optimized_prog_q90_53x37", img, dict(quality=90, optimize=True, progressive=True)),
            # Pillow writes 16-bit tables (and SOF1) only for custom tables
            # above 255: quality alone stays baseline (8-bit) even at 1
            ("qtables16_53x37", img,
             dict(qtables=[[64 + 37 * i for i in range(64)], [300 + 500 * i for i in range(64)]])),
            ("rgb_adobe_q85_53x37", img, dict(quality=85, keep_rgb=True))]
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 CW to display
    out.append(("exif_orientation6_56x40", render(40, 56, view=3), dict(quality=90, exif=exif)))
    out.append((PHOTO, render(*PHOTO_SIZE, view=0, noise=1.0), dict(quality=95)))
    return out


def golden_digest(arr) -> np.ndarray:
    """SHA-256 of a uint8 array's bytes (C order), as 32 uint8."""
    arr = np.ascontiguousarray(arr, np.uint8)
    return np.frombuffer(hashlib.sha256(arr.tobytes()).digest(), np.uint8)


def write_jpeg_fixtures():
    import imageio.v2 as imageio
    from PIL import Image

    os.makedirs(JPEG_DIR, exist_ok=True)
    golden, fixtures = {}, variants()
    for stem, img, opts in fixtures:
        path = os.path.join(JPEG_DIR, stem + ".jpg")
        Image.fromarray(img).save(path, "JPEG", **opts)
        arr = imageio.imread(path)
        if stem == PHOTO:
            golden[stem + "_shape"] = np.array(arr.shape)
            golden[stem + "_sha256"] = golden_digest(arr)
        else:
            golden[stem] = arr
    np.savez_compressed(os.path.join(JPEG_DIR, "golden.npz"), **golden)
    total = sum(os.path.getsize(os.path.join(JPEG_DIR, f)) for f in os.listdir(JPEG_DIR))
    print(f"{len(fixtures)} JPEG fixtures in {JPEG_DIR}, {total} bytes with golden.npz")


def write_capture():
    """The minicapture generator's scene, its views re-encoded as JPG."""
    from PIL import Image

    from cfnerf_tpu.data.colmap import read_images_binary, write_images_binary
    from cfnerf_tpu.data.llff import _minify

    with tempfile.TemporaryDirectory() as tmp:
        png_root = os.path.join(tmp, "minicapture")
        capture.main(png_root)  # renders, poses, COLMAP files and self-checks
        shutil.rmtree(CAPTURE_JPG, ignore_errors=True)
        os.makedirs(os.path.join(CAPTURE_JPG, "images"))
        shutil.copytree(os.path.join(png_root, "sparse"), os.path.join(CAPTURE_JPG, "sparse"))
        shutil.copy(os.path.join(png_root, "poses_bounds.npy"), CAPTURE_JPG)
        for name in sorted(os.listdir(os.path.join(png_root, "images"))):
            im = Image.open(os.path.join(png_root, "images", name))
            stem = os.path.splitext(name)[0]
            im.convert("RGB").save(os.path.join(CAPTURE_JPG, "images", stem + ".jpg"), "JPEG",
                                   quality=CAPTURE_QUALITY, subsampling="4:2:0")
        images_bin = os.path.join(CAPTURE_JPG, "sparse", "0", "images.bin")
        records = read_images_binary(images_bin)
        write_images_binary({i: dataclasses.replace(im, name=os.path.splitext(im.name)[0]
                                                    + ".jpg")
                             for i, im in records.items()}, images_bin)
        with open(os.path.join(png_root, "manifest.json")) as f:
            manifest = json.load(f)
        manifest.update(generator="scripts/make_fixture_capture.py via "
                                  "scripts/make_jpeg_fixtures.py",
                        images=f"JPEG, quality {CAPTURE_QUALITY}, 4:2:0 (Pillow)")
        with open(os.path.join(CAPTURE_JPG, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

        # the golden minify: the JAX loader's _minify on a copy
        work = shutil.copytree(CAPTURE_JPG, os.path.join(tmp, "minicapture_jpg"))
        _minify(work, factors=[2])
        shutil.rmtree(CAPTURE_GOLDEN, ignore_errors=True)
        shutil.copytree(os.path.join(work, "images_2"), os.path.join(CAPTURE_GOLDEN, "images_2"))
    print(f"JPEG capture written to {CAPTURE_JPG}, its minify golden to {CAPTURE_GOLDEN}")


def main():
    write_jpeg_fixtures()
    write_capture()


if __name__ == "__main__":
    main()
