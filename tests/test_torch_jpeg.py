"""The port's JPEG decoder (cfnerf_torch/data/jpeg.py) against imageio /
Pillow (libjpeg-turbo), bit for bit: a matrix of files Pillow writes here,
the checked-in fixtures and their goldens, a hypothesis search, streams
written by a small baseline encoder below (4:4:0, coefficients past 16
bits, component-id colour spaces, sampling the port refuses); image_shape;
the refusals; and the LLFF loader on the checked-in JPEG capture against
the JAX package's.  Every port call runs with imageio, Pillow and cv2
blocked, as on the card."""
import contextlib
import hashlib
import io
import shutil
import struct
import sys
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from cfnerf_tpu.data import llff as jllff
from cfnerf_tpu.train import loop as jloop
from cfnerf_tpu.utils.config import parse_args as jparse
from cfnerf_torch.data import image_io
from cfnerf_torch.data import jpeg
from cfnerf_torch.data import llff as tllff
from cfnerf_torch.train import loop as tloop
from cfnerf_torch.utils.config import parse_args as tparse
from tests.test_torch_data_io import _assert_tree_equal

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
JPEG_FIXTURES = FIXTURES / "jpeg"
CAPTURE_JPG = FIXTURES / "minicapture_jpg"
CAPTURE_GOLDEN = FIXTURES / "minicapture_jpg_golden" / "images_2"
BLOCKED = ("imageio", "imageio.v2", "PIL", "PIL.Image", "cv2")


@contextlib.contextmanager
def no_image_libraries():
    """imageio, Pillow and cv2 unimportable, as on the card."""
    with pytest.MonkeyPatch.context() as mp:
        for name in BLOCKED:
            mp.setitem(sys.modules, name, None)
        yield


def port_read(path):
    with no_image_libraries():
        return jpeg.imread_jpeg(path)


def _photo(h, w, seed=0, channels=3):
    """Smooth colour fields with noise: what a photograph compresses like."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 5.0 + i) * np.cos(yy / 7.0 - i) for i in range(channels)],
                    -1) * 90 + 128
    img = np.clip(base + rng.randint(-30, 30, (h, w, channels)), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _save(path, img, **opts):
    Image.fromarray(img).save(path, "JPEG", **opts)
    return imageio.imread(path)


def _assert_same(got, want, what=""):
    assert got.dtype == want.dtype == np.uint8, what
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------- #
# against imageio on files Pillow writes here
# ---------------------------------------------------------------------- #

SIZES = [(1, 1), (8, 8), (7, 9), (16, 16), (17, 33), (96, 128), (97, 131)]


@pytest.mark.parametrize("quality", [1, 10, 50, 95, 100])
@pytest.mark.parametrize("optimize", [False, True], ids=["std", "optimized"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_imread_jpeg_matches_imageio(subsampling, progressive, optimize, quality, tmp_path):
    for i, (h, w) in enumerate(SIZES):
        path = tmp_path / f"{h}x{w}.jpg"
        want = _save(path, _photo(h, w, seed=i), quality=quality, subsampling=subsampling,
                     progressive=progressive, optimize=optimize)
        _assert_same(port_read(path), want, f"{h}x{w}")


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_imread_jpeg_grayscale_matches_imageio(progressive, tmp_path):
    for i, (h, w) in enumerate(SIZES):
        path = tmp_path / f"{h}x{w}.jpg"
        want = _save(path, _photo(h, w, seed=i, channels=1), quality=75,
                     progressive=progressive)
        assert want.shape == (h, w)
        _assert_same(port_read(path), want, f"{h}x{w}")


@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1),
                                     dict(restart_marker_rows=2)],
                         ids=["blocks1", "blocks3", "rows1", "rows2"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_imread_jpeg_restart_markers_match_imageio(restart, progressive, tmp_path):
    for subsampling in ("4:4:4", "4:2:0"):
        path = tmp_path / f"{subsampling.replace(':', '')}.jpg"
        want = _save(path, _photo(97, 131), quality=80, subsampling=subsampling,
                     progressive=progressive, **restart)
        assert b"\xff\xdd" in path.read_bytes()  # a DRI segment
        _assert_same(port_read(path), want, subsampling)


@pytest.mark.parametrize("qtables", [
    [[64 + 37 * i for i in range(64)], [300 + 500 * i for i in range(64)]],
    [[1000] * 64, [32767] * 64],
], ids=["ramp", "flat_max"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_imread_jpeg_16_bit_quantization_tables_match_imageio(qtables, progressive, tmp_path):
    """Pillow writes 16-bit tables (Pq = 1, and SOF1 or SOF2) only for
    custom tables above 255: from quality alone it forces baseline tables
    (at most 255), even at quality 1."""
    path = tmp_path / "q16.jpg"
    want = _save(path, _photo(97, 131), qtables=qtables, progressive=progressive)
    data = path.read_bytes()
    assert b"\xff\xdb\x00\x83\x10" in data  # a DQT of one 16-bit table (2 + 1 + 128)
    assert (b"\xff\xc2" if progressive else b"\xff\xc1") in data
    _assert_same(port_read(path), want)


def test_imread_jpeg_rgb_without_ycbcr_and_exif_orientation_match_imageio(tmp_path):
    rgb = tmp_path / "rgb.jpg"  # Adobe APP14, transform 0, component ids R, G, B
    want = _save(rgb, _photo(37, 53), quality=85, keep_rgb=True)
    assert b"Adobe" in rgb.read_bytes()
    _assert_same(port_read(rgb), want, "keep_rgb")
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 CW to display: neither imageio nor the port applies it
    rotated = tmp_path / "exif.jpg"
    want = _save(rotated, _photo(40, 56), quality=90, exif=exif)
    assert want.shape == (40, 56, 3)
    _assert_same(port_read(rotated), want, "exif orientation 6")


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(1, 100),
       subsampling=st.sampled_from(["4:4:4", "4:2:2", "4:2:0"]), progressive=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_imread_jpeg_matches_imageio_hypothesis(h, w, quality, subsampling, progressive, seed):
    buf = io.BytesIO()
    Image.fromarray(_photo(h, w, seed=seed)).save(buf, "JPEG", quality=quality,
                                                  subsampling=subsampling,
                                                  progressive=progressive)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
    with no_image_libraries():
        got = jpeg.decode(buf.getvalue())
    _assert_same(got, want)


def test_fill_bytes_and_bytes_after_eoi_are_ignored_as_pillow_ignores_them(tmp_path):
    path = tmp_path / "r.jpg"
    _save(path, _photo(40, 48), quality=80, restart_marker_blocks=2)
    data = path.read_bytes()
    dqt, rst = data.index(b"\xff\xdb"), data.index(b"\xff\xd1")
    padded = (data[:dqt] + b"\xff\xff" + data[dqt:rst] + b"\xff\xff\xff" + data[rst:-2]
              + b"\xff\xff" + data[-2:] + b"trailing bytes\x00\xff")
    want = _pillow(data)
    _assert_same(_pillow(padded), want)
    _assert_same(_port(padded), want)


# ---------------------------------------------------------------------- #
# the checked-in fixtures
# ---------------------------------------------------------------------- #

FIXTURE_FILES = sorted(p.name for p in JPEG_FIXTURES.glob("*.jpg"))


def _golden_holds(golden, stem, arr):
    """The fixture's golden: its array, or (the 1 MP photo) its shape and
    the SHA-256 of its bytes."""
    if stem in golden:
        return arr.dtype == golden[stem].dtype and np.array_equal(arr, golden[stem])
    return (arr.dtype == np.uint8 and tuple(golden[stem + "_shape"]) == arr.shape
            and hashlib.sha256(np.ascontiguousarray(arr).tobytes()).digest()
            == golden[stem + "_sha256"].tobytes())


def test_fixture_set_is_whole():
    assert len(FIXTURE_FILES) == 35
    total = sum(p.stat().st_size for p in JPEG_FIXTURES.iterdir())
    assert total < 1.5e6
    assert (JPEG_FIXTURES / "photo_1mp.jpg").stat().st_size <= 700_000


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_imread_jpeg_matches_the_checked_in_goldens(name):
    path = JPEG_FIXTURES / name
    golden = np.load(JPEG_FIXTURES / "golden.npz")
    got = port_read(path)
    assert _golden_holds(golden, name[:-4], got), name
    _assert_same(got, imageio.imread(path), name)  # the golden is still imageio's
    with no_image_libraries():
        assert image_io.image_shape(path) == got.shape


# ---------------------------------------------------------------------- #
# streams from a small baseline encoder: what Pillow cannot write
# ---------------------------------------------------------------------- #


def _std_tables():
    """libjpeg's standard Huffman tables, from a file Pillow writes."""
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "JPEG", quality=50)
    data, out, i = buf.getvalue(), {}, 2
    while data[i + 1] != 0xDA:
        (length,) = struct.unpack(">H", data[i + 2:i + 4])
        if data[i + 1] == 0xC4:
            body, p = data[i + 4:i + 2 + length], 0
            while p < len(body):
                counts = list(body[p + 1:p + 17])
                n = sum(counts)
                out[body[p] >> 4, body[p] & 15] = (counts, list(body[p + 17:p + 17 + n]))
                p += 17 + n
        i += 2 + length
    return out


def _codes(counts, symbols):
    code, k, out = 0, 0, {}
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode(comps, H, W, blocks, qtables, app0=True, adobe=None):
    """A baseline (or, with a table above 255, extended) JPEG of quantized
    coefficient blocks: comps [(id, h, v, table)], blocks per component
    (rows, cols, 64) in natural order over the MCU-padded grid; one
    interleaved scan (or one block an MCU for one component) with the
    standard tables, luma tables for the first component."""
    tables = _std_tables()
    dc = [_codes(*tables[0, t]) for t in (0, 1)]
    ac = [_codes(*tables[1, t]) for t in (0, 1)]
    out = bytearray(b"\xff\xd8")
    if app0:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    wide = any(np.max(q) > 255 for q in qtables.values())
    for t, q in qtables.items():
        zz = np.asarray(q)[jpeg.NATURAL]
        out += _segment(0xDB, bytes([t | (0x10 if wide else 0)])
                        + zz.astype(">u2" if wide else np.uint8).tobytes())
    sof = struct.pack(">BHHB", 8, H, W, len(comps))
    for cid, h, v, t in comps:
        sof += bytes([cid, (h << 4) | v, t])
    out += _segment(0xC1 if wide else 0xC0, sof)
    for (tc, th), (counts, symbols) in sorted(tables.items()):
        out += _segment(0xC4, bytes([(tc << 4) | th] + counts + symbols))
    sos = bytes([len(comps)])
    for i, (cid, *_) in enumerate(comps):
        sos += bytes([cid, 0x11 if i else 0x00])
    out += _segment(0xDA, sos + b"\x00\x3f\x00")

    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    if len(comps) == 1:
        h, v = comps[0][1:3]
        bx, by = -(-(-(-W * h // hmax)) // 8), -(-(-(-H * v // vmax)) // 8)
        order = [(0, r, c) for r in range(by) for c in range(bx)]
    else:
        order = [(i, my * c[2] + v, mx * c[1] + h) for my in range(mcuy) for mx in range(mcux)
                 for i, c in enumerate(comps) for v in range(c[2]) for h in range(c[1])]
    bits, nbits, data, pred = 0, 0, bytearray(), [0] * len(comps)

    def put(code, n):
        nonlocal bits, nbits
        bits, nbits = (bits << n) | code, nbits + n
        while nbits >= 8:
            nbits -= 8
            data.append((bits >> nbits) & 255)
            if data[-1] == 0xFF:
                data.append(0)
        bits &= (1 << nbits) - 1

    def magnitude(v):
        s = abs(v).bit_length()
        return s, v if v >= 0 else v + (1 << s) - 1

    for i, r, c in order:
        zz = np.asarray(blocks[i][r, c])[jpeg.NATURAL].tolist()
        t = min(i, 1)
        s, m = magnitude(zz[0] - pred[i])
        pred[i] = zz[0]
        put(*dc[t][s])
        put(m, s)
        last = max([k for k in range(1, 64) if zz[k]], default=0)
        run = 0
        for k in range(1, last + 1):
            if not zz[k]:
                run += 1
                continue
            while run > 15:
                put(*ac[t][0xF0])
                run -= 16
            s, m = magnitude(zz[k])
            put(*ac[t][(run << 4) | s])
            put(m, s)
            run = 0
        if last < 63:
            put(*ac[t][0x00])
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)
    return bytes(out + data + b"\xff\xd9")


def _random_blocks(rng, comps, H, W, dc=60, ac=4, n_ac=5):
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    out = []
    for _, h, v, _ in comps:
        b = np.zeros((mcuy * v, mcux * h, 64), np.int64)
        b[..., 0] = rng.randint(-dc, dc + 1, b.shape[:2])
        b[..., 1:1 + n_ac] = rng.randint(-ac, ac + 1, b.shape[:2] + (n_ac,))
        out.append(b)
    return out


def _pillow(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _port(data):
    with no_image_libraries():
        return jpeg.decode(data)


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (3, 40), (17, 33), (97, 131)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("luma", [(1, 2), (2, 1), (2, 2)], ids=["440", "422", "420"])
def test_upsampling_matches_pillow_on_encoded_streams(luma, size):
    """4:4:0 (h1v2_fancy_upsample) only this way: Pillow writes no 4:4:0."""
    rng = np.random.RandomState(sum(size) + luma[0])
    comps = [(1, *luma, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    data = encode(comps, *size, _random_blocks(rng, comps, *size),
                  {0: np.full(64, 6), 1: np.full(64, 9)})
    _assert_same(_port(data), _pillow(data))


def test_colour_conversion_matches_pillow_on_flat_blocks():
    """Flat blocks (DC only, table 8) set every (Y, Cb, Cr) the test draws:
    2^15 triples through jdcolor.c's tables."""
    rng = np.random.RandomState(3)
    comps = [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    blocks = [np.zeros((128, 256, 64), np.int64) for _ in comps]
    for b in blocks:
        b[..., 0] = rng.randint(-128, 128, b.shape[:2])
    data = encode(comps, 8 * 128, 8 * 256, blocks, {0: np.full(64, 8), 1: np.full(64, 8)})
    _assert_same(_port(data), _pillow(data))


@pytest.mark.parametrize("scale", [1, 8, 30, "wide"])
def test_idct_past_16_bits_matches_pillow(scale):
    """Coefficients whose dequantized values and sums pass 16 bits, half the
    blocks with rows 1-7 zero: libjpeg-turbo's SIMD islow wraps and
    saturates there (jidctint.c's C code would differ); the port follows
    the SIMD code, which Pillow runs."""
    rng = np.random.RandomState(7 if scale == "wide" else scale)
    nb = 256
    blocks = np.zeros((1, nb, 64), np.int64)
    for i in range(nb):
        n = rng.randint(1, 8)
        blocks[0, i, rng.choice(64, n, replace=False)] = rng.randint(-3, 4, n)
        if i % 2:
            blocks[0, i, 8:] = 0
    if scale == "wide":
        q = rng.randint(1, 32768, 64)
    else:
        q, blocks = rng.randint(1, 256, 64), blocks * scale
    data = encode([(1, 1, 1, 0)], 8, 8 * nb, [blocks], {0: q})
    _assert_same(_port(data), _pillow(data))


@pytest.mark.parametrize("ids,adobe,app0", [((1, 2, 3), None, False), ((82, 71, 66), None, False),
                                            ((82, 71, 66), None, True), ((1, 2, 3), 0, False),
                                            ((1, 2, 3), 1, False), ((1, 2, 3), 0, True)],
                         ids=["ycc_ids", "rgb_ids", "rgb_ids_jfif", "adobe0", "adobe1",
                              "adobe0_jfif"])
def test_colour_space_guess_matches_pillow(ids, adobe, app0):
    """jdapimin.c's guess: JFIF means YCbCr; else Adobe's transform (0:
    RGB); else component ids R, G, B mean RGB."""
    rng = np.random.RandomState(11)
    comps = [(cid, 1, 1, min(i, 1)) for i, cid in enumerate(ids)]
    data = encode(comps, 24, 40, _random_blocks(rng, comps, 24, 40),
                  {0: np.full(64, 5), 1: np.full(64, 7)}, app0=app0, adobe=adobe)
    _assert_same(_port(data), _pillow(data))


# ---------------------------------------------------------------------- #
# image_shape
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("shape,dtype", [((5, 7), np.uint8), ((5, 7), np.uint16),
                                         ((5, 7, 2), np.uint8), ((5, 7, 2), np.uint16),
                                         ((5, 7, 3), np.uint8), ((5, 7, 3), np.uint16),
                                         ((5, 7, 4), np.uint8)],
                         ids=["gray8", "gray16", "ga8", "ga16", "rgb8", "rgb16", "rgba8"])
def test_image_shape_matches_imread_for_png(shape, dtype, tmp_path):
    path = tmp_path / "x.png"
    image_io.imwrite_png(path, (np.arange(np.prod(shape)) % 200).reshape(shape).astype(dtype))
    with no_image_libraries():
        assert image_io.image_shape(path) == image_io.imread(path).shape


def test_image_shape_matches_imread_for_palette_png_and_jpeg(tmp_path):
    pal = tmp_path / "p.png"
    Image.fromarray(_photo(9, 11)).convert("P").save(pal)
    files = [pal]
    for channels, opts in ((3, {}), (1, {}), (3, dict(progressive=True))):
        path = tmp_path / f"{channels}{len(files)}.jpg"
        _save(path, _photo(9, 11, channels=channels), **opts)
        files.append(path)
    for path in files:
        with no_image_libraries():
            assert image_io.image_shape(path) == image_io.imread(path).shape, path


def test_image_shape_reads_only_the_header(tmp_path):
    """The frame header suffices: a JPEG cut right after it still has a
    shape (and is refused by imread)."""
    path = tmp_path / "cut.jpg"
    _save(path, _photo(30, 20), quality=90)
    data = path.read_bytes()
    path.write_bytes(data[:data.index(b"\xff\xc0") + 40])
    with no_image_libraries():
        assert image_io.image_shape(path) == (30, 20, 3)
        with pytest.raises(ValueError, match="cut.jpg"):
            image_io.imread(path)


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #


def _variant(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return path


@pytest.fixture
def baseline(tmp_path):
    path = tmp_path / "ok.jpg"
    _save(path, _photo(40, 48), quality=80)
    return path.read_bytes()


@pytest.mark.parametrize("cut", [1, 10, 200, 0.5, -3, -2], ids=lambda c: f"cut{c}")
def test_truncated_streams_raise_naming_the_file(baseline, cut, tmp_path):
    n = int(len(baseline) * cut) if isinstance(cut, float) else cut % len(baseline)
    path = _variant(tmp_path, "truncated.jpg", baseline[:n])
    with no_image_libraries(), pytest.raises(ValueError, match="truncated.jpg"):
        image_io.imread(path)


@pytest.mark.parametrize("damage", ["dht_length", "sos_component", "no_eoi_marker",
                                    "huffman_garbage", "restart_count"])
def test_corrupt_streams_raise_naming_the_file(baseline, damage, tmp_path):
    data = bytearray(baseline)
    if damage == "dht_length":
        i = data.index(b"\xff\xc4")
        data[i + 2:i + 4] = struct.pack(">H", 2000)
    elif damage == "sos_component":
        i = data.index(b"\xff\xda")
        data[i + 5] = 9  # a component id the frame does not have
    elif damage == "no_eoi_marker":
        data[-2:] = b"\x00\x00"
    elif damage == "huffman_garbage":  # all ones: no Huffman code of the tables
        i = data.index(b"\xff\xda")
        start = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        data[start:len(data) - 2] = b"\xff\x00" * ((len(data) - 2 - start) // 2)
    elif damage == "restart_count":  # a DRI with no RST markers in the scan
        i = data.index(b"\xff\xda")
        data[i:i] = b"\xff\xdd\x00\x04\x00\x01"
    path = _variant(tmp_path, "corrupt.jpg", bytes(data))
    with no_image_libraries(), pytest.raises(ValueError, match="corrupt.jpg"):
        image_io.imread(path)


@pytest.mark.parametrize("what,match", [
    ("arithmetic", "arithmetic coding"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical"), ("precision12", "12-bit samples"),
    ("cmyk", "four components"), ("sampling411", "sampling factors"),
    ("not_jpeg", "neither a PNG nor a JPEG")])
def test_unsupported_streams_raise_naming_the_file(baseline, what, match, tmp_path):
    data = bytearray(baseline)
    sof = data.index(b"\xff\xc0")
    if what == "arithmetic":
        data[sof + 1] = 0xC9
    elif what == "lossless":
        data[sof + 1] = 0xC3
    elif what == "hierarchical":
        data[sof + 1] = 0xC5
    elif what == "precision12":
        data[sof + 4] = 12
    elif what == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(_photo(16, 16, channels=3)).convert("CMYK").save(buf, "JPEG")
        data = bytearray(buf.getvalue())
    elif what == "sampling411":
        comps = [(1, 4, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
        data = bytearray(encode(comps, 16, 64, _random_blocks(np.random.RandomState(0), comps,
                                                              16, 64),
                                {0: np.full(64, 6), 1: np.full(64, 9)}))
        _pillow(bytes(data))  # Pillow reads it; the port refuses
    else:
        data = bytearray(b"BM" + bytes(60))
    path = _variant(tmp_path, f"{what}.jpg", bytes(data))
    with no_image_libraries(), pytest.raises(ValueError, match=f"{what}.jpg.*{match}"):
        image_io.imread(path)


# ---------------------------------------------------------------------- #
# the LLFF loader on the JPEG capture, against the JAX package's
# ---------------------------------------------------------------------- #


def _copies(tmp_path):
    return [shutil.copytree(CAPTURE_JPG, tmp_path / side) for side in ("port", "jax")]


def _pngs(directory):
    return {p.name: imageio.imread(p) for p in sorted(Path(directory).glob("*.png"))}


def test_jpeg_capture_names_its_jpgs():
    from cfnerf_torch.data.colmap import read_images_binary

    names = sorted(im.name for im in read_images_binary(
        CAPTURE_JPG / "sparse" / "0" / "images.bin").values())
    assert names == sorted(p.name for p in (CAPTURE_JPG / "images").iterdir())
    assert all(n.endswith(".jpg") for n in names) and len(names) == 8
    assert not (CAPTURE_JPG / "images_2").exists()


def test_llff_loader_on_jpgs_matches_jax_at_factor_2(tmp_path):
    port_root, jax_root = _copies(tmp_path)
    want = jllff.load_llff_data(str(jax_root), factor=2)
    with no_image_libraries():
        got = tllff.load_llff_data(str(port_root), factor=2)
    assert got[0].shape == (8, 48, 64, 3)
    _assert_tree_equal(got, want, what="images/poses/bds/render_poses/i_test")
    written = _pngs(port_root / "images_2")
    _assert_tree_equal(written, _pngs(jax_root / "images_2"), what="images_2")
    _assert_tree_equal(written, _pngs(CAPTURE_GOLDEN), what="images_2 vs the golden")


def test_llff_loader_reads_jpgs_directly_as_jax_does(tmp_path):
    port_root, jax_root = _copies(tmp_path)
    want = jllff.load_llff_data(str(jax_root), factor=None)
    with no_image_libraries():
        got = tllff.load_llff_data(str(port_root), factor=None)
    assert got[0].shape == (8, 96, 128, 3)
    _assert_tree_equal(got, want, what="images/poses/bds/render_poses/i_test")


def test_llff_loader_minifies_jpgs_to_a_width_as_jax_does(tmp_path):
    port_root, jax_root = _copies(tmp_path)
    want = jllff._load_data(str(jax_root), width=40)
    with no_image_libraries():
        got = tllff._load_data(str(port_root), width=40)
    _assert_tree_equal(got, want, what="poses/bds/imgs")
    name = "images_40x30"
    _assert_tree_equal(_pngs(port_root / name), _pngs(jax_root / name), what=name)


def test_llff_loader_decodes_no_original_once_minified(tmp_path, monkeypatch):
    (root,) = [shutil.copytree(CAPTURE_JPG, tmp_path / "capture")]
    shutil.copytree(CAPTURE_GOLDEN, root / "images_2")
    read = []
    real = tllff._imread
    monkeypatch.setattr(tllff, "_imread", lambda p: read.append(Path(p)) or real(p))
    with no_image_libraries():
        images = tllff.load_llff_data(str(root), factor=2)[0]
    assert images.shape == (8, 48, 64, 3)
    assert read and all(p.parent.name == "images_2" for p in read)


def test_load_dataset_on_jpgs_matches_jax(tmp_path):
    out = {}
    for side, parse, mod in (("port", tparse, tloop), ("jax", jparse, jloop)):
        root = shutil.copytree(CAPTURE_JPG, tmp_path / side)
        args = parse(["--config", str(ROOT / "configs" / "minicapture_ds.txt"),
                      "--datadir", str(root)])
        assert args.colmap_depth and args.factor == 2
        if side == "port":
            with no_image_libraries():
                out[side] = mod.load_dataset(args)
        else:
            out[side] = mod.load_dataset(args)
    assert sum(len(d["depth"]) for d in out["port"]["depth_gts"]) > 0
    _assert_tree_equal(out["port"], out["jax"], what="scene")


def test_decode_entry_is_imread_jpeg_on_bytes(tmp_path):
    path = tmp_path / "x.jpg"
    _save(path, _photo(13, 17), quality=70)
    with no_image_libraries():
        _assert_same(jpeg.decode(path.read_bytes()), jpeg.imread_jpeg(path))
        with pytest.raises(ValueError, match="not a JPEG"):
            jpeg.decode(b"GIF89a")
