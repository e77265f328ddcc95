"""Image reading, writing and resampling in numpy and the standard library.

The JAX package's loaders read with imageio, shrink Blender images with
cv2.resize(..., INTER_AREA) and LLFF images with Pillow's Lanczos
(cfnerf_tpu/data/blender.py:70,103-110, cfnerf_tpu/data/llff.py:36-78).  The
port's loaders must also run where none of those libraries is installed, so
this module computes the same results itself:

  * imread_png / imwrite_png: PNG files of 8 or 16 bits, gray, gray+alpha,
    RGB, RGBA and palette (1-8 bits), all five scanline filters; arrays
    shaped and typed as imageio.v2.imread returns them (uint8; a 16-bit
    gray image as uint16; a 16-bit colour image as its high bytes, which is
    what Pillow decodes, gray + alpha then as RGBA).  An interlaced (Adam7)
    PNG raises;
  * imread: imread_png for a PNG, data/jpeg.py's imread_jpeg (Pillow's
    libjpeg-turbo pixels, bit for bit) for a JPEG, chosen by the file's
    signature; any other file raises, naming it.  image_shape gives the
    shape imread returns from the PNG IHDR or the JPEG frame header alone;
  * resize_area: cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA) of a
    float image: cv2's pixel-overlap weights (the block mean at an integer
    factor), in float64, returned as float32;
  * resize_lanczos: Image.fromarray(img).convert("RGB").resize((W, H),
    Image.LANCZOS): two separable passes, horizontal first, in Pillow's
    fixed point (22 fraction bits, rounded and clipped to uint8 after each
    pass), so the result is Pillow's bit for bit.
"""
from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from cfnerf_torch.data.jpeg import imread_jpeg, jpeg_shape

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---------------------------------------------------------------------- #
# PNG
# ---------------------------------------------------------------------- #


def _chunks(data: bytes, path):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters.  raw: (H, 1 + stride) bytes, each row its
    filter type and its filtered bytes.  Every pixel depends on its left,
    upper and upper-left neighbours, so the rows are reconstructed along
    anti-diagonals of pixels (bpp bytes each): every pixel of one diagonal
    at once, from the two diagonals before it.  In skewed storage
    S[d, r] = pixel (r, d - r) those neighbours are contiguous slices."""
    ftype = raw[:, 0].astype(np.int16)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    W = stride // bpp
    filt = raw[:, 1:].reshape(H, W, bpp).astype(np.int16)
    n_diag = H + W - 1
    rows = np.arange(H)
    # skewed: row 0 of the second axis is padding (the row above the image);
    # unwritten cells stay 0, which is what the filters read off the image
    S = np.zeros((n_diag + 1, H + 1, bpp), np.int16)
    F = np.zeros((n_diag, H + 1, bpp), np.int16)
    r_idx, x_idx = np.meshgrid(rows, np.arange(W), indexing="ij")
    F[r_idx + x_idx, r_idx + 1] = filt
    t = np.zeros(H + 1, np.int16)
    t[1:] = ftype
    t = t[:, None]
    for d in range(n_diag):
        lo, hi = max(0, d - W + 1) + 1, min(H - 1, d) + 1  # padded rows
        f = F[d, lo:hi + 1]
        a = S[d, lo:hi + 1]          # left: (r, x-1) on diagonal d-1
        b = S[d, lo - 1:hi]          # up: (r-1, x) on diagonal d-1
        c = S[d - 1, lo - 1:hi] if d > 0 else np.zeros_like(a)  # up-left
        tt = t[lo:hi + 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(tt == 1, a, np.where(tt == 2, b, np.where(
            tt == 3, (a + b) >> 1, np.where(tt == 4, paeth, 0))))
        S[d + 1, lo:hi + 1] = (f + pred) & 255
    # S[d + 1] holds diagonal d
    return S[r_idx + x_idx + 1, r_idx + 1].astype(np.uint8).reshape(H, stride)


def imread_png(path) -> np.ndarray:
    """Decode a PNG file into the array imageio.v2.imread returns for it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = body
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    W, H, depth, ctype = _png_header(path, header)
    ch = _CHANNELS[ctype]
    stride = (W * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < H * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = _unfilter(raw[:H * (stride + 1)].reshape(H, stride + 1), H, stride, bpp)

    if depth == 16:
        samples = rows.view(">u2").reshape(H, W, ch)
        if ctype == 0:  # Pillow's I;16: kept at 16 bits
            return samples[..., 0].astype(np.uint16)
        samples = (samples >> 8).astype(np.uint8)  # Pillow's ;16B modes: high bytes
        if ctype == 4:  # Pillow opens 16-bit gray + alpha as RGBA
            samples = samples[..., [0, 0, 0, 1]]
    elif depth == 8:
        samples = rows.reshape(H, W, ch)
    else:  # a palette image of 1, 2 or 4 bits: unpack the indices
        bits = np.unpackbits(rows, axis=1)[:, :W * depth].reshape(H, W, depth)
        samples = (bits.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)
                   ).sum(-1, dtype=np.uint8)[..., None]
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)  # indices past the palette: black
        table[:len(palette)] = palette
        return table[samples[..., 0]]
    if ctype == 0:
        return np.ascontiguousarray(samples[..., 0])
    return np.ascontiguousarray(samples)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def imwrite_png(path, arr: np.ndarray) -> None:
    """Write a uint8 or uint16 array as a PNG: (H, W) gray, (H, W, 2) gray +
    alpha, (H, W, 3) RGB or (H, W, 4) RGBA, every row with the Up filter."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"imwrite_png takes uint8 or uint16, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"imwrite_png takes (H, W) or (H, W, 1-4), got {arr.shape}")
    H, W, ch = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(H, W * ch * arr.dtype.itemsize)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # uint8 wraps: the Up filter, mod 256
    body = np.concatenate([np.full((H, 1), 2, np.uint8), up], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(body.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _png_header(path, ihdr: bytes) -> tuple:
    """IHDR's (W, H, depth, colour type), refusing what imread_png refuses."""
    W, H, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG files are not supported; "
                         "save it without interlacing")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth not in (8, 16) and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{path}: PNG of colour type {ctype} at {depth} bits is not "
                         "supported (8 or 16 bits; 1-8 for palette images)")
    return W, H, depth, ctype


def _kind(path) -> str:
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head == PNG_SIGNATURE:
        return "png"
    if head[:3] == JPEG_SIGNATURE:
        return "jpeg"
    raise ValueError(f"{os.fspath(path)} is neither a PNG nor a JPEG file")


def imread(path) -> np.ndarray:
    """Read a PNG or JPEG file into the array imageio.v2.imread returns,
    choosing the decoder by the file's signature."""
    return imread_png(path) if _kind(path) == "png" else imread_jpeg(path)


def image_shape(path) -> tuple:
    """imread(path).shape, from the PNG IHDR or the JPEG frame header only:
    (H, W) gray, otherwise (H, W, C) with C as imread gives it."""
    if _kind(path) == "jpeg":
        return jpeg_shape(path)
    with open(path, "rb") as f:
        head = f.read(33)  # the signature, then IHDR: length, type, 13 bytes, CRC
    if len(head) < 33 or head[8:16] != b"\x00\x00\x00\x0dIHDR":
        raise ValueError(f"{path}: PNG does not start with its IHDR chunk")
    ihdr = head[16:29]
    if zlib.crc32(b"IHDR" + ihdr) != struct.unpack(">I", head[29:33])[0]:
        raise ValueError(f"{path}: PNG chunk b'IHDR' fails its CRC")
    W, H, depth, ctype = _png_header(path, ihdr)
    if ctype == 0:
        return (H, W)
    # palette -> RGB; 16-bit gray + alpha opens as RGBA (imread_png)
    channels = {2: 3, 3: 3, 4: 4 if depth == 16 else 2, 6: 4}[ctype]
    return (H, W, channels)


# ---------------------------------------------------------------------- #
# cv2's INTER_AREA
# ---------------------------------------------------------------------- #


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of cv2's computeResizeAreaTab: each output
    cell covers `scale` input pixels, the partly covered ones by their
    overlap; each weight rounded to float32 as cv2 stores it."""
    scale = 1.0 / (dsize / ssize)  # cv2: 1 / inv_scale
    w = np.zeros((dsize, ssize))
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        w[dx, sx1:sx2] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(fsx2 - sx2, 1.0, cell) / cell)
    return w


def resize_area(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA) of a float
    image (H0, W0) or (H0, W0, C), shrinking only.  Returns float32."""
    img = np.asarray(img)
    H0, W0 = img.shape[:2]
    if W > W0 or H > H0 or W < 1 or H < 1:
        raise ValueError(f"resize_area shrinks only: {W0}x{H0} -> {W}x{H}")
    x = img.astype(np.float64).reshape(H0, W0, -1)
    out = np.tensordot(_area_weights(H0, H), x, axes=(1, 0))      # (H, W0, C)
    out = np.tensordot(_area_weights(W0, W), out, axes=(1, 1))    # (W, H, C)
    return out.transpose(1, 0, 2).reshape((H, W) + img.shape[2:]).astype(np.float32)


# ---------------------------------------------------------------------- #
# Pillow's LANCZOS
# ---------------------------------------------------------------------- #

_PRECISION_BITS = 32 - 8 - 2  # Pillow's Resample.c


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the box
    (0, in_size): per output pixel its first input pixel and ksize integer
    weights (zero past its window).  Evaluated in Python floats, the C
    doubles and libm calls of Pillow, in its order."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    start = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            kk[xx, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << _PRECISION_BITS))
        start[xx] = xmin
    return start, kk


def _lanczos_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` of a uint8 (H, W, C) image, in Pillow's fixed
    point: 2^21 + sum of weight * pixel, shifted right by 22 and clipped."""
    in_size = img.shape[axis]
    start, kk = _lanczos_coeffs(in_size, out_size)
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        idx = np.minimum(start + j, in_size - 1)  # past a window the weight is 0
        acc += kk[:, j].reshape((-1,) + (1,) * (x.ndim - 1)) * x[idx]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _to_rgb8(img: np.ndarray) -> np.ndarray:
    """Pillow's convert("RGB") of an array as imread returns it: gray is
    repeated (16-bit gray saturating at 255, as Pillow converts I;16),
    gray + alpha and RGBA lose their alpha."""
    img = np.asarray(img)
    if img.ndim == 2:
        if img.dtype == np.uint16:
            img = np.minimum(img, 255)
        return np.repeat(img.astype(np.uint8)[..., None], 3, -1)
    if img.dtype != np.uint8 or img.shape[-1] not in (2, 3, 4):
        raise ValueError(f"resize_lanczos takes uint8 (H, W, 2-4) or gray, got {img.dtype} "
                         f"{img.shape}")
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def resize_lanczos(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """Image.fromarray(img).convert("RGB").resize((W, H), Image.LANCZOS)
    as a uint8 (H, W, 3) array, bit for bit."""
    rgb = _to_rgb8(img)
    if W < 1 or H < 1:
        raise ValueError(f"resize_lanczos to {W}x{H}")
    if W != rgb.shape[1]:
        rgb = _lanczos_pass(rgb, W, axis=1)
    if H != rgb.shape[0]:
        rgb = _lanczos_pass(rgb, H, axis=0)
    return rgb
