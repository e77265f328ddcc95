"""Colour maps without OpenCV: cv2's COLORMAP_JET and COLORMAP_MAGMA as
256 x 3 uint8 RGB tables held in source, and `apply_colormap`, the
counterpart of cv2.cvtColor(cv2.applyColorMap(u8, cm), cv2.COLOR_BGR2RGB).

The JAX package colours its TensorBoard panels and its uncertainty point
clouds through cv2 (cfnerf_tpu/train/logging.py:29-42,
cfnerf_tpu/utils/pointcloud.py:75-87); the port must also run where OpenCV
is not installed, as data/image_io.py does for images.  The tables were
read from cv2.applyColorMap over the 256 grey levels (OpenCV 5.0) and
converted to RGB.  A 3-channel input is first reduced to grey as
cv2.applyColorMap reduces it: COLOR_BGR2GRAY of its channels taken as B, G,
R, in OpenCV's 15-bit fixed point (3735 B + 19235 G + 9798 R, rounded).
"""
from __future__ import annotations

import numpy as np

_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"
)
_MAGMA_HEX = (
    "00000401000501010601010802010902020b02020d03030f030312040414050416060518"
    "06051a07061c08071e0907200a08220b09240c09260d0a290e0b2b100b2d110c2f120d31"
    "130d34140e36150e38160f3b180f3d19103f1a10421c10441d11471e114920114b21114e"
    "22115024125325125527125829115a2a115c2c115f2d11612f1163311165331067341069"
    "36106b38106c390f6e3b0f703d0f713f0f72400f74420f75440f76451077471078491078"
    "4a10794c117a4e117b4f127b51127c52137c54137d56147d57157e59157e5a167e5c167f"
    "5d177f5f187f601880621980641a80651a80671b80681c816a1c816b1d816d1d816e1e81"
    "701f81721f817320817521817621817822817922827b23827c23827e2482802582812581"
    "8326818426818627818827818928818b29818c29818e2a81902a81912b81932b80942c80"
    "962c80982d80992d809b2e7f9c2e7f9e2f7fa02f7fa1307ea3307ea5317ea6317da8327d"
    "aa337dab337cad347cae347bb0357bb2357bb3367ab5367ab73779b83779ba3878bc3978"
    "bd3977bf3a77c03a76c23b75c43c75c53c74c73d73c83e73ca3e72cc3f71cd4071cf4070"
    "d0416fd2426fd3436ed5446dd6456cd8456cd9466bdb476adc4869de4968df4a68e04c67"
    "e24d66e34e65e44f64e55064e75263e85362e95462ea5661eb5760ec5860ed5a5fee5b5e"
    "ef5d5ef05f5ef1605df2625df2645cf3655cf4675cf4695cf56b5cf66c5cf66e5cf7705c"
    "f7725cf8745cf8765cf9785df9795df97b5dfa7d5efa7f5efa815ffb835ffb8560fb8761"
    "fc8961fc8a62fc8c63fc8e64fc9065fd9266fd9467fd9668fd9869fd9a6afd9b6bfe9d6c"
    "fe9f6dfea16efea36ffea571fea772fea973feaa74feac76feae77feb078feb27afeb47b"
    "feb67cfeb77efeb97ffebb81febd82febf84fec185fec287fec488fec68afec88cfeca8d"
    "fecc8ffecd90fecf92fed194fed395fed597fed799fed89afdda9cfddc9efddea0fde0a1"
    "fde2a3fde3a5fde5a7fde7a9fde9aafdebacfcecaefceeb0fcf0b2fcf2b4fcf4b6fcf6b8"
    "fcf7b9fcf9bbfcfbbdfcfdbf"
)

COLORMAPS = {
    "jet": np.frombuffer(bytes.fromhex("".join(_JET_HEX)), np.uint8).reshape(256, 3),
    "magma": np.frombuffer(bytes.fromhex("".join(_MAGMA_HEX)), np.uint8).reshape(256, 3),
}


def bgr_to_gray(u8: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(u8, cv2.COLOR_BGR2GRAY) of an (..., 3) uint8 array."""
    x = u8.astype(np.int32)
    gray = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15
    return gray.astype(np.uint8)


def apply_colormap(u8: np.ndarray, name: str) -> np.ndarray:
    """(H, W) or (H, W, 1|3) uint8 -> (H, W, 3) uint8 RGB through the table
    `name` ("jet" or "magma"), as cv2's applyColorMap then BGR2RGB."""
    if name not in COLORMAPS:
        raise ValueError(f"unknown colour map {name!r}; one of {sorted(COLORMAPS)}")
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8:
        raise ValueError(f"apply_colormap takes uint8, got {u8.dtype}")
    if u8.ndim == 3 and u8.shape[-1] == 3:
        u8 = bgr_to_gray(u8)
    elif u8.ndim == 3 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    elif u8.ndim != 2:
        raise ValueError(f"apply_colormap takes (H, W) or (H, W, 1|3), got {u8.shape}")
    return COLORMAPS[name][u8]
