"""Offline figures; counterpart of cfnerf_tpu/utils/visualization.py (the
reference's visualization_funcs.py, which it never calls).

The JAX package draws these with matplotlib, which the port cannot count on
(the card's installation has none).  The port keeps JAX's names and
signatures and draws in numpy, writing PNGs through data/image_io.py:

  * MidpointNormalize: matplotlib's TwoSlopeNorm, the piecewise-linear map
    vmin -> 0, midpoint -> 0.5, vmax -> 1 (extrapolated outside), vmin and
    vmax taken from the first data it sees when not given;
  * save_uncertainty_figure: one PNG of the panel's tiles side by side, each
    H x W, no gaps: GT, the mean prediction (both clipped to [0, 1]), the
    |error| averaged over channels (JET), the std averaged over channels
    (JET) and, when given, the disparity (MAGMA); each heat map divided by
    its maximum (+ 1e-8) before the 8-bit table.  The maps are the arrays
    JAX's figure plots; titles, colour bars and the figure title are not
    drawn (no fonts);
  * save_sparsification_figure: the oracle curve (blue, dashed) and the
    by-variance curve (red) over the removed fraction, the band between them
    filled pale red, on a fixed 320 x 400 white canvas with its axes.

So the figures are not matplotlib's pixel for pixel; what they show is what
the tests hold.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from cfnerf_torch.data.image_io import imwrite_png
from cfnerf_torch.ops.metrics import to8b
from cfnerf_torch.utils.colormap import apply_colormap


class MidpointNormalize:
    """Normalize with a fixed midpoint (reference visualization_funcs.py:7-16),
    as matplotlib.colors.TwoSlopeNorm(vcenter=midpoint or 0, vmin, vmax)."""

    def __init__(self, vmin=None, vmax=None, midpoint=None, clip=False):
        self.vcenter = midpoint if midpoint is not None else 0.0
        if vmax is not None and self.vcenter >= vmax:
            raise ValueError("vmin, vcenter, and vmax must be in ascending order")
        if vmin is not None and self.vcenter <= vmin:
            raise ValueError("vmin, vcenter, and vmax must be in ascending order")
        self.vmin, self.vmax = vmin, vmax
        self.clip = clip

    def __call__(self, value):
        a = np.asarray(value)
        scalar = a.ndim == 0
        if not np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float64)
        # TwoSlopeNorm.autoscale_None: the data's range, then vcenter kept
        # inside it by mirroring the far end
        if self.vmin is None and a.size:
            self.vmin = a.min()
        if self.vmax is None and a.size:
            self.vmax = a.max()
        if self.vmin >= self.vcenter:
            self.vmin = self.vcenter - (self.vmax - self.vcenter)
        if self.vmax <= self.vcenter:
            self.vmax = self.vcenter + (self.vcenter - self.vmin)
        if not self.vmin <= self.vcenter <= self.vmax:
            raise ValueError("vmin, vcenter, vmax must increase monotonically")
        out = np.interp(a, [self.vmin, self.vcenter, self.vmax], [0, 0.5, 1],
                        left=-np.inf, right=np.inf)
        return out[()] if scalar else out


def _heat(m: np.ndarray, cmap: str) -> np.ndarray:
    return apply_colormap(to8b(m / (m.max() + 1e-8)), cmap)


def save_uncertainty_figure(
    path: str,
    *,
    gt: np.ndarray,            # (H, W, 3)
    rgb_mean: np.ndarray,      # (H, W, 3)
    rgb_std: np.ndarray,       # (H, W, 3) or (H, W)
    disp: Optional[np.ndarray] = None,  # (H, W)
    title: str = "",
) -> None:
    """Panel: GT | prediction | abs error | uncertainty | disp, one PNG.
    `title` is accepted for JAX's signature and not drawn."""
    err = np.abs(rgb_mean - gt).mean(-1)
    unc = rgb_std.mean(-1) if rgb_std.ndim == 3 else rgb_std
    tiles = [to8b(gt), to8b(rgb_mean), _heat(err, "jet"), _heat(unc, "jet")]
    if disp is not None:
        tiles.append(_heat(disp, "magma"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imwrite_png(path, np.concatenate(tiles, 1))


# the sparsification canvas: size, the plot area's margins, colours
CANVAS_H, CANVAS_W = 320, 400
_MARGIN = dict(left=40, right=10, top=10, bottom=30)
_ORACLE_RGB = (31, 119, 180)
_BY_VAR_RGB = (214, 39, 40)
_BAND_RGB = (244, 204, 204)


def _rows(values: np.ndarray, y_max: float, top: int, height: int) -> np.ndarray:
    return np.round(top + (1.0 - values / y_max) * (height - 1)).astype(int)


def _polyline(canvas, cols, rows, rgb, dashed=False):
    """Join consecutive (col, row) points by vertical runs, 2 pixels wide;
    dashed: every other 8 columns left out."""
    for c in range(len(cols)):
        if dashed and (c // 8) % 2:
            continue
        r0, r1 = rows[c], rows[min(c + 1, len(cols) - 1)]
        lo, hi = min(r0, r1), max(r0, r1)
        canvas[lo:hi + 2, cols[c]:cols[c] + 2] = rgb


def save_sparsification_figure(
    path: str,
    oracle_curve: np.ndarray,
    by_var_curve: np.ndarray,
) -> None:
    """AUSE sparsification plot (oracle vs variance-ordered error removal):
    x the removed fraction in [0, 1), y from 0 to 1.05 x the larger curve's
    maximum."""
    oracle_curve = np.asarray(oracle_curve, np.float64)
    by_var_curve = np.asarray(by_var_curve, np.float64)
    canvas = np.full((CANVAS_H, CANVAS_W, 3), 255, np.uint8)
    left, top = _MARGIN["left"], _MARGIN["top"]
    width = CANVAS_W - left - _MARGIN["right"]
    height = CANVAS_H - top - _MARGIN["bottom"]
    ratio = np.linspace(0, 1, len(oracle_curve), endpoint=False)
    cols_x = np.arange(width) / (width - 1) * ratio[-1] if len(ratio) > 1 else np.zeros(width)
    oracle = np.interp(cols_x, ratio, oracle_curve)
    by_var = np.interp(cols_x, ratio, by_var_curve)
    y_max = 1.05 * max(float(oracle.max()), float(by_var.max()), 1e-12)
    r_oracle = _rows(oracle, y_max, top, height)
    r_by_var = _rows(by_var, y_max, top, height)
    cols = left + np.arange(width)
    for c, a, b in zip(cols, r_oracle, r_by_var):
        canvas[min(a, b):max(a, b) + 1, c] = _BAND_RGB
    _polyline(canvas, cols, r_oracle, _ORACLE_RGB, dashed=True)
    _polyline(canvas, cols, r_by_var, _BY_VAR_RGB)
    canvas[top:top + height, left - 1] = 0            # y axis
    canvas[top + height, left - 1:left + width] = 0   # x axis
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imwrite_png(path, canvas)
