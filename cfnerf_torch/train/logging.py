"""Observability; counterpart of cfnerf_tpu/train/logging.py (the
reference's SummaryWriter use, run_nerf_uncertainty_NF.py:929,1055-1062,
1082,1112-1196):

  * a JSONL stream basedir/dataname/summaries/expname/metrics.jsonl, always
    written: one record a call of scalars() with step, t (seconds since the
    logger opened) and every scalar;
  * TensorBoard scalars and the per-i_img five-image panels (gt, mean, MAGMA
    disparity, JET MSE heat map, JET std heat map) only where
    torch.utils.tensorboard imports, as the JAX logger does; without it the
    panels are skipped;
  * the console lines of the JAX loop.

The heat maps go through utils/colormap.py, cv2's tables without cv2.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from cfnerf_torch.ops.metrics import std_over_k, to8b
from cfnerf_torch.utils.colormap import apply_colormap


def _colormap(img01: np.ndarray, cmap: str) -> np.ndarray:
    """(H, W) or (H, W, 1|3) in [0,1] -> (3, H, W) uint8 heat map; a
    3-channel map is reduced to grey first, as cv2.applyColorMap does."""
    if img01.ndim == 3 and img01.shape[-1] == 3:
        src = to8b(img01)
    else:
        src = to8b(img01.reshape(img01.shape[0], img01.shape[1], -1)[..., 0])
    return apply_colormap(src, cmap).transpose(2, 0, 1)


class MetricsLogger:
    def __init__(self, basedir: str, dataname: str, expname: str, *, use_tb: bool = True):
        self.summary_dir = os.path.join(basedir, dataname, "summaries", expname)
        os.makedirs(self.summary_dir, exist_ok=True)
        self.writer = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(self.summary_dir)
            except Exception:
                self.writer = None
        self.jsonl = open(os.path.join(self.summary_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "t": time.time() - self._t0}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self.writer is not None:
                self.writer.add_scalar(k, float(v), step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def image_panel(
        self,
        step: int,
        prefix: str,
        *,
        gt: np.ndarray,          # (H, W, 3)
        rgb_k: np.ndarray,       # (H, W, 3, K)
        disp_k: np.ndarray,      # (H, W, K)
    ) -> None:
        """The reference's five-image panel (:1119-1147); TensorBoard only."""
        if self.writer is None:
            return
        rgb_mean = rgb_k.mean(-1)
        disp_mean = disp_k.mean(-1)[..., None]

        heat_mse = _colormap((rgb_mean - gt) ** 2, "jet")
        heat_std = _colormap(std_over_k(torch.from_numpy(np.asarray(rgb_k))).numpy(), "jet")
        disp_norm = disp_mean / (np.percentile(disp_mean, 90) + 1e-8)
        heat_disp = _colormap(np.clip(disp_norm, 0, 1), "magma")

        self.writer.add_image(prefix + "rgb_gt", to8b(gt).transpose(2, 0, 1), step)
        self.writer.add_image(prefix + "rgb_pred", to8b(rgb_mean).transpose(2, 0, 1), step)
        self.writer.add_image(prefix + "rgb_disp_pred", heat_disp, step)
        self.writer.add_image(prefix + "heatmap_mse_", heat_mse, step)
        self.writer.add_image(prefix + "heatmap_v", heat_std, step)

    def console(self, step: int, scalars: Dict[str, float], colmap_depth: bool = False) -> None:
        if colmap_depth and "train/depth_loss" in scalars:
            print(
                f"[TRAIN] Iter: {step} Loss: {scalars['train/loss']:.6f} "
                f"entropy: {scalars['train/loss_entropy']:.6f} "
                f"depth: {scalars['train/depth_loss']:.6f} "
                f"nll: {scalars['train/loss_nll']:.6f} PSNR: {scalars['train/psnr']:.4f}"
            )
        else:
            print(
                f"[TRAIN] Iter: {step} Loss: {scalars['train/loss']:.6f} "
                f"nll: {scalars['train/loss_nll']:.6f} PSNR: {scalars['train/psnr']:.4f}"
            )

    def close(self):
        if self.writer is not None:
            self.writer.close()
        self.jsonl.close()
