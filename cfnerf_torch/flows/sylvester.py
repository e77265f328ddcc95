"""Triangular Sylvester flow steps as plain functions; counterpart of
cfnerf_tpu/flows/sylvester.py (reference model/flow/flows.py:168-276).

    z' = z + P^T R1 tanh(R2 P z + b),  P = the flip permutation on odd steps
    log|det J| = sum_i log(|1 + tanh'(.)_i * diag(R1)_i * diag(R2)_i| + 1e-8)

The K Monte-Carlo draws ride a broadcast axis: flow parameters are per
point (B), z carries (B, K, Z).  Z is 1 (density) or 3 (rgb), so the Z axis
is unrolled into (B, K) elementwise chains over the upper triangle.  All
math is f32.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

LOGDET_EPS = 1e-8  # reference flows.py:255 (diag_j.abs() + 1e-08)


def _step_components(
    zs: List[torch.Tensor], r1, r2, b, *, flip: bool, compute_log_det: bool
) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """One flow step on a list of Z tensors (B, K); r1, r2 (B, Z, Z); b (B, Z)."""
    Z = len(zs)
    zp = zs[::-1] if flip else zs  # permuted view

    def coef(mat, i, j):
        return mat[:, i, j][:, None]  # (B, 1), broadcast over K

    ts = []
    for i in range(Z):
        pre = b[:, i][:, None]
        for j in range(i, Z):
            pre = pre + coef(r2, i, j) * zp[j]
        ts.append(torch.tanh(pre))

    # the update lives in permuted coordinates; scatter back through the flip
    zs_new = list(zs)
    for i in range(Z):
        upd = coef(r1, i, i) * ts[i]
        for j in range(i + 1, Z):
            upd = upd + coef(r1, i, j) * ts[j]
        out_idx = (Z - 1 - i) if flip else i
        zs_new[out_idx] = zs[out_idx] + upd

    if not compute_log_det:
        return zs_new, None

    log_det = None
    for i in range(Z):
        der = 1.0 - ts[i] ** 2  # tanh'(pre_i)
        dj = der * (coef(r1, i, i) * coef(r2, i, i)) + 1.0
        term = torch.log(torch.abs(dj) + LOGDET_EPS)
        log_det = term if log_det is None else log_det + term
    return zs_new, log_det


def triangular_sylvester_step(
    z: torch.Tensor,
    r1: torch.Tensor,
    r2: torch.Tensor,
    b: torch.Tensor,
    *,
    flip: bool,
    compute_log_det: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step.  z (B, K, Z); r1, r2 (B, Z, Z) upper-triangular with
    tanh-bounded diagonals; b (B, Z).  Returns (z', log_det (B, K)), the
    log-det being zeros when compute_log_det is False (the reference's test
    shortpath, flows.py:204-223)."""
    zs = list(z.unbind(-1))
    zs_new, log_det = _step_components(
        zs, r1, r2, b, flip=flip, compute_log_det=compute_log_det
    )
    z_new = torch.stack(zs_new, dim=-1)
    if log_det is None:
        return z_new, torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    return z_new, log_det


def triangular_sylvester_stack(
    z0: torch.Tensor,
    r1: torch.Tensor,
    r2: torch.Tensor,
    b: torch.Tensor,
    *,
    compute_log_det: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """F steps, flipping on odd steps (reference models.py:401-413).

    z0 (B, K, Z); r1, r2 (B, Z, Z, F); b (B, Z, F).
    Returns (z_F (B, K, Z), summed log-det (B, K))."""
    zs = list(z0.unbind(-1))
    ldj = None
    for k in range(r1.shape[-1]):
        zs, ld = _step_components(
            zs, r1[..., k], r2[..., k], b[..., k],
            flip=(k % 2 == 1), compute_log_det=compute_log_det,
        )
        if ld is not None:
            ldj = ld if ldj is None else ldj + ld
    z = torch.stack(zs, dim=-1)
    if ldj is None:
        return z, torch.zeros(z0.shape[:-1], dtype=z0.dtype, device=z0.device)
    return z, ldj
