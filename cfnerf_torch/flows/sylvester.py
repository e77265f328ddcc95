"""Normalizing-flow steps as plain functions; counterpart of
cfnerf_tpu/flows/sylvester.py (reference model/flow/flows.py:15-276): the
triangular Sylvester step and stack, the general Sylvester step with its
orthogonal Q (householder_q, orthogonalize_q) and the planar step.

    z' = z + P^T R1 tanh(R2 P z + b),  P = the flip permutation on odd steps
    log|det J| = sum_i log(|1 + tanh'(.)_i * diag(R1)_i * diag(R2)_i| + 1e-8)

The K Monte-Carlo draws ride a broadcast axis: flow parameters are per
point (B), z carries (B, K, Z).  Z is 1 (density) or 3 (rgb), so the Z axis
is unrolled into (B, K) elementwise chains (over the upper triangle for
the triangular step).  All math is f32.
"""
from __future__ import annotations

import functools
import operator
from typing import List, Optional, Tuple

import torch

from cfnerf_torch.ops.compositing import softplus

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


# ---------------------------------------------------------------------- #
# the other flow families (cfnerf_tpu/flows/sylvester.py:152-246)
# ---------------------------------------------------------------------- #


def _fold(terms) -> torch.Tensor:
    """t0 + t1 + ... in order, without sum()'s leading 0 + t0."""
    return functools.reduce(operator.add, terms)


def _matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, Z, Z) x (B, Z, Z) with Z = 1 or 3 as an elementwise product and a
    sum over the tiny inner axis, not a batched matmul over 10^6 points."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def general_sylvester_step(
    z: torch.Tensor,
    r1: torch.Tensor,
    r2: torch.Tensor,
    q: torch.Tensor,
    b: torch.Tensor,
    *,
    compute_log_det: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One general Sylvester step z' = z + Q R1 tanh(R2 Q^T z + b)
    (reference Sylvester._forward, flows.py:89-165).

    z (B, K, Z); r1, r2 (B, Z, Z) upper-triangular with bounded diagonals;
    q (B, Z, Z) orthogonal; b (B, Z).  Returns (z', log_det (B, K)), zeros
    when compute_log_det is False.  For orthogonal Q the log-det is the
    triangular one: sum_i log(|1 + tanh'(.)_i r1_ii r2_ii| + 1e-8).  The Z
    axis is unrolled into (B, K) elementwise chains."""
    Z = z.shape[-1]
    zs = z.unbind(-1)

    def coef(mat, i, j):
        return mat[:, i, j][:, None]  # (B, 1), broadcast over K

    # (Q^T z)_y = sum_z z_z q_zy
    zq = [_fold(zs[i] * coef(q, i, y) for i in range(Z)) for y in range(Z)]
    ts = []
    for i in range(Z):
        pre = b[:, i][:, None]
        for y in range(Z):
            pre = pre + coef(r2, i, y) * zq[y]
        ts.append(torch.tanh(pre))
    # (R1 t)_j, then z + Q (R1 t)
    upd = [_fold(ts[i] * coef(r1, j, i) for i in range(Z)) for j in range(Z)]
    z_new = torch.stack(
        [zs[i] + _fold(upd[j] * coef(q, i, j) for j in range(Z)) for i in range(Z)], dim=-1)
    if not compute_log_det:
        return z_new, torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    log_det = None
    for i in range(Z):
        dj = (1.0 - ts[i] ** 2) * (coef(r1, i, i) * coef(r2, i, i)) + 1.0
        term = torch.log(torch.abs(dj) + LOGDET_EPS)
        log_det = term if log_det is None else log_det + term
    return z_new, log_det


def householder_q(v: torch.Tensor) -> torch.Tensor:
    """(B, Z) reflection vectors -> (B, Z, Z) Householder matrices
    Q = I - 2 v^ v^T, exactly the identity where |v|^2 <= 1e-12.  The
    unselected branch divides by a safe 1, so the gradient stays finite
    there."""
    Z = v.shape[-1]
    norm2 = torch.sum(v ** 2, -1, keepdim=True)
    safe = norm2 > 1e-12
    vn = v / torch.sqrt(torch.where(safe, norm2, torch.ones_like(norm2)))
    eye = torch.eye(Z, dtype=v.dtype, device=v.device)
    h = eye - 2.0 * vn[:, :, None] * vn[:, None, :]
    return torch.where(safe[..., None], h, eye)


def orthogonalize_q(m: torch.Tensor) -> torch.Tensor:
    """(B, Z, Z) unconstrained matrices -> orthogonal Q, the product of Z
    Householder reflections, one per row of m, multiplied on the right in
    row order as the JAX package does."""
    q = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand(m.shape)
    for i in range(m.shape[-1]):
        q = _matmul_small(q, householder_q(m[:, i, :]))
    return q


def planar_step(
    z: torch.Tensor,
    u: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One planar step z' = z + u^ tanh(w^T z + b), u reparameterised so that
    w^T u^ >= -1 (Rezende & Mohamed; reference flows.py:52-86).

    z (B, K, Z); u, w (B, Z); b (B,).  Returns (z', log_det (B, K)),
    log(|1 + psi(z)^T u^| + 1e-10)."""
    Z = z.shape[-1]
    uw = torch.sum(u * w, -1, keepdim=True)  # (B, 1)
    m_uw = -1.0 + softplus(uw)
    w_norm_sq = torch.sum(w ** 2, -1, keepdim=True)
    u_hat = u + (m_uw - uw) * w / w_norm_sq  # (B, Z)
    zs = z.unbind(-1)
    wzb = b[:, None]
    for i in range(Z):
        wzb = wzb + zs[i] * w[:, i][:, None]
    t = torch.tanh(wzb)  # (B, K)
    z_new = torch.stack([zs[i] + u_hat[:, i][:, None] * t for i in range(Z)], dim=-1)
    psi_u = (1.0 - t ** 2) * torch.sum(w * u_hat, -1, keepdim=True)
    log_det = torch.log(torch.abs(1.0 + psi_u) + 1e-10)
    return z_new, log_det
