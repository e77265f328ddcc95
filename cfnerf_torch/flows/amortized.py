"""Amortization networks: conditioning vector h -> per-point flow
parameters; counterpart of cfnerf_tpu/flows/amortized.py (reference
TriangularSylvesterNeRF, model/models.py:294-416): AmortizedTriangularSylvester,
AmortizedGeneralSylvester (householder / orthogonal Q) and AmortizedPlanar.

Per flow step, linear heads map h to a strictly-upper-triangular matrix
(amor_d, shared between r1 and r2 as d and its transpose), two tanh-bounded
diagonals (amor_diag1/2) and a bias (amor_b).  Parameters are computed once
per point; the K draws broadcast over them later.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from cfnerf_torch.flows.sylvester import householder_q, orthogonalize_q


class AmortizedTriangularSylvester(nn.Module):
    """h (B, h_size) -> r1, r2 (B, Z, Z, F) upper-triangular with tanh
    diagonals, and b (B, Z, F).  The amor_d output is read as (B, Z, Z, F)
    with F minor, as in the JAX package."""

    def __init__(self, h_size: int, z_size: int, n_flows: int):
        super().__init__()
        Z, F = z_size, n_flows
        self.z_size, self.n_flows = Z, F
        self.amor_d = nn.Linear(h_size, F * Z * Z)
        self.amor_diag1 = nn.Linear(h_size, F * Z)
        self.amor_diag2 = nn.Linear(h_size, F * Z)
        self.amor_b = nn.Linear(h_size, F * Z)
        triu = torch.triu(torch.ones(Z, Z), diagonal=1)[None, :, :, None]
        eye = torch.eye(Z)[None, :, :, None]
        self.register_buffer("triu", triu, persistent=False)
        self.register_buffer("eye", eye, persistent=False)

    def forward(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        Z, F = self.z_size, self.n_flows
        B = h.shape[0]
        h = h.to(torch.float32)
        full_d = self.amor_d(h).reshape(B, Z, Z, F)
        diag1 = torch.tanh(self.amor_diag1(h)).reshape(B, Z, F)
        diag2 = torch.tanh(self.amor_diag2(h)).reshape(B, Z, F)
        b = self.amor_b(h).reshape(B, Z, F)
        r1 = full_d * self.triu + self.eye * diag1[:, :, None, :]
        r2 = full_d.transpose(1, 2) * self.triu + self.eye * diag2[:, :, None, :]
        return r1, r2, b


class AmortizedGeneralSylvester(AmortizedTriangularSylvester):
    """h (B, h_size) -> r1, r2 (B, Z, Z, F) as the triangular family's, an
    orthogonal q (B, Z, Z, F) and b (B, Z, F), for the general Sylvester
    step.  q_mode 'householder': amor_q gives a reflection vector a step,
    (B, Z, F); 'orthogonal': a Z x Z matrix a step, (B, Z, Z, F), made
    orthogonal as a product of Householder reflections.  Heads read F
    minor, as the JAX package's."""

    def __init__(self, h_size: int, z_size: int, n_flows: int, q_mode: str = "householder"):
        super().__init__(h_size, z_size, n_flows)
        if q_mode not in ("householder", "orthogonal"):
            raise ValueError(f"q_mode must be 'householder' or 'orthogonal', got {q_mode!r}")
        self.q_mode = q_mode
        Z, F = z_size, n_flows
        self.amor_q = nn.Linear(h_size, F * Z * (Z if q_mode == "orthogonal" else 1))

    def forward(self, h: torch.Tensor):
        r1, r2, b = super().forward(h)
        Z, F = self.z_size, self.n_flows
        B = h.shape[0]
        if self.q_mode == "householder":
            v = self.amor_q(h.to(torch.float32)).reshape(B, Z, F)
            q = torch.stack([householder_q(v[..., k]) for k in range(F)], -1)
        else:
            m = self.amor_q(h.to(torch.float32)).reshape(B, Z, Z, F)
            q = torch.stack([orthogonalize_q(m[..., k]) for k in range(F)], -1)
        return r1, r2, q, b


class AmortizedPlanar(nn.Module):
    """h (B, h_size) -> u, w (B, Z, F) and b (B, F) for planar steps; the
    heads amor_u, amor_w (F * Z each, F minor) and amor_b (F)."""

    def __init__(self, h_size: int, z_size: int, n_flows: int):
        super().__init__()
        Z, F = z_size, n_flows
        self.z_size, self.n_flows = Z, F
        self.amor_u = nn.Linear(h_size, F * Z)
        self.amor_w = nn.Linear(h_size, F * Z)
        self.amor_b = nn.Linear(h_size, F)

    def forward(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        Z, F = self.z_size, self.n_flows
        B = h.shape[0]
        h = h.to(torch.float32)
        return (self.amor_u(h).reshape(B, Z, F), self.amor_w(h).reshape(B, Z, F),
                self.amor_b(h))
