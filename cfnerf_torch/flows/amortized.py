"""Amortization network: conditioning vector h -> per-point flow parameters;
counterpart of cfnerf_tpu/flows/amortized.py:AmortizedTriangularSylvester
(reference TriangularSylvesterNeRF, model/models.py:294-416).

Per flow step, linear heads map h to a strictly-upper-triangular matrix
(amor_d, shared between r1 and r2 as d and its transpose), two tanh-bounded
diagonals (amor_diag1/2) and a bias (amor_b).  Parameters are computed once
per point; the K draws broadcast over them later.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


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
