"""Inverse Autoregressive Flow (MADE-masked), conditioned on a context
vector; counterpart of cfnerf_tpu/flows/iaf.py (the intended design of the
reference's IAF, model/flow/flows.py:279-354, and its MADE layers,
model/flow/layers.py):

    per flow step k (the latent reversed on odd steps):
        h    = ELU(masked_linear(z) + context)      (autoregressive in z)
        m, s = masked_linear_strict(h), masked_linear_strict(h)
        g    = sigmoid(s + forget_bias)
        z    = g * z + (1 - g) * m
        logdet += sum_i log(g_i + 1e-12)

Output i depends on z_<i only, so the Jacobian is triangular with
diagonal g.  z is (B, K, Z) with the K draws on a broadcast axis; the
hidden state is (B, K, h_size).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def made_degrees(z_size: int, h_size: int) -> Tuple[np.ndarray, np.ndarray]:
    d_in = np.arange(1, z_size + 1)
    if z_size == 1:
        m_h = np.ones(h_size, dtype=int)
    else:
        m_h = (np.arange(h_size) % (z_size - 1)) + 1
    return d_in, m_h


def input_mask(z_size: int, h_size: int) -> np.ndarray:
    """(z_size, h_size): hidden j sees input i iff m_h[j] >= d_in[i]."""
    d_in, m_h = made_degrees(z_size, h_size)
    return (m_h[None, :] >= d_in[:, None]).astype(np.float32)


def output_mask(z_size: int, h_size: int) -> np.ndarray:
    """(h_size, z_size): output o sees hidden j iff d_out[o] > m_h[j]
    (strict: no self-dependence)."""
    d_out, m_h = made_degrees(z_size, h_size)
    return (d_out[None, :] > m_h[:, None]).astype(np.float32)


class MaskedLinear(nn.Linear):
    """nn.Linear whose weight is multiplied by a fixed 0/1 mask in forward.
    `mask` is (in_features, out_features), the JAX package's kernel layout;
    the weight is stored unmasked, as the JAX kernel is, and the mask is a
    buffer outside the state dict.  Initialised as nn.Linear is,
    U(+-1/sqrt(in_features)) for weight and bias."""

    def __init__(self, in_features: int, out_features: int, mask: np.ndarray):
        super().__init__(in_features, out_features)
        self.register_buffer("mask", torch.from_numpy(np.ascontiguousarray(mask.T)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight * self.mask, self.bias)


class IAFStep(nn.Module):
    def __init__(self, z_size: int, h_size: int, forget_bias: float = 1.0):
        super().__init__()
        self.forget_bias = forget_bias
        self.z_feats = MaskedLinear(z_size, h_size, input_mask(z_size, h_size))
        self.mean = MaskedLinear(h_size, z_size, output_mask(z_size, h_size))
        self.std = MaskedLinear(h_size, z_size, output_mask(z_size, h_size))

    def forward(self, z: torch.Tensor, context: torch.Tensor):
        """z (B, K, Z); context (B, H).  Returns (z', log_det (B, K))."""
        h = F.elu(self.z_feats(z) + context[:, None, :])
        gate = torch.sigmoid(self.std(h) + self.forget_bias)
        z_new = gate * z + (1.0 - gate) * self.mean(h)
        return z_new, torch.log(gate + 1e-12).sum(-1)


class IAFNeRF(nn.Module):
    """n_flows IAF steps (flow_0, flow_1, ... as the JAX package names them),
    the latent reversed around every odd step, conditioned on the per-point
    context projected to h_size by ctx_proj."""

    def __init__(self, context_size: int, z_size: int, n_flows: int, h_size: int = 64):
        super().__init__()
        self.n_flows = n_flows
        self.ctx_proj = nn.Linear(context_size, h_size)
        for k in range(n_flows):
            self.add_module(f"flow_{k}", IAFStep(z_size, h_size))

    def forward(self, z0: torch.Tensor, context: torch.Tensor,
                compute_log_det: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """z0 (B, K, Z), context (B, context_size).  Returns (z_F, summed
        log-det (B, K)); the log-det is computed either way and zeroed when
        compute_log_det is False, as the JAX package does."""
        ctx = self.ctx_proj(context.to(torch.float32))
        z = z0
        ldj = torch.zeros(z0.shape[:-1], dtype=z0.dtype, device=z0.device)
        for k in range(self.n_flows):
            if k % 2 == 1:
                z = z.flip(-1)
            z, ld = getattr(self, f"flow_{k}")(z, ctx)
            if k % 2 == 1:
                z = z.flip(-1)
            ldj = ldj + ld
        if not compute_log_det:
            ldj = torch.zeros_like(ldj)
        return z, ldj
