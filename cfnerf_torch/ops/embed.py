"""Positional encoding (NeRF section 5.1); counterpart of cfnerf_tpu/ops/embed.py.

gamma(x) concatenates the raw input with [sin(x * f), cos(x * f)] for f in
2**linspace(0, multires-1, multires).  Output dim = d + d * 2 * multires
(63 for positions at multires=10, 27 for view dirs at multires=4).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    *,
    include_input: bool = True,
    log_sampling: bool = True,
    max_freq_log2: float | None = None,
) -> torch.Tensor:
    """gamma(x): [..., d] -> [..., d * (include_input + 2*num_freqs)].

    Feature order is the reference's: [x, sin(x*f0), cos(x*f0), sin(x*f1),
    cos(x*f1), ...], each per-frequency block spanning all d input dims.
    """
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    if max_freq_log2 is None:
        max_freq_log2 = num_freqs - 1
    freqs = _freqs(num_freqs, float(max_freq_log2), log_sampling, x.dtype, x.device)  # (F,)

    xf = x[..., None, :] * freqs[:, None]              # (..., F, d)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, d)
    enc = enc.reshape(*x.shape[:-1], -1)               # (..., F*2*d)
    if include_input:
        return torch.cat([x, enc], dim=-1)
    return enc


@functools.lru_cache(maxsize=None)
def _freqs(num_freqs: int, max_freq_log2: float, log_sampling: bool, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """The encoding's frequencies on `device`, made once a configuration,
    dtype and device: the copy from the host is then never part of a step,
    nor of the step's CUDA graph (train/graph.py), which cannot capture one.
    Read only; never an inference tensor."""
    if log_sampling:
        freqs = 2.0 ** np.linspace(0.0, max_freq_log2, num_freqs)
    else:
        freqs = np.linspace(2.0 ** 0.0, 2.0 ** max_freq_log2, num_freqs)
    with torch.inference_mode(False):
        return torch.as_tensor(freqs, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Embedder:
    """Configured positional encoder (the reference Embedder's flag surface)."""

    num_freqs: int
    input_dims: int = 3
    include_input: bool = True
    log_sampling: bool = True
    max_freq_log2: float | None = None

    @property
    def out_dim(self) -> int:
        d = self.input_dims
        out = d if self.include_input else 0
        return out + d * 2 * self.num_freqs

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return positional_encoding(
            x,
            self.num_freqs,
            include_input=self.include_input,
            log_sampling=self.log_sampling,
            max_freq_log2=self.max_freq_log2,
        )


def get_embedder(multires: int, i_embed: int = 0) -> Tuple[Embedder, int]:
    """i_embed == -1 -> identity (3 features)."""
    if i_embed == -1:
        return Embedder(num_freqs=0, input_dims=3, include_input=True), 3
    emb = Embedder(num_freqs=multires, input_dims=3, max_freq_log2=multires - 1)
    return emb, emb.out_dim
