"""Convolutional flow building blocks; counterpart of
cfnerf_tpu/flows/conv_layers.py (reference model/flow/layers.py: GatedConv2d
and GatedConvTranspose2d :16-58, MaskedConv2d :132-204).  In the reference
they are dead code: their only consumers, the realnvp / glow conv-flow
families, were deleted upstream.  They complete the flow-layer toolbox.

Layout: NCHW, PyTorch's; the JAX package is NHWC, and build_pixelcnn_mask
returns its HWIO layout, transposed to OIHW where a weight takes it.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

Pair = Tuple[int, int]


class GatedConv2d(nn.Module):
    """h(x) * sigmoid(g(x)) with two parallel convolutions (GLU gating)."""

    def __init__(self, in_channels: int, features: int, kernel_size: Pair = (3, 3),
                 strides: Pair = (1, 1), padding: Pair = (1, 1), dilation: Pair = (1, 1),
                 activation: Optional[Callable] = None):
        super().__init__()
        conv = lambda: nn.Conv2d(in_channels, features, kernel_size, stride=strides,
                                 padding=padding, dilation=dilation)
        self.h, self.g = conv(), conv()
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.h(x)
        if self.activation is not None:
            h = self.activation(h)
        return h * torch.sigmoid(self.g(x))


class GatedConvTranspose2d(nn.Module):
    """Gated transposed convolution with torch ConvTranspose2d geometry:
    out = (in - 1) * stride - 2 * padding + dilation * (k - 1)
    + output_padding + 1."""

    def __init__(self, in_channels: int, features: int, kernel_size: Pair = (3, 3),
                 strides: Pair = (1, 1), padding: Pair = (0, 0),
                 output_padding: Pair = (0, 0), dilation: Pair = (1, 1),
                 activation: Optional[Callable] = None):
        super().__init__()
        tconv = lambda: nn.ConvTranspose2d(
            in_channels, features, kernel_size, stride=strides, padding=padding,
            output_padding=output_padding, dilation=dilation)
        self.h, self.g = tconv(), tconv()
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.h(x)
        if self.activation is not None:
            h = self.activation(h)
        return h * torch.sigmoid(self.g(x))


def build_pixelcnn_mask(n_in: int, n_out: int, size_kernel: Pair = (3, 3),
                        diagonal_zeros: bool = False) -> np.ndarray:
    """Autoregressive conv mask, HWIO (kh, kw, n_in, n_out): PixelCNN spatial
    structure (taps above the centre row and left of the centre zeroed) and,
    at the centre tap, block-autoregressive channels: output block i reads
    input channels < i (diagonal_zeros) or <= i, channels grouped by the
    n_out / n_in (or n_in / n_out) ratio (reference MaskedConv2d.build_mask,
    layers.py:163-189)."""
    if not (n_out % n_in == 0 or n_in % n_out == 0):
        raise ValueError(f"channel counts must divide: {n_in} vs {n_out}")
    kh, kw = size_kernel
    ch, cw = (kh - 1) // 2, (kw - 1) // 2
    mask = np.ones((kh, kw, n_in, n_out), np.float32)
    mask[:ch, :, :, :] = 0.0
    mask[ch, :cw, :, :] = 0.0
    if n_out >= n_in:
        k = n_out // n_in
        for i in range(n_in):
            mask[ch, cw, i + 1:, i * k:(i + 1) * k] = 0.0
            if diagonal_zeros:
                mask[ch, cw, i:i + 1, i * k:(i + 1) * k] = 0.0
    else:
        k = n_in // n_out
        for i in range(n_out):
            mask[ch, cw, (i + 1) * k:, i:i + 1] = 0.0
            if diagonal_zeros:
                mask[ch, cw, i * k:(i + 1) * k, i:i + 1] = 0.0
    return mask


class MaskedConv2d(nn.Module):
    """PixelCNN-style masked convolution.  Pads (1, 1) whatever the kernel
    size, as the reference does (layers.py:192): 'same' geometry for 3 x 3
    kernels only.  Weight (out, in, kh, kw), kaiming-normal; bias zeros."""

    def __init__(self, in_channels: int, features: int, size_kernel: Pair = (3, 3),
                 diagonal_zeros: bool = False, use_bias: bool = True):
        super().__init__()
        mask = build_pixelcnn_mask(in_channels, features, size_kernel, diagonal_zeros)
        self.register_buffer("mask", torch.from_numpy(mask.transpose(3, 2, 0, 1).copy()),
                             persistent=False)
        self.weight = nn.Parameter(torch.empty(features, in_channels, *size_kernel))
        nn.init.kaiming_normal_(self.weight)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.mask, self.bias, padding=1)
