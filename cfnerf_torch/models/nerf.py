"""The baseline (non-flow) NeRF models; counterpart of
cfnerf_tpu/models/nerf.py (the paper's baselines, defined but never
instantiated by the reference: vanilla NeRF run_nerf_helpers.py:76-163,
MC-dropout NeRF_Dropout :165-226, learned-std NeRF_wild :228-284).

Each is a D x W ReLU trunk with the input concatenated after layer D//2 and
the heads of nerf-pytorch.  The concatenations (skip, and feature + view
directions) are materialised, as the JAX package's baselines do, so in
bf16 (compute_dtype=torch.bfloat16) every layer is one product on the
concatenated bf16 input, then the bias add, each rounded to bf16; the
parameters stay f32 and are cast per call.

MC-dropout is inverted dropout (h / keep where kept, else 0, in the compute
dtype) before trunk layers 2, 4, 6, ... and before the heads: before the
alpha / feature heads on the trunk output, and before the rgb head on the
views layer's output.  Its masks come in through `masks=` (tests feed JAX's
jax.random.bernoulli masks through it) or are drawn from an explicit
torch.Generator.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cfnerf_torch.models.nerf_flows import _dense_bf16, _dense_f32
from cfnerf_torch.ops.sampling import per_ray


class _Trunk(nn.Module):
    """depth x nn.Linear(width), ReLU; the input concatenated in front after
    each layer in `skips` (pts_linears, JAX's pts_linear_{i})."""

    def __init__(self, depth: int, width: int, input_ch: int, skips: Sequence[int]):
        super().__init__()
        self.skips = tuple(skips)
        layers, fan_in = [], input_ch
        for i in range(depth):
            layers.append(nn.Linear(fan_in, width))
            fan_in = width + input_ch if i in self.skips else width
        self.pts_linears = nn.ModuleList(layers)
        self.out_features = fan_in

    def dropout_sites(self) -> List[int]:
        """Indices of the layers that dropout precedes: even, > 0."""
        return [i for i in range(len(self.pts_linears)) if i % 2 == 0 and i > 0]

    def forward(self, input_pts: torch.Tensor, dense,
                masks: Optional[Sequence[torch.Tensor]] = None, keep: float = 1.0):
        masks = list(masks) if masks is not None else None
        h = input_pts
        for i, layer in enumerate(self.pts_linears):
            if masks is not None and i % 2 == 0 and i > 0:
                h = _dropout(h, masks.pop(0), keep)
            h = torch.relu(dense(layer, (h,)))
            if i in self.skips:
                h = torch.cat([input_pts, h], -1)
        return h


def _dropout(h: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """Inverted dropout in h's dtype: h / keep where mask, else 0.  keep is
    rounded to h's dtype first, as JAX's weakly typed scalar is (0.8 is
    0.80078125 in bf16)."""
    keep_t = torch.tensor(keep, dtype=h.dtype, device=h.device)
    return torch.where(mask, h / keep_t, torch.zeros((), dtype=h.dtype, device=h.device))


class NeRF(nn.Module):
    """Vanilla NeRF: trunk -> alpha head, and feature + view directions ->
    views layer -> rgb head; output (..., 4): rgb then density (without
    view directions one output_linear of output_ch)."""

    std_head = False

    def __init__(self, depth: int = 8, width: int = 256, input_ch: int = 63,
                 input_ch_views: int = 27, output_ch: int = 4, skips: Sequence[int] = (4,),
                 use_viewdirs: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        self.depth, self.width = depth, width
        self.input_ch, self.input_ch_views = input_ch, input_ch_views
        self.use_viewdirs = use_viewdirs
        self.compute_dtype = compute_dtype
        self.trunk = _Trunk(depth, width, input_ch, skips)
        fan_in = self.trunk.out_features
        if use_viewdirs:
            self.alpha_linear = nn.Linear(fan_in, 1)
            self.feature_linear = nn.Linear(fan_in, width)
            self.views_linear = nn.Linear(width + input_ch_views, width // 2)
            self.rgb_linear = nn.Linear(width // 2, 3)
            if self.std_head:
                self.std_linear = nn.Linear(width // 2, 1)
        else:
            self.output_linear = nn.Linear(fan_in, output_ch)

    def mask_shapes(self, n_points: int) -> List[Tuple[int, int]]:
        """The shapes of the dropout masks a forward on n_points takes, in
        order: one per trunk site, then the trunk output's and the views
        layer's (with view directions)."""
        widths = [self.trunk.pts_linears[i].in_features for i in self.trunk.dropout_sites()]
        if self.use_viewdirs:
            widths += [self.trunk.out_features, self.width // 2]
        return [(n_points, w) for w in widths]

    def forward(self, x: torch.Tensor, *,
                masks: Optional[Sequence[torch.Tensor]] = None, keep: float = 1.0):
        dense = _dense_f32 if self.compute_dtype == torch.float32 else _dense_bf16
        x = x.to(self.compute_dtype)
        input_pts = x[..., : self.input_ch]
        input_views = x[..., self.input_ch:]
        n_trunk = len(self.trunk.dropout_sites())
        h = self.trunk(input_pts, dense, None if masks is None else masks[:n_trunk], keep)
        if not self.use_viewdirs:
            return dense(self.output_linear, (h,)).float()
        if masks is not None:
            h = _dropout(h, masks[n_trunk], keep)
        alpha = dense(self.alpha_linear, (h,))
        feature = dense(self.feature_linear, (h,))
        hv = torch.relu(dense(self.views_linear, (torch.cat([feature, input_views], -1),)))
        if masks is not None:
            hv = _dropout(hv, masks[n_trunk + 1], keep)
        rgb = dense(self.rgb_linear, (hv,))
        heads = [rgb, dense(self.std_linear, (hv,)), alpha] if self.std_head else [rgb, alpha]
        return torch.cat(heads, -1).float()


class NeRFDropout(NeRF):
    """MC-dropout baseline: dropout_rate (0.2) before trunk layers 2, 4, 6, ...
    and before the heads.

    forward(x, masks=None, generator=None): with `masks` (boolean, keep where
    True, in the order and shapes of mask_shapes) one dropout draw with
    those masks; else with `generator` one draw from it; with neither, no
    dropout (JAX's rng=None)."""

    def __init__(self, *args, dropout_rate: float = 0.2, **kwargs):
        super().__init__(*args, **kwargs)
        self.dropout_rate = dropout_rate

    def draw_masks(self, n_points: int, generator: torch.Generator) -> List[torch.Tensor]:
        """One draw's masks from `generator`, on its device: keep each unit
        with probability 1 - dropout_rate."""
        keep = 1.0 - self.dropout_rate
        return [per_ray(lambda s: torch.rand(s, generator=generator,
                                             device=generator.device), shape) < keep
                for shape in self.mask_shapes(n_points)]

    def forward(self, x: torch.Tensor, *, masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        if masks is None and generator is not None:
            masks = self.draw_masks(x.shape[0], generator)
        if masks is not None:
            masks = [torch.as_tensor(m, dtype=torch.bool).to(x.device) for m in masks]
        return super().forward(x, masks=masks, keep=1.0 - self.dropout_rate)


class NeRFWild(NeRF):
    """Learned-std baseline: the rgb head plus a per-point std head
    (std_linear); output (..., 5): rgb, raw std, density."""

    std_head = True

    def __init__(self, *args, output_ch: int = 5, **kwargs):
        super().__init__(*args, output_ch=output_ch, **kwargs)


def load_weights_from_keras(model: NeRF, weights: Sequence) -> NeRF:
    """Load an original TF-NeRF (Keras) checkpoint into a view-direction NeRF
    (reference NeRF.load_weights_from_keras, run_nerf_helpers.py:136-163).

    `weights` is the flat [w0, b0, w1, b1, ...] list of the bmild/nerf
    release: the D trunk layers, feature_linear, views_linear, rgb_linear,
    alpha_linear.  Keras kernels are (in, out); nn.Linear weights are (out,
    in), so each is transposed.  A shape that does not match raises
    ValueError with the JAX package's message, in its (in, out) terms.  In
    place; returns the model."""
    layers = list(model.trunk.pts_linears) + [
        model.feature_linear, model.views_linear, model.rgb_linear, model.alpha_linear]
    loads = []
    for j, layer in enumerate(layers):
        kern = np.asarray(weights[2 * j], np.float32)
        bias = np.asarray(weights[2 * j + 1], np.float32)
        tgt_k = tuple(layer.weight.shape[::-1])
        if kern.shape != tgt_k:
            raise ValueError(f"keras kernel shape {kern.shape} != target {tgt_k}")
        if bias.shape != tuple(layer.bias.shape):
            raise ValueError(f"keras bias shape {bias.shape} != target {tuple(layer.bias.shape)}")
        loads.append((layer, kern, bias))
    with torch.no_grad():
        for layer, kern, bias in loads:
            layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(kern.T)))
            layer.bias.copy_(torch.from_numpy(bias))
    return model
