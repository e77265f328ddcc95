"""The NeRF trunk forward (MLP + skip + heads) in bf16 products.

Counterpart of cfnerf_tpu/ops/pallas/trunk.py:pallas_encode, forward only.
On CUDA tensors `trunk_encode` launches the hand-written Hopper kernel
(cfnerf_torch/csrc/trunk.cu) or raises; on CPU tensors it runs
`trunk_encode_plain`, the same arithmetic in eager PyTorch, which is also
the kernel's oracle on the card.  Its backward is not ported yet: either
route raises where a gradient is required.

The arithmetic is `_fwd_mlp`'s: inputs and every activation rounded to
bf16, every product bf16 x bf16 summed in f32, the f32 bias added, then
relu (not on the feature layer and the heads), then the activation rounded
to bf16; the skip layer and the views layer each sum two products
(x Wsx + h Wsh, f Wvf + v Wvv) before the bias; h_alpha and h_rgb come out
in f32.

`pack_trunk_weights` turns a NeRFFlows' nn.Linear weights into the two flat
buffers the kernel reads, once per call as pallas_encode packs (~4.7 MB at
D8/W512).  Each matrix keeps nn.Linear's (out, in) layout, K-major, so that
no transpose is needed and each tensor-core fragment's pair along k is one
32-bit load; the odd input widths (63, 27) are zero-padded to the kernel's
k-step of 16.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from cfnerf_torch.ops.kernels import _build
from cfnerf_torch.ops.kernels.render_core import _on_device

NAME = "trunk"
SOURCE = "cfnerf_torch/csrc/trunk.cu"
REPLACES = "cfnerf_tpu/ops/pallas/trunk.py:160"  # _fwd_kernel (with _fwd_mlp :132)

K_STEP = 16  # the kernel's k-step: input widths are padded to it
MAX_WIDTH = 512  # two (64, W) bf16 activation buffers in a block's shared memory
MAX_INPUT = 128  # x and v widths the kernel stages beside them

Outputs = Tuple[torch.Tensor, torch.Tensor]


def _round(n: int) -> int:
    return -(-n // K_STEP) * K_STEP


def supported(depth: int, width: int, use_viewdirs: bool, skips: Sequence[int],
              h_alpha: int, h_rgb: int, input_ch: int, views_ch: int) -> bool:
    """The kernel's own rules: the viewdirs topology with one skip after
    layer depth // 2, depth >= 3 (a skip + 1 layer exists), a width that
    splits into 16-column tiles at W and W/2 and fits shared memory, head
    widths in whole 16-column tiles, input widths it can stage."""
    return (use_viewdirs and tuple(skips) == (depth // 2,) and depth >= 3
            and width % 32 == 0 and 32 <= width <= MAX_WIDTH
            and h_alpha % 16 == 0 and h_alpha >= 16 and h_rgb % 16 == 0 and h_rgb >= 16
            and 1 <= input_ch <= MAX_INPUT and 1 <= views_ch <= MAX_INPUT)


def _layout(depth, width, input_ch, views_ch, h_alpha, h_rgb):
    """[(name, out, in_padded)] of the weight matrices and [(name, size)] of
    the biases, in the order trunk.cu reads them."""
    skip, in_pad, v_pad, half = depth // 2, _round(input_ch), _round(views_ch), width // 2
    mats = [("w0", width, in_pad)]
    for i in range(1, depth):
        if i == skip + 1:
            mats += [("wsx", width, in_pad), ("wsh", width, width)]
        else:
            mats.append((f"w{i}", width, width))
    mats += [("wha", h_alpha, width), ("wf", width, width), ("wvf", half, width),
             ("wvv", half, v_pad), ("whr", h_rgb, half)]
    biases = ([(f"b{i}", width) for i in range(depth)]
              + [("bha", h_alpha), ("bf", width), ("bv", half), ("bhr", h_rgb)])
    return mats, biases


@dataclasses.dataclass(frozen=True)
class TrunkWeights:
    """The packed trunk: `w` the bf16 matrices, `b` the f32 biases, each one
    flat buffer in `_layout` order; the ints are the trunk's shape."""

    depth: int
    width: int
    input_ch: int
    views_ch: int
    h_alpha: int
    h_rgb: int
    w: torch.Tensor
    b: torch.Tensor

    def _shape(self):
        return (self.depth, self.width, self.input_ch, self.views_ch, self.h_alpha,
                self.h_rgb)

    def matrices(self) -> Dict[str, torch.Tensor]:
        """Views of `w`: name -> (out, in_padded) bf16."""
        out, at = {}, 0
        for name, rows, cols in _layout(*self._shape())[0]:
            out[name] = self.w[at:at + rows * cols].view(rows, cols)
            at += rows * cols
        return out

    def biases(self) -> Dict[str, torch.Tensor]:
        """Views of `b`: name -> (size,) f32."""
        out, at = {}, 0
        for name, size in _layout(*self._shape())[1]:
            out[name] = self.b[at:at + size]
            at += size
        return out


def pack_trunk_weights(model) -> TrunkWeights:
    """The trunk of a NeRFFlows (its pts_linears, feature_linear,
    views_linear, h_alpha_linear, h_rgb_linear) as the kernel reads it.  The
    skip layer's weight splits into its x part (the first input_ch input
    columns, as the model concatenates [input_pts, h]) and its h part;
    views_linear's into its feature part (the first W columns) and its views
    part.  Made with differentiable ops, so the result requires grad where
    the model's weights do and grad mode is on."""
    D, W = model.net_depth, model.net_width
    in_ch, v_ch = model.input_ch, model.input_ch_views
    in_pad, v_pad = _round(in_ch), _round(v_ch)
    skip = D // 2

    def pad(w, cols):
        return F.pad(w, (0, cols - w.shape[1]))

    lin = model.pts_linears
    mats: Dict[str, torch.Tensor] = {"w0": pad(lin[0].weight, in_pad)}
    for i in range(1, D):
        if i == skip + 1:
            mats["wsx"] = pad(lin[i].weight[:, :in_ch], in_pad)
            mats["wsh"] = lin[i].weight[:, in_ch:]
        else:
            mats[f"w{i}"] = lin[i].weight
    kv = model.views_linear.weight  # (W/2, W + views): feature columns first
    mats.update(wha=model.h_alpha_linear.weight, wf=model.feature_linear.weight,
                wvf=kv[:, :W], wvv=pad(kv[:, W:], v_pad), whr=model.h_rgb_linear.weight)
    biases = {f"b{i}": lin[i].bias for i in range(D)}
    biases.update(bha=model.h_alpha_linear.bias, bf=model.feature_linear.bias,
                  bv=model.views_linear.bias, bhr=model.h_rgb_linear.bias)

    shape = (D, W, in_ch, v_ch, model.h_alpha_linear.out_features,
             model.h_rgb_linear.out_features)
    mat_layout, bias_layout = _layout(*shape)
    for name, rows, cols in mat_layout:
        if tuple(mats[name].shape) != (rows, cols):
            raise ValueError(f"trunk weight {name}: expected {(rows, cols)}, "
                             f"got {tuple(mats[name].shape)}")
    w = torch.cat([mats[name].reshape(-1) for name, _, _ in mat_layout]).to(torch.bfloat16)
    b = torch.cat([biases[name].reshape(-1) for name, _ in bias_layout]).float()
    return TrunkWeights(*shape, w=w, b=b)


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, k) x (out, k) -> (B, out): bf16 values, f32 products and sums."""
    return a.bfloat16().float() @ w.float().t()


def _check_x(packed: TrunkWeights, x: torch.Tensor) -> int:
    if x.ndim != 2 or x.shape[1] != packed.input_ch + packed.views_ch:
        raise ValueError(
            f"x: expected (B, {packed.input_ch + packed.views_ch}), got {tuple(x.shape)}")
    return x.shape[0]


def trunk_encode_plain(packed: TrunkWeights, x: torch.Tensor) -> Outputs:
    """The trunk forward in eager PyTorch, with the kernel's arithmetic.
    x (B, input_ch + views_ch) f32 -> (h_alpha (B, h_alpha), h_rgb (B,
    h_rgb)) f32.  Differentiable through autograd."""
    _check_x(packed, x)
    m, b = packed.matrices(), packed.biases()
    skip = packed.depth // 2
    xb = F.pad(x[:, :packed.input_ch], (0, _round(packed.input_ch) - packed.input_ch))
    vb = F.pad(x[:, packed.input_ch:], (0, _round(packed.views_ch) - packed.views_ch))
    xb, vb = xb.bfloat16(), vb.bfloat16()

    h = torch.relu(_dot(xb, m["w0"]) + b["b0"]).bfloat16()
    for i in range(1, packed.depth):
        if i == skip + 1:
            z = _dot(xb, m["wsx"]) + _dot(h, m["wsh"]) + b[f"b{i}"]
        else:
            z = _dot(h, m[f"w{i}"]) + b[f"b{i}"]
        h = torch.relu(z).bfloat16()
    h_alpha = _dot(h, m["wha"]) + b["bha"]
    f = (_dot(h, m["wf"]) + b["bf"]).bfloat16()
    hv = torch.relu(_dot(f, m["wvf"]) + _dot(vb, m["wvv"]) + b["bv"]).bfloat16()
    h_rgb = _dot(hv, m["whr"]) + b["bhr"]
    return h_alpha, h_rgb


def trunk_encode(packed: TrunkWeights, x: torch.Tensor) -> Outputs:
    """Trunk forward.  Arguments and outputs as in `trunk_encode_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise; anything else raises.  Raises where a gradient is required."""
    _check_x(packed, x)
    args = (x, packed.w, packed.b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "the trunk kernel has no backward yet: the trunk backward kernels come "
            "with slice 4b; train with trunk_impl='xla', or run the forward under "
            "torch.no_grad() / torch.inference_mode()"
        )
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return trunk_encode_plain(packed, x)
    if kinds != {"cuda"}:
        raise ValueError(
            f"trunk: all inputs must be on one CUDA device or all on the CPU "
            f"(got {sorted(kinds)})"
        )
    return _launch(packed, x)


trunk_encode.launches = 0  # kernel launches; the plain route never counts


def _launch(packed: TrunkWeights, x: torch.Tensor) -> Outputs:
    B = _check_x(packed, x)
    dev = x.device
    for name, t, dtype in (("x", x, torch.float32), ("w", packed.w, torch.bfloat16),
                           ("b", packed.b, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"trunk kernel: {name} must be {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if not (packed.w.is_contiguous() and packed.b.is_contiguous() and x.stride(1) == 1):
        raise ValueError("trunk kernel takes contiguous weights and x with contiguous "
                         f"rows (got x strides {x.stride()})")
    if not supported(packed.depth, packed.width, True, (packed.depth // 2,), packed.h_alpha,
                     packed.h_rgb, packed.input_ch, packed.views_ch):
        raise ValueError(f"trunk kernel: unsupported shape {packed._shape()}")
    fn = _entry()
    h_alpha = x.new_empty((B, packed.h_alpha))
    h_rgb = x.new_empty((B, packed.h_rgb))
    row_stride = x.stride(0) if B > 1 else x.shape[1]  # a single row's stride is arbitrary
    with _on_device(dev) as stream:
        err = fn(x.data_ptr(), row_stride, packed.w.data_ptr(), packed.b.data_ptr(),
                 h_alpha.data_ptr(), h_rgb.data_ptr(), B, *packed._shape(), stream)
    if err != 0:
        raise RuntimeError(
            f"trunk_fwd launch failed: CUDA error {err} (B={B}, shape {packed._shape()})"
        )
    trunk_encode.launches += 1
    return h_alpha, h_rgb


def _entry():
    """The ctypes entry: emb, its row stride, w, b, h_alpha, h_rgb, then B,
    depth, width, input_ch, views_ch, h_alpha, h_rgb and the stream."""
    fn = getattr(_build.load(NAME), "trunk_fwd")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
