"""The NeRF trunk (MLP + skip + heads) in bf16 products, forward and backward.

Counterpart of cfnerf_tpu/ops/pallas/trunk.py:pallas_encode and its custom
VJP (_trunk_bwd).  On CUDA tensors `trunk_encode` launches the hand-written
Hopper kernel (cfnerf_torch/csrc/trunk.cu) or raises; on CPU tensors it runs
`trunk_encode_plain`, the same arithmetic in eager PyTorch, which is also
the kernel's oracle on the card.  Where a gradient is needed either route
goes through `_Trunk`, an autograd Function.  On the card its forward
launches the kernel's training variant, which also writes every bf16
activation into a workspace kept for the backward, and its backward is the
backward kernel (cfnerf_torch/csrc/trunk_bwd.cu) reading that workspace; on
the CPU they are `trunk_encode_plain` and `trunk_encode_bwd_plain`, so that
both routes compute _trunk_bwd's arithmetic.

The forward arithmetic is `_fwd_mlp`'s: inputs and every activation rounded
to bf16, every product bf16 x bf16 summed in f32, the f32 bias added, then
relu (not on the feature layer and the heads), then the activation rounded
to bf16; the skip layer and the views layer each sum two products
(x Wsx + h Wsh, f Wvf + v Wvv) before the bias; h_alpha and h_rgb come out
in f32.  The backward's is `_trunk_bwd`'s: both operands of every product
rounded to bf16 (the cotangents too), f32 sums, the relu mask taken from
the bf16 activation, bias gradients summed from the f32 gradient, and no
gradient for the input (it is data).

`pack_trunk_weights` turns a NeRFFlows' nn.Linear weights into the two flat
f32 buffers the kernels read, once per call as pallas_encode packs (~9.4 MB
at D8/W512).  Each matrix keeps nn.Linear's (out, in) layout, K-major: the
forward's TMA streams it as wgmma's B operand with no transpose; the odd
input widths (63, 27) are zero-padded to the kernel's k-step of 16.  The
weights stay f32 up to the Function and are rounded to bf16 inside it, as
_trunk_fwd_impl casts them inside the custom VJP: so the weight gradients
reach the nn.Linear leaves in f32 (autograd would round a gradient to the
dtype of the tensor it belongs to).

A member axis: `pack_member_trunk_weights` stacks M ensemble members'
packed trunks to (M, ...) buffers, and x (M, B, input_ch + views_ch) then
runs each member's B rows through its own trunk, as the vmap of JAX's
ensemble step batches pallas_encode.  On the card one launch of each kernel
covers every member (grids with a member axis); the plain versions run
member by member.  Outputs and gradients keep the member axis first.

Spans and counters (utils/trace.py, while a profile records):
cfnerf.trunk.launch, the wrappers' host work for a kernel launch (the
checks, the bf16 weights, the outputs and workspaces, the tensor maps'
encoding and the enqueue); trunk.rows, the rows through `trunk_encode`
(every member's).  NeRFFlows.encode adds cfnerf.trunk.pack and
trunk.packs around `pack_trunk_weights`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cfnerf_torch.ops.kernels import _build
from cfnerf_torch.ops.kernels.render_core import _on_device
from cfnerf_torch.utils.trace import count, span

NAME = "trunk"
SOURCE = "cfnerf_torch/csrc/trunk.cu"
REPLACES = "cfnerf_tpu/ops/pallas/trunk.py:160"  # _fwd_kernel (with _fwd_mlp :132)
NAME_BWD = "trunk_bwd"
SOURCE_BWD = "cfnerf_torch/csrc/trunk_bwd.cu"
# _bwd_top_kernel and _bwd_bottom_kernel, both launched by _trunk_bwd (:330)
REPLACES_BWD = ("cfnerf_tpu/ops/pallas/trunk.py:170", "cfnerf_tpu/ops/pallas/trunk.py:229")

K_STEP = 16  # the kernel's k-step: input widths are padded to it
MAX_WIDTH = 512  # the forward's shared memory: at W=512, with x and v up to MAX_INPUT,
# one (64, W) bf16 activation buffer and the x and v tiles leave room for two 64 KB
# weight stages; the backward's data pass fits its own tiles at that width
MAX_INPUT = 128  # x and v widths the forward stages beside them
MAX_DEPTH = 32  # the backward's weight-gradient job table

Outputs = Tuple[torch.Tensor, torch.Tensor]


def _round(n: int) -> int:
    return -(-n // K_STEP) * K_STEP


def supported(depth: int, width: int, use_viewdirs: bool, skips: Sequence[int],
              h_alpha: int, h_rgb: int, input_ch: int, views_ch: int) -> bool:
    """The kernels' own rules: the viewdirs topology with one skip after
    layer depth // 2, 3 <= depth <= MAX_DEPTH (a skip + 1 layer exists), a
    width that splits into 16-column tiles at W and W/2 and fits shared
    memory, head widths in whole 16-column tiles no wider than the trunk
    (the backward stages their cotangents in an activation buffer), input
    widths they can stage."""
    return (use_viewdirs and tuple(skips) == (depth // 2,) and 3 <= depth <= MAX_DEPTH
            and width % 32 == 0 and 32 <= width <= MAX_WIDTH
            and h_alpha % 16 == 0 and 16 <= h_alpha <= width
            and h_rgb % 16 == 0 and 16 <= h_rgb <= width
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
    """The packed trunk: `w` the f32 matrices, `b` the f32 biases, each one
    flat buffer in `_layout` order, or (M, ...) for M members' trunks of one
    shape (`pack_member_trunk_weights`); the ints are the trunk's shape."""

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

    @property
    def stacked(self) -> bool:
        """True for the members' trunks stacked on a member axis."""
        return self.w.dim() == 2

    @property
    def members(self) -> int:
        return self.w.shape[0] if self.stacked else 1

    def member(self, m: int) -> "TrunkWeights":
        """Member m's trunk out of stacked ones."""
        return TrunkWeights(*self._shape(), w=self.w[m], b=self.b[m])

    def matrices(self) -> Dict[str, torch.Tensor]:
        """Views of `w`: name -> (out, in_padded) f32."""
        return _split_mats(self.w, self._shape())

    def biases(self) -> Dict[str, torch.Tensor]:
        """Views of `b`: name -> (size,) f32."""
        out, at = {}, 0
        for name, size in _layout(*self._shape())[1]:
            out[name] = self.b[at:at + size]
            at += size
        return out


def _split_mats(flat: torch.Tensor, shape) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, rows, cols in _layout(*shape)[0]:
        out[name] = flat[at:at + rows * cols].view(rows, cols)
        at += rows * cols
    return out


def pack_trunk_weights(model) -> TrunkWeights:
    """The trunk of a NeRFFlows (its pts_linears, feature_linear,
    views_linear, h_alpha_linear, h_rgb_linear) as the kernels read it.  The
    skip layer's weight splits into its x part (the first input_ch input
    columns, as the model concatenates [input_pts, h]) and its h part;
    views_linear's into its feature part (the first W columns) and its views
    part.  Made with differentiable ops, so the result requires grad where
    the model's weights do and grad mode is on, and the gradients of the
    packed buffers flow back through the splits and pads to the weights."""
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
    w = torch.cat([mats[name].reshape(-1) for name, _, _ in mat_layout]).float()
    b = torch.cat([biases[name].reshape(-1) for name, _ in bias_layout]).float()
    return TrunkWeights(*shape, w=w, b=b)


def pack_member_trunk_weights(models) -> TrunkWeights:
    """Ensemble members' trunks (NeRFFlows of one shape) packed each as
    `pack_trunk_weights` does and stacked on a leading member axis, with
    differentiable ops: each member's gradients flow back to its own
    weights."""
    packed = [pack_trunk_weights(m) for m in models]
    if len({p._shape() for p in packed}) != 1:
        raise ValueError(f"members' trunks differ in shape: {[p._shape() for p in packed]}")
    return TrunkWeights(*packed[0]._shape(), w=torch.stack([p.w for p in packed]),
                        b=torch.stack([p.b for p in packed]))


def _bf(t: torch.Tensor) -> torch.Tensor:
    """t's values rounded to bf16, held in f32: products of two such values
    are exact in f32, so an f32 product of them is a bf16 x bf16 product
    summed in f32."""
    return t.bfloat16().float()


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, k) x (out, k) -> (B, out): bf16 values, f32 products and sums."""
    return _bf(a) @ _bf(w).t()


def _check_x(packed: TrunkWeights, x: torch.Tensor) -> int:
    """The rows of x, a member's for stacked trunks."""
    cols = packed.input_ch + packed.views_ch
    if packed.stacked:
        if x.ndim != 3 or x.shape[0] != packed.members or x.shape[2] != cols:
            raise ValueError(f"x: expected ({packed.members}, B, {cols}), got {tuple(x.shape)}")
    elif x.ndim != 2 or x.shape[1] != cols:
        raise ValueError(f"x: expected (B, {cols}), got {tuple(x.shape)}")
    return x.shape[-2]


def _inputs(packed: TrunkWeights, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x split into its point and view columns, each zero-padded to the
    k-step and rounded to bf16 (held in f32)."""
    n = packed.input_ch
    xb = F.pad(x[:, :n], (0, _round(n) - n))
    vb = F.pad(x[:, n:], (0, _round(packed.views_ch) - packed.views_ch))
    return _bf(xb), _bf(vb)


def _forward(packed: TrunkWeights, x: torch.Tensor):
    """The forward's trunk activations (bf16 values in f32): (xb, vb, hs,
    f, hv) with hs the D post-relu layer outputs."""
    m, b = packed.matrices(), packed.biases()
    skip = packed.depth // 2
    xb, vb = _inputs(packed, x)
    hs = [_bf(torch.relu(_dot(xb, m["w0"]) + b["b0"]))]
    for i in range(1, packed.depth):
        if i == skip + 1:
            z = _dot(xb, m["wsx"]) + _dot(hs[-1], m["wsh"]) + b[f"b{i}"]
        else:
            z = _dot(hs[-1], m[f"w{i}"]) + b[f"b{i}"]
        hs.append(_bf(torch.relu(z)))
    f = _bf(_dot(hs[-1], m["wf"]) + b["bf"])
    hv = _bf(torch.relu(_dot(f, m["wvf"]) + _dot(vb, m["wvv"]) + b["bv"]))
    return xb, vb, hs, f, hv


ROWS = 64  # the kernels' rows per CTA: the saved activations' rows are padded to it
PLAN_FIELDS = ("rows_pad", "x", "v", "h", "f", "hv", "bytes")


def act_plan(packed: TrunkWeights, B: int) -> Dict[str, int]:
    """Where the training forward saves its activations for B rows, as the
    kernel library computes it (csrc/trunk.cuh's ActPlan, through
    trunk_fwd_act_plan): byte offsets of x, v, h (h_0..h_{D-1} then f, one
    (D + 1) x rows_pad x width block), f and hv, all bf16 row-major with
    rows_pad rows, and the workspace's bytes."""
    fn = _build.load(NAME).trunk_fwd_act_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    if fn(B, packed.depth, packed.width, packed.input_ch, packed.views_ch, out) != 0:
        raise ValueError(f"act_plan: unsupported shape {packed._shape()}")
    return dict(zip(PLAN_FIELDS, out))


def workspace_views(packed: TrunkWeights, B: int, acts: torch.Tensor,
                    plan: Optional[Dict[str, int]] = None):
    """The activations the training forward saved for B rows, read from its
    workspace (`acts`, uint8, laid out by `plan`, act_plan's by default) as
    `_forward` returns them: (xb, vb, hs, f, hv), bf16 values held in f32,
    rows < B."""
    plan = act_plan(packed, B) if plan is None else plan
    if acts.dtype != torch.uint8 or acts.numel() < plan["bytes"]:
        raise ValueError(f"workspace: expected >= {plan['bytes']} bytes of uint8, got "
                         f"{acts.numel()} of {acts.dtype}")
    R = plan["rows_pad"]

    def read(off, cols):
        return acts[off:off + R * cols * 2].view(torch.bfloat16).view(R, cols)[:B].float()

    W = packed.width
    hs = [read(plan["h"] + i * R * W * 2, W) for i in range(packed.depth)]
    return (read(plan["x"], _round(packed.input_ch)), read(plan["v"], _round(packed.views_ch)),
            hs, read(plan["f"], W), read(plan["hv"], W // 2))


def trunk_encode_plain(packed: TrunkWeights, x: torch.Tensor) -> Outputs:
    """The trunk forward in eager PyTorch, with the kernel's arithmetic.
    x (B, input_ch + views_ch) f32 -> (h_alpha (B, h_alpha), h_rgb (B,
    h_rgb)) f32; stacked trunks: x (M, B, .) -> (M, B, .), member by
    member.  Differentiable by autograd, but autograd rounds the weight
    gradients to bf16 and takes its products in f32: `_Trunk` differentiates
    it with `trunk_encode_bwd_plain` instead."""
    _check_x(packed, x)
    if packed.stacked:
        outs = [trunk_encode_plain(packed.member(m), x[m]) for m in range(packed.members)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    m, b = packed.matrices(), packed.biases()
    _, _, hs, _, hv = _forward(packed, x)
    return _dot(hs[-1], m["wha"]) + b["bha"], _dot(hv, m["whr"]) + b["bhr"]


def trunk_encode_bwd_plain(packed: TrunkWeights, x: torch.Tensor,
                           g_h_alpha: Optional[torch.Tensor],
                           g_h_rgb: Optional[torch.Tensor]) -> Outputs:
    """The trunk backward in eager PyTorch, with _trunk_bwd's arithmetic
    (cfnerf_tpu/ops/pallas/trunk.py:170-262): the forward recomputed, then
    the heads and layers in reverse.  g_h_alpha (B, h_alpha), g_h_rgb (B,
    h_rgb) f32, None for an unused head.  Returns (dw, db), f32, laid out as
    `packed.w` and `packed.b`; x gets no gradient.  Stacked trunks: x and
    the cotangents (M, B, .), member by member."""
    B = _check_x(packed, x)
    if packed.stacked:
        grads = [trunk_encode_bwd_plain(packed.member(m), x[m],
                                        None if g_h_alpha is None else g_h_alpha[m],
                                        None if g_h_rgb is None else g_h_rgb[m])
                 for m in range(packed.members)]
        return torch.stack([g[0] for g in grads]), torch.stack([g[1] for g in grads])
    with torch.no_grad():
        m, b = packed.matrices(), packed.biases()
        skip = packed.depth // 2
        xb, vb, hs, f, hv = _forward(packed, x)
        g_ha = x.new_zeros(B, packed.h_alpha) if g_h_alpha is None else g_h_alpha.float()
        g_hr = x.new_zeros(B, packed.h_rgb) if g_h_rgb is None else g_h_rgb.float()
        dw: Dict[str, torch.Tensor] = {}
        db: Dict[str, torch.Tensor] = {}

        def outer(g, h):  # (B, out) x (B, in) -> (out, in): the weight gradient
            return _bf(g).t() @ h

        def back(g, w):  # (B, out) x (out, in) -> (B, in): the input gradient
            return _bf(g) @ _bf(w)

        db["bhr"], dw["whr"] = g_hr.sum(0), outer(g_hr, hv)
        g_hv = back(g_hr, m["whr"]) * (hv > 0)
        db["bv"], dw["wvf"], dw["wvv"] = g_hv.sum(0), outer(g_hv, f), outer(g_hv, vb)
        g_f = back(g_hv, m["wvf"])
        db["bf"], dw["wf"] = g_f.sum(0), outer(g_f, hs[-1])
        db["bha"], dw["wha"] = g_ha.sum(0), outer(g_ha, hs[-1])
        g = back(g_f, m["wf"]) + back(g_ha, m["wha"])
        for i in range(packed.depth - 1, -1, -1):
            g = g * (hs[i] > 0)
            db[f"b{i}"] = g.sum(0)
            if i == skip + 1:
                dw["wsh"], dw["wsx"] = outer(g, hs[i - 1]), outer(g, xb)
                g = back(g, m["wsh"])
            elif i == 0:
                dw["w0"] = outer(g, xb)
            else:
                dw[f"w{i}"] = outer(g, hs[i - 1])
                g = back(g, m[f"w{i}"])
        mats, biases = _layout(*packed._shape())
        return (torch.cat([dw[name].reshape(-1) for name, _, _ in mats]),
                torch.cat([db[name] for name, _ in biases]))


def _devices(what: str, tensors) -> str:
    """'cpu' or 'cuda' for tensors all on the CPU or all on CUDA; raises
    otherwise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(
            f"{what}: all inputs must be on one CUDA device or all on the CPU "
            f"(got {sorted(kinds)})"
        )
    return kinds.pop()


def trunk_encode(packed: TrunkWeights, x: torch.Tensor, *, interpret: bool = False) -> Outputs:
    """Trunk forward.  Arguments and outputs as in `trunk_encode_plain`,
    stacked trunks included (one launch covers every member).  CPU tensors,
    and with interpret=True tensors on either device, take the plain
    version; CUDA tensors launch the kernel or raise; anything else
    raises.  Where a gradient is required the call goes through `_Trunk`,
    whose backward is the backward kernel or, on the plain route,
    `trunk_encode_bwd_plain`."""
    count("trunk.rows", _check_x(packed, x) * packed.members)
    args = (x, packed.w, packed.b)
    plain = _devices("trunk", args) == "cpu" or interpret
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Trunk.apply(packed._shape(), plain, *args)
    if plain:
        return trunk_encode_plain(packed, x)
    return _launch(packed, x)


trunk_encode.launches = 0  # kernel launches; the plain route never counts


def trunk_encode_bwd(packed: TrunkWeights, x: torch.Tensor,
                     g_h_alpha: Optional[torch.Tensor],
                     g_h_rgb: Optional[torch.Tensor]) -> Outputs:
    """Trunk backward.  Arguments and gradients as in
    `trunk_encode_bwd_plain`.  CPU tensors take the plain version; CUDA
    tensors launch the forward's training variant, then the backward
    kernels on its saved activations (or raise); anything else raises.
    Training reaches the same two launches through autograd (`_Trunk`);
    this entry lets a caller hold them against the plain version."""
    _check_x(packed, x)
    if _devices("trunk backward", (x, packed.w, packed.b, g_h_alpha, g_h_rgb)) == "cpu":
        return trunk_encode_bwd_plain(packed, x, g_h_alpha, g_h_rgb)
    B, _ = _kernel_args(packed, x, "trunk backward kernel")
    cots = _cotangents(packed._shape(), B, packed.members if packed.stacked else None, x,
                       g_h_alpha, g_h_rgb)
    w16 = packed.w.to(torch.bfloat16)
    _, _, acts = _launch(packed, x, save=True, w16=w16)
    return _launch_bwd(packed._shape(), w16, acts, B, *cots)


trunk_encode_bwd.launches = 0  # backward launches (one entry call, its four kernels)


class _Trunk(torch.autograd.Function):
    """The trunk with a gradient: forward and backward kernels on the card,
    or (`plain`) the plain versions.  Takes the f32 packed weights, so that
    the weight gradients it returns stay f32; x gets none.  On the card the
    forward keeps the bf16 weights and the activation workspace for the
    backward (~9.9 KB a row at D8/W512); autograd drops both once the
    backward has run."""

    @staticmethod
    def forward(ctx, shape, plain, x, w, b):
        ctx.shape, ctx.plain, ctx.rows = shape, plain, x.shape[-2]
        ctx.set_materialize_grads(False)  # an unused head's cotangent arrives as None
        packed = TrunkWeights(*shape, w=w, b=b)
        if plain:
            ctx.save_for_backward(x, w, b)
            return trunk_encode_plain(packed, x)
        w16 = w.to(torch.bfloat16)
        h_alpha, h_rgb, acts = _launch(packed, x, save=True, w16=w16)
        ctx.save_for_backward(w16, acts)
        return h_alpha, h_rgb

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_h_alpha, g_h_rgb):
        if ctx.plain:
            x, w, b = ctx.saved_tensors
            dw, db = trunk_encode_bwd_plain(TrunkWeights(*ctx.shape, w=w, b=b), x,
                                            g_h_alpha, g_h_rgb)
        else:
            w16, acts = ctx.saved_tensors
            dw, db = _launch_bwd(ctx.shape, w16, acts, ctx.rows, g_h_alpha, g_h_rgb)
        return None, None, None, dw, db


def _kernel_args(packed: TrunkWeights, x: torch.Tensor, what: str):
    """Checks what the kernels take; returns (B, x's row stride), B a
    member's rows for stacked trunks, whose rows must follow one another
    through the members at that stride."""
    B = _check_x(packed, x)
    dev = x.device
    for name, t in (("x", x), ("w", packed.w), ("b", packed.b)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if not (packed.w.is_contiguous() and packed.b.is_contiguous() and x.stride(-1) == 1):
        raise ValueError(f"{what} takes contiguous weights and x with contiguous "
                         f"rows (got x strides {x.stride()})")
    if not supported(packed.depth, packed.width, True, (packed.depth // 2,), packed.h_alpha,
                     packed.h_rgb, packed.input_ch, packed.views_ch):
        raise ValueError(f"{what}: unsupported shape {packed._shape()}")
    row_stride = x.stride(-2) if B > 1 else x.shape[-1]  # a single row's stride is arbitrary
    if packed.members > 1 and x.stride(0) != B * row_stride:
        raise ValueError(f"{what}: the members' rows must follow one another at one stride "
                         f"(got x strides {x.stride()} for {B} rows a member)")
    return B, row_stride


def _launch(packed: TrunkWeights, x: torch.Tensor, save: bool = False,
            w16: Optional[torch.Tensor] = None):
    """The forward kernel: (h_alpha, h_rgb); with `save` the training
    variant, which also writes every bf16 activation into a new workspace:
    (h_alpha, h_rgb, workspace).  `w16`: the weights already cast."""
    with span("cfnerf.trunk.launch"):
        B, row_stride = _kernel_args(packed, x, "trunk kernel")
        w16 = packed.w.to(torch.bfloat16) if w16 is None else w16
        M, lead = packed.members, x.shape[:-2]
        h_alpha = x.new_empty((*lead, B, packed.h_alpha))
        h_rgb = x.new_empty((*lead, B, packed.h_rgb))
        shape = packed._shape()
        if save:
            fn, workspace_bytes = _entry_save()
            acts = x.new_empty((M * workspace_bytes(B, *shape[:4]),), dtype=torch.uint8)
            extra = (acts.data_ptr(), acts.numel())
        else:
            fn, extra = _entry(), ()
        with _on_device(x.device) as stream:
            err = fn(x.data_ptr(), row_stride, w16.data_ptr(), packed.b.data_ptr(),
                     h_alpha.data_ptr(), h_rgb.data_ptr(), *extra, B, *shape, M, stream)
    if err != 0:
        raise RuntimeError(f"trunk_fwd{'_save' if save else ''} launch failed: CUDA error "
                           f"{err} (B={B}, members={M}, shape {shape})")
    trunk_encode.launches += 1
    return (h_alpha, h_rgb, acts) if save else (h_alpha, h_rgb)


def _cotangents(shape, B: int, members: Optional[int], like: torch.Tensor,
                g_h_alpha: Optional[torch.Tensor], g_h_rgb: Optional[torch.Tensor]) -> Outputs:
    """The two heads' cotangents as the backward kernels take them: f32
    (B, width), or (members, B, width) for stacked trunks, on `like`'s
    device, contiguous, zeros for an unused head (None)."""
    dev = like.device
    lead = () if members is None else (members,)
    cots = []
    for name, g, cols in (("h_alpha", g_h_alpha, shape[4]), ("h_rgb", g_h_rgb, shape[5])):
        want = (*lead, B, cols)
        if g is None:
            g = like.new_zeros(want, dtype=torch.float32)
        elif tuple(g.shape) != want or g.dtype != torch.float32 or g.device != dev:
            raise ValueError(f"cotangent of {name}: expected float32 {want} on "
                             f"{dev}, got {g.dtype} {tuple(g.shape)} on {g.device}")
        cots.append(g.contiguous())  # autograd may hand over expanded views
    return cots[0], cots[1]


def _launch_bwd(shape, w16: torch.Tensor, acts: torch.Tensor, B: int,
                g_h_alpha: Optional[torch.Tensor], g_h_rgb: Optional[torch.Tensor]) -> Outputs:
    """The backward kernels of the trunk `shape` (TrunkWeights._shape) on
    the activations the training forward saved for B rows (`acts`), with the
    bf16 weights `w16`; (M, ...) weights for M stacked members, B rows
    each.  Returns (dw, db) in f32, (M, ...) for stacked members."""
    members = w16.shape[0] if w16.dim() == 2 else None
    M = members or 1
    with span("cfnerf.trunk.launch"):
        g_ha, g_hr = _cotangents(shape, B, members, acts, g_h_alpha, g_h_rgb)
        fn, workspace_bytes = _entry_bwd()
        workspace = acts.new_empty((M * workspace_bytes(B, *shape),))
        mats, biases = _layout(*shape)
        lead = w16.shape[:-1]
        dw = acts.new_empty((*lead, sum(r * c for _, r, c in mats)), dtype=torch.float32)
        db = acts.new_empty((*lead, sum(n for _, n in biases)), dtype=torch.float32)
        with _on_device(acts.device) as stream:
            err = fn(acts.data_ptr(), acts.numel(), w16.data_ptr(), g_ha.data_ptr(),
                     g_hr.data_ptr(), dw.data_ptr(), db.data_ptr(), workspace.data_ptr(),
                     workspace.numel(), B, *shape, M, stream)
    if err != 0:
        raise RuntimeError(
            f"trunk_bwd launch failed: CUDA error {err} (B={B}, members={M}, shape {shape})"
        )
    trunk_encode_bwd.launches += 1
    return dw, db


def _entry():
    """The ctypes entry of the serving forward: emb, its row stride, w, b,
    h_alpha, h_rgb, then B (a member's), depth, width, input_ch, views_ch,
    h_alpha, h_rgb, the members and the stream."""
    fn = getattr(_build.load(NAME), "trunk_fwd")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _entry_save():
    """The ctypes entries of the training forward: trunk_fwd_save (as
    trunk_fwd, with the activation workspace and its bytes after h_rgb) and
    trunk_fwd_workspace (B, depth, width, input_ch, views_ch -> a member's
    workspace bytes)."""
    lib = _build.load(NAME)
    fn, size = lib.trunk_fwd_save, lib.trunk_fwd_workspace
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    if size.argtypes is None:
        size.argtypes = [ctypes.c_int] * 5
        size.restype = ctypes.c_longlong
    return fn, size


def _entry_bwd():
    """The ctypes entries of the backward: trunk_bwd (the saved activations
    and their bytes, w, g_h_alpha, g_h_rgb, dw, db, the workspace and its
    bytes, then B (a member's), depth, width, input_ch, views_ch, h_alpha,
    h_rgb, the members and the stream) and trunk_bwd_workspace (B and the six
    shape ints -> the bytes of scratch trunk_bwd needs a member)."""
    lib = _build.load(NAME_BWD)
    fn, size = lib.trunk_bwd, lib.trunk_bwd_workspace
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 6
                       + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    if size.argtypes is None:
        size.argtypes = [ctypes.c_int] * 7
        size.restype = ctypes.c_longlong
    return fn, size
