"""The triangular-Sylvester flow stack, forward and backward.

Counterpart of cfnerf_tpu/ops/pallas/flow_stack.py:fused_flow_stack and its
custom VJP.  The unfused model forward (hierarchical sampling, applied
density noise) runs both flow families through it.  On CUDA tensors the
wrappers launch the hand-written Hopper kernels (cfnerf_torch/csrc/
flow_stack.cu, flow_stack_bwd.cu) or raise; on CPU tensors they run the
plain versions, which are also the kernels' oracles on the card.

Shapes: z0 (B, K, Z), r1, r2 (B, Z, Z, F), b (B, Z, F), Z in {1, 3}, any
B, K >= 1 and F >= 1.  z0 may be the model's shared (K, Z) draws expanded
over the points: the kernels read it through its point stride (0), so the
expand is never materialised.  The other inputs must be contiguous.

A member axis: z0 (M, K, Z) with M != B dividing B makes one call cover M
ensemble members, as the vmap of JAX's ensemble step batches the Pallas
kernel.  The B points are member-major blocks of B / M, block m drawing
z0[m] (M = 1: the shared draws of one model).  One launch of each kernel
covers every member, each (point, draw) doing its member's arithmetic;
the plain versions run member by member, each on its one-member shapes.

Where a gradient is needed, the CUDA route goes through `_FlowStack`, an
autograd Function whose forward is the forward kernel and whose backward is
the backward kernel.  Like JAX's _fused_bwd, the backward kernel returns
g_z0 as (B, K, Z); autograd's expand sums it over the points, and with a
member axis `_FlowStack` sums each member's block as that expand sums a
member's own call.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from cfnerf_torch.flows.sylvester import triangular_sylvester_stack
from cfnerf_torch.ops.kernels import _build
from cfnerf_torch.ops.kernels.render_core import _on_device

NAME = "flow_stack"
SOURCE = "cfnerf_torch/csrc/flow_stack.cu"
REPLACES = "cfnerf_tpu/ops/pallas/flow_stack.py:109"  # _fwd_kernel
NAME_BWD = "flow_stack_bwd"
SOURCE_BWD = "cfnerf_torch/csrc/flow_stack_bwd.cu"
REPLACES_BWD = "cfnerf_tpu/ops/pallas/flow_stack.py:125"  # _bwd_kernel

Z_SIZES = (1, 3)  # the density and rgb chains; the kernels' template values

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def member_axis(z0, r1) -> bool:
    """Whether a call has a member axis: z0 (M, K, Z) beside the B points
    of r1, M != B (M = 1: one model's shared draws, not expanded)."""
    return z0.shape[0] != r1.shape[0]


def members_of(z0, r1) -> int:
    """The member count of a call: M for z0 (M, K, Z) with a member axis,
    else 1 (z0 (B, K, Z): a draw set a point, or one model's expanded)."""
    return z0.shape[0] if member_axis(z0, r1) else 1


def _shapes(z0, r1, r2, b) -> Tuple[int, int, int, int]:
    """Validate the argument shapes; returns (B, K, Z, F), B the points of
    all members."""
    if z0.ndim != 3:
        raise ValueError(f"z0: expected (B, K, Z) or (M, K, Z), got {tuple(z0.shape)}")
    _, K, Z = z0.shape
    B = r1.shape[0] if r1.ndim else 0
    if Z not in Z_SIZES:
        raise ValueError(f"flow stack: Z must be one of {Z_SIZES}, got {Z}")
    if z0.shape[0] != B and (z0.shape[0] < 1 or B % z0.shape[0]):
        raise ValueError(f"{B} points do not split over z0's {z0.shape[0]} members")
    F = r1.shape[-1] if r1.ndim == 4 else 0
    for name, t, shape in (("r1", r1, (B, Z, Z, F)), ("r2", r2, (B, Z, Z, F)),
                           ("b", b, (B, Z, F))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if K < 1 or F < 1:
        raise ValueError(f"need K >= 1 draws and F >= 1 flow steps (K={K}, F={F})")
    return B, K, Z, F


def _rows(params, m: int, M: int):
    """Member m's points of a member-batched call's per-point tensors."""
    n = params[0].shape[0] // M
    return [t[m * n:(m + 1) * n] for t in params]


def fused_flow_stack_plain(z0, r1, r2, b, compute_log_det: bool):
    """The flow stack in eager PyTorch: `triangular_sylvester_stack`.
    Returns (z (B, K, Z), ldj (B, K)); ldj is zeros when compute_log_det is
    False.  With a member axis, member by member, each member's call as a
    model makes it alone (its draws expanded over its points); the outputs
    joined along the points."""
    _shapes(z0, r1, r2, b)
    if not member_axis(z0, r1):
        return triangular_sylvester_stack(z0, r1, r2, b, compute_log_det=compute_log_det)
    M = members_of(z0, r1)
    n = r1.shape[0] // M
    outs = [triangular_sylvester_stack(d[None].expand(n, *d.shape), *_rows((r1, r2, b), m, M),
                                       compute_log_det=compute_log_det)
            for m, d in enumerate(z0.unbind(0))]
    return outs[0] if M == 1 else tuple(torch.cat(t) for t in zip(*outs))


def fused_flow_stack_bwd_plain(
    inputs: Sequence[torch.Tensor],
    cotangents: Sequence[Optional[torch.Tensor]],
    compute_log_det: bool,
) -> Grads:
    """The flow-stack backward in eager PyTorch: autograd through the plain
    version.  `inputs` are (z0, r1, r2, b), `cotangents` those of (z, ldj),
    None for an unused one.  Returns (g_z0 (B, K, Z), g_r1, g_r2, g_b); z0
    is differentiated as the (B, K, Z) tensor it is, expanded or not.  With
    z0 (M, K, Z), member by member, each member's draws expanded over its
    points: g_z0 per point (B, K, Z), as the backward kernel gives it."""
    _shapes(*inputs)
    z0, params = inputs[0], inputs[1:]
    if member_axis(z0, params[0]):
        M = members_of(z0, params[0])
        n = params[0].shape[0] // M
        grads = [fused_flow_stack_bwd_plain(
            [z0[m][None].expand(n, *z0.shape[1:]), *_rows(params, m, M)],
            [None if g is None else g[m * n:(m + 1) * n] for g in cotangents],
            compute_log_det) for m in range(M)]
        return tuple(torch.cat(g) for g in zip(*grads))
    with torch.enable_grad():
        z0 = inputs[0].detach().contiguous().requires_grad_()
        xs = [z0] + [t.detach().requires_grad_() for t in inputs[1:]]
        outs = fused_flow_stack_plain(*xs, compute_log_det)
        # test mode's ldj is a constant: it has no graph to go back through
        pairs = [(o, g) for o, g in zip(outs, cotangents)
                 if g is not None and o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], xs,
                                    [g for _, g in pairs], allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads))


def fused_flow_stack(z0, r1, r2, b, compute_log_det: bool):
    """Flow-stack forward.  Arguments and outputs as in
    `fused_flow_stack_plain`, with or without a member axis (one launch
    covers every member).  CPU tensors take the plain version (and
    autograd through it); CUDA tensors launch the kernel or raise, through
    `_FlowStack` when a gradient is needed, so that the backward launches the
    backward kernel; anything else raises."""
    args = (z0, r1, r2, b)
    _shapes(*args)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return fused_flow_stack_plain(*args, compute_log_det)
    if kinds != {"cuda"}:
        raise ValueError(
            f"flow stack: all inputs must be on one CUDA device or all on the "
            f"CPU (got {sorted(kinds)})"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FlowStack.apply(compute_log_det, *args)
    return _launch(args, compute_log_det)


fused_flow_stack.launches = 0  # kernel launches; the plain route never counts


def fused_flow_stack_bwd(
    inputs: Sequence[torch.Tensor],
    cotangents: Sequence[Optional[torch.Tensor]],
    compute_log_det: bool,
) -> Grads:
    """Flow-stack backward.  Arguments and gradients as in
    `fused_flow_stack_bwd_plain`.  CPU tensors take the plain version; CUDA
    tensors launch the backward kernel (or raise); anything else raises.
    Training reaches the kernel through autograd (`_FlowStack`); this entry
    lets a caller hold the kernel against the plain version."""
    _shapes(*inputs)
    kinds = {t.device.type for t in (*inputs, *cotangents) if t is not None}
    if kinds == {"cpu"}:
        return fused_flow_stack_bwd_plain(inputs, cotangents, compute_log_det)
    if kinds != {"cuda"}:
        raise ValueError(
            f"flow stack backward: all tensors must be on one CUDA device or "
            f"all on the CPU (got {sorted(kinds)})"
        )
    return _launch_bwd(inputs, cotangents, compute_log_det)


fused_flow_stack_bwd.launches = 0  # backward kernel launches


class _FlowStack(torch.autograd.Function):
    """The CUDA route with a gradient: the forward kernel, then the backward
    kernel on the saved inputs (z0 saved as the view it is), one launch each
    for all members.  With a member axis the per-point g_z0 is summed over
    each member's points in turn, as autograd's expand sums a one-member
    call's (a sum over axis 0 of that member's (B / M, K, Z) block), so
    each member gets the bits of its own call."""

    @staticmethod
    def forward(ctx, compute_log_det, *args):
        ctx.save_for_backward(*args)
        ctx.compute_log_det = compute_log_det
        ctx.set_materialize_grads(False)  # an unused output arrives as None
        return _launch(args, compute_log_det)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_z, g_ldj):
        z0, r1 = ctx.saved_tensors[:2]
        g_z0, *grads = _launch_bwd(ctx.saved_tensors, (g_z, g_ldj), ctx.compute_log_det)
        if member_axis(z0, r1):
            g_z0 = torch.cat([g.sum(0, keepdim=True)
                              for g in g_z0.chunk(members_of(z0, r1))])
        return (None, g_z0, *grads)


def _z0_stride(z0: torch.Tensor, r1: torch.Tensor) -> int:
    """Floats between two points' draws in z0: K*Z when z0 is contiguous, 0
    when it is a (K, Z) block expanded over the points or a member axis's
    contiguous (M, K, Z) blocks.  Raises otherwise."""
    B, K, Z = z0.shape
    if member_axis(z0, r1):
        if not z0.is_contiguous():
            raise ValueError("flow stack kernel takes a member axis's z0 (M, K, Z) contiguous "
                             f"(got strides {z0.stride()})")
        return 0
    if z0.is_contiguous():
        return K * Z
    block = (K == 1 or z0.stride(1) == Z) and (Z == 1 or z0.stride(2) == 1)
    if z0.stride(0) == 0 and block:
        return 0
    raise ValueError(
        "flow stack kernel takes z0 contiguous or as a contiguous (K, Z) block "
        f"expanded over the points (got strides {z0.stride()})"
    )


def _check_kernel_inputs(tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "flow stack kernel takes contiguous float32 tensors on one "
                f"device (got {t.dtype} on {t.device}, contiguous="
                f"{t.is_contiguous()})"
            )


def _launch(args, compute_log_det: bool):
    z0, r1, r2, b = args
    B, K, Z, F = _shapes(*args)
    stride = _z0_stride(z0, r1)
    M = members_of(z0, r1)
    _check_kernel_inputs((r1, r2, b))
    if z0.device != r1.device or z0.dtype != torch.float32:
        raise ValueError(f"z0: expected float32 on {r1.device}, got {z0.dtype} on {z0.device}")
    fn = _entry()
    z = r1.new_empty((B, K, Z))
    ldj = r1.new_empty((B, K))
    with _on_device(r1.device) as stream:
        err = fn(z0.data_ptr(), stride, r1.data_ptr(), r2.data_ptr(), b.data_ptr(),
                 z.data_ptr(), ldj.data_ptr(), B, K, Z, F,
                 int(bool(compute_log_det)), M, stream)
    if err != 0:
        raise RuntimeError(f"flow_stack_fwd launch failed: CUDA error {err} "
                           f"(B={B}, members={M}, K={K}, Z={Z}, F={F})")
    fused_flow_stack.launches += 1
    return z, ldj


def _launch_bwd(inputs, cotangents, compute_log_det: bool) -> Grads:
    z0, r1, r2, b = inputs
    B, K, Z, F = _shapes(*inputs)
    stride = _z0_stride(z0, r1)
    M = members_of(z0, r1)
    _check_kernel_inputs((r1, r2, b))
    cots = []
    for name, g, shape in zip(("z", "ldj"), cotangents, ((B, K, Z), (B, K))):
        if g is None:
            g = r1.new_zeros(shape)
        elif tuple(g.shape) != shape or g.dtype != torch.float32:
            raise ValueError(
                f"cotangent of {name}: expected float32 {shape}, got "
                f"{g.dtype} {tuple(g.shape)}"
            )
        cots.append(g.contiguous())  # autograd may hand over expanded views
    fn = _entry_bwd()
    g_z0 = r1.new_empty((B, K, Z))
    g_r1, g_r2, g_b = (t.new_empty(t.shape) for t in (r1, r2, b))
    with _on_device(r1.device) as stream:
        err = fn(z0.data_ptr(), stride, r1.data_ptr(), r2.data_ptr(), b.data_ptr(),
                 cots[0].data_ptr(), cots[1].data_ptr(), g_z0.data_ptr(),
                 g_r1.data_ptr(), g_r2.data_ptr(), g_b.data_ptr(), B, K, Z, F,
                 int(bool(compute_log_det)), M, stream)
    if err != 0:
        raise RuntimeError(f"flow_stack_bwd launch failed: CUDA error {err} "
                           f"(B={B}, members={M}, K={K}, Z={Z}, F={F})")
    fused_flow_stack_bwd.launches += 1
    return g_z0, g_r1, g_r2, g_b


def _bind(name: str, symbol: str, n_in: int, n_out: int):
    """The ctypes entry: z0, its point stride, the other inputs and the
    outputs, then B, K, Z, F, compute_log_det, the member count and the
    stream."""
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * (n_in - 1 + n_out)
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _entry():
    return _bind(NAME, "flow_stack_fwd", 4, 2)


def _entry_bwd():
    return _bind(NAME_BWD, "flow_stack_bwd", 6, 4)
