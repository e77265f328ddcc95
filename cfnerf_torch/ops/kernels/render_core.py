"""Fused flow stacks + K-sample alpha composite: the render core, forward
and backward.

Counterpart of cfnerf_tpu/ops/pallas/render_core.py:fused_flow_composite
and its custom VJP.  On CUDA tensors the wrappers launch the hand-written
Hopper kernels (cfnerf_torch/csrc/render_core.cu, render_core_bwd.cu) or
raise; on CPU tensors they run the plain versions, the same functions in
eager PyTorch, which are also the kernels' oracles on the card.  There is
no shape gate: any R, any S >= 1, any K and any F up to MAX_F, the most
the forward kernel can stage (the backward takes every F the forward
takes: F = 4 compile-time, F <= 8 with each step's input kept in
registers, any larger F recomputed from z0).  The
kernels cut each ray into segments, one per warp (`kernel_segments`), and
join them; `fused_flow_composite_segmented` and
`fused_flow_composite_bwd_segmented` do that arithmetic in eager PyTorch
for the tests.

Where a gradient is needed, the CUDA route goes through an autograd
Function whose forward is the forward kernel and whose backward is the
backward kernel.  The plain version differentiates through autograd
(cumprod, no closed-form division).

A member axis: z0_a (M, K, 1) and z0_r (M, K, 3) instead of (K, 1) and
(K, 3) make one call cover M ensemble members, as the vmap of JAX's
ensemble step batches the Pallas kernel.  The M * R rays are member-major
(R a member, the same S, K and F for all), each drawing its member's z0;
the outputs keep the ray axis (M * R, ...) and the z0 gradients come out
(M, K, .), each member's sum over its own points.  One launch of each
kernel covers them all; the plain versions run member by member.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Sequence, Tuple

import torch

from cfnerf_torch.flows.sylvester import triangular_sylvester_stack
from cfnerf_torch.ops.compositing import TRANS_EPS, composite_weights, softplus
from cfnerf_torch.ops.kernels import _build

NAME = "render_core"
SOURCE = "cfnerf_torch/csrc/render_core.cu"
REPLACES = "cfnerf_tpu/ops/pallas/render_core.py:322"  # _fwd_kernel
NAME_BWD = "render_core_bwd"
SOURCE_BWD = "cfnerf_torch/csrc/render_core_bwd.cu"
REPLACES_BWD = "cfnerf_tpu/ops/pallas/render_core.py:378"  # _bwd_kernel
# flow steps the forward kernel can stage: one sample a ring stage must fit
# its 227 KB of shared memory (render_core.cu:fwd_smem_bytes)
MAX_F = 146
SEG_WARPS, MAX_SEG = 8, 16  # segments a round, samples a segment (render_core.cuh)

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Grads = Tuple[torch.Tensor, ...]  # the 8 flow-input gradients, z0_a ... b_r


def members_of(z0_a) -> int:
    """The member count of a call: M for z0_a (M, K, 1), 1 for (K, 1)."""
    return z0_a.shape[0] if z0_a.dim() == 3 else 1


def _shapes(z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts, s_per_ray):
    """Validate the argument shapes; returns (R, S, K, F), R the rays of
    all members."""
    lead = tuple(z0_a.shape[:-2]) if z0_a.dim() == 3 else ()
    K = z0_a.shape[-2]
    B, F = r1_a.shape[0], r1_a.shape[-1]
    S = int(s_per_ray)
    want = {
        "z0_a": (z0_a, (*lead, K, 1)), "r1_a": (r1_a, (B, 1, 1, F)),
        "r2_a": (r2_a, (B, 1, 1, F)), "b_a": (b_a, (B, 1, F)),
        "z0_r": (z0_r, (*lead, K, 3)), "r1_r": (r1_r, (B, 3, 3, F)),
        "r2_r": (r2_r, (B, 3, 3, F)), "b_r": (b_r, (B, 3, F)),
        "z_pts": (z_pts, (B,)), "d_pts": (d_pts, (B,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if S < 1 or B % S:
        raise ValueError(f"B={B} points do not split into rays of S={S} samples")
    if K < 1 or F < 1:
        raise ValueError(f"need K >= 1 draws and F >= 1 flow steps (K={K}, F={F})")
    M = members_of(z0_a)
    if M < 1 or (B // S) % M:
        raise ValueError(f"{B // S} rays do not split over {M} members")
    return B // S, S, K, F


def _member_slices(args, m: int, M: int):
    """Member m's share of a member-batched call's 10 arguments: its z0
    rows and its points."""
    n = args[1].shape[0] // M
    rows = slice(m * n, (m + 1) * n)
    return [t[m] if i in (0, 4) else t[rows] for i, t in enumerate(args)]


def fused_flow_composite_plain(
    z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts,
    s_per_ray: int, compute_log_det: bool,
) -> Outputs:
    """The render-core forward in eager PyTorch: broadcast the shared draws
    to (B, K, Z), run both flow stacks, then the log-det corrections and the
    raw2outputs composite.  Same signature and outputs as the kernel:

      z0_a (K, 1), z0_r (K, 3): shared base draws;
      r1_a, r2_a (B, 1, 1, F), b_a (B, 1, F): density flow parameters;
      r1_r, r2_r (B, 3, 3, F), b_r (B, 3, F): rgb flow parameters;
      z_pts (B,): sample depths; d_pts (B,): interval * |rays_d|, last
      interval LAST_DIST already applied; B = R * s_per_ray, sample minor.

    Returns rgb (R, 3, K), depth (R, K), acc (R, K), ldj (2, R): per-ray sums
    over (s, k) of the flow log-dets + final-activation corrections, density
    row then rgb row; zeros when compute_log_det is False.

    With z0_a (M, K, 1) and z0_r (M, K, 3) (a member axis), the rays are
    M members' in turn and each member runs through the one-member version
    on its share; the outputs are the members' joined along the ray axis.
    """
    R, S, K, _ = _shapes(z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r,
                         z_pts, d_pts, s_per_ray)
    M = members_of(z0_a)
    if z0_a.dim() == 3:
        args = (z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts)
        outs = [fused_flow_composite_plain(*_member_slices(args, m, M), s_per_ray,
                                           compute_log_det) for m in range(M)]
        rgb, depth, acc, ldj = zip(*outs)
        # rgb joined in the one-member version's memory layout, (R, K, 3)
        # transposed, so that later reductions over K sum in its order
        rgb = torch.cat([r.transpose(1, 2) for r in rgb]).transpose(1, 2)
        return rgb, torch.cat(depth), torch.cat(acc), torch.cat(ldj, 1)
    B = R * S
    z_a, ldj_a = triangular_sylvester_stack(
        z0_a[None].expand(B, K, 1), r1_a, r2_a, b_a,
        compute_log_det=compute_log_det,
    )
    z_r, ldj_r = triangular_sylvester_stack(
        z0_r[None].expand(B, K, 3), r1_r, r2_r, b_r,
        compute_log_det=compute_log_det,
    )
    z = z_pts.reshape(R, S)
    alpha = 1.0 - torch.exp(-softplus(z_a[..., 0].reshape(R, S, K))
                            * d_pts.reshape(R, S, 1))
    w = composite_weights(alpha)  # (R, S, K)
    rgb = torch.sigmoid(z_r).reshape(R, S, K, 3)
    rgb_map = torch.sum(w[..., None] * rgb, dim=1).transpose(1, 2)  # (R, 3, K)
    depth = torch.sum(w * z[..., None], dim=1)
    acc = torch.sum(w, dim=1)
    if compute_log_det:
        # final-activation corrections (reference models.py:261-278)
        corr_a = ldj_a + (z_a - softplus(z_a)).sum(-1)
        corr_r = ldj_r + (z_r - 2.0 * softplus(z_r)).sum(-1)
        ldj = torch.stack([corr_a.reshape(R, S * K).sum(1),
                           corr_r.reshape(R, S * K).sum(1)])
    else:
        ldj = torch.zeros(2, R, dtype=acc.dtype, device=acc.device)
    return rgb_map, depth, acc, ldj


def fused_flow_composite_bwd_plain(
    inputs: Sequence[torch.Tensor],
    cotangents: Sequence[Optional[torch.Tensor]],
    s_per_ray: int,
    compute_log_det: bool,
) -> Grads:
    """The render-core backward in eager PyTorch: autograd through
    `fused_flow_composite_plain`.  `inputs` are its 10 arguments, `cotangents`
    the cotangents of (rgb, depth, acc, ldj), None for an unused output.
    Returns the gradients of z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r;
    z_pts and d_pts get none (the kernel's VJP treats them as constants).
    With a member axis, member by member: the z0 gradients (M, K, .), each
    member's own."""
    if inputs[0].dim() == 3:
        M = members_of(inputs[0])
        per = _shapes(*inputs, s_per_ray)[0] // M
        grads = []
        for m in range(M):
            rays = slice(m * per, (m + 1) * per)  # the ray axis: the maps' first, ldj's second
            cots = [None if g is None else (g[:, rays] if i == 3 else g[rays])
                    for i, g in enumerate(cotangents)]
            grads.append(fused_flow_composite_bwd_plain(_member_slices(inputs, m, M), cots,
                                                        s_per_ray, compute_log_det))
        return tuple(torch.stack(g) if i in (0, 4) else torch.cat(g)
                     for i, g in enumerate(zip(*grads)))
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs[:8]]
        outs = fused_flow_composite_plain(
            *xs, *(t.detach() for t in inputs[8:]), s_per_ray, compute_log_det)
        # test mode's ldj is a constant: it has no graph to go back through
        pairs = [(o, g) for o, g in zip(outs, cotangents)
                 if g is not None and o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], xs,
                                    [g for _, g in pairs], allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads))


def segment_bounds(S: int, n_seg: int, rounds: int = 1):
    """The kernels' cut of a ray of S samples: `rounds` rounds of `n_seg`
    contiguous segments of ceil(ceil(S / rounds) / n_seg) samples each,
    the last ones shorter or empty.  Returns [(start, end)] in order."""
    per_round = -(-S // rounds)
    seg = -(-per_round // n_seg)
    return [(min(S, i * seg), min(S, (i + 1) * seg)) for i in range(rounds * n_seg)]


def kernel_segments(S: int):
    """The segments the kernels cut a ray of S samples into: rounds of
    SEG_WARPS segments of at most MAX_SEG samples (render_core.cuh:
    seg_plan)."""
    return segment_bounds(S, SEG_WARPS, -(-S // (SEG_WARPS * MAX_SEG)))


def _segment_join(P, Y):
    """The join of segments given each one's product of x (P) and its C map
    C_in = Y + P C_out: T at each segment's start, the exclusive prefix
    product in order; C at each segment's end, the suffix composition from
    C = 0 after the last sample."""
    T, t_start = torch.ones_like(P[0]), []
    for p in P:
        t_start.append(T)
        T = T * p
    C, c_end = torch.zeros_like(P[0]), [None] * len(P)
    for i in reversed(range(len(P))):
        c_end[i] = C
        C = Y[i] + P[i] * C
    return t_start, c_end


def fused_flow_composite_bwd_segmented(
    inputs: Sequence[torch.Tensor],
    cotangents: Sequence[Optional[torch.Tensor]],
    s_per_ray: int,
    compute_log_det: bool,
    n_seg: int,
    rounds: int = 1,
) -> Grads:
    """The backward kernel's transmittance arithmetic in eager PyTorch, for
    the tests (never on the main path).  Arguments and gradients as in
    `fused_flow_composite_bwd_plain`; each ray is cut by `segment_bounds`.
    Per segment: the local exclusive transmittance, the product P of
    x = e + 1e-10 and the (P, Y) map of C_s = g_T[s+1] + x[s+1] C_{s+1};
    joined across segments; then each segment in reverse with
    T_s = T_start T_local[s] and no division.  Both flow chains go back
    through autograd."""
    R, S, K, _ = _shapes(*inputs, s_per_ray)
    B = R * S
    g_rgb, g_depth, g_acc, g_ldj = (
        torch.zeros(shape, dtype=inputs[0].dtype) if g is None else g.detach()
        for g, shape in zip(cotangents, ((R, 3, K), (R, K), (R, K), (2, R))))
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in inputs[:8]]
        z_a, ldj_a = triangular_sylvester_stack(
            xs[0][None].expand(B, K, 1), *xs[1:4], compute_log_det=compute_log_det)
        z_r, ldj_r = triangular_sylvester_stack(
            xs[4][None].expand(B, K, 3), *xs[5:8], compute_log_det=compute_log_det)
    with torch.no_grad():
        den = z_a[..., 0].reshape(R, S, K)
        v = torch.sigmoid(z_r.reshape(R, S, K, 3))
        sg = torch.sigmoid(den)
        d = inputs[9].detach().reshape(R, S, 1)
        e = torch.exp(-softplus(den) * d)
        x = e + TRANS_EPS
        g_w = (g_acc[:, None] + g_depth[:, None] * inputs[8].detach().reshape(R, S, 1)
               + (g_rgb.transpose(1, 2)[:, None] * v).sum(-1))
        g_T = g_w * (1.0 - e)
        # phase A: per segment, T_local, P and Y = sum_s g_T[s] T_local[s]
        bounds = segment_bounds(S, n_seg, rounds)
        t_loc, P, Y = torch.empty_like(x), [], []
        for a, b in bounds:
            t, y = torch.ones(R, K), torch.zeros(R, K)
            for s in range(a, b):
                t_loc[:, s] = t
                y = y + g_T[:, s] * t
                t = t * x[:, s]
            P.append(t)
            Y.append(y)
        t_start, c_end = _segment_join(P, Y)
        # phase B: each segment in reverse
        g_den = torch.empty_like(x)
        g_zr = torch.empty_like(v)
        for (a, b), t0, C in zip(bounds, t_start, c_end):
            for s in reversed(range(a, b)):
                T = t0 * t_loc[:, s]
                g_x = T * C
                C = g_T[:, s] + x[:, s] * C
                g_e = g_x - g_w[:, s] * T
                g_den[:, s] = g_e * e[:, s] * (-d[:, s]) * sg[:, s]
                w = (1.0 - e[:, s]) * T
                g_zr[:, s] = g_rgb.transpose(1, 2) * (w[..., None] * v[:, s] * (1.0 - v[:, s]))
        if compute_log_det:
            g_den = g_den + g_ldj[0][:, None, None] * (1.0 - sg)
            g_zr = g_zr + g_ldj[1][:, None, None, None] * (1.0 - 2.0 * v)
    outs, outs_g = [z_a, z_r], [g_den.reshape(B, K, 1), g_zr.reshape(B, K, 3)]
    if compute_log_det:
        outs += [ldj_a, ldj_r]
        outs_g += [g_ldj[0].repeat_interleave(S)[:, None].expand(B, K),
                   g_ldj[1].repeat_interleave(S)[:, None].expand(B, K)]
    grads = torch.autograd.grad(outs, xs, outs_g, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads))


def fused_flow_composite_segmented(
    z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts,
    s_per_ray: int, compute_log_det: bool, n_seg: int, rounds: int = 1,
) -> Outputs:
    """The forward kernel's segment join in eager PyTorch, for the tests
    (never on the main path).  Arguments and outputs as in
    `fused_flow_composite_plain`; each ray is cut by `segment_bounds`.  Each
    segment composites from T = 1 and keeps its product P of x; the ray's
    maps are sum over segments of T_start * (segment's maps), T_start the
    exclusive prefix product of P in order."""
    R, S, K, _ = _shapes(z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r,
                         z_pts, d_pts, s_per_ray)
    B = R * S
    z_a, ldj_a = triangular_sylvester_stack(
        z0_a[None].expand(B, K, 1), r1_a, r2_a, b_a, compute_log_det=compute_log_det)
    z_r, ldj_r = triangular_sylvester_stack(
        z0_r[None].expand(B, K, 3), r1_r, r2_r, b_r, compute_log_det=compute_log_det)
    e = torch.exp(-softplus(z_a[..., 0].reshape(R, S, K)) * d_pts.reshape(R, S, 1))
    x = e + TRANS_EPS
    v = torch.sigmoid(z_r).reshape(R, S, K, 3)
    z = z_pts.reshape(R, S)
    P, maps = [], []  # maps: (R, 5, K) rgb, depth, acc per segment
    for a, b in segment_bounds(S, n_seg, rounds):
        t, m = torch.ones(R, K), torch.zeros(R, 5, K)
        for s in range(a, b):
            w = (1.0 - e[:, s]) * t
            m = m + torch.stack([w * v[:, s, :, 0], w * v[:, s, :, 1], w * v[:, s, :, 2],
                                 w * z[:, s, None], w], 1)
            t = t * x[:, s]
        P.append(t)
        maps.append(m)
    t_start, _ = _segment_join(P, [torch.zeros_like(p) for p in P])
    out = torch.zeros(R, 5, K)
    for t0, m in zip(t_start, maps):
        out = out + t0[:, None] * m
    if compute_log_det:
        corr_a = ldj_a + (z_a - softplus(z_a)).sum(-1)
        corr_r = ldj_r + (z_r - 2.0 * softplus(z_r)).sum(-1)
        ldj = torch.stack([corr_a.reshape(R, S * K).sum(1),
                           corr_r.reshape(R, S * K).sum(1)])
    else:
        ldj = torch.zeros(2, R, dtype=out.dtype)
    return out[:, :3], out[:, 3], out[:, 4], ldj


def fused_flow_composite(
    z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts,
    s_per_ray: int, compute_log_det: bool,
) -> Outputs:
    """Render-core forward.  Arguments and outputs as in
    `fused_flow_composite_plain`, with or without a member axis (one launch
    covers every member).  CPU tensors take the plain version (and
    autograd through it); CUDA tensors launch the kernel or raise, through
    `_RenderCore` when a gradient is needed, so that the backward launches
    the backward kernel; anything else raises."""
    args = (z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return fused_flow_composite_plain(*args, s_per_ray, compute_log_det)
    if kinds != {"cuda"}:
        raise ValueError(
            f"render core: all inputs must be on one CUDA device or all on the "
            f"CPU (got {sorted(kinds)})"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _RenderCore.apply(s_per_ray, compute_log_det, *args)
    return _launch(args, s_per_ray, compute_log_det)


fused_flow_composite.launches = 0  # kernel launches; the plain route never counts


def fused_flow_composite_bwd(
    inputs: Sequence[torch.Tensor],
    cotangents: Sequence[Optional[torch.Tensor]],
    s_per_ray: int,
    compute_log_det: bool,
) -> Grads:
    """Render-core backward.  Arguments and gradients as in
    `fused_flow_composite_bwd_plain`.  CPU tensors take the plain version;
    CUDA tensors launch the backward kernel (or raise); anything else
    raises.  Training reaches the kernel through autograd (`_RenderCore`);
    this entry lets a caller hold the kernel against the plain version."""
    kinds = {t.device.type for t in (*inputs, *cotangents) if t is not None}
    if kinds == {"cpu"}:
        return fused_flow_composite_bwd_plain(inputs, cotangents, s_per_ray,
                                              compute_log_det)
    if kinds != {"cuda"}:
        raise ValueError(
            f"render core backward: all tensors must be on one CUDA device or "
            f"all on the CPU (got {sorted(kinds)})"
        )
    return _launch_bwd(inputs, cotangents, s_per_ray, compute_log_det)


fused_flow_composite_bwd.launches = 0  # backward kernel launches


class _RenderCore(torch.autograd.Function):
    """The CUDA route with a gradient: the forward kernel, then the backward
    kernel on the saved inputs, one launch each for all members.  The
    backward returns the 8 flow-input gradients and None for z_pts and
    d_pts: the JAX backward returns zeros for those two
    (render_core.py:684-685), since the stratified depths and the ray
    geometry carry no parameters upstream."""

    @staticmethod
    def forward(ctx, s_per_ray, compute_log_det, *args):
        ctx.save_for_backward(*args)
        ctx.s_per_ray, ctx.compute_log_det = s_per_ray, compute_log_det
        ctx.set_materialize_grads(False)  # unused outputs arrive as None
        return _launch(args, s_per_ray, compute_log_det)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        grads = _launch_bwd(ctx.saved_tensors, cotangents, ctx.s_per_ray,
                            ctx.compute_log_det)
        return (None, None, *grads, None, None)


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """The CUDA device of a launch, current; yields its current stream."""
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def _check_kernel_inputs(args) -> None:
    dev = args[0].device
    for t in args:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "render core kernel takes contiguous float32 tensors on one "
                f"device (got {t.dtype} on {t.device}, contiguous="
                f"{t.is_contiguous()})"
            )


def _check_flow_steps(F: int) -> None:
    if F > MAX_F:
        raise ValueError(f"render core kernels: F={F} flow steps, at most {MAX_F} (the "
                         "forward's shared memory); use the unfused path")


def _launch(args, s_per_ray: int, compute_log_det: bool) -> Outputs:
    R, S, K, F = _shapes(*args, s_per_ray)
    _check_kernel_inputs(args)
    _check_flow_steps(F)
    fn = _entry()
    like = args[0]  # outputs go where the inputs are
    rgb = like.new_empty((R, 3, K))
    depth = like.new_empty((R, K))
    acc = like.new_empty((R, K))
    ldj = like.new_empty((2, R))
    M = members_of(args[0])
    with _on_device(like.device) as stream:
        err = fn(*(t.data_ptr() for t in args),
                 rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), ldj.data_ptr(),
                 R, S, K, F, int(bool(compute_log_det)), M, stream)
    if err != 0:
        raise RuntimeError(
            f"render_core_fwd launch failed: CUDA error {err} "
            f"(R={R}, members={M}, S={S}, K={K}, F={F})"
        )
    fused_flow_composite.launches += 1
    return rgb, depth, acc, ldj


def _launch_bwd(inputs, cotangents, s_per_ray: int, compute_log_det: bool) -> Grads:
    R, S, K, F = _shapes(*inputs, s_per_ray)
    _check_kernel_inputs(inputs)
    like = inputs[0]
    cots = []
    for name, g, shape in zip(("rgb", "depth", "acc", "ldj"), cotangents,
                              ((R, 3, K), (R, K), (R, K), (2, R))):
        if g is None:
            g = like.new_zeros(shape)
        elif tuple(g.shape) != shape or g.dtype != torch.float32:
            raise ValueError(
                f"cotangent of {name}: expected float32 {shape}, got "
                f"{g.dtype} {tuple(g.shape)}"
            )
        cots.append(g.contiguous())  # autograd may hand over expanded views
    _check_flow_steps(F)
    fn = _entry_bwd()
    grads = tuple(x.new_empty(x.shape) for x in inputs[:8])
    z0_part = like.new_empty((R * 4 * K,))  # per-ray z0 gradient partials
    M = members_of(inputs[0])
    with _on_device(like.device) as stream:
        err = fn(*(t.data_ptr() for t in (*inputs, *cots, *grads, z0_part)),
                 R, S, K, F, int(bool(compute_log_det)), M, stream)
    if err != 0:
        raise RuntimeError(
            f"render_core_bwd launch failed: CUDA error {err} "
            f"(R={R}, members={M}, S={S}, K={K}, F={F})"
        )
    fused_flow_composite_bwd.launches += 1
    return grads


def _bind(name: str, symbol: str, n_ptrs: int):
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _entry():
    return _bind(NAME, "render_core_fwd", 14)


def _entry_bwd():
    return _bind(NAME_BWD, "render_core_bwd", 23)
