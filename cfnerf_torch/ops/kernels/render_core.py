"""Fused flow stacks + K-sample alpha composite: the render-core forward.

Counterpart of cfnerf_tpu/ops/pallas/render_core.py:fused_flow_composite.
On a CUDA tensor the wrapper launches the hand-written Hopper kernel
(cfnerf_torch/csrc/render_core.cu) or raises; on a CPU tensor it runs
`fused_flow_composite_plain`, the same function in eager PyTorch, which is
also the kernel's oracle on the card.  There is no shape gate: any R, any
S >= 1, any K and any F the kernel can stage.

The backward kernel comes with slice 2 (training).  Until then the kernel
refuses inputs that need a gradient; the plain version differentiates
through autograd (cumprod, no closed-form division).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cfnerf_torch.flows.sylvester import triangular_sylvester_stack
from cfnerf_torch.ops.compositing import composite_weights, softplus
from cfnerf_torch.ops.kernels import _build

NAME = "render_core"
SOURCE = "cfnerf_torch/csrc/render_core.cu"
REPLACES = "cfnerf_tpu/ops/pallas/render_core.py:322"  # _fwd_kernel

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _shapes(z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts, s_per_ray):
    """Validate the argument shapes; returns (R, S, K, F)."""
    K = z0_a.shape[0]
    B, F = r1_a.shape[0], r1_a.shape[-1]
    S = int(s_per_ray)
    want = {
        "z0_a": (z0_a, (K, 1)), "r1_a": (r1_a, (B, 1, 1, F)),
        "r2_a": (r2_a, (B, 1, 1, F)), "b_a": (b_a, (B, 1, F)),
        "z0_r": (z0_r, (K, 3)), "r1_r": (r1_r, (B, 3, 3, F)),
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
    return B // S, S, K, F


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
    """
    R, S, K, _ = _shapes(z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r,
                         z_pts, d_pts, s_per_ray)
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


def fused_flow_composite(
    z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts,
    s_per_ray: int, compute_log_det: bool,
) -> Outputs:
    """Render-core forward.  Arguments and outputs as in
    `fused_flow_composite_plain`.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise); anything else raises."""
    args = (z0_a, r1_a, r2_a, b_a, z0_r, r1_r, r2_r, b_r, z_pts, d_pts)
    kinds = {t.device.type for t in args}
    if kinds == {"cpu"}:
        return fused_flow_composite_plain(*args, s_per_ray, compute_log_det)
    if kinds != {"cuda"}:
        raise ValueError(
            f"render core: all inputs must be on one CUDA device or all on the "
            f"CPU (got {sorted(kinds)})"
        )
    return _launch(args, s_per_ray, compute_log_det)


fused_flow_composite.launches = 0  # kernel launches; the plain route never counts


def _launch(args, s_per_ray: int, compute_log_det: bool) -> Outputs:
    R, S, K, F = _shapes(*args, s_per_ray)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "the render-core kernel has no backward yet: the backward kernel "
            "comes with slice 2 (training); serve under torch.inference_mode()"
        )
    dev = args[0].device
    for t in args:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "render core kernel takes contiguous float32 tensors on one "
                f"device (got {t.dtype} on {t.device}, contiguous="
                f"{t.is_contiguous()})"
            )
    fn = _entry()
    with torch.cuda.device(dev):
        rgb = torch.empty((R, 3, K), dtype=torch.float32, device=dev)
        depth = torch.empty((R, K), dtype=torch.float32, device=dev)
        acc = torch.empty((R, K), dtype=torch.float32, device=dev)
        ldj = torch.empty((2, R), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in args),
                 rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(), ldj.data_ptr(),
                 R, S, K, F, int(bool(compute_log_det)), stream)
    if err != 0:
        raise RuntimeError(
            f"render_core_fwd launch failed: CUDA error {err} "
            f"(R={R}, S={S}, K={K}, F={F})"
        )
    fused_flow_composite.launches += 1
    return rgb, depth, acc, ldj


def _entry():
    fn = _build.load(NAME).render_core_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
