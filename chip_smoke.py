#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA toolkit); exits non-zero without them.
Phases, one JSON line each, any failed check raises (non-zero exit, no
final line):

  1. device   the card, its power limit, the software versions
  2. build    nvcc builds every kernel of cfnerf_torch/csrc for sm_90a
  3. kernel   each kernel against its plain PyTorch version on the card,
              at the serving tile and at awkward shapes, both modes
  4. serve    the flagship model (D8 W512 N128 K32 F4, random weights from
              a seed) renders a 400x400 view in 8192-ray tiles through
              build_model -> make_render_rays -> render_image; launch
              counts, output checks, timing, kernel path vs plain path
  5. golden   a tiny model's JAX render (tests/fixtures) against the
              card's kernel path on the same weights
  6. kernels  per-kernel launches, error, time, plain time and bound

then the `nvidia-smi` name/power line and, last, the `ok` line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from cfnerf_torch.convert import nerf_flows_state_dict_from_jax
from cfnerf_torch.models.factory import build_model
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.ops.compositing import LAST_DIST
from cfnerf_torch.ops.kernels import _build
from cfnerf_torch.ops.kernels import render_core
from cfnerf_torch.ops.metrics import std_over_k
from cfnerf_torch.ops.rays import get_rays
from cfnerf_torch.render.renderer import (
    RenderConfig,
    make_render_rays,
    prepare_rays,
    render_image,
)

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_golden.npz"

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

# flagship serving configuration (scripts/train_NF.sh widths; Blender
# half-resolution camera: 400x400, camera_angle_x 0.6911112, near 2, far 6)
FLAGSHIP = dict(
    netdepth=8, netwidth=512, N_samples=128, K_samples=32, n_flows=4,
    h_alpha_size=64, h_rgb_size=64, type_flows="triangular", use_viewdirs=True,
    multires=10, multires_views=4, i_embed=0, white_bkgd=True, N_importance=0,
    perturb=1.0, raw_noise_std=0.0, seed=0,
)
H = W = 400
FOCAL = 0.5 * 800 / math.tan(0.5 * 0.6911112070083618) / 2
NEAR, FAR, TILE = 2.0, 6.0, 8192

# kernel vs plain tolerances.  Maps are sums of <= S weighted terms taken in
# another order: measured <= 2e-6 at the serving tile, so 1e-5.  ldj sums
# S*K*(3F+4) ~ 78k f32 terms per ray at the serving tile, sequentially per
# draw in the kernel and as a tree in the plain version; the saturated case
# measured 1.1e-4 relative before per-sample partial sums, so 2e-4.
MAP_RTOL = MAP_ATOL = 1e-5
LDJ_RTOL = 2e-4
# end to end, kernel path vs plain path and vs the JAX golden: the same
# rule as the CPU tests' wide-trunk parity (different matmul summation)
E2E_RTOL = E2E_ATOL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Median ms of `fn` over `iters` launches, CUDA-event timed, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------- #
# render core: inputs, work model, comparison
# ---------------------------------------------------------------------- #


def render_core_inputs(R, S, K, F, seed, saturate=False):
    """Device-made inputs shaped as the renderer gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, sc = R * S, 0.5

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * sc

    def triangular():  # (B, Z, Z, F), upper triangle per step
        return torch.triu(randn(B, F, 3, 3)).permute(0, 2, 3, 1).contiguous()

    b_a = randn(B, 1, F)
    if saturate:
        b_a[: B // 7] = 8.0  # alpha == 1 on a seventh of the points
    z = torch.sort(torch.rand(R, S, generator=g, device="cuda"), -1).values * 3.5 + 0.5
    d = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), LAST_DIST, device="cuda")], -1)
    d = d * (torch.randn(R, 3, generator=g, device="cuda").norm(dim=-1, keepdim=True))
    return [randn(K, 1), randn(B, 1, 1, F), randn(B, 1, 1, F), b_a,
            randn(K, 3), triangular(), triangular(), randn(B, 3, F),
            z.reshape(-1).contiguous(), d.reshape(-1).contiguous()]


def render_core_work(R, S, K, F, compute_log_det):
    """(bytes, operations) the function needs: each input read once, each
    output written once; f32 operations per (point, draw), an FMA counted
    as two and a transcendental as one:
      per flow step  32  (density 5; rgb 12 pre + 3 tanh + 12 update)
      composite      33  (softplus 5, alpha 4, transmittance 3, 3 sigmoids 12,
                          rgb/depth/acc sums 9)
      train mode    +36 per step (log-dets) and +26 per sample (corrections)."""
    B = R * S
    in_floats = K * 4 + B * (24 * F + 2)
    out_floats = R * 3 * K + 2 * R * K + 2 * R
    per = 32 * F + 33 + ((36 * F + 26) if compute_log_det else 0)
    return 4 * (in_floats + out_floats), B * K * per


def bound_ms(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(out, ref, rtol, atol, ldj_rtol=None):
    """Max abs / rel error per output; raises past the tolerance."""
    errs = {}
    for name, a, b in zip(("rgb", "depth", "acc", "ldj"), out, ref):
        diff = (a - b).abs()
        if name == "ldj":
            if ldj_rtol is None:
                continue
            rel = diff / b.abs().clamp(min=1.0)
            check(bool(torch.isfinite(a).all()), "ldj finite")
            check(float(rel.max()) <= ldj_rtol, f"ldj rel err {float(rel.max())}")
        else:
            rel = diff / b.abs().clamp(min=1e-6)
            check(bool(torch.isfinite(a).all()), f"{name} finite")
            check(bool((diff <= atol + rtol * b.abs()).all()),
                  f"{name}: max abs err {float(diff.max())}")
        errs[name] = {"max_abs": float(diff.max()), "max_rel": float(rel.max())}
    return errs


def phase_kernel_checks():
    cases = [  # (R, S, K, F, compute_log_det, saturate, label)
        (8192, 128, 32, 4, False, False, "serving tile, test mode"),
        (8192, 128, 32, 4, True, False, "serving tile, train mode"),
        (8192, 128, 32, 4, True, True, "serving tile, saturated alpha"),
        (100, 20, 8, 2, True, False, "awkward R=100 S=20 K=8 F=2"),
        (100, 20, 8, 2, False, False, "awkward R=100 S=20 K=8 F=2"),
        (1024, 48, 32, 4, True, False, "S=48"),
        (1024, 96, 32, 4, True, False, "S=96"),
        (64, 48, 40, 3, True, True, "K=40 > one warp, saturated"),
    ]
    serving_err = None
    for i, (R, S, K, F, cld, sat, label) in enumerate(cases):
        x = render_core_inputs(R, S, K, F, seed=100 + i, saturate=sat)
        with torch.inference_mode():
            out = render_core.fused_flow_composite(*x, S, cld)
            ref = render_core.fused_flow_composite_plain(*x, S, cld)
        torch.cuda.synchronize()
        if not cld:
            check(float(out[3].abs().max()) == 0.0, "test-mode ldj is zero")
        errs = compare(out, ref, MAP_RTOL, MAP_ATOL, LDJ_RTOL if cld else None)
        emit("kernel", kernel="render_core_fwd", case=label, R=R, S=S, K=K, F=F,
             compute_log_det=cld, saturate=sat, errors=errs,
             tolerance={"rtol": MAP_RTOL, "atol": MAP_ATOL, "ldj_rtol": LDJ_RTOL})
        if i == 0:
            serving_err = max(e["max_abs"] for e in errs.values())

    # time at the serving tile (inputs ~411 MB: cold in the 50 MB L2 anyway)
    R, S, K, F = 8192, 128, 32, 4
    x = render_core_inputs(R, S, K, F, seed=7)
    with torch.inference_mode():
        ms = cuda_ms(lambda: render_core.fused_flow_composite(*x, S, False), 20)
        plain_ms = cuda_ms(lambda: render_core.fused_flow_composite_plain(*x, S, False), 5)
    nbytes, ops = render_core_work(R, S, K, F, False)
    b_ms, b_by = bound_ms(nbytes, ops)
    emit("kernel_time", kernel="render_core_fwd", R=R, S=S, K=K, F=F, ms=ms,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
         achieved_gb_per_s=nbytes / ms / 1e6)
    return dict(max_abs_err=serving_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #


def pose_spherical(theta, phi, radius):
    """Blender-style camera-to-world on a sphere (load_blender.py)."""
    t = np.eye(4, dtype=np.float32)
    t[2, 3] = radius
    p, th = math.radians(phi), math.radians(theta)
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(p), -math.sin(p), 0],
                        [0, math.sin(p), math.cos(p), 0], [0, 0, 0, 1]], np.float32)
    rot_theta = np.array([[math.cos(th), 0, -math.sin(th), 0], [0, 1, 0, 0],
                          [math.sin(th), 0, math.cos(th), 0], [0, 0, 0, 1]], np.float32)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return flip @ rot_theta @ rot_phi @ t


def phase_serve():
    args = types.SimpleNamespace(**FLAGSHIP)
    model, _, rc = build_model(args)  # the default device: the card
    model.eval()
    render_rays = make_render_rays(model, rc)
    c2w = pose_spherical(30.0, -30.0, 4.0)
    view = dict(H=H, W=W, focal=FOCAL, ndc=False, use_viewdirs=True,
                near=NEAR, far=FAR, tile=TILE)
    n_tiles = -(-H * W // TILE)

    # the main path, counted
    render_core.fused_flow_composite.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = render_core.fused_flow_composite.launches
    check(launches == n_tiles, f"render core launched {launches} times, want {n_tiles}")

    K = args.K_samples
    check(tuple(out["rgb_map"].shape) == (H, W, 3, K), f"rgb_map {tuple(out['rgb_map'].shape)}")
    for k in ("depth_map", "disp_map", "acc_map"):
        check(tuple(out[k].shape) == (H, W, K), f"{k} {tuple(out[k].shape)}")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} finite")
    std = std_over_k(out["rgb_map"])
    check(float(std.max()) > 0.0, "std over K is positive somewhere")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # steady state: host clock around whole renders ending in a sync
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        render_image(render_rays, c2w, **view)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    image_s = statistics.median(times)

    # one 1024-ray tile: kernel path against the plain (unfused) path
    rays_o, rays_d = get_rays(H, W, FOCAL, torch.as_tensor(c2w, device="cuda"))
    rays_o, rays_d, vd, nv, fv = prepare_rays(
        rays_o, rays_d, H=H, W=W, focal=FOCAL, ndc=False, use_viewdirs=True,
        near=NEAR, far=FAR)
    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(1))[:1024].cuda()
    sub = [t[pick] for t in (rays_o, rays_d, vd, nv, fv)]
    plain_rays = make_render_rays(model, rc, fused=False)
    with torch.inference_mode():
        a = render_rays(*sub, None, is_test=True)
        b = plain_rays(*sub, None, is_test=True)
    torch.cuda.synchronize()
    errs = {}
    for k in ("rgb_map", "depth_map", "acc_map"):
        d = (a[k] - b[k]).abs()
        check(bool((d <= E2E_ATOL + E2E_RTOL * b[k].abs()).all()),
              f"kernel vs plain path {k}: {float(d.max())}")
        errs[k] = float(d.max())
    mask = b["acc_map"] > 1e-3
    rel = ((a["disp_map"] - b["disp_map"]).abs() / b["disp_map"].abs())[mask]
    errs["disp_map_rel_where_acc>1e-3"] = float(rel.max()) if rel.numel() else 0.0

    breakdown = profile_tile(render_rays, [t[:TILE] for t in (rays_o, rays_d, vd, nv, fv)])

    emit("serve", H=H, W=W, K=K, tile=TILE, n_tiles=n_tiles,
         render_core_launches=launches, first_render_s=first_s,
         image_s=image_s, image_s_all=times, rays_per_s=H * W / image_s,
         peak_mem_gb=peak_gb, mean_std_over_k=float(std.mean()),
         mean_acc=float(out["acc_map"].mean()),
         kernel_vs_plain_1024_rays=errs,
         tolerance={"rtol": E2E_RTOL, "atol": E2E_ATOL})
    emit("profile", tile_rays=TILE, **breakdown)
    return launches


def profile_tile(render_rays, tile_rays):
    """Device time by kernel for one serving tile, from torch.profiler's
    CUDA activity (CUPTI); kernels run on one stream, so their summed time
    over the tile's wall time is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        render_rays(*tile_rays, None, is_test=True)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            render_rays(*tile_rays, None, is_test=True)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.end - evt.time_range.start
            n, t = by_name.get(evt.name, (0, 0.0))
            by_name[evt.name] = (n + 1, t + us / 1e3)
    if not by_name:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}

    def group(name):
        low = name.lower()
        if "render_core" in low:
            return "render_core"
        if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90")):
            return "matmul"
        return "other"

    groups = {}
    for name, (_, ms) in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    device_ms = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "by_group_ms": groups,
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms} for n, (c, ms) in top]}


def phase_golden():
    with np.load(GOLDEN) as g:
        D, Wd, K, F, ha, hr, n_samples, h, w = (int(v) for v in g["config"])
        focal, near, far = (float(v) for v in g["view"])
        params = {}
        for key in g.files:
            if key.startswith("p/"):
                node = params
                *parents, leaf = key[2:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = g[key]
        model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K)
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            params, (g["test_eps_a"], g["test_eps_r"])))
        model = model.cuda().eval()
        rc = RenderConfig(n_samples=n_samples, perturb=False, use_viewdirs=True,
                          white_bkgd=True)
        before = render_core.fused_flow_composite.launches
        out = render_image(make_render_rays(model, rc), g["c2w"], H=h, W=w, focal=focal,
                           ndc=False, use_viewdirs=True, near=near, far=far, tile=64)
        check(render_core.fused_flow_composite.launches > before, "golden went through the kernel")
        errs = {}
        for k in ("rgb_map", "depth_map", "acc_map"):
            ref = torch.as_tensor(g[f"jax/{k}"], device="cuda")
            d = (out[k] - ref).abs()
            check(bool((d <= E2E_ATOL + E2E_RTOL * ref.abs()).all()),
                  f"golden {k}: {float(d.max())}")
            errs[k] = float(d.max())
    emit("golden", source=str(GOLDEN.relative_to(ROOT)), H=h, W=w, K=K,
         max_abs_err_vs_jax=errs, tolerance={"rtol": E2E_RTOL, "atol": E2E_ATOL})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    logs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, kernels=list(logs),
         ptxas=[ln.strip() for log in logs.values() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    rc_stats = phase_kernel_checks()
    launches = phase_serve()
    phase_golden()

    print(json.dumps({"kernels": [{
        "name": "render_core_fwd",
        "route": "cuda",
        "source": render_core.SOURCE,
        "replaces": render_core.REPLACES,
        "launches": launches,
        "max_abs_err": rc_stats["max_abs_err"],
        "ms": rc_stats["ms"],
        "plain_ms": rc_stats["plain_ms"],
        "bound_ms": rc_stats["bound_ms"],
        "bound_by": rc_stats["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
