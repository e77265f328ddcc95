"""Evaluation of a trained run on its held-out views; counterpart of
cfnerf_tpu/cli/eval.py.  For each view of the val split: K test-mode draws
of the image, then

  * PSNR and SSIM of the mean image,
  * the per-pixel predictive NLL under the K-sample KDE (the training
    loss's Parzen bandwidth),
  * AUSE from the per-pixel std,

and the files of the JAX package, in basedir/dataname/type_flows/expname/
eval_{step:06d}/: NNN_pred.png, NNN_std.png, NNN_panel.png (the
uncertainty panel), NNN_ause.png (the sparsification plot),
NNN_uncertainty.ply (the depth map as a point cloud coloured by its std),
metrics.json; the summary's last line is printed as JSON.

    python -m cfnerf_torch.cli.eval --config configs/africa_ds.txt \
        --expname africa ... (the training run's flags)

--occ_eval renders at placed depths (the grid or the proposal,
--occ_impl), --N_importance_eval adds importance samples through the same
network, --render_factor renders at 1/factor resolution against the
ground truth shrunk by cv2's INTER_AREA (data/image_io.resize_area).
Runs on the CUDA device; evaluate(args, device="cpu") / main(argv,
device="cpu") on the CPU.  --mesh_devices N (0: every visible card) renders
each view's tiles over N ranks (render_image's mesh path, as JAX's eval
does); rank 0 writes the files.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from cfnerf_torch.data.image_io import imwrite_png, resize_area
from cfnerf_torch.models.factory import create_nerf
from cfnerf_torch.ops.metrics import sparsification_plot, ssim, std_over_k, to8b
from cfnerf_torch.parallel.mesh import create_mesh, is_writer, launch, rank_device
from cfnerf_torch.render.renderer import make_render_rays, render_image
from cfnerf_torch.train import checkpoint as ckpt
from cfnerf_torch.train.loop import load_dataset, mesh_devices, needs_launch
from cfnerf_torch.utils.config import parse_args
from cfnerf_torch.utils.device import DeviceLike, resolve_device
from cfnerf_torch.utils.pointcloud import depth_uncertainty_pointcloud
from cfnerf_torch.utils.visualization import save_sparsification_figure, save_uncertainty_figure


def kde_nll_per_pixel(rgb_k: np.ndarray, gt: np.ndarray, k: int) -> np.ndarray:
    """Per-pixel Parzen NLL with the training loss's bandwidth rule (std with
    ddof=1, times k / (k - 1); the reference's :1031-1042), not the maps'
    std convention.  rgb_k (H, W, 3, K), gt (H, W, 3) -> (H, W, 3)."""
    eps = 1e-5
    std = rgb_k.std(-1, ddof=1) * k / (k - 1)
    h = std * (0.8 / k) ** (-1.0 / 7.0) + eps
    h = h[..., None]
    kernel = np.exp(-((rgb_k - gt[..., None]) ** 2) / (2 * h * h))
    norm = (2 * math.pi) ** (-1.5) / h
    p = (kernel * norm).mean(-1) + eps
    return -np.log(p)  # (H, W, 3)


def evaluate(args, device: DeviceLike = None) -> Dict[str, float]:
    """Evaluate the run of `args` at its checkpoint (create_nerf's resume;
    step 0 with fresh weights when there is none).  Returns the summary
    written to metrics.json: step, the mean psnr / ssim / nll over the
    views, the AUSE of all views' pixels together, and the per-view
    records.  With --mesh_devices > 1: launched on that many ranks, each
    rendering its share of every tile (the data mesh; --model_parallel is
    a training flag, as in JAX's eval); rank 0's summary is returned."""
    n_devices = mesh_devices(args, device)
    if needs_launch(n_devices):
        return launch(_evaluate_rank, n_devices, args, device, device=device)[0]
    dev = resolve_device(device)
    mesh = create_mesh(n_devices) if dist.is_initialized() else None
    writer = is_writer()
    scene = load_dataset(args)
    H, W, focal = scene["H"], scene["W"], scene["focal"]

    model, model_fine, render_config, start = create_nerf(args, dev)
    print(f"evaluating checkpoint step {start}")

    occ_n = int(getattr(args, "occ_eval", 0) or 0)
    if occ_n > 0 and (model_fine is not None or args.N_importance_eval > 0):
        print("WARNING: --occ_eval ignored — incompatible with a fine "
              "network / --N_importance_eval (hierarchical placement "
              "already owns the z axis)", file=sys.stderr)
        occ_n = 0
    if occ_n > 0:
        trained_n = render_config.n_samples
        render_config = dataclasses.replace(render_config, n_samples=occ_n)
        print(f"occupancy-grid eval: N={occ_n} grid-placed samples/ray "
              f"(trained at N={trained_n}; grid {args.occ_res}^3, "
              f"{args.occ_candidates} candidates, floor {args.occ_floor})")

    if args.N_importance_eval > 0 and model_fine is None:
        # eval-only importance placement: the coarse pass at the trained
        # N_samples, N_importance_eval depths resampled from it, the second
        # pass through the same network (the renderer's shared-net mode)
        render_config = dataclasses.replace(render_config, n_importance=args.N_importance_eval)
        print(f"eval-only importance placement: +{args.N_importance_eval} "
              f"samples on top of N={render_config.n_samples}")
    elif args.N_importance_eval > 0:
        print("WARNING: --N_importance_eval ignored — this run already has "
              "a fine network (--N_importance > 0)", file=sys.stderr)

    render_rays_fn = make_render_rays(model, render_config, model_fine)
    if occ_n > 0:
        from cfnerf_torch.ops.occupancy import wrap_renderer_for_serving

        render_rays_fn = wrap_renderer_for_serving(render_rays_fn, args, scene, model,
                                                   render_config)

    rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    outdir = os.path.join(rundir, f"eval_{start:06d}")
    if writer:
        os.makedirs(outdir, exist_ok=True)

    rf = args.render_factor
    He, We, fe = (H, W, focal) if rf == 0 else (H // rf, W // rf, focal / rf)

    K = args.K_samples
    per_view = []
    all_var, all_err = [], []
    for view in scene["i_val"]:
        out = render_image(
            render_rays_fn, scene["poses"][view], H=He, W=We, focal=fe,
            ndc=(args.dataset_type == "llff" and not args.no_ndc),
            use_viewdirs=args.use_viewdirs, near=scene["near"], far=scene["far"],
            tile=args.chunk, device=dev, mesh=mesh,
        )
        rgb_k = out["rgb_map"].cpu().numpy()   # (H, W, 3, K)
        disp_k = out["disp_map"].cpu().numpy()
        depth_k = out["depth_map"].cpu().numpy()
        gt = scene["images"][view]
        if rf != 0:
            gt = resize_area(gt, We, He)

        rgb_mean = rgb_k.mean(-1)
        rgb_std = std_over_k(out["rgb_map"]).cpu().numpy()
        mse = float(((rgb_mean - gt) ** 2).mean())
        psnr = -10.0 * np.log10(mse)
        ssim_v = float(ssim(torch.from_numpy(rgb_mean).to(dev), torch.from_numpy(gt).to(dev)))
        nll = float(kde_nll_per_pixel(rgb_k, gt, K).mean())

        err_vec = ((rgb_mean - gt) ** 2).mean(-1).reshape(-1)
        var_vec = (rgb_std ** 2).mean(-1).reshape(-1)
        oracle, by_var = sparsification_plot(var_vec, err_vec)
        ause = float(np.mean(by_var - oracle))
        all_var.append(var_vec)
        all_err.append(err_vec)

        per_view.append(
            dict(view=int(view), psnr=psnr, ssim=ssim_v, nll=nll, ause=ause, mse=mse)
        )
        print(f"view {view}: PSNR {psnr:.2f}  SSIM {ssim_v:.4f}  NLL {nll:.4f}  AUSE {ause:.4f}")
        if not writer:
            continue

        imwrite_png(os.path.join(outdir, f"{view:03d}_pred.png"), to8b(rgb_mean))
        imwrite_png(os.path.join(outdir, f"{view:03d}_std.png"),
                    to8b(rgb_std / (rgb_std.max() + 1e-8)))
        save_uncertainty_figure(
            os.path.join(outdir, f"{view:03d}_panel.png"),
            gt=gt, rgb_mean=rgb_mean, rgb_std=rgb_std,
            disp=disp_k.mean(-1), title=f"view {view}",
        )
        save_sparsification_figure(os.path.join(outdir, f"{view:03d}_ause.png"), oracle, by_var)
        depth_uncertainty_pointcloud(
            os.path.join(outdir, f"{view:03d}_uncertainty.ply"),
            depth_k.mean(-1), rgb_std.mean(-1), scene["poses"][view][:3, :4], fe,
        )

    oracle, by_var = sparsification_plot(np.concatenate(all_var), np.concatenate(all_err))
    summary = {
        "step": start,
        "psnr": float(np.mean([v["psnr"] for v in per_view])),
        "ssim": float(np.mean([v["ssim"] for v in per_view])),
        "nll": float(np.mean([v["nll"] for v in per_view])),
        "ause": float(np.mean(by_var - oracle)),
        "views": per_view,
    }
    if writer:
        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "views"}))
    return summary


def _evaluate_rank(rank: int, args, device: DeviceLike) -> Dict[str, float]:
    return evaluate(args, device=rank_device(device, rank))


def main(argv=None, device: DeviceLike = None) -> Dict[str, float]:
    args = parse_args(argv)
    return evaluate(args, device=device)


if __name__ == "__main__":
    main()
