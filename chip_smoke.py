#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and check them.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA toolkit); exits non-zero without them.
Phases, one JSON line each, any failed check raises (non-zero exit, no
final line):

  1. device        the card, its power limit, the software versions
  2. build         nvcc builds every kernel of cfnerf_torch/csrc for sm_90a,
                   one process per source, all started together
  3. kernel        each kernel against its plain PyTorch version on the card:
                   the render-core forward at the serving tile, the flagship
                   train tile and awkward shapes, both modes; its backward at
                   the flagship train tile, saturated, test mode, awkward
                   shapes and K=40; both at the edges of their segments
                   (S=1, S=5, S=129) and at the placed paths' shapes (an
                   S=16 serving tile, an S=12 training step); the
                   backward also at F=5 and 8 (each step's input kept in
                   registers) and F=9, 12 and 16 (its
                   generic path), and one fused training step at F=12
                   through the kernels against the same step through the
                   plain render core; the flow-stack forward (Z = 1 and 3,
                   both modes) at the hierarchical serving and training fine
                   passes, awkward shapes, K=40, K=7 with a ragged B, F=1,
                   F=9, expanded and contiguous z0, a density query's
                   65,536 and 8,192 points; its backward at the
                   hierarchical training passes and the same edges; the
                   trunk forward (bf16 tensor cores) at the flat serving
                   tile, the hierarchical fine and coarse passes, D4/W256, a
                   ragged B and strided rows; its training variant at the
                   flat training step, D4/W256, the ragged cases and odd
                   widths (W32/96/160/384, heads 16-48, x and v padded to
                   96-128 columns): outputs against the plain version and
                   bitwise equal to the serving variant's, two launches of
                   each bitwise equal, the saved activations (read back by
                   trunk.workspace_views) against the plain forward's; the
                   trunk backward at the
                   three training shapes, D4/W256, a ragged B, strided rows
                   and exact (dyadic) arithmetic, bitwise deterministic, and
                   through the training forward's saved workspace bitwise
                   equal to the standalone entry; its weight-gradient pass
                   alone at 64 x 64 x 64 and the flat step's matrix shapes
                   against a float64 product; the member axis
                   (kernel_members): the render core forward and backward at
                   3 members' flagship train tiles, trunk_fwd,
                   trunk_fwd_save and trunk_bwd at 2 members' flat training
                   steps, the flow stack forward at 3 members' co-training
                   density queries and both ways at 3 members' unfused
                   flagship steps (both chains), one launch for all,
                   against the plain versions and bitwise against one
                   launch a member (outputs, z0 gradients, saved
                   activations, dW and db), each timed beside those M
                   launches
  4. kernel_time   each kernel's ms, plain ms, bytes, operations and bound
                   (train-tile launches rotate over inputs larger than L2;
                   the render-core backward also at F=12; every flow-stack
                   launch of a hierarchical serving tile and training step,
                   each group's sum beside its bound);
                   the trunk forward's also beside two yardsticks, the f32
                   nn.Linear encode and its layer chain in bf16 through
                   torch.matmul (with cuBLAS's bf16 reduced-precision
                   reductions off, the port's setting, and on); the trunk
                   backward alone from a saved
                   workspace, by pass, the training forward (checked
                   against the plain forward, its bound counting the saved
                   activations) beside the serving one, and the two
                   together beside autograd of that bf16 chain (both
                   settings)
  5. serve         the flagship model (D8 W512 N128 K32 F4, random weights from
                   a seed) renders a 400x400 view in 8192-ray tiles through
                   build_model -> make_render_rays -> render_image; launch
                   counts, output checks, timing, fused path vs unfused path
  6. golden        a tiny model's JAX render (tests/fixtures) against the
                   card's kernel path on the same weights
  7. train         flagship training steps (512 + 128 COLMAP depth rays) from
                   RayBatcher / DepthRayBatcher over a synthetic scene through
                   make_train_step: launch counts, finite metrics, every
                   parameter moves, the loss falls on a fixed batch, step
                   time, train rays/s, peak memory, a profiled step
  8. train_golden  one JAX training step of a tiny model (tests/fixtures):
                   the card's loss, gradients and updated weights against it
  9. hier_serve    the flagship coarse + fine pair (64 + 128 samples, fine
                   net D8 W512) renders the 400x400 view hierarchically:
                   flow-stack launches, output checks, timing, a profiled
                   tile, 64 rays against the CPU's plain path, and the
                   shared-net mode (128 + 32 samples) against the pair mode
 10. hier_golden   a tiny JAX pair's hierarchical render and training step
                   (tests/fixtures) against the card's kernel path
 11. hier_train    flagship hierarchical training steps (512 + 128 rays):
                   launch counts, finite metrics, both nets move, the loss
                   falls on a fixed batch, step time, rays/s, a profiled step
 12. graph_step    make_train_step's CUDA graph (train/graph.py) against its
                   eager step, two objects from the same weights: the
                   flagship and the hierarchical pair (5 steps each, the
                   draws made in the graph from a registered generator of
                   the eager one's seed, and handed in as seams), a
                   flagship call with half the rays between replays (run
                   eagerly, counted), then the trunk kernels, bf16, the
                   unfused render with applied noise and each other flow
                   family (3 steps): metrics, parameters and Adam's state
                   bitwise, launches equal, a profiled replay's kernels
                   against the launch counters, ms a step both ways; the
                   composite's cumprod bitwise torch.cumprod, forward and
                   gradient
 13. trunk_serve   both views again with trunk_impl="pallas": the flat one
                   (20 trunk + 20 render-core launches) and the hierarchical
                   pair (40 trunk + 80 flow-stack launches); output checks,
                   64 rays against trunk_impl="interpret" on the card (and
                   the f32 trunk, reported), one timed render, a profiled tile
 14. trunk_golden  the card's trunk kernel against JAX's pallas_encode on a
                   D4/W256 trunk (tests/fixtures)
 15. trunk_train   flagship training steps with trunk_impl="pallas" nets,
     trunk_hier_train  flat and hierarchical: launch counts (trunk forward
                   and backward kernels beside the render-core or flow-stack
                   ones), finite metrics, every parameter moves, the loss
                   falls on a fixed batch, step time, rays/s, peak memory, a
                   profiled step, one step's gradients against the same
                   step through trunk_impl="interpret"
 16. trunk_grad_golden  the card's trunk backward kernels against JAX's
                   _trunk_bwd gradients on the D4/W256 trunk (tests/fixtures)
 17. bf16_serve    the flagship view with --compute_dtype bfloat16 on the xla
     bf16_train    trunk (20 render-core launches), its first tile against
                   the f32 trunk (reported), a profiled tile; 1 + 10 + 10
                   flagship steps (a render-core forward and backward
                   each), the parameters f32
 18. bf16_golden   a tiny bf16 model's JAX render and encode (tests/fixtures)
                   against the card's bf16 path; the same weights on the f32
                   trunk as the control that the encode gate must refuse
 19. occ_serve     --occ_eval 16 (32 candidates, floor 0.3) through
                   wrap_renderer_for_serving: --occ_impl auto, the grid on the
                   card (a 128^3 bake of the field through the flow-stack
                   kernel, 64 launches; 64 baked cells against the CPU's
                   density query), the view (20 render-core launches), 64
                   rays against the CPU's plain path, a profiled tile
 20. occ_prop_serve  the same with --occ_impl proposal (the distillation,
                   2^20 points, 4 epochs, 32 flow-stack launches), 64 rays'
                   placed depths against the CPU's placement with the same
                   proposal, and bitwise against the same placement on the
                   card in a fresh process
 21. occ_train     --occ_train 12 (128 candidates, floor 0.3, co-training at
                   8192 points): the proposal distilled from the initial
                   field, then 1 + 10 + 10 steps (a render-core forward and
                   backward and two flow-stack forwards each), a profiled step
 22. occ_golden    one JAX occ step of a tiny model (tests/fixtures, with its
                   draws) through the card's occ step
 23. data_train    the path from disk: scripts/train_NF.sh's flags through the
                   port's parse_args on a copy of the checked-in LLFF + COLMAP
                   capture (tests/fixtures/minicapture), load_dataset (the
                   minify to 48x64 and COLMAP depth on the card's own
                   installation), create_nerf, batches through
                   BatchPrefetcher (the first bitwise the host batch), 1
                   warm-up + 10 counted steps of the flagship model,
                   save_checkpoint at step 10 with args.txt, the held-out
                   view, create_nerf again (bitwise state with the eps
                   buffers, the same view within 1e-6, start 10, a fresh
                   Adam at the decayed lr, one more step), and a Blender
                   scene written by imwrite_png and read back, half_res
                   against a 2x2 block mean
 24. jpeg          JPEG captures with imageio, Pillow and cv2 blocked:
                   every checked-in JPEG fixture (tests/fixtures/jpeg: the
                   subsampling x progression matrix, grayscale, restarts,
                   optimized and 16-bit tables, RGB, EXIF, a 1 MP photo)
                   decoded by cfnerf_torch/data/jpeg.py bitwise its golden
                   (imageio.v2.imread's array; the photo's SHA-256) and
                   image_shape its shape; cli.train with train_NF.sh's
                   flags and factor 2 on a copy of
                   tests/fixtures/minicapture_jpg: each JPG decoded once,
                   images_2 bitwise the JAX loader's minify (golden), COLMAP
                   depth, 10 flagship steps, the checkpoint, the held-out
                   view, launches exact; the photo's decode time (median of
                   3; seconds, us a pixel, MB/s of entropy-coded bytes)
 25. cli_train     the loop through the CLI on a copy of the capture:
                   cfnerf_torch.cli.eval.evaluate at step 0 (random
                   weights), cli.train.main with train_NF.sh's flags and
                   500 steps (the val stream at each i_print, a checkpoint,
                   the test set and the spiral video as PNG frames at step
                   500), evaluate at step 500: the held-out view's PSNR must
                   rise by 3 dB and its NLL fall; the files of each; render-
                   core launches exact, predicted from the cadences; the
                   loop's rays/s beside the train phase's
 26. cli_train_pallas  the same with --trunk_impl pallas in a fresh run dir
                   (trunk launches exact too); both trunks again at seeds 1
                   and 2, each run held to cli_train's gates, and the
                   quality side by side with its seed-to-seed spread and
                   the per-seed pallas - f32 difference (cli_quality)
 27. cli_render_only  the CLI without --is_train on the f32 run: resumes at
                   step 500, renders the spiral (30 launches), its frames
                   bitwise the step-500 video's
 28. entry         cfnerf_torch.entry.entry() on the card against the same
                   fn on the CPU (rtol = atol = 1e-4)
 29. families_golden  each flow family (no_flow, householder, orthogonal,
                   planar, IAF) and baseline (nerf, nerf_dropout on JAX's
                   masks, nerf_wild, and nerf_wild in bf16) of a tiny JAX
                   model (D4/W64, K8, F2; tests/fixtures): a test render and
                   one training step's loss and gradients through the card's
                   unfused path, no kernel of the port launched
 30. families_serve  one 8192-ray tile of the view (N128, K32) for each family
                   and baseline at the flagship's widths, householder and IAF
                   also with the trunk kernel: launches exact (render core
                   and flow stack 0, trunk 1 a pallas tile), rays/s, peak
                   memory, 64 rays against the CPU's plain path, a profiled
                   householder tile
 31. families_train  the same cells, 10 steps (nerf_dropout 3) of 512 + 128
                   rays in each model's loss mode: launches exact (a trunk
                   forward and backward a pallas step, else none), finite
                   metrics, rays/s, peak memory
 32. sample_interp NeRFFlows.sample on 2^20 points and interpolation (K = 21)
                   on 2^18 through the flagship net: 1 and 2 flow-stack
                   launches, each against the flow stack's plain version
 33. cli_families  the CLI (cli.train.main, scripts/train_NF.sh's flags on the
                   capture, 100 steps) with --model nerf_wild, with
                   --type_flows householder --trunk_impl pallas, and without
                   --type_flows (the parser's no_flow); each evaluated at
                   step 100: finite metrics, launches exact
 34. ensemble      cfnerf_torch.cli.ensemble on the capture at train_NF.sh's
                   flags: (a) 3 members trained serially, 20 steps each;
                   (b) the mixture eval of all three, of 1 and 3, of each
                   alone, --members auto under train_psnr and val_nll; (c)
                   --parallel in a fresh run dir, each member's checkpoint
                   against its serial one (relative 1e-5 a tensor, 0
                   expected), the tagged scalars, its mixture eval, its loop
                   rate against (a)'s, peak memory; (d) --trunk_impl pallas,
                   (e) --occ_train 12 --occ_train_from 10, 3 members x 20
                   steps each, and (f) --fused_render off, 3 x 20 steps,
                   serially and --parallel, each --parallel checkpoint
                   against its serial one; --parallel is the member-batched
                   step: one render-core forward and backward (and trunk
                   forward and backward), or unfused two flow-stack
                   launches each way, a dispatch for all members, one
                   co-training density query for all in the occ stage, one
                   val batch render for all; (g) --type_flows householder
                   --trunk_impl pallas and (h) --type_flows IAF, 3 x 20
                   steps, serially and --parallel (one trunk forward and
                   backward a dispatch, the flows eager); (i) remat on the
                   fused render, 3 x 10 steps through the library's steps
                   (make_train_step in turn, make_ensemble_train_step), the
                   recompute's render-core launch counted; the baselines,
                   no kernel on their path: (j) --model nerf_wild, 3 x 30
                   steps through the CLI (its val batch one render for all
                   members), (k) nerf_dropout, 3 x 3, and (l) nerf, 3 x 10,
                   through the library's steps; each --parallel
                   run's weights and Adam state against its serial one, both
                   loops' rays/s (--parallel >= 0.95x) and peak memory;
                   launches exact
 35. mesh          the several-device paths (cfnerf_torch/parallel/mesh.py)
                   on the one card: (a) a one-rank NCCL group through
                   cli.train's mesh path (10 steps of train_NF.sh's flags on
                   the capture) and a mesh render of one view, against the
                   same without a group (relative 1e-6 a tensor, 0
                   expected); (b) two ranks on the card over gloo: the
                   flagship data-parallel step (1024 + 128 rays), the same
                   with the trunk kernels, cli.ensemble train --parallel
                   with 2 members on create_ensemble_mesh(2, 2) (each
                   member's checkpoint against its serial run) and the
                   (data 1, model 2) tensor-parallel step in f32, each
                   against one process (the first step's gradients, the
                   parameters' change); launches exact on every rank
 36. rates         every path's rays/s of this run, side by side
 37. kernels       per-kernel launches, error, time, plain time and bound;
                   trunk_fwd's entry also the training variant's
                   (fwd_save_*, at the flat training step); every entry its
                   member-batched launch's (members); launches_by_path
                   splits the ensemble phase into its serial runs, its
                   evals and its --parallel runs, (e)-(i) apart

then the script's wall time, the `nvidia-smi` name/power line and, last, the
`ok` line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from cfnerf_torch.convert import (
    nerf_flows_pair_state_dicts_from_jax,
    nerf_flows_state_dict_from_jax,
    proposal_state_dict_from_jax,
    state_dict_from_jax,
)
from cfnerf_torch.data.blender import load_blender_data
from cfnerf_torch.data import image_io, jpeg
from cfnerf_torch.data.image_io import imread_png, imwrite_png
from cfnerf_torch.data.prefetch import BatchPrefetcher
from cfnerf_torch.data.sampler import (
    N_DEPTH,
    DepthRayBatcher,
    RayBatcher,
    precompute_depth_rays,
    precompute_rays,
)
from cfnerf_torch.models.baseline_adapter import KSampleBaseline
from cfnerf_torch.models.factory import build_model, create_nerf, loss_mode_for_model
from cfnerf_torch.models.nerf_flows import NeRFFlows
from cfnerf_torch.ops.compositing import LAST_DIST, TRANS_EPS, _CumProd
from cfnerf_torch.ops.kernels import _build
from cfnerf_torch.ops.kernels import flow_stack, render_core, trunk
from cfnerf_torch.ops.kernels.trunk import pack_member_trunk_weights, pack_trunk_weights
from cfnerf_torch.ops.metrics import std_over_k
from cfnerf_torch.ops.occupancy import (
    aabb_from_scene,
    distill_proposal,
    grid_coords,
    make_density_fn,
    make_occ_render_rays,
    make_proposal_sigma_fn,
    place_from_sigma,
    wrap_renderer_for_serving,
)
from cfnerf_torch.ops.rays import get_rays
from cfnerf_torch.ops.sampling import sample_z_vals, stratified_perturb
from cfnerf_torch.render.renderer import (
    RenderConfig,
    make_render_rays,
    prepare_rays,
    render_image,
    schedule_z_vals,
)
from cfnerf_torch.train import checkpoint as ckpt
from cfnerf_torch.cli import ensemble as cli_ensemble
from cfnerf_torch.cli import eval as cli_eval
from cfnerf_torch.cli import train as cli_train
from cfnerf_torch.entry import entry
from cfnerf_torch.train.loop import _snapshot_args, load_dataset
from cfnerf_torch.train.step import OccTrainConfig, TrainConfig, make_train_step
from cfnerf_torch.parallel.ensemble import make_ensemble_train_step, member_generators
from cfnerf_torch.utils.config import parse_args
from cfnerf_torch.utils import trace
from cfnerf_torch.utils.trace import launch_counters

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_golden.npz"
TRAIN_GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_train_golden.npz"
HIER_GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_hier_golden.npz"

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # bf16 dense, tensor cores

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
# backward kernel vs plain.  A per-point gradient sums K per-draw terms of
# magnitude up to ~1 in another order (a warp butterfly against autograd's
# sum over the expanded axis): atol 1e-5 is ~80 f32 ulps of 1.  The z0
# gradients sum ~2.6 M terms at the train tile: judged against 1e-4 of the
# tensor's largest magnitude.
BWD_RTOL, BWD_ATOL, Z0_REL = 1e-4, 1e-5, 1e-4
# the card's training step vs JAX's (train golden): loss and metrics by the
# end-to-end rule; gradients by the CPU tests' rule (rtol 1e-4, atol 1e-6);
# weights after one Adam step within 1e-6 where |g| >= 1e-5, elsewhere
# within one step's reach (2 lr), as tests/test_torch_train.py states
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ADAM_G_MIN, ADAM_ATOL = 1e-5, 1e-6

# flagship training (scripts/train_NF.sh + configs/africa_ds.txt): 512 rgb
# rays + 128 COLMAP depth rays per step, beta1 0.01, depth_lambda 0.01,
# lrate 5e-4, decay 250k; the scene is synthetic (Blender-style poses)
N_RAND = 512
TRAIN_CFG = dict(lrate=5e-4, lrate_decay=250, beta1=0.01, colmap_depth=True,
                 depth_lambda=0.01)
TRAIN_STEPS, FIXED_STEPS = 10, 10
FLAT_METRICS = ("loss", "loss_nll", "loss_entropy", "depth_loss", "mse", "psnr")
HIER_METRICS = FLAT_METRICS + ("loss_nll0",)

# hierarchical sampling at the flagship widths: nerf-pytorch's published
# Blender setting (configs/lego.txt upstream: N_samples 64, N_importance
# 128) with a fine net as wide as the coarse one (D8 W512)
HIER = dict(FLAGSHIP, N_samples=64, N_importance=128, netdepth_fine=8,
            netwidth_fine=512)
# eval-only importance placement on one net (EVAL_r05: 128 + 32 samples)
SHARED_EVAL = dict(n_samples=128, n_importance=32)
HIER_TIMED_RENDERS = 2
# flow-stack kernel vs plain: z and ldj are F steps of the same f32
# arithmetic, contracted into FMAs by nvcc: rtol = atol = 1e-5, the rule of
# tests/test_pallas_flow.py.  The backward's per-point gradients sum K
# draws in another order (a warp butterfly against autograd's sum over the
# expanded axis): BWD_RTOL / BWD_ATOL; g_z0 against Z0_REL of its largest
# magnitude, as the render-core backward judges it.  The inputs are shaped
# as the amortization gives them (tanh-bounded diagonals): with raw randn
# diagonals |1 + (1-t^2) r1 r2| comes near 0 and log-det's conditioning,
# not the kernel, sets the error (PERF.md, PR 2).
FLOW_RTOL = FLOW_ATOL = 1e-5
# the shared-net mode against the pair mode with the coarse net as the fine
# one: the same computation on the same inputs
SHARED_TOL = 1e-6
HIER_MAPS = ("rgb_map", "depth_map", "acc_map", "rgb0", "depth0")

# the trunk kernel (trunk_impl="pallas") vs its plain version, and vs the
# JAX trunk golden: both round the same values to bf16 and sum f32 products
# in another order, so an activation sometimes lands on the neighbouring
# bf16 value (2^-8 relative): atol 1e-3 / rtol 1e-2, the rule of
# tests/test_torch_trunk.py (measured there 9e-8 to 4.0e-4 against JAX).
# Renders through the kernel vs through trunk_impl="interpret" (the plain
# version on the card) carry such flips through the flows and the
# composite: maps rtol = atol = 1e-3
TRUNK_RTOL, TRUNK_ATOL = 1e-2, 1e-3
TRUNK_MAP_RTOL = TRUNK_MAP_ATOL = 1e-3
TRUNK_GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_trunk_golden.npz"
TRUNK_GRAD_GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_trunk_grad_golden.npz"
SERVE_FLAT_PTS = TILE * FLAGSHIP["N_samples"]  # points of one flagship serving tile
# the trunk backward kernels vs their plain version, per gradient leaf (a
# weight matrix or a bias), as tests/test_pallas_trunk.py judges JAX's
# kernel: relative RMS error and cosine.  Both sides round the same f32 sums
# to bf16, taken in another order, so an activation or a gradient now and
# then lands on the neighbouring bf16 value (2^-8 relative) and a relu input
# within one rounding of 0 takes the other branch; through D8's layers that
# compounds: measured on the card up to 1.09e-2 / 0.99994 (D8/W512, randn
# cotangents; 1.3e-3 at D4/W256), so 2e-2 / 0.9998.  The JAX golden
# (D4/W256) sums in XLA's order on the CPU: the same gate.  With dyadic
# weights, inputs and cotangents every sum before a bf16 rounding or a
# relu is exact, so only the order of the final f32 sums over the rows
# differs: measured 1.03e-5 for w0 (4099 rows, values up to ~3e3), so
# 1e-4 / 0.999999, a hundred times below the randn cases' spread.
TRUNK_BWD_REL_RMS, TRUNK_BWD_MIN_COS = 2e-2, 0.9998
TRUNK_EXACT_REL_RMS, TRUNK_EXACT_MIN_COS = 1e-4, 0.999999
# the weight-gradient pass alone against float64: every bf16 x bf16 product
# is exact, but the tensor cores add each k-step's sum into the f32
# accumulator with a rounding that is not to nearest, so over K rows the
# error grows like K, not sqrt(K): measured 6.6e-8 at 64 rows and 9.5e-5 at
# 81,920 (randn G and H).  Gate: at most one f32 ulp (2^-23) of the running
# sum lost every 8 rows, K / 8 * 2^-24 relative (6.1e-4 at 81,920 rows),
# and never below 1e-6
def trunk_wgrad_rel(rows):
    return max(1e-6, rows / 8 * 2.0 ** -24)
# one training step's gradients through trunk_impl="pallas" vs
# trunk_impl="interpret" on the card (same weights, batch and draws): the
# two forwards differ as above, the loss's gradient at the trunk differs by
# that, and each bf16 rounding on the way down turns such a difference
# into whole bf16 steps.  Measured on the card 5.0e-3 flat and 8.0e-3
# hierarchically (worst leaf, relative RMS), so 2.5e-2 / 0.9995
TRUNK_STEP_REL_RMS, TRUNK_STEP_MIN_COS = 2.5e-2, 0.9995
TRAIN_FLAT_PTS = (N_RAND + N_DEPTH) * FLAGSHIP["N_samples"]  # points of a training step


# rays/s of every serving and training path of this run, by phase label,
# printed together (phase "rates") so each path stands beside the others
RATES = {}


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


def cuda_ms(fn, iters: int, arg_sets=((),)) -> float:
    """Median ms of `fn` over `iters` launches, CUDA-event timed, after one
    warm-up call.  Launch i takes `arg_sets[i % len(arg_sets)]`: sets that
    together exceed the 50 MB L2 keep each launch's inputs cold."""
    fn(*arg_sets[0])
    times = []
    for i in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*arg_sets[i % len(arg_sets)])
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


def render_core_bwd_work(R, S, K, F, compute_log_det):
    """(bytes, operations) of the backward: the forward's inputs, the four
    cotangents and the eight gradients, each read or written once; f32
    operations per (point, draw), counted as in render_core_work:
      forward values it needs   32 per flow step + 24 (softplus, alpha,
                                transmittance, 3 sigmoids)
      per flow step, reverse    89 (density 11 + rgb 60 + the 18 per-point
                                sums over the draws)
      composite reverse         42 (incl. sigmoid of the density and the z0
                                accumulation)
      train mode               +65 per step (log-det terms) and +15 (the
                                final-activation corrections).
    The kernel recomputes the forward twice (its phases A and B): that is
    its own overhead, not the function's work."""
    B = R * S
    in_floats = K * 4 + B * (24 * F + 2) + R * 3 * K + 2 * R * K + 2 * R
    out_floats = K * 4 + B * 24 * F
    per = 32 * F + 24 + 89 * F + 42 + ((65 * F + 15) if compute_log_det else 0)
    return 4 * (in_floats + out_floats), B * K * per


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
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
        (N_RAND + N_DEPTH, 128, 32, 4, True, False, "flagship train tile, train mode"),
        (100, 20, 8, 2, True, False, "awkward R=100 S=20 K=8 F=2"),
        (100, 20, 8, 2, False, False, "awkward R=100 S=20 K=8 F=2"),
        (1024, 48, 32, 4, True, False, "S=48"),
        (1024, 96, 32, 4, True, False, "S=96"),
        (64, 48, 40, 3, True, True, "K=40 > one warp, saturated"),
        # the model's diagonals are tanh-bounded: is the ldj gap above the
        # ill-conditioning of log|1 + (1-t^2) r1 r2| at raw randn diagonals?
        (8192, 128, 32, 4, True, True, "serving tile, saturated, tanh-bounded diagonals"),
        # the edges of the kernels' segments (8 a round, <= 16 samples each)
        (640, 1, 32, 4, True, True, "segment edge: S=1"),
        (640, 5, 32, 4, True, False, "segment edge: S=5, under one segment"),
        (640, 129, 32, 4, True, True, "segment edge: S=129, two rounds"),
        # the placed paths' shapes: --occ_eval 16 a serving tile, --occ_train
        # 12 a training step
        (8192, OCC["occ_eval"], 32, 4, False, False, "placed serving tile, test mode"),
        (N_RAND + N_DEPTH, OCC["occ_train"], 32, 4, True, False,
         "placed training step, train mode"),
    ]
    serving_err = None
    for i, (R, S, K, F, cld, sat, label) in enumerate(cases):
        x = render_core_inputs(R, S, K, F, seed=100 + i, saturate=sat)
        if "tanh-bounded" in label:
            x = bounded_diagonals(x)
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


GRAD_NAMES = ("z0_a", "r1_a", "r2_a", "b_a", "z0_r", "r1_r", "r2_r", "b_r")


def bounded_diagonals(x):
    """Model-like flow diagonals: the amortization bounds them with tanh, so
    |1 + (1 - t^2) r1_ii r2_ii| stays away from 0.  Raw randn diagonals
    bring it near 0 and make the log-det gradient ill-conditioned."""
    x = list(x)
    x[1], x[2] = torch.tanh(x[1]), torch.tanh(x[2])
    diag = torch.eye(3, dtype=torch.bool, device="cuda")[None, :, :, None]
    for i in (5, 6):
        x[i] = torch.where(diag, torch.tanh(x[i]), x[i]).contiguous()
    return x


def render_core_cotangents(R, K, seed):
    """Random cotangents of (rgb, depth, acc, ldj); the ldj one scaled by
    1e-2, as training weights it by -beta1 / (B K)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    return [randn(R, 3, K), randn(R, K), randn(R, K), randn(2, R) * 1e-2]


def compare_grads(out, ref):
    """Max abs / rel error per gradient, and the names of those past the
    tolerance or not finite."""
    errs, bad = {}, []
    for name, a, b in zip(GRAD_NAMES, out, ref):
        check(tuple(a.shape) == tuple(b.shape), f"{name} shape {tuple(a.shape)}")
        diff = (a - b).abs()
        if name.startswith("z0"):
            scale = float(b.abs().max())
            ok = float(diff.max()) <= Z0_REL * scale
            rel = float(diff.max()) / max(scale, 1e-30)
        else:
            ok = bool((diff <= BWD_ATOL + BWD_RTOL * b.abs()).all())
            rel = float((diff / b.abs().clamp(min=1e-6)).max())
        if not (ok and bool(torch.isfinite(a).all())):
            bad.append(name)
        errs[name] = {"max_abs": float(diff.max()), "max_rel": rel}
    return errs, bad


def phase_bwd_checks():
    cases = [  # (R, S, K, F, compute_log_det, saturate, label)
        (640, 128, 32, 4, True, False, "flagship train tile"),
        (640, 128, 32, 4, True, True, "flagship train tile, saturated alpha"),
        (640, 128, 32, 4, False, False, "flagship train tile, test mode"),
        (100, 20, 8, 2, True, False, "awkward R=100 S=20 K=8 F=2"),
        (64, 48, 40, 3, True, True, "K=40 > one warp, saturated"),
        # the entropy term's gradient alone, at a unit cotangent per ray
        (640, 128, 32, 4, True, True, "flagship train tile, saturated, ldj cotangent only"),
        # the edges of the kernel's segments (8 a round, <= 16 samples each)
        (640, 1, 32, 4, True, True, "segment edge: S=1"),
        (640, 5, 32, 4, True, False, "segment edge: S=5, under one segment"),
        (640, 129, 32, 4, True, True, "segment edge: S=129, two rounds"),
        # F past the compile-time 4: the staged path (F <= 8, each step's
        # input in registers) and the generic one (F > 8, recomputed)
        (640, 128, 32, 5, True, False, "F=5, staged path"),
        (640, 128, 32, 8, True, True, "F=8, staged path's bound, saturated"),
        (256, 64, 32, 9, True, False, "F=9, generic path"),
        (256, 64, 40, 12, True, True, "F=12, generic path, K=40, saturated"),
        (64, 129, 8, 12, False, False, "F=12, generic path, S=129 two rounds, test mode"),
        (128, 48, 32, 16, True, False, "F=16, generic path"),
        (N_RAND + N_DEPTH, OCC["occ_train"], 32, 4, True, False,
         "placed training step (--occ_train 12)"),
    ]
    train_err = None
    for i, (R, S, K, F, cld, sat, label) in enumerate(cases):
        x = bounded_diagonals(render_core_inputs(R, S, K, F, seed=200 + i, saturate=sat))
        cots = render_core_cotangents(R, K, seed=300 + i)
        if "ldj cotangent only" in label:
            cots = [torch.zeros_like(c) for c in cots[:3]] + [torch.ones_like(cots[3])]
        out = render_core.fused_flow_composite_bwd(x, cots, S, cld)
        again = render_core.fused_flow_composite_bwd(x, cots, S, cld)
        ref = render_core.fused_flow_composite_bwd_plain(x, cots, S, cld)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"backward is deterministic run to run ({label})")
        lower = torch.tril(torch.ones(3, 3, dtype=torch.bool, device="cuda"), -1)
        check(all(float(g[:, lower].abs().max()) == 0.0 for g in (out[5], out[6])),
              "lower triangles of g_r1_r / g_r2_r are zero")
        errs, bad = compare_grads(out, ref)
        emit("kernel", kernel="render_core_bwd", case=label, R=R, S=S, K=K, F=F,
             compute_log_det=cld, saturate=sat, errors=errs,
             tolerance={"rtol": BWD_RTOL, "atol": BWD_ATOL, "z0_rel_to_max": Z0_REL})
        check(not bad, f"render_core_bwd vs plain ({label}): {bad} past the tolerance")
        if i == 0:
            train_err = max(e["max_abs"] for e in errs.values())

    # time at the flagship train tile, train mode.  One set of inputs and
    # cotangents is ~32 MB and fits the 50 MB L2, so launches rotate over
    # three sets (~97 MB): each launch reads its inputs cold, as the
    # forward's serving-tile timing does by size
    R, S, K, F = N_RAND + N_DEPTH, 128, 32, 4
    sets = [(bounded_diagonals(render_core_inputs(R, S, K, F, seed=8 + 2 * i)),
             render_core_cotangents(R, K, seed=9 + 2 * i)) for i in range(3)]
    ms = cuda_ms(lambda x, c: render_core.fused_flow_composite_bwd(x, c, S, True), 21, sets)
    plain_ms = cuda_ms(lambda x, c: render_core.fused_flow_composite_bwd_plain(x, c, S, True),
                       5, sets)
    nbytes, ops = render_core_bwd_work(R, S, K, F, True)
    b_ms, b_by = bound_ms(nbytes, ops)
    emit("kernel_time", kernel="render_core_bwd", R=R, S=S, K=K, F=F, ms=ms,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
         achieved_tflop_per_s=ops / ms / 1e9, input_sets_rotated=len(sets))
    # the generic path (F > 8) at the same tile, F = 12
    F12 = 12
    sets12 = [(bounded_diagonals(render_core_inputs(R, S, K, F12, seed=40 + 2 * i)),
               render_core_cotangents(R, K, seed=41 + 2 * i)) for i in range(3)]
    ms12 = cuda_ms(lambda x, c: render_core.fused_flow_composite_bwd(x, c, S, True), 11,
                   sets12)
    b12, b12_by = bound_ms(*render_core_bwd_work(R, S, K, F12, True))
    emit("kernel_time", kernel="render_core_bwd", R=R, S=S, K=K, F=F12,
         path="generic (F > 8)", ms=ms12, bound_ms=b12, bound_by=b12_by,
         input_sets_rotated=len(sets12))
    del sets12
    xs = [(x,) for x, _ in sets]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda x: render_core.fused_flow_composite(*x, S, True), 21, xs)
        fwd_plain_ms = cuda_ms(lambda x: render_core.fused_flow_composite_plain(*x, S, True),
                               5, xs)
        # the timed inputs' outputs against the plain version's
        fwd_errs = compare(render_core.fused_flow_composite(*xs[0][0], S, True),
                           render_core.fused_flow_composite_plain(*xs[0][0], S, True),
                           MAP_RTOL, MAP_ATOL, LDJ_RTOL)
    f_bytes, f_ops = render_core_work(R, S, K, F, True)
    f_ms, f_by = bound_ms(f_bytes, f_ops)
    emit("kernel_time", kernel="render_core_fwd", R=R, S=S, K=K, F=F, compute_log_det=True,
         ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=f_ms, bound_by=f_by, bytes=f_bytes,
         ops=f_ops, input_sets_rotated=len(xs), errors=fwd_errs)
    return dict(max_abs_err=train_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


# a fused training step past the 8 flow steps the render-core backward keeps
# in registers: a small net (D4 W128, 64 samples, K32) at F = 12, through
# the render core's kernels (the backward's generic path) and through its
# plain version (RenderConfig.fused = "interpret") from the same weights,
# batch and draws.  The two differ only in the render core's sums (each
# gradient within BWD_RTOL / BWD_ATOL of the plain one, as phase_bwd_checks
# holds it), carried back through the amortization and the f32 trunk: per
# leaf relative RMS <= 1e-3 and cosine >= 0.9999
MANY_FLOWS = dict(FLAGSHIP, netdepth=4, netwidth=128, N_samples=64, n_flows=12)
MANY_FLOWS_REL_RMS, MANY_FLOWS_MIN_COS = 1e-3, 0.9999


def phase_many_flows_step():
    batch = flagship_batches()()
    grads, losses, launches = {}, {}, {}
    counters = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd)
    for fused in ("on", "interpret"):
        model, _, rc = build_model(types.SimpleNamespace(**MANY_FLOWS, trunk_impl="xla"))
        cfg = TrainConfig(H=H, W=W, focal=FOCAL, ndc=False, near=NEAR, far=FAR,
                          k_samples=MANY_FLOWS["K_samples"], **TRAIN_CFG)
        step, _ = make_train_step(model, dataclasses.replace(rc, fused=fused), cfg)
        for counter in counters:
            counter.launches = 0
        loss, _ = step.loss_fn(batch, torch.Generator(device="cuda").manual_seed(3))
        loss.backward()
        torch.cuda.synchronize()
        launches[fused] = [counter.launches for counter in counters]
        losses[fused] = float(loss.detach())
        grads[fused] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        del model, step, loss
    check(launches == {"on": [1, 1], "interpret": [0, 0]},
          f"F=12 step: render-core launches {launches}, want one forward and one "
          "backward through the kernels and none through the plain version")
    check(math.isfinite(losses["on"])
          and abs(losses["on"] - losses["interpret"]) <= E2E_ATOL + E2E_RTOL * abs(
              losses["interpret"]), f"F=12 step: loss {losses}")
    check(set(grads["on"]) == set(grads["interpret"]), "F=12 step: the same leaves")
    worst = gate_leaves(leaf_errors(grads["on"], grads["interpret"]), MANY_FLOWS_REL_RMS,
                        MANY_FLOWS_MIN_COS, "F=12 step: kernels vs plain render core")
    emit("kernel", kernel="render_core_fwd+bwd", case="a fused training step at F=12 "
         "(D4 W128, N64, K32)", launches=launches, loss=losses, grads_vs_plain=worst,
         tolerance={"loss_rtol": E2E_RTOL, "loss_atol": E2E_ATOL,
                    "rel_rms": MANY_FLOWS_REL_RMS, "min_cos": MANY_FLOWS_MIN_COS})
    del grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# flow stack: inputs, work model, checks, times
# ---------------------------------------------------------------------- #

SERVE_COARSE_PTS = TILE * HIER["N_samples"]  # points of one hierarchical tile
SERVE_FINE_PTS = TILE * (HIER["N_samples"] + HIER["N_importance"])
TRAIN_COARSE_PTS = (N_RAND + N_DEPTH) * HIER["N_samples"]
TRAIN_FINE_PTS = (N_RAND + N_DEPTH) * (HIER["N_samples"] + HIER["N_importance"])


def flow_stack_inputs(B, K, Z, F, seed, shared_z0=True):
    """Device-made inputs shaped as the amortization gives them: upper
    triangles of 0.5 randn with tanh-bounded diagonals, contiguous; z0 the
    shared (K, Z) draws expanded over the points (the model's case) or a
    contiguous (B, K, Z) tensor."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    triu = torch.triu(torch.ones(Z, Z, device="cuda"), 1)[None, :, :, None]
    eye = torch.eye(Z, device="cuda")[None, :, :, None]
    full = randn(B, Z, Z, F) * 0.5
    r1 = (full * triu + eye * torch.tanh(randn(B, Z, F))[:, :, None, :]).contiguous()
    r2 = (full.transpose(1, 2) * triu
          + eye * torch.tanh(randn(B, Z, F))[:, :, None, :]).contiguous()
    b = randn(B, Z, F) * 0.5
    z0 = randn(K, Z)[None].expand(B, K, Z) if shared_z0 else randn(B, K, Z)
    return [z0, r1, r2, b]


def flow_stack_work(B, K, Z, F, compute_log_det, shared_z0=True):
    """(bytes, operations) of the forward: each input read once (z0 as the
    (K, Z) draws when shared), z and ldj written once; f32 operations per
    (point, draw), counted as in render_core_work: per step Z(Z+1) for the
    pre-activations, Z tanh, Z(Z+1) for the update, and 9Z for the log-dets
    in train mode."""
    params = B * (2 * Z * Z * F + Z * F)
    in_floats = (K * Z if shared_z0 else B * K * Z) + params
    out_floats = B * K * Z + B * K
    per = F * (2 * Z * (Z + 1) + Z + (9 * Z if compute_log_det else 0))
    return 4 * (in_floats + out_floats), B * K * per


def flow_stack_bwd_work(B, K, Z, F, compute_log_det, shared_z0=True):
    """(bytes, operations) of the backward: the forward's inputs and the
    cotangents (g_ldj only in train mode) read once, g_z0 and the parameter
    gradients written once; f32 operations per (point, draw): the forward
    values it needs, F (2Z(Z+1) + Z), and per step in reverse 5Z(Z+1) + 5Z
    (the r1 and r2 terms, tanh', the flip, the per-point sums over the
    draws), + 16Z for the log-det terms in train mode.  The kernel
    recomputes each step's input from z0 (O(F^2) steps): that is its own
    overhead, not the function's work."""
    params = B * (2 * Z * Z * F + Z * F)
    z0 = K * Z if shared_z0 else B * K * Z
    in_floats = z0 + params + B * K * Z + (B * K if compute_log_det else 0)
    out_floats = B * K * Z + params
    per = (F * (2 * Z * (Z + 1) + Z)
           + F * (5 * Z * (Z + 1) + 5 * Z + (16 * Z if compute_log_det else 0)))
    return 4 * (in_floats + out_floats), B * K * per


def compare_flow(out, ref):
    """Max abs / rel error of (z, ldj); raises past the tolerance."""
    errs = {}
    for name, a, b in zip(("z", "ldj"), out, ref):
        diff = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f"{name} finite")
        check(bool((diff <= FLOW_ATOL + FLOW_RTOL * b.abs()).all()),
              f"flow stack {name}: max abs err {float(diff.max())}")
        errs[name] = {"max_abs": float(diff.max()),
                      "max_rel": float((diff / b.abs().clamp(min=1e-6)).max())}
    return errs


FLOW_GRAD_NAMES = ("g_z0", "g_r1", "g_r2", "g_b")


def compare_flow_grads(out, ref):
    """Max abs / rel error per gradient, and the names of those past the
    tolerance or not finite."""
    errs, bad = {}, []
    for name, a, b in zip(FLOW_GRAD_NAMES, out, ref):
        check(tuple(a.shape) == tuple(b.shape), f"{name} shape {tuple(a.shape)}")
        diff = (a - b).abs()
        if name == "g_z0":
            scale = float(b.abs().max())
            ok = float(diff.max()) <= Z0_REL * scale
        else:
            ok = bool((diff <= BWD_ATOL + BWD_RTOL * b.abs()).all())
        if not (ok and bool(torch.isfinite(a).all())):
            bad.append(name)
        errs[name] = {"max_abs": float(diff.max()),
                      "max_rel": float((diff / b.abs().clamp(min=1e-6)).max())}
    return errs, bad


def phase_flow_stack_checks():
    """The forward at the hierarchical path's shapes and awkward ones, for
    both chains and both modes; then the backward at the training passes."""
    cases = [  # (B, K, F, shared z0, label)
        (SERVE_FINE_PTS, 32, 4, True, "hierarchical serving fine pass"),
        (TRAIN_FINE_PTS, 32, 4, True, "hierarchical training fine pass"),
        (TRAIN_COARSE_PTS, 32, 4, False, "training coarse pass, contiguous z0"),
        (1000, 8, 2, False, "awkward B=1000 K=8 F=2, contiguous z0"),
        (4096, 40, 3, True, "K=40 > one warp"),
        (1001, 7, 4, True, "K=7 (a point's run not a multiple of 16 bytes), ragged B"),
        (5000, 32, 1, True, "F=1"),
        (3000, 32, 9, False, "F=9, contiguous z0"),
        (SERVE_FINE_PTS - 77, 32, 4, True, "ragged B: the serving fine pass less 77"),
        (DENSITY_CHUNK, 32, 4, True, "a density query's chunk (bake, distillation)"),
        (OCC_COTRAIN_POINTS, 32, 4, True, "the occ step's co-training density query"),
    ]
    serving_err = None
    for i, (B, K, F, shared, label) in enumerate(cases):
        for Z in (1, 3):
            x = flow_stack_inputs(B, K, Z, F, seed=400 + 4 * i + Z, shared_z0=shared)
            for cld in (False, True):
                with torch.inference_mode():
                    out = flow_stack.fused_flow_stack(*x, cld)
                    ref = flow_stack.fused_flow_stack_plain(*x, cld)
                torch.cuda.synchronize()
                if not cld:
                    check(float(out[1].abs().max()) == 0.0, "test-mode ldj is zero")
                errs = compare_flow(out, ref)
                emit("kernel", kernel="flow_stack_fwd", case=label, B=B, K=K, Z=Z, F=F,
                     compute_log_det=cld, z0="expanded" if shared else "contiguous",
                     errors=errs, tolerance={"rtol": FLOW_RTOL, "atol": FLOW_ATOL})
                if i == 0 and Z == 3 and not cld:
                    serving_err = max(e["max_abs"] for e in errs.values())
                del out, ref
            del x
    torch.cuda.empty_cache()

    cases = [  # (B, K, F, shared z0, label)
        (TRAIN_FINE_PTS, 32, 4, True, "hierarchical training fine pass"),
        (TRAIN_COARSE_PTS, 32, 4, True, "hierarchical training coarse pass"),
        (1000, 8, 2, False, "awkward B=1000 K=8 F=2, contiguous z0"),
        (4096, 40, 3, True, "K=40 > one warp"),
        (1001, 7, 4, True, "K=7, ragged B"),
        (5000, 32, 1, True, "F=1"),
        (3000, 32, 9, False, "F=9, contiguous z0"),
        (TRAIN_FINE_PTS - 77, 32, 4, True, "ragged B: the training fine pass less 77"),
    ]
    train_err = None
    for i, (B, K, F, shared, label) in enumerate(cases):
        for Z in (1, 3):
            x = flow_stack_inputs(B, K, Z, F, seed=500 + 4 * i + Z, shared_z0=shared)
            g = torch.Generator(device="cuda").manual_seed(600 + 4 * i + Z)
            # the ldj cotangent scaled by 1e-2, as training weights it by
            # -beta1 / (B K)
            cots = [torch.randn(B, K, Z, generator=g, device="cuda"),
                    torch.randn(B, K, generator=g, device="cuda") * 1e-2]
            for cld in (True, False):
                out = flow_stack.fused_flow_stack_bwd(x, cots, cld)
                again = flow_stack.fused_flow_stack_bwd(x, cots, cld)
                ref = flow_stack.fused_flow_stack_bwd_plain(x, cots, cld)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(out, again)),
                      f"flow-stack backward is deterministic run to run ({label})")
                lower = torch.tril(torch.ones(Z, Z, dtype=torch.bool, device="cuda"), -1)
                check(all(not bool(gr[:, lower].any()) for gr in out[1:3]),
                      "lower triangles of g_r1 / g_r2 are zero")
                errs, bad = compare_flow_grads(out, ref)
                emit("kernel", kernel="flow_stack_bwd", case=label, B=B, K=K, Z=Z, F=F,
                     compute_log_det=cld, z0="expanded" if shared else "contiguous",
                     errors=errs,
                     tolerance={"rtol": BWD_RTOL, "atol": BWD_ATOL, "z0_rel_to_max": Z0_REL})
                check(not bad, f"flow_stack_bwd vs plain ({label}, Z={Z}): {bad} "
                               "past the tolerance")
                if i == 0 and Z == 3 and cld:
                    train_err = max(e["max_abs"] for e in errs.values())
                del out, again, ref
            del x, cots
    torch.cuda.empty_cache()
    return serving_err, train_err


def phase_flow_stack_time(serving_err, train_err):
    """Each launch of the hierarchical paths at its own shape: the four
    forward launches of a serving tile (test mode), and the four forward
    and four backward launches of a training step (train mode; coarse and
    fine pass, both chains), each group's sum beside its bound.  Launches
    rotate over three input sets, so every launch reads its inputs cold
    from HBM.  Returns the stats of the kernels line: the forward at the
    serving fine pass's rgb launch, the backward at the training fine
    pass's."""
    K, F = HIER["K_samples"], HIER["n_flows"]
    stats = {}

    def time_fwd(label, B, Z, cld, iters):
        sets = [(flow_stack_inputs(B, K, Z, F, seed=700 + 7 * j + Z),) for j in range(3)]
        with torch.inference_mode():
            ms = cuda_ms(lambda x: flow_stack.fused_flow_stack(*x, cld), iters, sets)
            plain_ms = cuda_ms(lambda x: flow_stack.fused_flow_stack_plain(*x, cld), 3, sets)
        nbytes, ops = flow_stack_work(B, K, Z, F, cld)
        b_ms, b_by = bound_ms(nbytes, ops)
        emit("kernel_time", kernel="flow_stack_fwd", launch=label, B=B, K=K, Z=Z, F=F,
             compute_log_det=cld, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             bytes=nbytes, ops=ops, achieved_gb_per_s=nbytes / ms / 1e6,
             input_sets_rotated=len(sets))
        del sets
        torch.cuda.empty_cache()
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    def time_bwd(label, B, Z):
        sets = []
        for j in range(3):
            g = torch.Generator(device="cuda").manual_seed(800 + 7 * j + Z)
            sets.append((flow_stack_inputs(B, K, Z, F, seed=900 + 7 * j + Z),
                         [torch.randn(B, K, Z, generator=g, device="cuda"),
                          torch.randn(B, K, generator=g, device="cuda") * 1e-2]))
        ms = cuda_ms(lambda x, c: flow_stack.fused_flow_stack_bwd(x, c, True), 21, sets)
        plain_ms = cuda_ms(lambda x, c: flow_stack.fused_flow_stack_bwd_plain(x, c, True),
                           3, sets)
        nbytes, ops = flow_stack_bwd_work(B, K, Z, F, True)
        b_ms, b_by = bound_ms(nbytes, ops)
        emit("kernel_time", kernel="flow_stack_bwd", launch=label, B=B, K=K, Z=Z, F=F,
             compute_log_det=True, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             bytes=nbytes, ops=ops, achieved_gb_per_s=nbytes / ms / 1e6,
             input_sets_rotated=len(sets))
        del sets
        torch.cuda.empty_cache()
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    def emit_sum(kernel, label, times):
        emit("kernel_time", kernel=kernel, launch=label, launches=len(times),
             ms=sum(t["ms"] for t in times.values()),
             plain_ms=sum(t["plain_ms"] for t in times.values()),
             bound_ms=sum(t["bound_ms"] for t in times.values()))

    passes = {"serving": (("coarse pass", SERVE_COARSE_PTS), ("fine pass", SERVE_FINE_PTS)),
              "training": (("coarse pass", TRAIN_COARSE_PTS), ("fine pass", TRAIN_FINE_PTS))}
    tile = {(p, Z): time_fwd(f"serving {p}", B, Z, False, 20)
            for p, B in passes["serving"] for Z in (1, 3)}
    emit_sum("flow_stack_fwd", "one hierarchical serving tile", tile)
    stats["fwd"] = dict(tile[("fine pass", 3)], max_abs_err=serving_err,
                        shape=f"B={SERVE_FINE_PTS} K={K} Z=3 F={F}, test mode, "
                              "the serving fine pass's rgb launch")
    step = {(p, Z): time_fwd(f"training {p}", B, Z, True, 21)
            for p, B in passes["training"] for Z in (1, 3)}
    emit_sum("flow_stack_fwd", "one hierarchical training step", step)
    step = {(p, Z): time_bwd(f"training {p}", B, Z)
            for p, B in passes["training"] for Z in (1, 3)}
    emit_sum("flow_stack_bwd", "one hierarchical training step", step)
    stats["bwd"] = dict(step[("fine pass", 3)], max_abs_err=train_err,
                        shape=f"B={TRAIN_FINE_PTS} K={K} Z=3 F={F}, train mode, "
                              "the training fine pass's rgb launch")
    return stats


# ---------------------------------------------------------------------- #
# trunk: inputs, work model, checks, times
# ---------------------------------------------------------------------- #


def trunk_work(B, depth, width, in_ch, v_ch, ha, hr):
    """(bytes, operations) of the trunk forward at true widths: the f32
    embedding read once, the bf16 weights and f32 biases read once, h_alpha
    and h_rgb written once in f32; two operations per multiply-add of the
    layers: x -> W, D-2 W -> W, the skip layer (in + W) -> W, feature W -> W,
    the density head W -> ha, views (W + v) -> W/2, the rgb head W/2 -> hr."""
    half = width // 2
    macs = (in_ch * width + (depth - 2) * width * width + (in_ch + width) * width
            + width * width + width * ha + (width + v_ch) * half + half * hr)
    biases = depth * width + width + ha + half + hr
    nbytes = 4 * B * (in_ch + v_ch) + 2 * macs + 4 * biases + 4 * B * (ha + hr)
    return nbytes, 2 * macs * B


def trunk_args(depth=8, width=512, trunk_impl="pallas"):
    """The flagship flags with the trunk at (depth, width)."""
    return types.SimpleNamespace(**dict(FLAGSHIP, netdepth=depth, netwidth=width,
                                        trunk_impl=trunk_impl))


def trunk_inputs(B, seed, width=90):
    """A (B, 90) f32 embedding on the card, as the renderer hands it over
    (points' sin/cos features lie in [-1, 1]); with width > 90 the first 90
    columns of a wider tensor, so rows are strided."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(B, width, generator=g, device="cuda") * 2.0 - 1.0
    return x[:, :90]


def trunk_bf16_matmul(packed, x):
    """Yardstick, not used by the port: the kernel's layer chain in bf16
    through torch.matmul (cuBLAS, bf16 in and out, f32 sums inside)."""
    m = {k: v.bfloat16() for k, v in packed.matrices().items()}
    b = {k: v.bfloat16() for k, v in packed.biases().items()}
    in_ch, skip = packed.input_ch, packed.depth // 2
    xb = torch.nn.functional.pad(x[:, :in_ch], (0, m["w0"].shape[1] - in_ch)).bfloat16()
    vb = torch.nn.functional.pad(x[:, in_ch:], (0, m["wvv"].shape[1] - packed.views_ch)).bfloat16()
    h = torch.relu(torch.matmul(xb, m["w0"].t()) + b["b0"])
    for i in range(1, packed.depth):
        if i == skip + 1:
            z = torch.matmul(xb, m["wsx"].t()) + torch.matmul(h, m["wsh"].t())
        else:
            z = torch.matmul(h, m[f"w{i}"].t())
        h = torch.relu(z + b[f"b{i}"])
    ha = torch.matmul(h, m["wha"].t()) + b["bha"]
    f = torch.matmul(h, m["wf"].t()) + b["bf"]
    hv = torch.relu(torch.matmul(f, m["wvf"].t()) + torch.matmul(vb, m["wvv"].t()) + b["bv"])
    return ha.float(), (torch.matmul(hv, m["whr"].t()) + b["bhr"]).float()


@contextlib.contextmanager
def cublas_bf16_reduced(allowed):
    """cuBLAS's bf16 reduced-precision reductions, which the port turns off
    (utils/device.py), allowed or not: PyTorch's default allows them, so the
    yardsticks are timed both ways."""
    m = torch.backends.cuda.matmul
    was = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = allowed
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = was


def compare_trunk(out, ref, what="trunk kernel vs plain"):
    """Max abs / rel error of (h_alpha, h_rgb); raises past the tolerance."""
    errs = {}
    for name, a, b in zip(("h_alpha", "h_rgb"), out, ref):
        check(tuple(a.shape) == tuple(b.shape), f"{what} {name} shape {tuple(a.shape)}")
        diff = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f"{what} {name} finite")
        check(bool((diff <= TRUNK_ATOL + TRUNK_RTOL * b.abs()).all()),
              f"{what} {name}: max abs err {float(diff.max())}")
        errs[name] = {"max_abs": float(diff.max()),
                      "max_rel": float((diff / b.abs().clamp(min=1e-6)).max())}
    return errs


def phase_trunk_checks():
    """The trunk kernel against its plain version at the serving paths'
    shapes (flat tile, hierarchical fine and coarse passes), D4/W256, a
    ragged B and strided rows.  Returns the flat tile's max abs error."""
    cases = [  # (B, depth, width, x row stride, label)
        (SERVE_FLAT_PTS, 8, 512, 90, "flat serving tile"),
        (SERVE_FINE_PTS, 8, 512, 90, "hierarchical serving fine pass"),
        (SERVE_COARSE_PTS, 8, 512, 90, "hierarchical serving coarse pass"),
        (65536, 4, 256, 90, "D4/W256"),
        (1000, 8, 512, 90, "ragged B=1000"),
        (4099, 8, 512, 96, "ragged B=4099, row stride 96"),
    ]
    models = {}
    flat_err = None
    for i, (B, depth, width, stride, label) in enumerate(cases):
        if (depth, width) not in models:
            models[(depth, width)] = build_model(trunk_args(depth, width))[0]
        model = models[(depth, width)]
        x = trunk_inputs(B, seed=1000 + i, width=stride)
        with torch.inference_mode():
            packed = pack_trunk_weights(model)
            out = trunk.trunk_encode(packed, x)
            ref = trunk.trunk_encode_plain(packed, x)
        torch.cuda.synchronize()
        errs = compare_trunk(out, ref)
        emit("kernel", kernel="trunk_fwd", case=label, B=B, depth=depth, width=width,
             x_row_stride=stride, errors=errs,
             tolerance={"rtol": TRUNK_RTOL, "atol": TRUNK_ATOL})
        if i == 0:
            flat_err = max(e["max_abs"] for e in errs.values())
        del x, out, ref
    torch.cuda.empty_cache()
    return flat_err


def trunk_act_names(depth):
    return ["x", "v"] + [f"h_{i}" for i in range(depth)] + ["f", "hv"]


def flat_acts(acts):
    """(xb, vb, hs, f, hv) as one list, in trunk_act_names' order."""
    xb, vb, hs, f, hv = acts
    return [xb, vb, *hs, f, hv]


def phase_trunk_save_checks():
    """The training forward (trunk_fwd_save) beside the serving one
    (trunk_fwd) on the same inputs, at the flat training step, D4/W256, the
    ragged cases and odd widths (W32/96/160/384, heads 16-48, x and v
    padded to 96 and 128 columns): h_alpha / h_rgb against the plain
    version and bitwise equal across the two entries (one arithmetic); two
    launches of each entry bitwise equal (outputs, and the saved
    activations); the saved activations, read back through
    trunk.workspace_views, against the plain forward's (_forward), each at
    the forward's tolerance: a wrong box or swizzle on the TMA store shows
    here.  Returns the worst activation error."""
    cases = [  # (B, depth, width, ha, hr, multires, multires_views, extra x columns, label)
        (TRAIN_FLAT_PTS, 8, 512, 64, 64, 10, 4, 0, "flat training step"),
        (65536, 4, 256, 64, 64, 10, 4, 0, "D4/W256"),
        (1000, 8, 512, 64, 64, 10, 4, 0, "ragged B=1000"),
        (4099, 8, 512, 64, 64, 10, 4, 6, "ragged B=4099, row stride 96"),
        (777, 3, 96, 16, 48, 10, 4, 0, "D3/W96 ha16 hr48 B=777"),
        (300, 5, 160, 48, 32, 10, 4, 0, "D5/W160 ha48 hr32 B=300"),
        (129, 4, 32, 16, 16, 10, 4, 0, "D4/W32 ha16 hr16 B=129"),
        (2000, 6, 384, 64, 64, 15, 8, 0, "D6/W384 x/v padded to 96/64 B=2000"),
        (500, 8, 512, 64, 64, 20, 20, 0, "D8/W512 x/v padded to 128/128 B=500"),
    ]
    worst_all = 0.0
    for i, (B, depth, width, ha, hr, mr, mrv, extra, label) in enumerate(cases):
        args = types.SimpleNamespace(**dict(
            FLAGSHIP, netdepth=depth, netwidth=width, h_alpha_size=ha, h_rgb_size=hr,
            multires=mr, multires_views=mrv, trunk_impl="pallas"))
        model = build_model(args)[0]
        cols = model.input_ch + model.input_ch_views
        g = torch.Generator(device="cuda").manual_seed(1800 + i)
        x = (torch.rand(B, cols + extra, generator=g, device="cuda") * 2.0 - 1.0)[:, :cols]
        with torch.inference_mode():
            packed = pack_trunk_weights(model)
            w16 = packed.w.to(torch.bfloat16)
            serve = [trunk._launch(packed, x, w16=w16) for _ in range(2)]
            save = [trunk._launch(packed, x, save=True, w16=w16) for _ in range(2)]
            saved = [flat_acts(trunk.workspace_views(packed, B, s[2])) for s in save]
            ref = flat_acts(trunk._forward(packed, x))
            ref_out = trunk.trunk_encode_plain(packed, x)
        torch.cuda.synchronize()

        def same(a, b):
            return all(torch.equal(u, v) for u, v in zip(a, b))

        def close(name, a, b):
            check(tuple(a.shape) == tuple(b.shape), f"{name} shape ({label})")
            diff = (a - b).abs()
            check(bool(torch.isfinite(a).all())
                  and bool((diff <= TRUNK_ATOL + TRUNK_RTOL * b.abs()).all()),
                  f"{name} vs plain ({label}): max abs err {float(diff.max())}")
            return float(diff.max())

        out_errs = {name: close(f"trunk_fwd {name}", a, b)
                    for name, a, b in zip(("h_alpha", "h_rgb"), serve[0], ref_out)}
        check(same(*serve), f"trunk_fwd: two launches bitwise equal ({label})")
        check(same(save[0][:2], save[1][:2]) and same(*saved),
              f"trunk_fwd_save: two launches bitwise equal, outputs and saved "
              f"activations ({label})")
        check(same(save[0][:2], serve[0]),
              f"trunk_fwd_save's h_alpha / h_rgb bitwise equal to trunk_fwd's ({label})")
        errs = {name: close(f"saved {name}", a, b)
                for name, a, b in zip(trunk_act_names(depth), saved[0], ref)}
        worst = max(errs.values())
        worst_all = max(worst_all, worst)
        emit("kernel", kernel="trunk_fwd_save", case=label, B=B, depth=depth, width=width,
             h_alpha=ha, h_rgb=hr, input_ch=model.input_ch, views_ch=model.input_ch_views,
             x_row_stride=cols + extra, outputs_max_abs_vs_plain=out_errs,
             bitwise_two_launches=True, bitwise_outputs_vs_serving=True,
             saved_acts_max_abs_vs_plain=errs, saved_acts_worst=worst,
             tolerance={"rtol": TRUNK_RTOL, "atol": TRUNK_ATOL, "per": "output and activation"})
        del x, serve, save, saved, ref, ref_out, model
        torch.cuda.empty_cache()
    return worst_all


def phase_trunk_time(flat_err):
    """One trunk launch at each serving shape, CUDA-event timed after a
    warm-up, beside its bound at the bf16 peak, the plain version and two
    yardsticks on the same weights and inputs: the port's own f32 encode
    (trunk_impl="xla", nn.Linear) and the same layer chain in bf16 through
    torch.matmul.  Returns the stats of the kernels line (the flat tile)."""
    model = build_model(trunk_args())[0]
    model_xla = build_model(trunk_args(trunk_impl="xla"))[0]  # the same seed: same weights
    D, Wd = model.net_depth, model.net_width
    shape = (D, Wd, model.input_ch, model.input_ch_views, FLAGSHIP["h_alpha_size"],
             FLAGSHIP["h_rgb_size"])
    stats = None
    for i, (label, B) in enumerate((("flat serving tile", SERVE_FLAT_PTS),
                                    ("hierarchical serving fine pass", SERVE_FINE_PTS),
                                    ("hierarchical serving coarse pass", SERVE_COARSE_PTS))):
        x = trunk_inputs(B, seed=1100 + i)
        with torch.inference_mode():
            pack_ms = cuda_ms(lambda: pack_trunk_weights(model), 5)
            packed = pack_trunk_weights(model)
            ms = cuda_ms(lambda: trunk.trunk_encode(packed, x), 10)
            plain_ms = cuda_ms(lambda: trunk.trunk_encode_plain(packed, x), 3)
            xla_ms = cuda_ms(lambda: model_xla.encode(x), 3)
            check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                  "the port's cuBLAS setting: no bf16 reduced-precision reductions")
            bf16_ms = cuda_ms(lambda: trunk_bf16_matmul(packed, x), 5)
            with cublas_bf16_reduced(True):
                bf16_reduced_ms = cuda_ms(lambda: trunk_bf16_matmul(packed, x), 5)
            # not gated: the yardstick rounds its sums to bf16 between layers
            bf16_errs = [float((a - b).abs().max()) for a, b in zip(
                trunk_bf16_matmul(packed, x), trunk.trunk_encode_plain(packed, x))]
        nbytes, ops = trunk_work(B, *shape)
        b_ms, b_by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        # a model, not a measurement: every CTA of 64 rows reads the whole
        # packed bf16 weight buffer once
        l2_model = -(-B // trunk.ROWS) * packed.w.numel() * 2
        emit("kernel_time", kernel="trunk_fwd", launch=label, B=B, depth=D, width=Wd, ms=ms,
             plain_ms=plain_ms, xla_f32_ms=xla_ms, bf16_matmul_ms=bf16_ms,
             bf16_matmul_reduced_ms=bf16_reduced_ms, pack_ms=pack_ms,
             bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
             achieved_tflop_per_s=ops / ms / 1e9, l2_weight_bytes_model=l2_model,
             l2_weight_tb_per_s_model=l2_model / ms / 1e9,
             bf16_matmul_max_abs_vs_plain={"h_alpha": bf16_errs[0], "h_rgb": bf16_errs[1]})
        if i == 0:
            stats = dict(max_abs_err=flat_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, xla_f32_ms=xla_ms,
                         bf16_matmul_ms=bf16_ms, bf16_matmul_reduced_ms=bf16_reduced_ms,
                         shape=f"B={B} D{D} W{Wd}, the flat serving tile")
        del x, packed
        torch.cuda.empty_cache()
    return stats


def trunk_acts(depth, width, in_ch, v_ch):
    """bf16 values a row of the training forward saves for the backward:
    x, v, every layer's output, f and hv."""
    return in_ch + v_ch + depth * width + width + width // 2


def trunk_fwd_save_work(B, depth, width, in_ch, v_ch, ha, hr):
    """(bytes, operations) of the training forward: the serving forward's,
    and its saved activations written once."""
    nbytes, ops = trunk_work(B, depth, width, in_ch, v_ch, ha, hr)
    return nbytes + 2 * B * trunk_acts(depth, width, in_ch, v_ch), ops


def trunk_bwd_work(B, depth, width, in_ch, v_ch, ha, hr):
    """(bytes, operations) of the trunk backward at true widths, from the
    training forward's saved activations: those (bf16: x, v, every layer's
    output, f, hv) and the two heads' f32 cotangents read once, the bf16
    weights read once, dW and db written once in f32; two operations per
    multiply-add of the weight gradient of every matrix (the forward's
    multiply-adds) and of the gradient through every layer but the x and
    view inputs (they are data)."""
    _, fwd_ops = trunk_work(B, depth, width, in_ch, v_ch, ha, hr)
    half = width // 2
    wgrad = fwd_ops // (2 * B)
    dgrad = wgrad - 2 * in_ch * width - v_ch * half
    biases = depth * width + width + ha + half + hr
    acts = trunk_acts(depth, width, in_ch, v_ch)
    nbytes = (2 * B * acts + 4 * B * (ha + hr) + 2 * wgrad + 4 * wgrad + 4 * biases)
    return nbytes, 2 * (wgrad + dgrad) * B


def trunk_cotangents(B, seed, ha=64, hr=64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, ha, generator=g, device="cuda"),
            torch.randn(B, hr, generator=g, device="cuda"))


def trunk_leaves(packed, dw, db):
    """name -> tensor: the packed gradient buffers cut into their weight
    matrices and biases."""
    out = dict(trunk._split_mats(dw, packed._shape()))
    at = 0
    for name, size in trunk._layout(*packed._shape())[1]:
        out[name] = db[at:at + size]
        at += size
    return out


def leaf_errors(out, ref):
    """name -> {rel_rms, cos, max_abs} for two dicts of same-named tensors."""
    errs = {}
    for name, b in ref.items():
        a = out[name].double()
        b = b.double()
        d = a - b
        norm = float(b.norm())
        errs[name] = {"rel_rms": float(d.norm()) / max(norm, 1e-30),
                      "cos": float((a * b).sum()) / max(float(a.norm()) * norm, 1e-30),
                      "max_abs": float(d.abs().max()) if d.numel() else 0.0}
    return errs


def gate_leaves(errs, rel_rms, min_cos, what):
    """Raises if a leaf is not finite or past (rel_rms, min_cos); a leaf
    that is zero on both sides (the density flow's amor_d) passes and is
    left out of the worst values returned."""
    zero = {n for n, e in errs.items() if e["max_abs"] == e["cos"] == 0.0}
    bad = [n for n, e in errs.items()
           if not (math.isfinite(e["rel_rms"]) and e["rel_rms"] <= rel_rms
                   and (e["cos"] >= min_cos or n in zero))]
    check(not bad, f"{what}: {bad} past rel RMS {rel_rms} / cos {min_cos} "
                   f"({ {n: errs[n] for n in bad} })")
    rest = [e for n, e in errs.items() if n not in zero]
    return {"worst_rel_rms": max(e["rel_rms"] for e in rest),
            "min_cos": min(e["cos"] for e in rest),
            "max_abs": max(e["max_abs"] for e in rest), "zero_on_both_sides": sorted(zero)}


def dyadic_trunk(model, x_shape, seed):
    """The model's linear layers, x and the cotangents set to small dyadic
    values (weights k/16, |k| <= 2; x k/2; cotangents k/4): every sum before
    a bf16 rounding or a relu is exact in f32, in any order."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def dyadic(shape, k, den):
        return torch.randint(-k, k + 1, shape, generator=g, device="cuda").float() / den

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.copy_(dyadic(m.weight.shape, 2, 16))
                m.bias.copy_(dyadic(m.bias.shape, 2, 16))
    B = x_shape[0]
    return dyadic(x_shape, 2, 2), dyadic((B, 64), 4, 4), dyadic((B, 64), 4, 4)


def phase_trunk_bwd_checks():
    """The trunk backward kernels against their plain version at the
    training paths' shapes (flat step, hierarchical fine and coarse passes),
    D4/W256, a ragged B, strided rows, and on dyadic values; two launches
    give the same bits, and the training route (the forward's saved
    workspace, autograd's backward) gives the standalone entry's bits.
    Returns the flat step's max abs error."""
    cases = [  # (B, depth, width, x row stride, dyadic, label)
        (TRAIN_FLAT_PTS, 8, 512, 90, False, "flat training step"),
        (TRAIN_FINE_PTS, 8, 512, 90, False, "hierarchical training fine pass"),
        (TRAIN_COARSE_PTS, 8, 512, 90, False, "hierarchical training coarse pass"),
        (65536, 4, 256, 90, False, "D4/W256"),
        (1000, 8, 512, 90, False, "ragged B=1000"),
        (4099, 8, 512, 96, False, "ragged B=4099, row stride 96"),
        (4099, 8, 512, 90, True, "dyadic values, exact sums"),
    ]
    flat_err = None
    for i, (B, depth, width, stride, dyadic, label) in enumerate(cases):
        model = build_model(trunk_args(depth, width))[0]
        x = trunk_inputs(B, seed=1200 + i, width=stride)
        g_ha, g_hr = trunk_cotangents(B, seed=1300 + i)
        if dyadic:
            x, g_ha, g_hr = dyadic_trunk(model, (B, 90), seed=1400 + i)
        with torch.no_grad():
            packed = pack_trunk_weights(model)
            out = trunk.trunk_encode_bwd(packed, x, g_ha, g_hr)
            again = trunk.trunk_encode_bwd(packed, x, g_ha, g_hr)
            ref = trunk.trunk_encode_bwd_plain(packed, x, g_ha, g_hr)
        saved = trunk_grads_through_autograd(packed, x, g_ha, g_hr)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"trunk backward is deterministic run to run ({label})")
        check(all(torch.equal(a, b) for a, b in zip(out, saved)),
              f"trunk backward from the training forward's saved workspace equals the "
              f"standalone entry ({label})")
        rel, cos = ((TRUNK_EXACT_REL_RMS, TRUNK_EXACT_MIN_COS) if dyadic
                    else (TRUNK_BWD_REL_RMS, TRUNK_BWD_MIN_COS))
        errs = leaf_errors(trunk_leaves(packed, *out), trunk_leaves(packed, *ref))
        worst = gate_leaves(errs, rel, cos, f"trunk_bwd vs plain ({label})")
        emit("kernel", kernel="trunk_bwd", case=label, B=B, depth=depth, width=width,
             x_row_stride=stride, errors=worst, bitwise_run_to_run=True,
             bitwise_saved_workspace_vs_standalone=True,
             tolerance={"rel_rms": rel, "min_cos": cos, "per": "weight or bias leaf"})
        if i == 0:
            flat_err = worst["max_abs"]
        del x, out, again, ref, saved, model
        torch.cuda.empty_cache()
    return flat_err


def trunk_grads_through_autograd(packed, x, g_ha, g_hr):
    """(dw, db) of the packed trunk through `_Trunk`, the training route: the
    forward's training variant saves its activations, autograd's backward
    reads them."""
    w = packed.w.detach().requires_grad_()
    b = packed.b.detach().requires_grad_()
    with torch.enable_grad():
        outs = trunk.trunk_encode(dataclasses.replace(packed, w=w, b=b), x)
        return torch.autograd.grad(outs, [w, b], [g_ha, g_hr])


def phase_trunk_wgrad_checks():
    """The weight-gradient pass alone (trunk_bwd.cu's wgmma kernel through
    its one-matrix entry, trunk_bwd_wgrad_one) against the float64 product
    of the same bf16 G and H, at one 64 x 64 x 64 product and at every
    matrix shape of the flat training step (81,920 rows): the products are
    exact, only the order of the f32 sums over the rows differs."""
    import ctypes

    fn = _build.load(trunk.NAME_BWD).trunk_bwd_wgrad_one
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    R = TRAIN_FLAT_PTS
    cases = [(64, 64, 64, "64 x 64 x 64"), (R, 512, 512, "w1..w7, wf"), (R, 512, 64, "w0, wsx"),
             (R, 64, 512, "wha"), (R, 256, 512, "wvf"), (R, 256, 32, "wvv"),
             (R, 64, 256, "whr")]
    for i, (rows, n_out, n_in, label) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(1700 + i)
        G = torch.randn(rows, n_out, generator=g, device="cuda").bfloat16()
        Hm = torch.randn(rows, n_in, generator=g, device="cuda").bfloat16()
        dw = torch.full((n_out, n_in), float("nan"), device="cuda")
        err = fn(G.data_ptr(), Hm.data_ptr(), rows, n_out, n_in, dw.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"trunk_bwd_wgrad_one launch: CUDA error {err} ({label})")
        torch.cuda.synchronize()
        ref = G.double().t() @ Hm.double()
        rel = float((dw.double() - ref).norm() / ref.norm())
        tol = trunk_wgrad_rel(rows)
        check(bool(torch.isfinite(dw).all()) and rel <= tol,
              f"weight-gradient pass vs float64 ({label}): relative L2 {rel}")
        emit("kernel", kernel="trunk_bwd_wgrad", case=label, rows=rows, n_out=n_out, n_in=n_in,
             rel_l2_vs_f64=rel, tolerance={"rel_l2": tol})
        del G, Hm, dw, ref
    torch.cuda.empty_cache()


def trunk_bf16_matmul_bwd(packed):
    """Yardstick, not used by the port: autograd of trunk_bf16_matmul with
    bf16 leaves.  Returns fn(x, g_ha, g_hr) -> the weight and bias
    gradients after one forward."""
    w16 = packed.w.detach().bfloat16().requires_grad_()
    b32 = packed.b.detach().requires_grad_()
    leaf = dataclasses.replace(packed, w=w16, b=b32)

    def fn(x, g_ha, g_hr):
        with torch.enable_grad():
            outs = trunk_bf16_matmul(leaf, x)
            return torch.autograd.grad(outs, [w16, b32], [g_ha, g_hr])
    return fn


def device_ms_by_kernel(fn, arg_sets, iters, groups):
    """Mean device ms a call of `fn` spends in the kernels whose names hold
    each of `groups` (name -> substring), from torch.profiler's CUDA
    activity over `iters` calls rotating over `arg_sets`, after one warm-up
    call; "not measured" where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    sums = dict.fromkeys(groups, 0.0)
    seen = False
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            seen = True
            for group, key in groups.items():
                if key in evt.name:
                    sums[group] += (evt.time_range.end - evt.time_range.start) / 1e3
    if not seen:
        return dict.fromkeys(groups, "not measured")
    return {group: ms / iters for group, ms in sums.items()}


TRUNK_BWD_PASSES = {"data": "trunk_bwd_data", "wgrad": "trunk_bwd_wgrad",
                    "reductions": "trunk_bwd_reduce"}


def phase_trunk_bwd_time(flat_err):
    """At each training shape, CUDA-event timed after a warm-up, launches
    rotating over three input sets: the backward alone from a saved
    workspace (the kernel of the kernels line), split by pass through the
    profiler; the training forward (with its saved activations) beside the
    serving forward; the two together (the standalone entry) beside
    autograd of the bf16 torch.matmul chain, which also runs both; and the
    plain version.  Bounds at the bf16 peak: the backward's, and the
    weight-gradient pass's alone, and the training forward's (its saved
    activations written).  Returns the stats of the kernels line (the flat
    step): the backward's, and the training forward's for the trunk_fwd
    entry, with its max abs error against the plain forward."""
    model = build_model(trunk_args())[0]
    D, Wd = model.net_depth, model.net_width
    shape = (D, Wd, model.input_ch, model.input_ch_views, FLAGSHIP["h_alpha_size"],
             FLAGSHIP["h_rgb_size"])
    with torch.no_grad():
        packed = pack_trunk_weights(model)
        w16 = packed.w.to(torch.bfloat16)
    yard = trunk_bf16_matmul_bwd(packed)
    stats = None
    for i, (label, B) in enumerate((("flat training step", TRAIN_FLAT_PTS),
                                    ("hierarchical training fine pass", TRAIN_FINE_PTS),
                                    ("hierarchical training coarse pass", TRAIN_COARSE_PTS))):
        sets = [(trunk_inputs(B, seed=1500 + 7 * i + j), *trunk_cotangents(B, 1600 + 7 * i + j))
                for j in range(3)]
        with torch.no_grad():
            saved = [(trunk._launch(packed, x, save=True, w16=w16)[2], a, b)
                     for x, a, b in sets]

            def bwd(acts, a, b):
                return trunk._launch_bwd(packed._shape(), w16, acts, B, a, b)

            ms = cuda_ms(bwd, 10, saved)
            passes = device_ms_by_kernel(bwd, saved, 6, TRUNK_BWD_PASSES)
            fwd_save_ms = cuda_ms(lambda x, a, b: trunk._launch(packed, x, save=True, w16=w16),
                                  10, sets)
            fwd_ms = cuda_ms(lambda x, a, b: trunk._launch(packed, x, w16=w16), 10, sets)
            both_ms = cuda_ms(lambda x, a, b: trunk.trunk_encode_bwd(packed, x, a, b), 10, sets)
            plain_ms = cuda_ms(lambda x, a, b: trunk.trunk_encode_bwd_plain(packed, x, a, b),
                               3, sets)
        yard_ms = cuda_ms(yard, 3, sets)
        with cublas_bf16_reduced(True):
            yard_reduced_ms = cuda_ms(yard, 3, sets)
        nbytes, ops = trunk_bwd_work(B, *shape)
        b_ms, b_by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        wgrad_ops = trunk_work(B, *shape)[1]
        emit("kernel_time", kernel="trunk_bwd", launch=label, B=B, depth=D, width=Wd, ms=ms,
             pass_ms=passes, fwd_save_ms=fwd_save_ms, fwd_serving_kernel_ms=fwd_ms,
             fwd_plus_bwd_ms=both_ms, plain_ms=plain_ms, bf16_matmul_autograd_ms=yard_ms,
             bf16_matmul_autograd_reduced_ms=yard_reduced_ms,
             bound_ms=b_ms, bound_by=b_by, wgrad_bound_ms=1e3 * wgrad_ops / BF16_OPS_PER_S,
             bytes=nbytes, ops=ops, achieved_tflop_per_s=ops / ms / 1e9,
             wgrad_tflop_per_s=(wgrad_ops / passes["wgrad"] / 1e9
                                if isinstance(passes["wgrad"], float) and passes["wgrad"] > 0
                                else "not measured"),
             input_sets_rotated=len(sets))
        if i == 0:
            stats = dict(max_abs_err=flat_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, fwd_plus_bwd_ms=both_ms,
                         bf16_matmul_autograd_ms=yard_ms,
                         bf16_matmul_autograd_reduced_ms=yard_reduced_ms,
                         shape=f"B={B} D{D} W{Wd}, the flat training step, from the "
                               f"training forward's saved activations")
            x = sets[0][0]
            with torch.no_grad():
                out = trunk._launch(packed, x, save=True, w16=w16)[:2]
                ref = trunk.trunk_encode_plain(packed, x)
                fwd_plain_ms = cuda_ms(lambda x, a, b: trunk.trunk_encode_plain(packed, x),
                                       3, sets)
            save_bytes, save_ops = trunk_fwd_save_work(B, *shape)
            save_b_ms, save_b_by = bound_ms(save_bytes, save_ops, BF16_OPS_PER_S)
            save_stats = dict(
                fwd_save_max_abs_err=max(e["max_abs"] for e in compare_trunk(out, ref).values()),
                fwd_save_ms=fwd_save_ms, fwd_save_plain_ms=fwd_plain_ms,
                fwd_save_bound_ms=save_b_ms, fwd_save_bound_by=save_b_by,
                fwd_save_bytes=save_bytes,
                fwd_save_timed_at=f"B={B} D{D} W{Wd}, the flat training step, the "
                                  f"training variant (every bf16 activation saved)")
            emit("kernel_time", kernel="trunk_fwd", launch="flat training step, save variant",
                 B=B, depth=D, width=Wd, ms=fwd_save_ms, plain_ms=fwd_plain_ms,
                 serving_variant_ms=fwd_ms, bound_ms=save_b_ms, bound_by=save_b_by,
                 bytes=save_bytes, ops=save_ops,
                 max_abs_err_vs_plain=save_stats["fwd_save_max_abs_err"])
            del x, out, ref
        del sets, saved
        torch.cuda.empty_cache()
    return stats, save_stats


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #


# ---------------------------------------------------------------------- #
# the member axis (slice 10): one launch for every ensemble member
# ---------------------------------------------------------------------- #

# the member-batched launches at the batched ensemble step's shapes: the
# render core at three members' flagship train tiles, the trunk kernels at
# two members' flat training steps, the flow stack (slice 11) at three
# members' co-training density queries and unfused flagship steps.  Each
# against its plain version at the one-member checks' tolerances, and
# bitwise against one launch per member: a member's arithmetic is that of a
# launch of it alone (the same z0 reduction order, the same trunk row
# ranges, each (point, draw) reading its member's draws)
MEMBER_CORE_M, MEMBER_TRUNK_M, MEMBER_FLOW_M = 3, 2, 3


def member_core_inputs(M, R, S, K, F, seed):
    """M members' render-core inputs (bounded diagonals) and the batched
    call's: z0 stacked, the points joined."""
    per = [bounded_diagonals(render_core_inputs(R, S, K, F, seed=seed + m)) for m in range(M)]
    return per, [torch.stack([p[i] for p in per]) if i in (0, 4)
                 else torch.cat([p[i] for p in per]) for i in range(10)]


def member_bound(work, M, *args, ops_per_s=F32_OPS_PER_S):
    """The bound of M members' work: M times one member's bytes and
    operations (each member's weights, inputs and outputs its own)."""
    nbytes, ops = work(*args)
    return bound_ms(M * nbytes, M * ops, ops_per_s)


def member_flow_inputs(M, B, K, Z, F, seed):
    """M members' flow-stack inputs (each its shared draws expanded over its
    B points, as the model hands them over) and the batched call's: z0
    stacked (M, K, Z), the points joined."""
    per = [flow_stack_inputs(B, K, Z, F, seed=seed + m) for m in range(M)]
    return per, [torch.stack([p[0][0] for p in per])] + [
        torch.cat([p[i] for p in per]) for i in (1, 2, 3)]


def member_flow_checks(out):
    """The flow stack with a member axis: the occ stage's co-training
    density query (3 x 8,192 points, test mode) and the unfused flagship
    step's chains (3 x 81,920 points, train mode, forward and backward),
    both chains each, against the plain version at the `kernel` phase's
    tolerances and bitwise against one launch per member (z, ldj; the
    per-point g_z0 and the parameter gradients; through autograd each
    member's z0 gradient, summed over its own points), timed beside M
    launches.  Adds the stats of the unfused step's rgb chain to `out`."""
    M, K, F = MEMBER_FLOW_M, FLAGSHIP["K_samples"], FLAGSHIP["n_flows"]
    for label, B, cld in (("co-training density query", OCC_COTRAIN_POINTS, False),
                          ("unfused flagship step", TRAIN_FLAT_PTS, True)):
        for Z in (1, 3):
            case = f"{label}: M={M} x B={B} K={K} Z={Z} F={F}"
            per, x = member_flow_inputs(M, B, K, Z, F, seed=2400 + 10 * Z + B % 7)
            with torch.inference_mode():
                got = flow_stack.fused_flow_stack(*x, cld)
                ref = flow_stack.fused_flow_stack_plain(*x, cld)
                alone = [flow_stack.fused_flow_stack(*p, cld) for p in per]
            torch.cuda.synchronize()
            errs = compare_flow(got, ref)
            same = all(torch.equal(got[i][m * B:(m + 1) * B], alone[m][i])
                       for m in range(M) for i in range(2))
            check(same, f"member-batched flow-stack forward vs one launch per member "
                        f"({case}): bitwise")
            with torch.inference_mode():
                ms = cuda_ms(lambda: flow_stack.fused_flow_stack(*x, cld), 21)
                single_ms = cuda_ms(lambda: [flow_stack.fused_flow_stack(*p, cld)
                                             for p in per], 21)
                plain_ms = cuda_ms(lambda: flow_stack.fused_flow_stack_plain(*x, cld), 3)
            b_ms, b_by = member_bound(flow_stack_work, M, B, K, Z, F, cld)
            stats = dict(case=case, max_abs_err=max(e["max_abs"] for e in errs.values()),
                         ms=ms, single_launches_ms=single_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, bitwise_vs_one_launch_a_member=same)
            emit("kernel_members", kernel="flow_stack_fwd", errors=errs,
                 tolerance={"rtol": FLOW_RTOL, "atol": FLOW_ATOL}, **stats)
            if cld and Z == 3:
                out["flow_stack_fwd"] = stats
            del got, ref, alone
            if not cld:
                continue
            g = torch.Generator(device="cuda").manual_seed(2500 + Z)
            # the ldj cotangent scaled by 1e-2, as in the `kernel` phase
            cots_per = [[torch.randn(B, K, Z, generator=g, device="cuda"),
                         torch.randn(B, K, generator=g, device="cuda") * 1e-2]
                        for _ in range(M)]
            cots = [torch.cat([c[i] for c in cots_per]) for i in range(2)]
            got = flow_stack.fused_flow_stack_bwd(x, cots, cld)
            ref = flow_stack.fused_flow_stack_bwd_plain(x, cots, cld)
            alone = [flow_stack.fused_flow_stack_bwd(p, c, cld) for p, c in zip(per, cots_per)]
            torch.cuda.synchronize()
            errs, bad = compare_flow_grads(got, ref)
            check(not bad, f"member-batched flow_stack_bwd vs plain ({case}): {bad} past "
                           "the tolerance")
            same = all(torch.equal(got[i][m * B:(m + 1) * B], alone[m][i])
                       for m in range(M) for i in range(4))
            # through autograd (`_FlowStack`): each member's z0 gradient summed
            # over its own points as its own call's expand sums it
            z0 = x[0].clone().requires_grad_()
            z, ldj = flow_stack.fused_flow_stack(z0, *x[1:], cld)
            torch.autograd.backward([z, ldj], cots)
            summed = []
            for m, p in enumerate(per):
                z0_m = p[0][0].clone().requires_grad_()
                z, ldj = flow_stack.fused_flow_stack(z0_m[None].expand(B, K, Z), *p[1:], cld)
                torch.autograd.backward([z, ldj], cots_per[m])
                summed.append(torch.equal(z0.grad[m], z0_m.grad))
            check(same and all(summed),
                  f"member-batched flow-stack backward vs one launch per member ({case}): "
                  f"bitwise (per point {same}, z0 sums {summed})")
            ms = cuda_ms(lambda: flow_stack.fused_flow_stack_bwd(x, cots, cld), 21)
            single_ms = cuda_ms(lambda: [flow_stack.fused_flow_stack_bwd(p, c, cld)
                                         for p, c in zip(per, cots_per)], 21)
            plain_ms = cuda_ms(lambda: flow_stack.fused_flow_stack_bwd_plain(x, cots, cld), 3)
            b_ms, b_by = member_bound(flow_stack_bwd_work, M, B, K, Z, F, cld)
            stats = dict(case=case, max_abs_err=max(e["max_abs"] for e in errs.values()),
                         ms=ms, single_launches_ms=single_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         bitwise_vs_one_launch_a_member=same and all(summed))
            emit("kernel_members", kernel="flow_stack_bwd", errors=errs,
                 tolerance={"rtol": BWD_RTOL, "atol": BWD_ATOL, "z0_rel_to_max": Z0_REL},
                 **stats)
            if Z == 3:
                out["flow_stack_bwd"] = stats
            del got, ref, alone, cots, cots_per, z0
        del per, x
    torch.cuda.empty_cache()


def phase_member_kernels():
    """Each member-batched launch against its plain version and against one
    launch per member (bitwise), timed beside those M launches.  Returns
    per kernel the stats the kernels line carries under "members"."""
    out = {}
    M, R, S, K, F = MEMBER_CORE_M, N_RAND + N_DEPTH, 128, 32, 4
    case = f"M={M} x R={R} S={S} K={K} F={F}"
    per, x = member_core_inputs(M, R, S, K, F, seed=2100)
    with torch.inference_mode():
        got = render_core.fused_flow_composite(*x, S, True)
        ref = render_core.fused_flow_composite_plain(*x, S, True)
        alone = [render_core.fused_flow_composite(*p, S, True) for p in per]
    torch.cuda.synchronize()
    check(tuple(got[0].shape) == (M * R, 3, K), f"member render core rgb {tuple(got[0].shape)}")
    errs = compare(got, ref, MAP_RTOL, MAP_ATOL, LDJ_RTOL)
    same = all(torch.equal(got[i][m * R:(m + 1) * R] if i < 3 else got[3][:, m * R:(m + 1) * R],
                           alone[m][i]) for m in range(M) for i in range(4))
    check(same, "member-batched render-core forward vs one launch per member: bitwise")
    with torch.inference_mode():
        ms = cuda_ms(lambda: render_core.fused_flow_composite(*x, S, True), 21)
        single_ms = cuda_ms(lambda: [render_core.fused_flow_composite(*p, S, True)
                                     for p in per], 21)
        plain_ms = cuda_ms(lambda: render_core.fused_flow_composite_plain(*x, S, True), 3)
    b_ms, b_by = member_bound(render_core_work, M, R, S, K, F, True)
    out["render_core_fwd"] = dict(case=case, max_abs_err=max(e["max_abs"] for e in errs.values()),
                                  ms=ms, single_launches_ms=single_ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  bitwise_vs_one_launch_a_member=same)
    emit("kernel_members", kernel="render_core_fwd", case=case, errors=errs,
         tolerance={"rtol": MAP_RTOL, "atol": MAP_ATOL, "ldj_rtol": LDJ_RTOL},
         **{k: v for k, v in out["render_core_fwd"].items() if k != "case"})

    cots_per = [render_core_cotangents(R, K, seed=2200 + m) for m in range(M)]
    cots = [torch.cat([c[i] for c in cots_per], 1 if i == 3 else 0) for i in range(4)]
    got = render_core.fused_flow_composite_bwd(x, cots, S, True)
    ref = render_core.fused_flow_composite_bwd_plain(x, cots, S, True)
    alone = [render_core.fused_flow_composite_bwd(p, c, S, True) for p, c in zip(per, cots_per)]
    torch.cuda.synchronize()
    check(tuple(got[0].shape) == (M, K, 1) and tuple(got[4].shape) == (M, K, 3),
          f"member z0 gradients {tuple(got[0].shape)} {tuple(got[4].shape)}")
    errs, bad = compare_grads(got, ref)
    check(not bad, f"member-batched render_core_bwd vs plain: {bad} past the tolerance")
    B = R * S
    same = all(torch.equal(got[i][m] if i in (0, 4) else got[i][m * B:(m + 1) * B], alone[m][i])
               for m in range(M) for i in range(8))
    check(same, "member-batched render-core backward vs one launch per member: bitwise")
    ms = cuda_ms(lambda: render_core.fused_flow_composite_bwd(x, cots, S, True), 21)
    single_ms = cuda_ms(lambda: [render_core.fused_flow_composite_bwd(p, c, S, True)
                                 for p, c in zip(per, cots_per)], 21)
    plain_ms = cuda_ms(lambda: render_core.fused_flow_composite_bwd_plain(x, cots, S, True), 3)
    b_ms, b_by = member_bound(render_core_bwd_work, M, R, S, K, F, True)
    out["render_core_bwd"] = dict(case=case, max_abs_err=max(e["max_abs"] for e in errs.values()),
                                  ms=ms, single_launches_ms=single_ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  bitwise_vs_one_launch_a_member=same)
    emit("kernel_members", kernel="render_core_bwd", case=case, errors=errs,
         tolerance={"rtol": BWD_RTOL, "atol": BWD_ATOL, "z0_rel_to_max": Z0_REL},
         **{k: v for k, v in out["render_core_bwd"].items() if k != "case"})
    del per, x, cots, cots_per, got, ref, alone
    member_flow_checks(out)

    M, B, D, Wd = MEMBER_TRUNK_M, TRAIN_FLAT_PTS, 8, 512
    case = f"M={M} x B={B} D{D}/W{Wd}"
    models = [build_model(types.SimpleNamespace(**dict(vars(trunk_args(D, Wd)), seed=31 + m)))[0]
              for m in range(M)]
    x = trunk_inputs(M * B, seed=2300).reshape(M, B, 90)
    g_ha, g_hr = (t.reshape(M, B, 64) for t in trunk_cotangents(M * B, seed=2301))
    with torch.no_grad():
        packed = pack_member_trunk_weights(models)
        w16 = packed.w.to(torch.bfloat16)
        serve = trunk._launch(packed, x, w16=w16)
        ha, hr, acts = trunk._launch(packed, x, save=True, w16=w16)
        ref = trunk.trunk_encode_plain(packed, x)
        dw, db = trunk._launch_bwd(packed._shape(), w16, acts, B, g_ha, g_hr)
        dref = trunk.trunk_encode_bwd_plain(packed, x, g_ha, g_hr)
        ones = [packed.member(m) for m in range(M)]
        alone = [trunk._launch(p, x[m], w16=w16[m]) for m, p in enumerate(ones)]
        alone_save = [trunk._launch(p, x[m], save=True, w16=w16[m]) for m, p in enumerate(ones)]
        alone_bwd = [trunk._launch_bwd(p._shape(), w16[m], a[2], B, g_ha[m], g_hr[m])
                     for m, (p, a) in enumerate(zip(ones, alone_save))]
    torch.cuda.synchronize()
    errs = compare_trunk(serve, ref, "member-batched trunk_fwd vs plain")
    check(torch.equal(ha, serve[0]) and torch.equal(hr, serve[1]),
          "member-batched trunk_fwd_save's outputs vs trunk_fwd's: bitwise")
    per_bytes = acts.numel() // M
    same_fwd = all(torch.equal(serve[i][m], alone[m][i]) for m in range(M) for i in range(2))
    same_save = all(
        torch.equal(a, b) for m in range(M) for a, b in zip(
            flat_acts(trunk.workspace_views(ones[m], B, acts[m * per_bytes:(m + 1) * per_bytes])),
            flat_acts(trunk.workspace_views(ones[m], B, alone_save[m][2]))))
    same_bwd = all(torch.equal(dw[m], alone_bwd[m][0]) and torch.equal(db[m], alone_bwd[m][1])
                   for m in range(M))
    check(same_fwd and same_save and same_bwd,
          f"member-batched trunk launches vs one launch per member: bitwise (forward "
          f"{same_fwd}, saved activations {same_save}, backward {same_bwd})")
    worst = [gate_leaves(leaf_errors(trunk_leaves(ones[m], dw[m], db[m]),
                                     trunk_leaves(ones[m], dref[0][m], dref[1][m])),
                         TRUNK_BWD_REL_RMS, TRUNK_BWD_MIN_COS,
                         f"member-batched trunk_bwd vs plain (member {m})") for m in range(M)]
    del acts, alone_save, alone_bwd, dref
    torch.cuda.empty_cache()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: trunk._launch(packed, x, w16=w16), 10)
        fwd_single = cuda_ms(lambda: [trunk._launch(p, x[m], w16=w16[m])
                                      for m, p in enumerate(ones)], 10)
        save_ms = cuda_ms(lambda: trunk._launch(packed, x, save=True, w16=w16), 10)
        save_single = cuda_ms(lambda: [trunk._launch(p, x[m], save=True, w16=w16[m])
                                       for m, p in enumerate(ones)], 10)
        acts = trunk._launch(packed, x, save=True, w16=w16)[2]
        singles = [(p, trunk._launch(p, x[m], save=True, w16=w16[m])[2])
                   for m, p in enumerate(ones)]
        bwd_ms = cuda_ms(lambda: trunk._launch_bwd(packed._shape(), w16, acts, B, g_ha, g_hr),
                         10)
        bwd_single = cuda_ms(lambda: [trunk._launch_bwd(p._shape(), w16[m], a, B, g_ha[m],
                                                        g_hr[m])
                                      for m, (p, a) in enumerate(singles)], 10)
        fwd_plain = cuda_ms(lambda: trunk.trunk_encode_plain(packed, x), 3)
        bwd_plain = cuda_ms(lambda: trunk.trunk_encode_bwd_plain(packed, x, g_ha, g_hr), 3)
    shape = (B, D, Wd, 63, 27, 64, 64)
    f_ms, f_by = member_bound(trunk_work, M, *shape, ops_per_s=BF16_OPS_PER_S)
    s_ms, s_by = member_bound(trunk_fwd_save_work, M, *shape, ops_per_s=BF16_OPS_PER_S)
    bw_ms, bw_by = member_bound(trunk_bwd_work, M, *shape, ops_per_s=BF16_OPS_PER_S)
    out["trunk_fwd"] = dict(case=case, max_abs_err=max(e["max_abs"] for e in errs.values()),
                            ms=fwd_ms, single_launches_ms=fwd_single, plain_ms=fwd_plain,
                            bound_ms=f_ms, bound_by=f_by, save_ms=save_ms,
                            save_single_launches_ms=save_single, save_bound_ms=s_ms,
                            save_bound_by=s_by, bitwise_vs_one_launch_a_member=True)
    out["trunk_bwd"] = dict(case=case, max_abs_err=max(w["max_abs"] for w in worst),
                            worst_rel_rms=max(w["worst_rel_rms"] for w in worst),
                            min_cos=min(w["min_cos"] for w in worst), ms=bwd_ms,
                            single_launches_ms=bwd_single, plain_ms=bwd_plain, bound_ms=bw_ms,
                            bound_by=bw_by, bitwise_vs_one_launch_a_member=True)
    for name in ("trunk_fwd", "trunk_bwd"):
        emit("kernel_members", kernel=name, **out[name],
             tolerance=({"rtol": TRUNK_RTOL, "atol": TRUNK_ATOL} if name == "trunk_fwd" else
                        {"rel_rms": TRUNK_BWD_REL_RMS, "min_cos": TRUNK_BWD_MIN_COS}))
    del models, packed, w16, acts, singles, x, g_ha, g_hr
    torch.cuda.empty_cache()
    return out


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

    # 1024 rays: the fused path against the unfused one (model forward, its
    # flow stacks through the flow-stack kernel, then raw2outputs)
    rays_o, rays_d, vd, nv, fv = view_rays(c2w)
    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(1))[:1024].cuda()
    sub = [t[pick] for t in (rays_o, rays_d, vd, nv, fv)]
    unfused_rays = make_render_rays(model, dataclasses.replace(rc, fused="off"))
    with torch.inference_mode():
        a = render_rays(*sub, None, is_test=True)
        flow_stack.fused_flow_stack.launches = 0
        b = unfused_rays(*sub, None, is_test=True)
        torch.cuda.synchronize()
        unfused_launches = flow_stack.fused_flow_stack.launches
    check(unfused_launches == 2, f"the unfused check launched the flow stack "
                                 f"{unfused_launches} times, want 2")
    errs = {}
    for k in ("rgb_map", "depth_map", "acc_map"):
        d = (a[k] - b[k]).abs()
        check(bool((d <= E2E_ATOL + E2E_RTOL * b[k].abs()).all()),
              f"fused vs unfused path {k}: {float(d.max())}")
        errs[k] = float(d.max())
    mask = b["acc_map"] > 1e-3
    rel = ((a["disp_map"] - b["disp_map"]).abs() / b["disp_map"].abs())[mask]
    errs["disp_map_rel_where_acc>1e-3"] = float(rel.max()) if rel.numel() else 0.0

    tile_rays = [t[:TILE] for t in (rays_o, rays_d, vd, nv, fv)]

    def one_tile():
        with torch.inference_mode():
            render_rays(*tile_rays, None, is_test=True)

    breakdown = profile_device(one_tile)

    RATES["serve"] = H * W / image_s
    emit("serve", H=H, W=W, K=K, tile=TILE, n_tiles=n_tiles,
         render_core_launches=launches, first_render_s=first_s,
         image_s=image_s, image_s_all=times, rays_per_s=H * W / image_s,
         peak_mem_gb=peak_gb, mean_std_over_k=float(std.mean()),
         mean_acc=float(out["acc_map"].mean()),
         fused_vs_unfused_1024_rays=errs, unfused_flow_stack_launches=unfused_launches,
         tolerance={"rtol": E2E_RTOL, "atol": E2E_ATOL})
    emit("profile", tile_rays=TILE, **breakdown)
    return launches, unfused_launches


def view_rays(c2w):
    """The serving view's rays on the card: (rays_o, rays_d, viewdirs, near,
    far), one row per pixel."""
    rays_o, rays_d = get_rays(H, W, FOCAL, torch.as_tensor(c2w, device="cuda"))
    return prepare_rays(rays_o, rays_d, H=H, W=W, focal=FOCAL, ndc=False,
                        use_viewdirs=True, near=NEAR, far=FAR)


def profile_device(fn):
    """Device time by kernel for one call of `fn` (after one warm-up call),
    from torch.profiler's CUDA activity (CUPTI).  Only kernels, memcpys and
    memsets count: a user-annotation range on the device's timeline (such as
    Optimizer.step#Adam.step) spans the kernels it annotates and is left
    out.  The busy share is the union of those intervals over the call's
    wall time; by_group_ms and top_kernels sum each kernel's own time
    ("matmul": cuBLAS's and CUTLASS's GEMMs)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, spans, annotation_ms = {}, [], 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if (getattr(evt, "is_user_annotation", False)
                or "annotation" in str(getattr(evt, "activity_type", "")).lower()):
            annotation_ms += (end - start) / 1e3
            continue
        spans.append((start, end))
        n, t = by_name.get(evt.name, (0, 0.0))
        by_name[evt.name] = (n + 1, t + (end - start) / 1e3)
    if not by_name:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end

    def group(name):
        low = name.lower()
        for kernel in ("render_core_bwd", "render_core_fwd", "flow_stack_bwd",
                       "flow_stack_fwd", "trunk_fwd", "trunk_bwd"):
            if kernel in low:
                return kernel
        # cuBLAS's Hopper GEMMs are named nvjet_*
        if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90", "nvjet")):
            return "matmul"
        return "other"

    groups = {}
    for name, (_, ms) in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    device_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "kernel_sum_ms": sum(groups.values()), "annotation_ms_left_out": annotation_ms,
            "by_group_ms": groups,
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms} for n, (c, ms) in top]}


def nested_params(g):
    """The JAX params pytree stored flat in a golden file ("p/a/b" keys)."""
    params = {}
    for key in g.keys():
        if key.startswith("p/"):
            node = params
            *parents, leaf = key[2:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = g[key]
    return params


def phase_golden():
    with np.load(GOLDEN) as g:
        D, Wd, K, F, ha, hr, n_samples, h, w = (int(v) for v in g["config"])
        focal, near, far = (float(v) for v in g["view"])
        params = nested_params(g)
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


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #


def synthetic_scene(seed, n_images=4, n_points=2000):
    """Random images at the serving camera (400x400, Blender half
    resolution), Blender spherical poses around the origin, and per image
    COLMAP-style sparse depth: pixel coordinates, depths in (near, far) and
    reprojection weights.  Made from `seed`; nothing is downloaded."""
    rng = np.random.RandomState(seed)
    images = rng.rand(n_images, H, W, 3).astype(np.float32)
    poses = np.stack([pose_spherical(360.0 * i / n_images, -30.0, 4.0)[:3, :4]
                      for i in range(n_images)])
    depth_gts = [{"coord": rng.uniform(0, [W, H], (n_points, 2)).astype(np.float32),
                  "depth": rng.uniform(NEAR, FAR, n_points).astype(np.float32),
                  "weight": rng.rand(n_points).astype(np.float32)}
                 for _ in range(n_images)]
    return images, poses, depth_gts


def flagship_batches(seed=0):
    """next_batch() -> one flagship training batch: N_RAND rgb rays from
    RayBatcher and N_DEPTH depth rays from DepthRayBatcher over the
    synthetic scene, both streams shuffled from `seed`."""
    images, poses, depth_gts = synthetic_scene(seed=0)
    i_train = list(range(len(images)))
    rays = RayBatcher(precompute_rays(images, poses, FOCAL, i_train, seed=seed), N_RAND,
                      seed=seed)
    depth_rays = DepthRayBatcher(
        precompute_depth_rays(depth_gts, poses, H, W, FOCAL, i_train, seed=seed), N_DEPTH,
        seed=seed)

    def next_batch():
        batch = rays.next()
        batch.update(depth_rays.next())
        batch.pop("ray_weights")  # loaded but unused by the reference loss
        return batch

    return next_batch


def train_run(config, label, counters, want_per_step, metric_keys, trunk_impl="xla",
              occ=False):
    """Training steps of `config`'s nets (the flagship model, or with
    N_importance the hierarchical pair) on flagship batches of the
    synthetic scene: 1 warm-up, then TRAIN_STEPS timed steps, the main path,
    counted (each counter in `counters` reset just before and held to
    want_per_step * TRAIN_STEPS just after); finite metrics with the keys
    `metric_keys`; every parameter with a gradient moves and stays f32; the
    loss falls over FIXED_STEPS steps on a fixed batch; a profiled step.
    With trunk_impl="pallas", also one step's gradients against the same
    step through trunk_impl="interpret" nets.  With occ, the occ stage at
    config's occ_* flags: --occ_train placed samples, the aabb from the
    scene's train cameras, the proposal distilled once from the initial
    field before the warm-up (the stage boundary, at the JAX loop's 2^18
    points and 2 epochs) and installed.  Returns the counts."""
    extra = {}

    def nets(impl):
        args = types.SimpleNamespace(**config, trunk_impl=impl)
        model, model_fine, rc = build_model(args)
        cfg = TrainConfig(H=H, W=W, focal=FOCAL, ndc=False, near=NEAR, far=FAR,
                          k_samples=config["K_samples"], **TRAIN_CFG)
        occ_cfg = None
        if occ:
            lo, hi = aabb_from_scene(scene_dict(), args, model.alpha_mean.device)
            occ_cfg = OccTrainConfig(lo=tuple(lo.tolist()), hi=tuple(hi.tolist()),
                                     n_candidates=args.occ_candidates, floor=args.occ_floor,
                                     cotrain_points=OCC_COTRAIN_POINTS)
            dense_rc, rc = rc, dataclasses.replace(rc, n_samples=args.occ_train)
        step, _ = make_train_step(model, rc, cfg, model_fine=model_fine, occ=occ_cfg)
        if occ:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prop, loss = distill_proposal(
                make_density_fn(model, dense_rc), lo, hi,
                torch.Generator(device="cuda").manual_seed(0), n_points=1 << 18, epochs=2)
            step.install_proposal(prop)
            torch.cuda.synchronize()
            extra.update(distill_s=time.perf_counter() - t0, distill_loss=loss,
                         aabb=[lo.tolist(), hi.tolist()], placed_samples=args.occ_train,
                         candidates=args.occ_candidates, floor=args.occ_floor,
                         cotrain_points=OCC_COTRAIN_POINTS)
        named = {"coarse": model} if model_fine is None else {"coarse": model,
                                                              "fine": model_fine}
        return step, named

    train_step, named = nets(trunk_impl)
    next_batch = flagship_batches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = {(side, n): p.detach().clone() for side, m in named.items()
             for n, p in m.named_parameters()}
    train_step(next_batch(), gen)  # warm-up
    torch.cuda.synchronize()

    # the main path, counted
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        batch = next_batch()
        t0 = time.perf_counter()
        m = train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {counter.__name__: counter.launches for counter in counters}
    for counter, n in zip(counters, want_per_step):
        check(counter.launches == n * TRAIN_STEPS,
              f"{label}: {TRAIN_STEPS} steps launched {counter.__name__} "
              f"{counter.launches} times, want {n * TRAIN_STEPS}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"{label}: finite metrics {m}")
    check(set(metrics[0]) == set(metric_keys), f"{label}: metrics {sorted(metrics[0])}")
    # every parameter moved, but for those with no gradient at all: the
    # density flow's amor_d feeds only the strictly upper triangle of a
    # 1x1 matrix, as in the JAX model
    params = {(side, n): p for side, m in named.items() for n, p in m.named_parameters()}
    still = [f"{side}/{n}" for (side, n), p in params.items()
             if torch.equal(p.detach(), start[(side, n)])]
    check(all(params[tuple(k.split("/", 1))].grad is not None
              and not params[tuple(k.split("/", 1))].grad.any() for k in still),
          f"{label}: parameters with a gradient that did not move: {still}")
    check(all(p.dtype == torch.float32 for p in params.values()),
          f"{label}: the parameters stay f32")
    fixed = next_batch()
    fixed_losses = [float(train_step(fixed, torch.Generator(device="cuda").manual_seed(1))["loss"])
                    for _ in range(FIXED_STEPS)]
    check(fixed_losses[-1] < fixed_losses[0],
          f"{label}: loss on a fixed batch did not fall: {fixed_losses}")
    batch = next_batch()
    breakdown = profile_device(lambda: train_step(batch, gen))
    del train_step, named, params, start
    torch.cuda.empty_cache()

    vs_interpret = None
    if trunk_impl == "pallas":
        # one step from fresh nets, through the kernels and through the plain
        # versions: the same weights (the seed), batch and draws
        grads = {}
        for impl in ("pallas", "interpret"):
            step, fresh = nets(impl)
            loss, _ = step.loss_fn(batch, torch.Generator(device="cuda").manual_seed(2))
            loss.backward()
            grads[impl] = {f"{side}/{n}": p.grad.detach().clone()
                           for side, m in fresh.items() for n, p in m.named_parameters()
                           if p.grad is not None}
            del step, fresh, loss
        check(set(grads["pallas"]) == set(grads["interpret"]),
              f"{label}: the same leaves get gradients")
        vs_interpret = gate_leaves(leaf_errors(grads["pallas"], grads["interpret"]),
                                   TRUNK_STEP_REL_RMS, TRUNK_STEP_MIN_COS,
                                   f"{label}: pallas vs interpret step gradients")
        del grads
        torch.cuda.empty_cache()

    step_s = statistics.median(times)
    RATES[label] = (N_RAND + N_DEPTH) / step_s
    emit(label, rays_per_step=N_RAND + N_DEPTH, rgb_rays=N_RAND, depth_rays=N_DEPTH,
         samples={"coarse": config["occ_train"] if occ else config["N_samples"],
                  "importance": config["N_importance"]},
         K=config["K_samples"], steps=TRAIN_STEPS, launches=launches, step_ms=1e3 * step_s,
         step_ms_all=[1e3 * t for t in times], train_rays_per_s=(N_RAND + N_DEPTH) / step_s,
         peak_mem_gb=peak_gb, unmoved_zero_gradient=still, first_loss=metrics[0]["loss"],
         last_metrics=metrics[-1], fixed_batch_losses=fixed_losses,
         compute_dtype=config.get("compute_dtype", "float32"), **extra,
         **({} if vs_interpret is None else dict(
             pallas_vs_interpret_step_grads=vs_interpret,
             tolerance={"rel_rms": TRUNK_STEP_REL_RMS, "min_cos": TRUNK_STEP_MIN_COS})))
    emit(f"{label}_profile", rays_per_step=N_RAND + N_DEPTH, **breakdown)
    return launches


def phase_train():
    """Flagship training: a render-core forward and backward a step."""
    return train_run(FLAGSHIP, "train",
                     (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd),
                     (1, 1), FLAT_METRICS)


def phase_train_golden():
    with np.load(TRAIN_GOLDEN) as g:
        D, Wd, K, F, ha, hr, S = (int(v) for v in g["config"])
        h, w, focal, near, far, beta1, depth_lambda, lrate = (float(v) for v in g["train"])
        params = nested_params(g)
        model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K)
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            params, (g["test_eps_a"], g["test_eps_r"])))
        model = model.cuda()
        cfg = TrainConfig(H=int(h), W=int(w), focal=focal, ndc=False, near=near, far=far,
                          k_samples=K, lrate=lrate, beta1=beta1, colmap_depth=True,
                          depth_lambda=depth_lambda)
        step, _ = make_train_step(model, RenderConfig(n_samples=S), cfg)
        batch = {k[6:]: g[k] for k in g.files if k.startswith("batch/")}
        t_rand = torch.as_tensor(g["t_rand"], device="cuda")
        R = t_rand.shape[0]
        z_vals = stratified_perturb(
            sample_z_vals(torch.full((R, 1), near, device="cuda"),
                          torch.full((R, 1), far, device="cuda"), S).expand(R, S),
            t_rand=t_rand)
        eps = (g["eps_a"], g["eps_r"])
        before = (render_core.fused_flow_composite.launches,
                  render_core.fused_flow_composite_bwd.launches)
        loss, metrics = step.loss_fn(batch, None, z_vals=z_vals, eps=eps)
        loss.backward()
        torch.cuda.synchronize()
        check((render_core.fused_flow_composite.launches,
               render_core.fused_flow_composite_bwd.launches) == (before[0] + 1, before[1] + 1),
              "the golden step went through both kernels")
        m_err, bad = {}, []
        for k, v in metrics.items():
            ref = float(g[f"jax/{k}"])
            m_err[k] = abs(float(v.detach()) - ref)
            if not m_err[k] <= E2E_ATOL + E2E_RTOL * abs(ref):
                bad.append(k)
        g_err, grads = {}, {}
        for n, p in model.named_parameters():
            ref = torch.as_tensor(g[f"grad/{n}"], device="cuda")
            d = (p.grad - ref).abs()
            if not bool((d <= GRAD_ATOL + GRAD_RTOL * ref.abs()).all()):
                bad.append(f"grad/{n}")
            g_err[n] = float(d.max())
            grads[n] = ref.abs()
        step.update()
        p_err = {}
        for n, p in model.named_parameters():
            d = (p.detach() - torch.as_tensor(g[f"after/{n}"], device="cuda")).abs()
            sel = d[grads[n] >= ADAM_G_MIN]
            if not (bool((sel <= ADAM_ATOL).all()) and float(d.max()) <= 2 * lrate + ADAM_ATOL):
                bad.append(f"after/{n}")
            p_err[n] = float(sel.max()) if sel.numel() else 0.0
    emit("train_golden", source=str(TRAIN_GOLDEN.relative_to(ROOT)), rays=R, S=S, K=K,
         metrics_abs_err_vs_jax=m_err, grad_max_abs_err_vs_jax=max(g_err.values()),
         weights_after_update_max_abs_err=max(p_err.values()),
         tolerance={"metrics": {"rtol": E2E_RTOL, "atol": E2E_ATOL},
                    "grads": {"rtol": GRAD_RTOL, "atol": GRAD_ATOL},
                    "weights": {"atol": ADAM_ATOL, "where_abs_grad_ge": ADAM_G_MIN}})
    check(not bad, f"train golden past the tolerance: {bad} (grads {g_err}, weights {p_err})")


# ---------------------------------------------------------------------- #
# hierarchical sampling
# ---------------------------------------------------------------------- #


def compare_maps(a, b, keys, rtol, atol, what):
    """Max abs error per map; raises past the tolerance."""
    errs = {}
    for k in keys:
        d = (a[k].float().cpu() - b[k].float().cpu()).abs()
        ref = b[k].float().cpu().abs()
        check(bool(torch.isfinite(a[k]).all()), f"{what} {k} finite")
        check(bool((d <= atol + rtol * ref).all()), f"{what} {k}: {float(d.max())}")
        errs[k] = float(d.max())
    return errs


def phase_hier_serve():
    args = types.SimpleNamespace(**HIER)
    model, model_fine, rc = build_model(args)  # the default device: the card
    render_rays = make_render_rays(model, rc, model_fine=model_fine)
    c2w = pose_spherical(30.0, -30.0, 4.0)
    view = dict(H=H, W=W, focal=FOCAL, ndc=False, use_viewdirs=True,
                near=NEAR, far=FAR, tile=TILE)
    n_tiles = -(-H * W // TILE)

    # the main path, counted
    flow_stack.fused_flow_stack.launches = 0
    render_core.fused_flow_composite.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = flow_stack.fused_flow_stack.launches
    check(launches == 4 * n_tiles,
          f"flow stack launched {launches} times, want 4 x {n_tiles} tiles")
    check(render_core.fused_flow_composite.launches == 0,
          "the hierarchical path does not launch the render core")

    K = args.K_samples
    for k in ("rgb_map", "rgb0"):
        check(tuple(out[k].shape) == (H, W, 3, K), f"{k} {tuple(out[k].shape)}")
    for k in ("depth_map", "disp_map", "acc_map", "depth0", "disp0"):
        check(tuple(out[k].shape) == (H, W, K), f"{k} {tuple(out[k].shape)}")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} finite")
    std = std_over_k(out["rgb_map"])
    check(float(std.max()) > 0.0, "std over K is positive somewhere")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fine_vs_coarse = float((out["rgb_map"] - out["rgb0"]).abs().max())
    del out

    times = []
    for _ in range(HIER_TIMED_RENDERS):
        t0 = time.perf_counter()
        render_image(render_rays, c2w, **view)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    image_s = statistics.median(times)

    # 64 rays on the CPU through the plain versions, the same weights
    rays = view_rays(c2w)
    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(2))[:64].cuda()
    sub = [t[pick] for t in rays]
    cpu_rays = make_render_rays(copy.deepcopy(model).cpu(), rc,
                                model_fine=copy.deepcopy(model_fine).cpu())
    with torch.inference_mode():
        a = render_rays(*sub, None, is_test=True)
        b = cpu_rays(*[t.cpu() for t in sub], None, is_test=True)
    torch.cuda.synchronize()
    cpu_errs = compare_maps(a, b, HIER_MAPS, E2E_RTOL, E2E_ATOL, "card vs CPU plain path")

    # the shared-net mode (eval-only importance placement) on one tile
    tile_rays = [t[:TILE] for t in rays]
    rc_shared = dataclasses.replace(rc, **SHARED_EVAL)
    with torch.inference_mode():
        shared = make_render_rays(model, rc_shared)(*tile_rays, None, is_test=True)
        pair = make_render_rays(model, rc_shared, model_fine=model)(
            *tile_rays, None, is_test=True)
    torch.cuda.synchronize()
    shared_errs = compare_maps(shared, pair, HIER_MAPS, 0.0, SHARED_TOL,
                               "shared vs pair mode")
    del shared, pair

    def one_tile():
        with torch.inference_mode():
            render_rays(*tile_rays, None, is_test=True)

    breakdown = profile_device(one_tile)
    RATES["hier_serve"] = H * W / image_s
    emit("hier_serve", H=H, W=W, K=K, tile=TILE, n_tiles=n_tiles,
         samples={"coarse": args.N_samples, "importance": args.N_importance},
         fine_net={"depth": args.netdepth_fine, "width": args.netwidth_fine},
         flow_stack_launches=launches, first_render_s=first_s, image_s=image_s,
         image_s_all=times, rays_per_s=H * W / image_s, peak_mem_gb=peak_gb,
         mean_std_over_k=float(std.mean()), max_fine_vs_coarse=fine_vs_coarse,
         card_vs_cpu_plain_64_rays=cpu_errs,
         shared_vs_pair_one_tile={"samples": SHARED_EVAL, "max_abs": shared_errs},
         tolerance={"cpu": {"rtol": E2E_RTOL, "atol": E2E_ATOL}, "shared": SHARED_TOL})
    emit("hier_profile", tile_rays=TILE, **breakdown)
    return launches


def phase_hier_golden():
    with np.load(HIER_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    D, Wd, Df, Wf, K, F, ha, hr, S, NI = (int(v) for v in g["config"])
    h, w, focal, near, far, beta1, depth_lambda, lrate = (float(v) for v in g["train"])
    sd, sd_fine = nerf_flows_pair_state_dicts_from_jax(
        nested_params(g), (g["test_eps_a"], g["test_eps_r"]),
        (g["test_eps_fine_a"], g["test_eps_fine_r"]))

    def nets():
        out = []
        for (d, width), state in (((D, Wd), sd), ((Df, Wf), sd_fine)):
            m = NeRFFlows(net_depth=d, net_width=width, skips=(d // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K)
            m.load_state_dict(state)
            out.append(m.cuda())
        return out

    def dev(x):
        return torch.as_tensor(x, device="cuda")

    # a test-mode render
    model, model_fine = nets()
    rays = [dev(g[f"rays/{k}"]) for k in ("rays_o", "rays_d", "viewdirs", "near", "far")]
    before = flow_stack.fused_flow_stack.launches
    with torch.inference_mode():
        out = make_render_rays(model, RenderConfig(n_samples=S, n_importance=NI, perturb=False),
                               model_fine=model_fine)(*rays, None, is_test=True)
    torch.cuda.synchronize()
    check(flow_stack.fused_flow_stack.launches == before + 4,
          "the golden render went through the flow-stack kernel")
    r_err = compare_maps(out, {k: torch.as_tensor(g[f"jax/render/{k}"]) for k in HIER_MAPS},
                         HIER_MAPS, E2E_RTOL, E2E_ATOL, "hier golden render")

    # one training step with JAX's draws
    models = nets()
    cfg = TrainConfig(H=int(h), W=int(w), focal=focal, ndc=False, near=near, far=far,
                      k_samples=K, lrate=lrate, beta1=beta1, colmap_depth=True,
                      depth_lambda=depth_lambda)
    step, _ = make_train_step(models[0], RenderConfig(n_samples=S, n_importance=NI), cfg,
                              model_fine=models[1])
    batch = {k[6:]: v for k, v in g.items() if k.startswith("batch/")}
    t_rand = dev(g["t_rand"])
    R = t_rand.shape[0]
    z_vals = stratified_perturb(
        sample_z_vals(torch.full((R, 1), near, device="cuda"),
                      torch.full((R, 1), far, device="cuda"), S).expand(R, S),
        t_rand=t_rand)
    before = (flow_stack.fused_flow_stack.launches, flow_stack.fused_flow_stack_bwd.launches)
    loss, metrics = step.loss_fn(batch, None, z_vals=z_vals, eps=(g["eps_a"], g["eps_r"]),
                                 eps_fine=(g["eps_fine_a"], g["eps_fine_r"]),
                                 pdf_u=dev(g["pdf_u"]))
    loss.backward()
    torch.cuda.synchronize()
    check((flow_stack.fused_flow_stack.launches, flow_stack.fused_flow_stack_bwd.launches)
          == (before[0] + 4, before[1] + 4), "the golden step went through both kernels")
    m_err, bad = {}, []
    for k, v in metrics.items():
        ref = float(g[f"jax/{k}"])
        m_err[k] = abs(float(v.detach()) - ref)
        if not m_err[k] <= E2E_ATOL + E2E_RTOL * abs(ref):
            bad.append(k)
    g_err, grads = {}, {}
    for side, model in zip(("coarse", "fine"), models):
        for n, p in model.named_parameters():
            ref = dev(g[f"grad/{side}/{n}"])
            d = (p.grad - ref).abs()
            if not bool((d <= GRAD_ATOL + GRAD_RTOL * ref.abs()).all()):
                bad.append(f"grad/{side}/{n}")
            g_err[f"{side}/{n}"] = float(d.max())
            grads[f"{side}/{n}"] = ref.abs()
    step.update()
    p_err = {}
    for side, model in zip(("coarse", "fine"), models):
        for n, p in model.named_parameters():
            d = (p.detach() - dev(g[f"after/{side}/{n}"])).abs()
            sel = d[grads[f"{side}/{n}"] >= ADAM_G_MIN]
            if not (bool((sel <= ADAM_ATOL).all()) and float(d.max()) <= 2 * lrate + ADAM_ATOL):
                bad.append(f"after/{side}/{n}")
            p_err[f"{side}/{n}"] = float(sel.max()) if sel.numel() else 0.0
    emit("hier_golden", source=str(HIER_GOLDEN.relative_to(ROOT)), rays=R, S=S, NI=NI, K=K,
         render_max_abs_err_vs_jax=r_err, metrics_abs_err_vs_jax=m_err,
         grad_max_abs_err_vs_jax=max(g_err.values()),
         weights_after_update_max_abs_err=max(p_err.values()),
         tolerance={"render_and_metrics": {"rtol": E2E_RTOL, "atol": E2E_ATOL},
                    "grads": {"rtol": GRAD_RTOL, "atol": GRAD_ATOL},
                    "weights": {"atol": ADAM_ATOL, "where_abs_grad_ge": ADAM_G_MIN}})
    check(not bad, f"hier golden past the tolerance: {bad} (grads {g_err}, weights {p_err})")


def phase_hier_train():
    """Hierarchical training: four flow-stack forwards and backwards (two
    chains, two passes) a step, no render core."""
    return train_run(HIER, "hier_train",
                     (flow_stack.fused_flow_stack, flow_stack.fused_flow_stack_bwd,
                      render_core.fused_flow_composite), (4, 4, 0), HIER_METRICS)


# ---------------------------------------------------------------------- #
# the training step as one CUDA graph (cfnerf_torch/train/graph.py)
# ---------------------------------------------------------------------- #

GRAPH_STEPS = 5
GRAPH_FAMILY_STEPS = 3


def graph_seams(model, fine, rc, batch, gen):
    """Every draw of a step on `batch` from `gen`, as the seams the
    benchmark hands in: the jittered depths, the base draws and, with a
    fine pass, the resample's uniforms and the fine net's base draws."""
    n = len(batch["rays_o"]) + len(batch["depth_rays_o"])
    near, far = (torch.full((n, 1), v, device="cuda") for v in (NEAR, FAR))
    z_vals = schedule_z_vals(rc, near, far, gen, is_test=False)
    seams = dict(z_vals=z_vals, eps=model.train_eps(z_vals.numel(), gen, None))
    if fine is not None:
        seams["pdf_u"] = torch.rand((n, rc.n_importance), generator=gen, device="cuda")
        seams["eps_fine"] = fine.train_eps(n * (z_vals.shape[-1] + rc.n_importance), gen, None)
    return seams


def graph_kernel_events(prof):
    """The hand-written kernels' device kernels in a profile's events, by
    launch counter: each kernel's name carries its counter's (a launch may
    run more than one, as render_core_bwd's reduction)."""
    seen = dict.fromkeys(launch_counters(), 0)
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            name = evt.name().lower()
            for k in seen:
                seen[k] += k in name
    return seen


def graph_pair(config, label, batches, trunk_impl="xla", noise=False, handed=False,
               fallback=False):
    """Two step objects of `config` from the same weights: A runs
    train_step, a CUDA graph (captured at its first call, then replayed), B
    the eager step through its halves (zero_grad, loss_fn, backward,
    update: train_step's eager path) on the same kind of Adam; a step each
    a batch of `batches`.  The draws come from two generators of one seed,
    which A's graph registers and draws from (the CLI's path), or with
    `handed` from seams made once (graph_seams) and handed to both (the
    benchmark's path).  With `fallback` the third batch has half the rgb
    rays: A runs it eagerly (train.graph_eager counts 1), then replays
    again.  Checks, bitwise: every step's metrics, the parameters and Adam's
    moments and step count after the last; the launch counters a step equal
    (the graph's warm-up and capture count as no step's); then two more
    steps of each, the second profiled: the replay's device events hold each
    hand-written kernel as often as the eager step's, and the counters,
    which count a replay's launches from its capture, say as much as the
    eager step's real ones.  Returns the times."""
    args = types.SimpleNamespace(**config, trunk_impl=trunk_impl)
    model_a, fine_a, rc = build_model(args)
    if noise:
        rc = dataclasses.replace(rc, apply_noise=True, raw_noise_std=1.0)
    model_b, fine_b = copy.deepcopy(model_a), copy.deepcopy(fine_a)
    cfg = TrainConfig(H=H, W=W, focal=FOCAL, ndc=False, near=NEAR, far=FAR,
                      k_samples=config["K_samples"], **TRAIN_CFG)
    step_a, opt_a = make_train_step(model_a, rc, cfg, model_fine=fine_a)
    step_b, opt_b = make_train_step(model_b, rc, cfg, model_fine=fine_b)
    check(step_a.graph_refusal is None, f"graph_step {label}: refused: {step_a.graph_refusal}")
    gen_a, gen_b, gen_s = (torch.Generator(device="cuda").manual_seed(s) for s in (7, 7, 11))
    counters = launch_counters()
    if fallback:
        half = {k: v[:len(v) // 2] for k, v in batches[0].items()
                if k in ("rays_o", "rays_d", "target")}
        batches = [*batches[:2], {**batches[0], **half}, *batches[2:]]

    def run(one):
        out, launched, times = [], [], []
        for batch in batches:
            before = {k: fn.launches for k, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append({k: v.clone() for k, v in one(batch).items()})
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            launched.append({k: fn.launches - before[k] for k, fn in counters.items()})
        return out, launched, times

    def graphed(batch):
        if handed:
            return step_a(batch, None, **graph_seams(model_b, fine_b, rc, batch, gen_s))
        return step_a(batch, gen_a)

    def eager(batch):
        opt_b.zero_grad(set_to_none=True)
        if handed:
            loss, metrics = step_b.loss_fn(batch, None,
                                           **graph_seams(model_b, fine_b, rc, batch, gen_s))
        else:
            loss, metrics = step_b.loss_fn(batch, gen_b)
        loss.backward()
        step_b.update()
        return {k: v.detach() for k, v in metrics.items()}

    start = {n: p.detach().clone() for n, p in model_a.named_parameters(prefix="coarse")}
    if fine_a is not None:
        start.update((n, p.detach().clone()) for n, p in fine_a.named_parameters(prefix="fine"))
    what = f"graph_step {label} ({'handed-in seams' if handed else 'generator'})"
    gen_s.manual_seed(11)
    if fallback:  # the graph's counters, recorded while a profile records
        from torch.profiler import ProfilerActivity, profile

        trace.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            got_a, launched_a, ms_a = run(graphed)
        calls = trace.snapshot()["counters"]
        trace.reset()
        want = {"train.graph_capture": 1, "train.graph_replay": len(batches) - 1,
                "train.graph_eager": 1}
        check({k: calls.get(k, 0) for k in want} == want,
              f"{what}: graph counters {calls}, want {want}")
    else:
        got_a, launched_a, ms_a = run(graphed)
    gen_s.manual_seed(11)
    got_b, launched_b, ms_b = run(eager)
    check(all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
              for a, b in zip(got_a, got_b)), f"{what}: metrics not bitwise")
    named_a = dict(model_a.named_parameters(prefix="coarse"))
    named_b = dict(model_b.named_parameters(prefix="coarse"))
    if fine_a is not None:
        named_a.update(fine_a.named_parameters(prefix="fine"))
        named_b.update(fine_b.named_parameters(prefix="fine"))
    differ = [n for n in named_a if not torch.equal(named_a[n], named_b[n])]
    check(not differ, f"{what}: parameters not bitwise: {differ[:5]}")
    state_differ = []
    for n in named_a:
        sa, sb = opt_a.state.get(named_a[n], {}), opt_b.state.get(named_b[n], {})
        if sa.keys() != sb.keys() or any(not torch.equal(sa[k], sb[k]) for k in sa):
            state_differ.append(n)
    check(not state_differ, f"{what}: Adam's state not bitwise: {state_differ[:5]}")
    check(launched_a == launched_b, f"{what}: launches {launched_a} against eager {launched_b}")
    moved = sum(not torch.equal(p, start[n]) for n, p in named_a.items())
    check(moved > 0, f"{what}: no parameter moved")
    # two more steps each, the second profiled: the replay's device kernels
    # against the eager step's, whose counters count real launches (a launch
    # may run more than one kernel), and the counters alike; the first step
    # is the profiler's warm-up (the kernels of a profile's first moments
    # can go unrecorded)
    from torch.profiler import ProfilerActivity, profile, schedule

    def profiled(one):
        seen = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: seen.append(graph_kernel_events(p))) as prof:
            one(batches[-1])
            torch.cuda.synchronize()
            prof.step()
            before = {k: fn.launches for k, fn in counters.items()}
            one(batches[-1])
            torch.cuda.synchronize()
            prof.step()
        check(len(seen) == 1, f"{what}: {len(seen)} profiled steps, want 1")
        return {k: fn.launches - before[k] for k, fn in counters.items()}, seen[0]

    (counted, seen), (counted_b, seen_b) = profiled(graphed), profiled(eager)
    check(seen == seen_b and counted == counted_b,
          f"{what}: a profiled replay ran the kernels {seen} and counted {counted}, "
          f"the eager step {seen_b} and {counted_b}")
    del step_a, step_b, opt_a, opt_b, model_a, model_b, fine_a, fine_b
    torch.cuda.empty_cache()
    steady = [ms for i, ms in enumerate(ms_a[1:], 1) if not (fallback and i == 2)]
    return dict(steps=len(batches), graphed_ms=ms_a, eager_ms=ms_b,
                graphed_step_ms=statistics.median(steady),
                eager_step_ms=statistics.median(ms_b[1:]), capture_step_ms=ms_a[0],
                launches_a_step=launched_b[-1], replay_kernel_events=seen,
                eager_kernel_events=seen_b,
                parameters_moved=f"{moved}/{len(named_a)}",
                last_loss=float(got_a[-1]["loss"]))


def phase_graph_step():
    """make_train_step's CUDA graph against its eager step (graph_pair): the
    flagship (D8/W512, 512 + 128 rays, N128, K32, the fused render core)
    and the hierarchical pair (64 + 128 samples, two D8/W512 nets, the
    flow-stack kernels), each through the generator and through handed-in
    seams, 5 steps; the flagship's eager fallback (3 steps and a call with
    half the rgb rays); then 3 steps of every other graphed way at the
    flagship's widths (the trunk kernels, bf16, the unfused render with
    applied noise, each other flow family) through the generator."""
    # the composite's cumprod (its backward written out so that a graph
    # captures it) against torch.cumprod on the card, at the hierarchical
    # fine pass's shape: forward and gradient bitwise
    g = torch.Generator(device="cuda").manual_seed(3)
    alpha = torch.rand((N_RAND + N_DEPTH, HIER["N_samples"] + HIER["N_importance"],
                        HIER["K_samples"]), generator=g, device="cuda")
    cot = torch.randn(alpha.shape, generator=g, device="cuda")
    got = []
    for cumprod in (torch.cumprod, _CumProd.apply):
        a = alpha.clone().requires_grad_()
        y = cumprod(1.0 - a + TRANS_EPS, -2)
        (y * cot)[:, :-1].sum().backward()
        got.append((y.detach(), a.grad))
    check(torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1]),
          "graph_step: the composite's cumprod is not torch.cumprod's bit for bit")
    next_batch = flagship_batches()
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in next_batch().items()}
               for _ in range(GRAPH_STEPS)]
    # beside the flagship and hierarchical pairs, at the flagship's widths:
    # every other way make_train_step graphs (label, flags, trunk_impl,
    # applied density noise)
    more = ([("trunk pallas", {}, "pallas", False),
             ("bf16", dict(compute_dtype="bfloat16"), "xla", False),
             ("unfused noise", {}, "xla", True)]
            + [(f, dict(type_flows=f), "xla", False) for f in FAMILY_NAMES])
    out = {}
    for label, config in (("flagship", FLAGSHIP), ("hierarchical", HIER)):
        for handed in (False, True):
            out[f"{label} {'handed' if handed else 'generator'}"] = graph_pair(
                config, label, batches, handed=handed)
    # a call with other shapes on a graphed object: eager, then replays again
    out["flagship eager fallback"] = graph_pair(FLAGSHIP, "flagship eager fallback",
                                                batches[:GRAPH_FAMILY_STEPS], fallback=True)
    for label, over, impl, noise in more:
        out[label] = graph_pair(dict(FLAGSHIP, **over), label, batches[:GRAPH_FAMILY_STEPS],
                                trunk_impl=impl, noise=noise)
    emit("graph_step", nvidia_smi=nvidia_smi_line(), rays_per_step=N_RAND + N_DEPTH, cells=out)
    return out


# ---------------------------------------------------------------------- #
# serving through the trunk kernel (trunk_impl="pallas")
# ---------------------------------------------------------------------- #


def trunk_view(config, label, counters, want):
    """Render the 400x400 view with trunk_impl="pallas" models: counted
    (each counter in `counters` reset just before, read just after, and held
    to `want`), then one timed render; 64 rays against the same weights with
    trunk_impl="interpret" (gated) and "xla" (reported); a profiled tile."""
    nets = {}
    for impl in ("pallas", "interpret", "xla"):
        model, model_fine, rc = build_model(types.SimpleNamespace(**config, trunk_impl=impl))
        nets[impl] = make_render_rays(model.eval(), rc, model_fine=model_fine)
    render_rays = nets["pallas"]
    c2w = pose_spherical(30.0, -30.0, 4.0)
    view = dict(H=H, W=W, focal=FOCAL, ndc=False, use_viewdirs=True,
                near=NEAR, far=FAR, tile=TILE)

    # the main path, counted
    for counter in counters:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {counter.__name__: counter.launches for counter in counters}
    for counter, n in zip(counters, want):
        check(counter.launches == n,
              f"{label}: {counter.__name__} launched {counter.launches} times, want {n}")
    K = config["K_samples"]
    check(tuple(out["rgb_map"].shape) == (H, W, 3, K), f"{label} rgb_map shape")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{label} {k} finite")
    std = std_over_k(out["rgb_map"])
    check(float(std.max()) > 0.0, f"{label}: std over K is positive somewhere")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del out

    t0 = time.perf_counter()
    render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0

    rays = view_rays(c2w)
    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(3))[:64].cuda()
    sub = [t[pick] for t in rays]
    with torch.inference_mode():
        maps = {impl: fn(*sub, None, is_test=True) for impl, fn in nets.items()}
    torch.cuda.synchronize()
    keys = HIER_MAPS if "rgb0" in maps["pallas"] else ("rgb_map", "depth_map", "acc_map")
    vs_interpret = compare_maps(maps["pallas"], maps["interpret"], keys, TRUNK_MAP_RTOL,
                                TRUNK_MAP_ATOL, f"{label}: pallas vs interpret trunk")
    vs_xla = {k: float((maps["pallas"][k] - maps["xla"][k]).abs().max()) for k in keys}

    tile_rays = [t[:TILE] for t in rays]

    def one_tile():
        with torch.inference_mode():
            render_rays(*tile_rays, None, is_test=True)

    breakdown = profile_device(one_tile)
    RATES[f"trunk_serve ({label})"] = H * W / image_s
    emit("trunk_serve", view=label, H=H, W=W, K=K, tile=TILE, launches=launches,
         counted_render_s=counted_s, image_s=image_s, rays_per_s=H * W / image_s,
         peak_mem_gb=peak_gb, mean_std_over_k=float(std.mean()),
         pallas_vs_interpret_64_rays=vs_interpret,
         pallas_vs_xla_f32_64_rays_not_gated=vs_xla,
         tolerance={"rtol": TRUNK_MAP_RTOL, "atol": TRUNK_MAP_ATOL})
    emit("trunk_profile", view=label, tile_rays=TILE, **breakdown)
    return launches


def phase_trunk_serve():
    """Both flagship views through the trunk kernel: the flat render (a
    trunk and a render-core launch a tile) and the hierarchical pair (two
    trunk launches and four flow-stack launches a tile)."""
    n_tiles = -(-H * W // TILE)
    flat = trunk_view(FLAGSHIP, "flagship flat", (trunk.trunk_encode,
                      render_core.fused_flow_composite), (n_tiles, n_tiles))
    hier = trunk_view(HIER, "hierarchical pair",
                      (trunk.trunk_encode, flow_stack.fused_flow_stack,
                       render_core.fused_flow_composite), (2 * n_tiles, 4 * n_tiles, 0))
    return flat, hier


def phase_trunk_golden():
    """The card's trunk kernel on a D4/W256 trunk against JAX's
    pallas_encode (interpreted on the CPU; tests/fixtures)."""
    with np.load(TRUNK_GOLDEN) as g:
        D, Wd, K, F, ha, hr = (int(v) for v in g["config"])
        model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K, trunk_impl="pallas")
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            nested_params(g), (g["test_eps_a"], g["test_eps_r"])))
        model = model.cuda()
        before = trunk.trunk_encode.launches
        with torch.inference_mode():
            out = model.encode(torch.as_tensor(g["x"], device="cuda"))
        torch.cuda.synchronize()
        check(trunk.trunk_encode.launches == before + 1, "the trunk golden went through the kernel")
        errs = compare_trunk(out, [torch.as_tensor(g[f"jax/{k}"], device="cuda")
                                   for k in ("h_alpha", "h_rgb")], what="trunk golden")
        rows = int(g["x"].shape[0])
    emit("trunk_golden", source=str(TRUNK_GOLDEN.relative_to(ROOT)), rows=rows, depth=D,
         width=Wd, max_abs_err_vs_jax=errs,
         tolerance={"rtol": TRUNK_RTOL, "atol": TRUNK_ATOL})


# ---------------------------------------------------------------------- #
# training through the trunk kernels (trunk_impl="pallas")
# ---------------------------------------------------------------------- #


def phase_trunk_train():
    """Flat training with a trunk_impl="pallas" net (a trunk forward and
    backward and a render-core forward and backward a step), then the
    hierarchical pair (two trunk forwards and backwards, four flow-stack
    forwards and backwards a step, no render core)."""
    flat = train_run(
        FLAGSHIP, "trunk_train",
        (trunk.trunk_encode, trunk.trunk_encode_bwd, render_core.fused_flow_composite,
         render_core.fused_flow_composite_bwd), (1, 1, 1, 1), FLAT_METRICS, "pallas")
    hier = train_run(
        HIER, "trunk_hier_train",
        (trunk.trunk_encode, trunk.trunk_encode_bwd, flow_stack.fused_flow_stack,
         flow_stack.fused_flow_stack_bwd, render_core.fused_flow_composite), (2, 2, 4, 4, 0),
        HIER_METRICS, "pallas")
    return flat, hier


def phase_trunk_grad_golden():
    """The card's trunk backward kernels on the D4/W256 trunk golden's
    weights and x, with the cotangents of tests/fixtures, against JAX's
    _trunk_bwd gradients (jax.vjp of pallas_encode, interpreted on the
    CPU)."""
    with np.load(TRUNK_GOLDEN) as g, np.load(TRUNK_GRAD_GOLDEN) as gg:
        D, Wd, K, F, ha, hr = (int(v) for v in g["config"])
        model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K, trunk_impl="pallas")
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            nested_params(g), (g["test_eps_a"], g["test_eps_r"])))
        model = model.cuda()
        before = trunk.trunk_encode_bwd.launches
        out = model.encode(torch.as_tensor(g["x"], device="cuda"))
        torch.autograd.backward(out, [torch.as_tensor(gg[f"g/{k}"], device="cuda")
                                      for k in ("h_alpha", "h_rgb")])
        torch.cuda.synchronize()
        check(trunk.trunk_encode_bwd.launches == before + 1,
              "the trunk grad golden went through the backward kernels")
        ref = {k[len("jax/grad/"):]: torch.as_tensor(gg[k], device="cuda")
               for k in gg.files if k.startswith("jax/grad/")}
        grads = {n: p.grad for n, p in model.named_parameters() if n in ref}
        check(set(grads) == set(ref) and all(v is not None for v in grads.values()),
              "the trunk grad golden's leaves get gradients")
        worst = gate_leaves(leaf_errors(grads, ref), TRUNK_BWD_REL_RMS,
                            TRUNK_BWD_MIN_COS, "trunk grad golden")
        rows = int(g["x"].shape[0])
    emit("trunk_grad_golden", source=str(TRUNK_GRAD_GOLDEN.relative_to(ROOT)), rows=rows,
         depth=D, width=Wd, errors_vs_jax=worst,
         tolerance={"rel_rms": TRUNK_BWD_REL_RMS, "min_cos": TRUNK_BWD_MIN_COS})


# ---------------------------------------------------------------------- #
# --compute_dtype bfloat16 on the xla trunk
# ---------------------------------------------------------------------- #

BF16 = dict(FLAGSHIP, compute_dtype="bfloat16")
BF16_GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_bf16_golden.npz"
# the card's bf16 render vs JAX's (tests/fixtures, op by op on the CPU):
# cuBLAS sums each bf16 product in another order than XLA's CPU dot, so a
# trunk entry lands one bf16 ulp (2^-8 relative) apart here and there, and
# the flows and the composite carry that into the maps: measured 2.3e-4 on
# the card, so rtol = atol = 2e-3, as tests/test_torch_bf16.py states.
# Those maps cannot tell the bf16 trunk from the f32 one (the f32 trunk's
# maps lie within 5.7e-4 of JAX's bf16 maps on the CPU), so the golden's
# JAX bf16 encode of 1024 rows is held too: an entry bitwise equal unless
# another summation order rounds it to the neighbouring bf16 value and the
# flip spreads through the later layers; the f32 trunk's outputs are not
# bf16 values and match almost none.  At least half the entries bitwise
# equal (set before the first reading, between the f32 trunk's ~0 and the
# bf16 trunk's expected > 0.9; measured 0.99994 and 0.0 on an H100), each
# within BF16_ATOL; the f32 trunk on the same weights, run as the control,
# must fail that share
BF16_RTOL = BF16_ATOL = 2e-3
BF16_ENCODE_EQUAL_MIN = 0.5


def phase_bf16_serve():
    """The flagship view with --compute_dtype bfloat16 on the xla trunk: 20
    render-core launches, counted, then one timed render; the first tile
    against the f32 trunk on the same weights (reported, not gated)."""
    model, _, rc = build_model(types.SimpleNamespace(**BF16))
    check(model.compute_dtype == torch.bfloat16, "bf16 model")
    render_rays = make_render_rays(model.eval(), rc)
    c2w = pose_spherical(30.0, -30.0, 4.0)
    view = dict(H=H, W=W, focal=FOCAL, ndc=False, use_viewdirs=True,
                near=NEAR, far=FAR, tile=TILE)
    n_tiles = -(-H * W // TILE)

    # the main path, counted
    render_core.fused_flow_composite.launches = 0
    out = render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    launches = render_core.fused_flow_composite.launches
    check(launches == n_tiles, f"bf16_serve: render core launched {launches} times, "
                               f"want {n_tiles}")
    check(tuple(out["rgb_map"].shape) == (H, W, 3, BF16["K_samples"]), "bf16_serve rgb_map shape")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"bf16_serve {k} finite")
    del out
    t0 = time.perf_counter()
    render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    RATES["bf16_serve"] = H * W / image_s

    f32_model, _, _ = build_model(types.SimpleNamespace(**FLAGSHIP))
    tile_rays = [t[:TILE] for t in view_rays(c2w)]
    with torch.inference_mode():
        a = render_rays(*tile_rays, None, is_test=True)
        b = make_render_rays(f32_model.eval(), rc)(*tile_rays, None, is_test=True)
    vs_f32 = {k: float((a[k] - b[k]).abs().max()) for k in ("rgb_map", "depth_map", "acc_map")}
    del a, b, f32_model

    def one_tile():
        with torch.inference_mode():
            render_rays(*tile_rays, None, is_test=True)

    breakdown = profile_device(one_tile)
    emit("bf16_serve", H=H, W=W, tile=TILE, render_core_launches=launches, image_s=image_s,
         rays_per_s=H * W / image_s, f32_serve_rays_per_s=RATES.get("serve"),
         bf16_vs_f32_first_tile_max_abs_not_gated=vs_f32)
    emit("bf16_profile", tile_rays=TILE, **breakdown)
    return launches


def phase_bf16_train():
    """Flagship training with --compute_dtype bfloat16: a render-core
    forward and backward a step; the parameters stay f32."""
    launches = train_run(BF16, "bf16_train", (render_core.fused_flow_composite,
                         render_core.fused_flow_composite_bwd), (1, 1), FLAT_METRICS)
    emit("bf16_train_vs_f32", bf16_train_rays_per_s=RATES["bf16_train"],
         f32_train_rays_per_s=RATES.get("train"))
    return launches


def phase_bf16_golden():
    """A tiny bf16 model's JAX render (tests/fixtures) against the card's
    bf16 xla trunk and render core on the same weights."""
    with np.load(BF16_GOLDEN) as g:
        D, Wd, K, F, ha, hr, n_samples, h, w = (int(v) for v in g["config"])
        focal, near, far = (float(v) for v in g["view"])
        model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K, compute_dtype=torch.bfloat16)
        model.load_state_dict(nerf_flows_state_dict_from_jax(
            nested_params(g), (g["test_eps_a"], g["test_eps_r"])))
        model = model.cuda().eval()
        rc = RenderConfig(n_samples=n_samples, perturb=False, use_viewdirs=True,
                          white_bkgd=True)
        before = render_core.fused_flow_composite.launches
        out = render_image(make_render_rays(model, rc), g["c2w"], H=h, W=w, focal=focal,
                           ndc=False, use_viewdirs=True, near=near, far=far, tile=64)
        check(render_core.fused_flow_composite.launches > before,
              "bf16 golden went through the kernel")
        maps = ("rgb_map", "depth_map", "acc_map")
        ref_maps = {k: torch.as_tensor(g[f"jax/{k}"]) for k in maps}
        errs = compare_maps(out, ref_maps, maps, BF16_RTOL, BF16_ATOL, "bf16 golden")
        x = torch.as_tensor(g["x"], device="cuda")
        ref_h = [torch.as_tensor(g[f"jax/{k}"], device="cuda") for k in ("h_alpha", "h_rgb")]

        def encode_vs_jax(m):
            with torch.inference_mode():
                hs = m.encode(x)
            equal = sum(int((a == b).sum()) for a, b in zip(hs, ref_h))
            return (equal / sum(b.numel() for b in ref_h),
                    max(float((a - b).abs().max()) for a, b in zip(hs, ref_h)))

        equal, enc_err = encode_vs_jax(model)
        check(equal >= BF16_ENCODE_EQUAL_MIN and enc_err <= BF16_ATOL,
              f"bf16 golden encode: {equal} of the entries bitwise equal to JAX's, "
              f"max abs {enc_err}")
        # the control: the same weights on the f32 trunk
        model.compute_dtype = torch.float32
        ctrl_equal, ctrl_err = encode_vs_jax(model)
        check(ctrl_equal < BF16_ENCODE_EQUAL_MIN,
              f"bf16 golden: the f32 trunk's encode passes the bf16 gate ({ctrl_equal})")
        ctrl = render_image(make_render_rays(model, rc), g["c2w"], H=h, W=w, focal=focal,
                            ndc=False, use_viewdirs=True, near=near, far=far, tile=64)
        ctrl_maps = {k: float((ctrl[k].cpu() - ref_maps[k]).abs().max()) for k in maps}
    emit("bf16_golden", source=str(BF16_GOLDEN.relative_to(ROOT)), H=h, W=w, K=K,
         max_abs_err_vs_jax=errs, encode_rows=int(x.shape[0]),
         encode_bitwise_equal_share=equal, encode_max_abs_err=enc_err,
         f32_control={"encode_bitwise_equal_share": ctrl_equal, "encode_max_abs_err": ctrl_err,
                      "maps_max_abs_err_vs_jax_bf16": ctrl_maps},
         tolerance={"rtol": BF16_RTOL, "atol": BF16_ATOL,
                    "encode_bitwise_equal_share_min": BF16_ENCODE_EQUAL_MIN})


# ---------------------------------------------------------------------- #
# proposal-placed serving and training (ops/occupancy.py)
# ---------------------------------------------------------------------- #

# the JAX package's serving and training defaults (cfnerf_tpu/utils/
# config.py:158-233): --occ_eval 16 placed samples from 32 candidates, floor
# 0.3, a 128^3 grid dilated once, --occ_impl auto (the grid off a TPU);
# --occ_train 12 from 128 candidates, the proposal co-trained at 8192 points
OCC = dict(FLAGSHIP, dataset_type="blender", no_ndc=False, occ_eval=16,
           occ_eval_candidates=32, occ_candidates=128, occ_floor=0.3, occ_res=128,
           occ_dilate=1, occ_impl="auto", occ_train=12)
OCC_COTRAIN_POINTS = 8192
# the points of one model forward in a density query (the chunk of
# bake_density_grid and distill_proposal) and the distillation's pool at
# serving: their defaults
DENSITY_CHUNK = 65536
DISTILL_POINTS = 1 << 20
OCC_METRICS = FLAT_METRICS + ("prop_loss",)
# placed depths through the proposal on the card vs on the CPU, the same
# weights: cuBLAS and the CPU may round the hidden layers' bf16 products
# apart (2^-8 of an activation), which would move the placement CDF by
# about that much of a candidate bin (0.125 here); measured 1.9e-6, so
# atol 1e-3, 0.8% of a bin
PROP_Z_ATOL = 1e-3
OCC_GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_occ_golden.npz"
# the card's occ step vs JAX's (tests/fixtures): metrics and weights after
# Adam by train_golden's rules; the field's gradients per leaf by relative
# RMS and cosine, as tests/test_torch_occ_train.py holds them (the placed
# depths differ by a few ulp and switch a ReLU near 0 now and then); the
# proposal after its Adam step 1e-6 where its |g| >= 1e-5, elsewhere 2 lr
OCC_GRAD_REL_RMS, OCC_GRAD_MIN_COS = 1e-2, 0.9999


def scene_dict():
    """The synthetic scene's train cameras as aabb_from_scene reads them."""
    _, poses, _ = synthetic_scene(seed=0)
    return dict(H=H, W=W, focal=FOCAL, i_train=list(range(len(poses))), poses=poses,
                near=NEAR, far=FAR)


def occ_view(impl, label):
    """The flagship model serves the view at --occ_eval placed samples
    through wrap_renderer_for_serving with --occ_impl `impl`: the proxy
    built from the field (flow-stack forward launches counted), the view
    (20 render-core launches, no flow-stack launch), a profiled tile.
    Returns (render_rays, model, rc, build launches, view launches, rays)."""
    args = types.SimpleNamespace(**dict(OCC, occ_impl=impl))
    model, _, rc = build_model(args)
    model.eval()
    rc = dataclasses.replace(rc, n_samples=args.occ_eval)
    flow_stack.fused_flow_stack.launches = 0
    torch.cuda.synchronize()
    render_rays = wrap_renderer_for_serving(make_render_rays(model, rc), args, scene_dict(),
                                            model, rc)
    torch.cuda.synchronize()
    build_launches = flow_stack.fused_flow_stack.launches
    # two launches (the density and rgb chains) a chunk of the density query:
    # the grid's res^3 cells, or the distillation's pool
    queried = DISTILL_POINTS if impl == "proposal" else args.occ_res ** 3
    want = 2 * -(-queried // DENSITY_CHUNK)
    check(build_launches == want, f"{label}: the proxy was built with {build_launches} "
                                  f"flow-stack launches, want {want}")
    c2w = pose_spherical(30.0, -30.0, 4.0)
    view = dict(H=H, W=W, focal=FOCAL, ndc=False, use_viewdirs=True,
                near=NEAR, far=FAR, tile=TILE)
    n_tiles = -(-H * W // TILE)

    # the main path, counted
    render_core.fused_flow_composite.launches = 0
    flow_stack.fused_flow_stack.launches = 0
    t0 = time.perf_counter()
    out = render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = render_core.fused_flow_composite.launches
    check(launches == n_tiles, f"{label}: render core launched {launches} times, "
                               f"want {n_tiles}")
    check(flow_stack.fused_flow_stack.launches == 0, f"{label}: the view ran no flow stack")
    check(tuple(out["rgb_map"].shape) == (H, W, 3, OCC["K_samples"]), f"{label} rgb_map shape")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{label} {k} finite")
    std = std_over_k(out["rgb_map"])
    del out
    t0 = time.perf_counter()
    render_image(render_rays, c2w, **view)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    RATES[label] = H * W / image_s

    rays = view_rays(c2w)
    tile_rays = [t[:TILE] for t in rays]

    def one_tile():
        with torch.inference_mode():
            render_rays(*tile_rays, None, is_test=True)

    breakdown = profile_device(one_tile)
    placement = render_rays.placement
    info = dict(impl=placement["impl"], build_s=placement["seconds"],
                build_flow_stack_launches=build_launches, placed_samples=rc.n_samples,
                candidates=placement["n_candidates"], floor=placement["floor"],
                aabb=[t.tolist() for t in placement["aabb"]], render_core_launches=launches,
                counted_render_s=counted_s, image_s=image_s, rays_per_s=H * W / image_s,
                dense_f32_serve_rays_per_s=RATES.get("serve"),
                mean_std_over_k=float(std.mean()))
    emit(f"{label}_profile", tile_rays=TILE, placed_samples=rc.n_samples, **breakdown)
    return render_rays, model, rc, build_launches, launches, info, rays


def phase_occ_serve():
    """--occ_eval 16 on the default --occ_impl auto (the grid on the card):
    the 128^3 bake, the view, and 64 placed rays against the CPU's plain
    path on the same weights and grid (the hier_serve tolerance)."""
    render_rays, model, rc, bake, launches, info, rays = occ_view("auto", "occ_serve")
    placement = render_rays.placement
    check(placement["impl"] == "grid", "occ_serve: auto is the grid on the card")
    grid = placement["proxy"]
    lo, hi = placement["aabb"]
    cpu_model = copy.deepcopy(model).cpu()

    # the bake against the CPU's plain density query: 64 interior cells, each
    # the max over its 3x3x3 neighbourhood's cell centres (one dilation)
    check(OCC["occ_dilate"] == 1, "occ_serve: the bake check reads one dilation")
    res = grid.shape[0]
    cells = torch.randint(1, res - 1, (64, 3), generator=torch.Generator().manual_seed(6))
    offs = torch.stack(torch.meshgrid(*[torch.arange(-1, 2)] * 3, indexing="ij"), -1)
    nb = (cells[:, None, :] + offs.reshape(27, 3)).cuda()
    centres = grid_coords(res, lo, hi).reshape(res, res, res, 3)[nb[..., 0], nb[..., 1],
                                                                  nb[..., 2]]
    with torch.inference_mode():
        sigma_cpu = make_density_fn(cpu_model, rc)(centres.reshape(-1, 3).cpu())
    baked = grid[cells[:, 0], cells[:, 1], cells[:, 2]].cpu()
    want = sigma_cpu.reshape(64, 27).max(-1).values
    bake_err = float((baked - want).abs().max())
    check(bool(torch.allclose(baked, want, rtol=E2E_RTOL, atol=E2E_ATOL)),
          f"occ_serve: baked cells vs the CPU's density query, max abs {bake_err}")

    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(4))[:64].cuda()
    sub = [t[pick] for t in rays]
    cpu_rays = make_occ_render_rays(make_render_rays(cpu_model, rc),
                                    grid.cpu(), lo.cpu(), hi.cpu(), rc.n_samples,
                                    n_candidates=placement["n_candidates"],
                                    floor=placement["floor"])
    with torch.inference_mode():
        a = render_rays(*sub, None, is_test=True)
        b = cpu_rays(*[t.cpu() for t in sub], None, is_test=True)
    cpu_errs = compare_maps(a, b, ("rgb_map", "depth_map", "acc_map"), E2E_RTOL, E2E_ATOL,
                            "occ_serve: card vs CPU plain path")
    emit("occ_serve", grid_res=grid.shape[0], grid_points=grid.numel(),
         occupied_share=placement["occupied"], **info,
         baked_64_cells_vs_cpu_max_abs=bake_err,
         baked_64_cells_max=float(baked.max()), card_vs_cpu_plain_64_rays=cpu_errs,
         tolerance={"rtol": E2E_RTOL, "atol": E2E_ATOL})
    return {"bake": bake, "view": launches}


PLACE_IN_CHILD = """
import sys
import torch
from cfnerf_torch.ops.occupancy import ProposalMLP, make_proposal_sigma_fn, place_from_sigma
d = torch.load(sys.argv[1], weights_only=True)
prop = ProposalMLP(d["width"], d["depth"], d["multires"], device="cuda")
prop.load_state_dict(d["state"])
with torch.inference_mode():
    z = place_from_sigma(make_proposal_sigma_fn(prop, d["lo"].cuda(), d["hi"].cuda()),
                         *(t.cuda() for t in d["rays"]), d["n_samples"],
                         n_candidates=d["n_candidates"], floor=d["floor"])
torch.save(z.cpu(), sys.argv[2])
"""


def place_in_child(prop, lo, hi, rays, n_samples, kw):
    """The proposal's placement of `rays` (ro, rd, near, far) on the card in
    a fresh Python process: the proposal's weights, the aabb and the rays
    pass through a file; returns the child's depths on the CPU."""
    with tempfile.TemporaryDirectory(prefix="cfnerf_place_") as tmp:
        inputs, out = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "z.pt")
        torch.save(dict(state={k: v.cpu() for k, v in prop.state_dict().items()},
                        width=prop.width, depth=prop.depth, multires=prop.multires,
                        lo=lo.cpu(), hi=hi.cpu(), rays=[t.cpu() for t in rays],
                        n_samples=n_samples, n_candidates=int(kw["n_candidates"]),
                        floor=float(kw["floor"])), inputs)
        subprocess.run([sys.executable, "-c", PLACE_IN_CHILD, inputs, out], cwd=str(ROOT),
                       check=True, timeout=300)
        return torch.load(out, weights_only=True)


def phase_occ_prop_serve():
    """--occ_impl proposal: the distillation, the view, and the placed depths
    of 64 rays against the CPU's plain placement with the same proposal and
    bitwise against the same placement in a fresh process on the card."""
    render_rays, model, rc, distill, launches, info, rays = occ_view("proposal",
                                                                     "occ_prop_serve")
    placement = render_rays.placement
    prop = placement["proxy"]
    lo, hi = placement["aabb"]
    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(5))[:64].cuda()
    ro, rd, _, nv, fv = [t[pick] for t in rays]
    kw = dict(n_candidates=placement["n_candidates"], floor=placement["floor"])
    prop_cpu = copy.deepcopy(prop).cpu()
    with torch.inference_mode():
        z = place_from_sigma(make_proposal_sigma_fn(prop, lo, hi), ro, rd, nv, fv,
                             rc.n_samples, **kw)
        z_cpu = place_from_sigma(make_proposal_sigma_fn(prop_cpu, lo.cpu(), hi.cpu()),
                                 ro.cpu(), rd.cpu(), nv.cpu(), fv.cpu(), rc.n_samples, **kw)
    z_err = float((z.cpu() - z_cpu).abs().max())
    check(z_err <= PROP_Z_ATOL, f"occ_prop_serve: placed z card vs CPU {z_err}")
    # the same placement in a fresh process on the card: bitwise
    z_child = place_in_child(prop, lo, hi, (ro, rd, nv, fv), rc.n_samples, kw)
    across = "bitwise equal" if torch.equal(z.cpu(), z_child) else (
        f"different (max abs {float((z.cpu() - z_child).abs().max())})")
    print(f"occ_prop_serve: the card's placed depths of 64 rays, this process vs a fresh "
          f"one: {across}", flush=True)
    check(across == "bitwise equal", f"occ_prop_serve: placement across processes {across}")
    emit("occ_prop_serve", distill_loss=placement["final_loss"], **info,
         placed_z_card_vs_cpu_64_rays=z_err, tolerance={"atol": PROP_Z_ATOL},
         placed_z_across_processes=across)
    return {"distill": distill, "view": launches}


def phase_occ_train():
    """--occ_train 12: a render-core forward and backward a step and the
    co-training density query's two flow-stack forwards (density and rgb
    chains of one model forward)."""
    launches = train_run(OCC, "occ_train", (render_core.fused_flow_composite,
                         render_core.fused_flow_composite_bwd, flow_stack.fused_flow_stack),
                         (1, 1, 2), OCC_METRICS, occ=True)
    emit("occ_train_vs_dense", occ_train_rays_per_s=RATES["occ_train"],
         dense_f32_train_rays_per_s=RATES.get("train"))
    return launches


def phase_occ_golden():
    """One JAX occ step of a tiny model (tests/fixtures, with its draws)
    through the card's occ step: render core forward and backward, the
    co-training target through the flow-stack forward, then both updates."""
    with np.load(OCC_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    D, Wd, K, F, ha, hr, n_placed, n_cand, cotrain = (int(v) for v in g["config"])
    h, w, focal, near, far, beta1, depth_lambda, lrate = (float(v) for v in g["train"])
    *box, floor, prop_lr = (float(v) for v in g["occ"])
    model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                      h_rgb_size=hr, n_flows=F, k_samples=K)
    model.load_state_dict(nerf_flows_state_dict_from_jax(
        nested_params(g), (g["test_eps_a"], g["test_eps_r"])))
    model = model.cuda()
    cfg = TrainConfig(H=int(h), W=int(w), focal=focal, ndc=False, near=near, far=far,
                      k_samples=K, lrate=lrate, beta1=beta1, colmap_depth=True,
                      depth_lambda=depth_lambda)
    occ = OccTrainConfig(lo=tuple(box[:3]), hi=tuple(box[3:]), n_candidates=n_cand,
                         floor=floor, prop_lr=prop_lr, cotrain_points=cotrain)
    step, _ = make_train_step(model, RenderConfig(n_samples=n_placed), cfg, occ=occ)
    step.install_proposal(proposal_state_dict_from_jax(
        {k[5:]: v for k, v in g.items() if k.startswith("prop/")}))
    batch = {k[6:]: v for k, v in g.items() if k.startswith("batch/")}
    counters = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                flow_stack.fused_flow_stack)
    before = [c.launches for c in counters]
    loss, metrics = step.loss_fn(batch, None, eps=(g["eps_a"], g["eps_r"]),
                                 place_u=torch.as_tensor(g["place_u"], device="cuda"))
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    step.update()
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    metrics["prop_loss"] = float(step.cotrain(None, prop_pts=torch.as_tensor(
        g["prop_pts"], device="cuda")))
    torch.cuda.synchronize()
    got = [c.launches - b for c, b in zip(counters, before)]
    check(got == [1, 1, 2], f"occ golden launches (render core fwd, bwd, flow stack) {got}")
    m_err, bad = {}, []
    for k, v in metrics.items():
        ref = float(g[f"jax/{k}"])
        m_err[k] = abs(v - ref)
        if not m_err[k] <= E2E_ATOL + E2E_RTOL * abs(ref):
            bad.append(k)
    ref_grads = {n: torch.as_tensor(g[f"grad/{n}"], device="cuda") for n in grads}
    worst = gate_leaves(leaf_errors(grads, ref_grads), OCC_GRAD_REL_RMS, OCC_GRAD_MIN_COS,
                        "occ golden gradients")
    p_err = {}
    for n, p in model.named_parameters():
        d = (p.detach() - torch.as_tensor(g[f"after/{n}"], device="cuda")).abs()
        sel = d[ref_grads[n].abs() >= ADAM_G_MIN]
        if not (bool((sel <= ADAM_ATOL).all()) and float(d.max()) <= 2 * lrate + ADAM_ATOL):
            bad.append(f"after/{n}")
        p_err[n] = float(sel.max()) if sel.numel() else 0.0
    prop_err = {}
    for n, p in step.proposal.named_parameters():
        d = (p.detach() - torch.as_tensor(g[f"prop_after/{n}"], device="cuda")).abs()
        sel = d[p.grad.abs() >= ADAM_G_MIN]
        if not (bool((sel <= ADAM_ATOL).all()) and float(d.max()) <= 2 * prop_lr + ADAM_ATOL):
            bad.append(f"prop_after/{n}")
        prop_err[n] = {"where_abs_grad_ge": float(sel.max()) if sel.numel() else 0.0,
                       "all": float(d.max())}
    emit("occ_golden", source=str(OCC_GOLDEN.relative_to(ROOT)), rays=len(g["place_u"]),
         placed_samples=n_placed, candidates=n_cand, K=K, metrics_abs_err_vs_jax=m_err,
         grad_errors_vs_jax=worst, weights_after_update_max_abs_err=max(p_err.values()),
         proposal_after_update_err=prop_err,
         tolerance={"metrics": {"rtol": E2E_RTOL, "atol": E2E_ATOL},
                    "grads": {"rel_rms": OCC_GRAD_REL_RMS, "min_cos": OCC_GRAD_MIN_COS},
                    "weights": {"atol": ADAM_ATOL, "where_abs_grad_ge": ADAM_G_MIN},
                    "proposal": {"atol": ADAM_ATOL, "where_abs_grad_ge": ADAM_G_MIN,
                                 "elsewhere": 2 * prop_lr}})
    check(not bad, f"occ golden past the tolerance: {bad} (weights {p_err}, "
                   f"proposal {prop_err})")


# ---------------------------------------------------------------------- #
# data_train: scenes from disk, flags, checkpoints and resume
# ---------------------------------------------------------------------- #

CAPTURE = ROOT / "tests" / "fixtures" / "minicapture"
# scripts/train_NF.sh's flags, verbatim
TRAIN_NF_FLAGS = [
    "--config", str(ROOT / "configs" / "africa_ds.txt"), "--expname", "africa",
    "--N_rand", "512", "--N_samples", "128", "--n_flows", "4", "--h_alpha_size", "64",
    "--h_rgb_size", "64", "--K_samples", "32", "--n_hidden", "128",
    "--type_flows", "triangular", "--beta1", "0.01", "--depth_lambda", "0.01",
    "--netdepth", "8", "--netwidth", "512", "--model", "NeRF_Flows", "--index_step", "-1",
    "--is_train",
]
# the view rendered from the restored weights against the trained model's:
# the same weights and eps through the same kernels, sums in a fixed order,
# so 0 is expected
RESTORED_VIEW_ATOL = 1e-6
# half_res against a numpy 2x2 block mean of the decoded images
HALF_RES_ATOL = 1e-6
BLENDER_SIDE = 800


def blender_round_trip(tmp):
    """A Blender scene written with imwrite_png (800x800 RGBA, 2 train / 1
    val / 1 test frames, transforms_*.json) and loaded back in full and with
    half_res: the decoded images bitwise what was written, the 400x400 ones
    a 2x2 block mean of them."""
    root = os.path.join(tmp, "blender")
    rng = np.random.RandomState(0)
    written = []
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        os.makedirs(os.path.join(root, split))
        frames = []
        for i in range(n):
            img = rng.randint(0, 256, (BLENDER_SIDE, BLENDER_SIDE, 4), dtype=np.uint8)
            imwrite_png(os.path.join(root, split, f"r_{i}.png"), img)
            written.append(img)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": pose_spherical(90.0 * len(written), -30.0,
                                                              4.0).tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618, "frames": frames}, f)
    t0 = time.perf_counter()
    full, _, _, hwf_full, i_split = load_blender_data(root, half_res=False, testskip=1)
    half, _, _, hwf_half, _ = load_blender_data(root, half_res=True, testskip=1)
    load_s = time.perf_counter() - t0
    written = np.stack(written)
    check(full.dtype == np.float32
          and np.array_equal(full, (written / 255.0).astype(np.float32)),
          "the decoded Blender images are bitwise what imwrite_png wrote")
    check([len(s) for s in i_split] == [2, 1, 1], f"Blender splits {i_split}")
    side = BLENDER_SIDE // 2
    block = full.astype(np.float64).reshape(-1, side, 2, side, 2, 4).mean((2, 4))
    half_err = float(np.abs(half - block).max())
    check(half.shape == (4, side, side, 4) and half_err <= HALF_RES_ATOL,
          f"half_res vs a 2x2 block mean: shape {half.shape}, max abs err {half_err}")
    check(hwf_half[:2] == [side, side] and hwf_half[2] == hwf_full[2] / 2,
          f"half_res hwf {hwf_half} from {hwf_full}")
    return {"images": int(len(written)), "side": BLENDER_SIDE, "load_s_full_and_half": load_s,
            "half_res_max_abs_err_vs_block_mean": half_err,
            "tolerance": {"half_res_atol": HALF_RES_ATOL, "full_res": "bitwise"}}


def with_output(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its standard output captured, then echoed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    text = out.getvalue()
    print(text, end="", flush=True)
    return result, text


def create_nerf_said(args):
    """create_nerf(args) on the card, with what it printed."""
    nets, text = with_output(create_nerf, args)
    return nets, text.strip()


def phase_data_train():
    """The slice's path from disk on the card: scripts/train_NF.sh's flags
    parsed by the port's parse_args on a copy of the checked-in LLFF + COLMAP
    capture; load_dataset (the minify to images_2, COLMAP depth);
    create_nerf; the JAX loop's batches through BatchPrefetcher; 1 warm-up
    forward + backward and 10 timed steps (a render-core forward and backward
    each, counted); save_checkpoint at step 10 with _snapshot_args; the
    held-out view rendered; create_nerf again resumes (bitwise state, the
    same view, start 10, the decayed lr of a fresh Adam, one more step, a
    profiled one after it); then a Blender scene written and loaded back
    with half_res."""
    fwd, bwd = render_core.fused_flow_composite, render_core.fused_flow_composite_bwd
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cfnerf_data_train_") as tmp:
        datadir = shutil.copytree(CAPTURE, os.path.join(tmp, "minicapture"))
        # the capture's own name: africa_ds.txt's "africa" selects the real
        # africa scene's hard-coded view ranges, past this capture's 8 views
        args = parse_args(TRAIN_NF_FLAGS + [
            "--datadir", datadir, "--basedir", os.path.join(tmp, "logs"),
            "--dataname", "minicapture", "--expname", "data_train", "--i_weights", "10"])

        t0 = time.perf_counter()
        scene = load_dataset(args)
        load_s = time.perf_counter() - t0
        minified = os.path.join(datadir, f"images_{args.factor}")
        check(os.path.isdir(minified), f"load_dataset wrote {minified}")
        shapes = {imread_png(os.path.join(minified, f)).shape for f in os.listdir(minified)}
        check(shapes == {(48, 64, 3)}, f"images_{args.factor} at 48x64: {shapes}")
        depth_gts = scene["depth_gts"]
        depth_points = sum(len(d["depth"]) for d in depth_gts)
        check(depth_points > 0, "the COLMAP depth list is non-empty")
        check(os.path.exists(os.path.join(datadir, "colmap_depth.npy")),
              "load_colmap_depth wrote colmap_depth.npy into the capture")
        Hs, Ws, focal = scene["H"], scene["W"], scene["focal"]
        near, far = scene["near"], scene["far"]
        images, poses, i_train = scene["images"], scene["poses"], scene["i_train"]
        emit("data_train_scene", views=len(images), H=Hs, W=Ws, focal=focal, near=near,
             far=far, i_train=[int(i) for i in i_train],
             i_val=[int(i) for i in scene["i_val"]], colmap_depth_points=depth_points,
             load_dataset_s=load_s)

        (model, model_fine, rc, start), said = create_nerf_said(args)
        check(said == "No reloading" and start == 0 and model_fine is None,
              f"create_nerf on an empty run dir: {said!r}, start {start}")
        cfg = TrainConfig(H=Hs, W=Ws, focal=focal, ndc=not args.no_ndc, near=near, far=far,
                          k_samples=args.K_samples, lrate=args.lrate,
                          lrate_decay=args.lrate_decay, start_step=start, beta1=args.beta1,
                          colmap_depth=args.colmap_depth, depth_lambda=args.depth_lambda)
        train_step, optimizer = make_train_step(model, rc, cfg)

        rays = RayBatcher(precompute_rays(images, poses, focal, i_train, seed=args.seed),
                          args.N_rand, seed=args.seed)
        depth_rays = DepthRayBatcher(precompute_depth_rays(
            depth_gts, poses, Hs, Ws, focal, i_train, seed=args.seed), N_DEPTH, seed=args.seed)
        host = {}

        def make_batch(step):
            batch = rays.next()
            batch.update(depth_rays.next())
            batch.pop("ray_weights")  # loaded but unused by the reference loss
            host[step] = batch
            return {k: torch.from_numpy(v).pin_memory().to("cuda", non_blocking=True)
                    for k, v in batch.items()}

        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        prefetch = BatchPrefetcher(make_batch, start_step=start, device="cuda")
        try:
            step_no, first = prefetch.next()
            check(step_no == start + 1 and set(first) == set(host[step_no])
                  and all(torch.equal(first[k].cpu(), torch.from_numpy(host[step_no][k]))
                          for k in first),
                  "the first prefetched batch is the host batch, bitwise")
            # warm-up: forward and backward without an update, so that the
            # timed steps are global steps 1-10; nothing of its autograd
            # graph kept, so that the step's first call captures its graph
            train_step.loss_fn(first, gen)[0].backward()
            optimizer.zero_grad(set_to_none=True)
            torch.cuda.synchronize()

            fwd.launches = bwd.launches = 0  # the main path, counted
            times, metrics = [], []
            for _ in range(TRAIN_STEPS):
                _, batch = prefetch.next()
                t0 = time.perf_counter()
                m = train_step(batch, gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in m.items()})
            step_launches = (fwd.launches, bwd.launches)
        finally:
            prefetch.close()
        check(step_launches == (TRAIN_STEPS, TRAIN_STEPS),
              f"data_train: {TRAIN_STEPS} steps launched the render core's forward and "
              f"backward {step_launches} times")
        check(all(math.isfinite(v) for m in metrics for v in m.values()),
              f"data_train: finite metrics {metrics[-1]}")
        check(set(metrics[0]) == set(FLAT_METRICS), f"data_train metrics {sorted(metrics[0])}")

        global_step = start + TRAIN_STEPS
        check(global_step % args.i_weights == 0, "a checkpoint is due at --i_weights")
        rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _snapshot_args(args, rundir)
        path = ckpt.save_checkpoint(rundir, global_step, {"coarse": model.state_dict()},
                                    optimizer.state_dict())
        save_s = time.perf_counter() - t0
        snap = os.path.join(rundir, "args.txt")
        check(vars(parse_args(["--config", snap])) == dict(vars(args), config=snap)
              and os.path.exists(os.path.join(rundir, "config.txt")),
              "args.txt parses back to the run's flags; config.txt written")

        i_view = int(scene["i_val"][0])
        n_tiles = math.ceil(Hs * Ws / args.chunk)

        def render(net):
            fwd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render_image(make_render_rays(net, rc), poses[i_view], H=Hs, W=Ws,
                               focal=focal, ndc=not args.no_ndc,
                               use_viewdirs=args.use_viewdirs, near=near, far=far,
                               tile=args.chunk)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check(fwd.launches == n_tiles,
                  f"the view launched the render core {fwd.launches} times, want {n_tiles}")
            check(out["rgb_map"].shape == (Hs, Ws, 3, args.K_samples)
                  and all(bool(torch.isfinite(v).all()) for v in out.values()),
                  "the view's maps: shape and finite values")
            return out, seconds

        view, view_s = render(model)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (model2, _, rc2, start2), said = create_nerf_said(args)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(said == f"Reloading from {path}" and start2 == global_step,
              f"create_nerf resumes: {said!r}, start {start2}")
        trained, restored = model.state_dict(), model2.state_dict()
        check(set(trained) == set(restored) and {"test_eps_a", "test_eps_r"} <= set(restored)
              and all(torch.equal(trained[k], restored[k]) for k in trained),
              "every restored state-dict entry, the eps buffers too, is bitwise the trained one")
        view2, _ = render(model2)
        view_err = max(float((view2[k] - view[k]).abs().max()) for k in view)
        check(view_err <= RESTORED_VIEW_ATOL,
              f"the restored model's view vs the trained one's: {view_err}")

        step2, opt2 = make_train_step(model2, rc2, dataclasses.replace(cfg, start_step=start2))
        # on the card Adam's lr is an f32 tensor (make_optimizer): the
        # schedule's value rounded to f32
        lr = float(opt2.param_groups[0]["lr"])
        want_lr = float(np.float32(args.lrate * 0.1 ** (start2 / (args.lrate_decay * 1000))))
        check(not opt2.state and lr == want_lr, f"a fresh Adam at lr {lr}, want {want_lr}")
        fwd.launches = bwd.launches = 0
        batch = make_batch(global_step + 1)
        m2 = step2(batch, gen)
        torch.cuda.synchronize()
        resumed_launches = (fwd.launches, bwd.launches)
        check(resumed_launches == (1, 1), f"the resumed step's launches {resumed_launches}")
        check(all(math.isfinite(float(v)) for v in m2.values()), "the resumed step's metrics")
        breakdown = profile_device(lambda: step2(batch, gen))

        blender = blender_round_trip(tmp)

    step_s = statistics.median(times)
    RATES["data_train"] = (args.N_rand + N_DEPTH) / step_s
    emit("data_train", nvidia_smi=nvidia_smi_line(), rays_per_step=args.N_rand + N_DEPTH,
         steps=TRAIN_STEPS, launches={"fused_flow_composite": step_launches[0],
                                      "fused_flow_composite_bwd": step_launches[1]},
         step_ms=1e3 * step_s, step_ms_all=[1e3 * t for t in times],
         train_rays_per_s=(args.N_rand + N_DEPTH) / step_s, last_metrics=metrics[-1],
         checkpoint=os.path.basename(path), save_s=save_s, restore_s=restore_s,
         start_after_restore=start2, lr_after_restore=lr,
         view={"index": i_view, "H": Hs, "W": Ws, "tiles": n_tiles, "s": view_s,
               "rays_per_s": Hs * Ws / view_s},
         restored_view_max_abs_err=view_err, resumed_step_metrics={
             k: float(v) for k, v in m2.items()},
         blender=blender, phase_s=time.perf_counter() - t_phase,
         tolerance={"restored_view_atol": RESTORED_VIEW_ATOL})
    emit("data_train_profile", rays_per_step=args.N_rand + N_DEPTH, **breakdown)
    # each segment's counts were reset before it and checked after it
    return {"fused_flow_composite": TRAIN_STEPS + 2 * n_tiles + 1,
            "fused_flow_composite_bwd": TRAIN_STEPS + 1}


# ---------------------------------------------------------------------- #
# jpeg: JPEG captures read by the port itself (slice 9)
# ---------------------------------------------------------------------- #

JPEG_FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
JPEG_CAPTURE = ROOT / "tests" / "fixtures" / "minicapture_jpg"
JPEG_CAPTURE_GOLDEN = ROOT / "tests" / "fixtures" / "minicapture_jpg_golden" / "images_2"
JPEG_PHOTO = "photo_1mp"
JPEG_STEPS = 10
JPEG_TIMED_DECODES = 3
# the libraries the JAX loader reads images with; blocked in sys.modules for
# the phase, so that any import of them on the port's path raises
IMAGE_LIBRARIES = ("imageio", "PIL", "cv2")


@contextlib.contextmanager
def image_libraries_blocked():
    saved = {name: sys.modules.get(name, False) for name in IMAGE_LIBRARIES}
    for name in IMAGE_LIBRARIES:
        sys.modules[name] = None
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is False:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def jpeg_entropy_bytes(data: bytes) -> int:
    """The bytes of a one-scan JPEG between its SOS header and its EOI."""
    sos = data.index(b"\xff\xda")
    (length,) = struct.unpack(">H", data[sos + 2:sos + 4])
    return data.rindex(b"\xff\xd9") - (sos + 2 + length)


def phase_jpeg():
    """JPEG captures on the card, imageio, Pillow and cv2 blocked: (a) every
    checked-in JPEG fixture decoded by the port bitwise its golden (made by
    imageio.v2.imread), image_shape its shape; (b) cli.train with
    scripts/train_NF.sh's flags (and the factor 2 of
    configs/minicapture_ds.txt) on a copy of the JPEG capture: images_2
    minified from the JPGs bitwise the JAX loader's golden, COLMAP depth, 10
    flagship steps (a render-core forward and backward each) with a finite
    loss, the checkpoint, the held-out view (one tile), launches exact; (c)
    the decode time of the 1 MP photo, median of 3.  Returns the launches
    of (b) by kernel."""
    t_phase = time.perf_counter()
    importable = {name: importlib.util.find_spec(name) is not None
                  for name in ("imageio", "PIL")}
    golden = np.load(JPEG_FIXTURES / "golden.npz")
    decoded = {}

    def counting_decode(data, name="JPEG data"):
        decoded[name] = decoded.get(name, 0) + 1
        return real_decode(data, name)

    real_decode = jpeg.decode
    counters = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                flow_stack.fused_flow_stack, flow_stack.fused_flow_stack_bwd,
                trunk.trunk_encode, trunk.trunk_encode_bwd)
    with image_libraries_blocked():
        # (a) the fixtures
        fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
        for path in fixtures:
            arr = image_io.imread(path)
            stem = path.stem
            if stem in golden:
                same = arr.dtype == golden[stem].dtype and np.array_equal(arr, golden[stem])
            else:  # the photo's golden is its shape and the SHA-256 of its bytes
                same = (arr.dtype == np.uint8 and tuple(golden[stem + "_shape"]) == arr.shape
                        and hashlib.sha256(np.ascontiguousarray(arr).tobytes()).digest()
                        == golden[stem + "_sha256"].tobytes())
            check(same, f"jpeg: {path.name} decodes bitwise to its golden")
            check(image_io.image_shape(path) == arr.shape,
                  f"jpeg: image_shape({path.name}) {image_io.image_shape(path)} vs {arr.shape}")

        # (b) the JPEG capture through the CLI
        with tempfile.TemporaryDirectory(prefix="cfnerf_jpeg_") as tmp:
            datadir = shutil.copytree(JPEG_CAPTURE, os.path.join(tmp, "minicapture_jpg"))
            basedir = os.path.join(tmp, "logs")
            flags = ([f for f in TRAIN_NF_FLAGS if f != "--is_train"]
                     + ["--datadir", datadir, "--basedir", basedir, "--dataname", "minicapture",
                        "--expname", "jpeg", "--factor", "2"])
            cadences = ["--n_iters", str(JPEG_STEPS), "--i_print", str(JPEG_STEPS),
                        "--i_weights", str(JPEG_STEPS), "--i_testset", str(JPEG_STEPS),
                        "--i_video", str(10 * JPEG_STEPS)]
            for c in counters:
                c.launches = 0  # the main path, counted
            jpeg.decode = counting_decode
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, text = with_output(cli_train.main, flags + ["--is_train"] + cadences)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            finally:
                jpeg.decode = real_decode
            launches = {c.__name__: c.launches for c in counters}
            originals = sorted(os.listdir(os.path.join(datadir, "images")))
            check(sorted(decoded) == sorted(os.path.join(datadir, "images", f)
                                            for f in originals)
                  and set(decoded.values()) == {1},
                  f"jpeg: the port decoded each original JPG once: {decoded}")
            minified = os.path.join(datadir, "images_2")
            written = sorted(os.listdir(minified))
            want = sorted(os.listdir(JPEG_CAPTURE_GOLDEN))
            check(written == want, f"jpeg: images_2 holds {written}, want {want}")
            for name in written:
                got = imread_png(os.path.join(minified, name))
                ref = imread_png(JPEG_CAPTURE_GOLDEN / name)
                check(got.shape == ref.shape == (48, 64, 3) and np.array_equal(got, ref),
                      f"jpeg: images_2/{name} bitwise the JAX loader's minify")
            depth = np.load(os.path.join(datadir, "colmap_depth.npy"), allow_pickle=True)
            depth_points = int(sum(len(d["depth"]) for d in depth))
            check(len(depth) == len(originals) and depth_points > 0,
                  f"jpeg: COLMAP depth for {len(depth)} views, {depth_points} points")
            args = parse_args(flags)
            rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
            check(os.path.exists(os.path.join(rundir, f"{JPEG_STEPS:06d}_01", ckpt.STATE_FILE)),
                  f"jpeg: checkpoint {JPEG_STEPS:06d}_01")
            testset = os.path.join(rundir, f"testset_{JPEG_STEPS:06d}")
            views = sorted(os.listdir(testset))
            n_val = len(views) // 2
            check(n_val == 1 and views == ["000.png", "000_std.png"],
                  f"jpeg: the held-out view's PNGs {views}")
            with open(os.path.join(basedir, "minicapture", "summaries", "jpeg",
                                   "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            check([r["step"] for r in records] == [JPEG_STEPS]
                  and all(math.isfinite(v) for v in records[0].values()),
                  f"jpeg: finite metrics at step {JPEG_STEPS}: {records}")
            # a render-core forward and backward a step, a forward for the val
            # batch at i_print and for the held-out view (48x64: one tile)
            want_launches = {"fused_flow_composite": JPEG_STEPS + 1 + n_val,
                             "fused_flow_composite_bwd": JPEG_STEPS, "fused_flow_stack": 0,
                             "fused_flow_stack_bwd": 0, "trunk_encode": 0,
                             "trunk_encode_bwd": 0}
            check(launches == want_launches,
                  f"jpeg: launches {launches}, want {want_launches}")

        # (c) the decode time of the 1 MP photo
        photo = JPEG_FIXTURES / f"{JPEG_PHOTO}.jpg"
        data = photo.read_bytes()
        times = []
        for _ in range(JPEG_TIMED_DECODES):
            t0 = time.perf_counter()
            arr = jpeg.imread_jpeg(photo)
            times.append(time.perf_counter() - t0)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in IMAGE_LIBRARIES
                    and sys.modules[m] is not None)
    decode_s = statistics.median(times)
    pixels = arr.shape[0] * arr.shape[1]
    entropy = jpeg_entropy_bytes(data)
    emit("jpeg", nvidia_smi=nvidia_smi_line(), importable=importable,
         image_libraries_loaded=leaked,
         fixtures={"files": len(fixtures), "bitwise_golden": True},
         capture={"views": len(originals), "jpg_decodes": len(decoded),
                  "images_2": "bitwise the JAX loader's minify",
                  "colmap_depth_points": depth_points, "steps": JPEG_STEPS,
                  "train_loss": records[0].get("train/loss"), "cli_train_s": train_s,
                  "launches": launches, "held_out_views": n_val},
         decode={"file": photo.name, "shape": list(arr.shape), "bytes": len(data),
                 "entropy_coded_bytes": entropy, "seconds": decode_s,
                 "seconds_all": times, "us_per_pixel": 1e6 * decode_s / pixels,
                 "entropy_mb_per_s": entropy / decode_s / 1e6,
                 "host": "the card's host CPU, one Python thread"},
         phase_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------- #
# cli_train, cli_train_pallas, cli_render_only, entry: the loop, the CLI,
# evaluation and the flagship entry (slice 6b)
# ---------------------------------------------------------------------- #

CLI_STEPS = 500
CLI_PRINT = 100
# every cadence but i_img (its default, 1000, lies past the run) fires:
# the val stream at each i_print, a checkpoint, the test set and the spiral
# video at the last step
CLI_CADENCES = ["--n_iters", str(CLI_STEPS), "--i_print", str(CLI_PRINT),
                "--i_weights", str(CLI_STEPS), "--i_testset", str(CLI_STEPS),
                "--i_video", str(CLI_STEPS)]
# gates, set before the first reading: 500 steps must lift the held-out
# view's PSNR by 3 dB over the random init and lower its NLL
CLI_PSNR_GAIN_DB = 3.0
QUALITY = ("psnr", "ssim", "nll", "ause")
# the render-core launches of the CLI run, from its cadences: a step each;
# the val batch (N_rand rays, one launch) at each i_print; one tile (the
# chunk, 8192 rays, holds a 48x64 view) for each held-out view of the test
# set and for each of the spiral's frames
CLI_SPIRAL_FRAMES = 30  # cfnerf_torch/data/llff.py: N_views of the spiral
# the quality's seed-to-seed spread: both trunks again at these seeds
# (init weights, batches and draws), beside the default seed 0; reported
# beside the f32 - pallas difference, not gated
CLI_SPREAD_SEEDS = (1, 2)
# entry() on the card against the same fn on the CPU: the hier_serve rule
ENTRY_RTOL = ENTRY_ATOL = 1e-4


def cli_flags(datadir, basedir, expname, *extra):
    """scripts/train_NF.sh's flags without --is_train, on the capture copy."""
    return ([f for f in TRAIN_NF_FLAGS if f != "--is_train"]
            + ["--datadir", str(datadir), "--basedir", str(basedir),
               "--dataname", "minicapture", "--expname", expname, *extra])


def quality_of(summary):
    return {k: float(summary[k]) for k in QUALITY}


def cli_run(datadir, basedir, expname, *extra):
    """evaluate at step 0 (random weights), the CLI's 500 training steps,
    evaluate at step 500; each counted.  Returns what the phase reports."""
    flags = cli_flags(datadir, basedir, expname, *extra)
    counters = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                trunk.trunk_encode, trunk.trunk_encode_bwd)

    def counted(fn, *args):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, text = with_output(fn, *args)
        torch.cuda.synchronize()
        return result, text, time.perf_counter() - t0, {c.__name__: c.launches
                                                         for c in counters}

    before, _, eval0_s, eval0_launches = counted(cli_eval.evaluate, parse_args(flags))
    _, text, train_s, train_launches = counted(cli_train.main, flags + ["--is_train"]
                                               + CLI_CADENCES)
    after, _, eval_s, eval_launches = counted(cli_eval.evaluate, parse_args(flags))
    args = parse_args(flags)
    rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
    with open(os.path.join(args.basedir, args.dataname, "summaries", expname,
                           "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    last = f"eval_{CLI_STEPS}"
    return dict(flags=flags, args=args, rundir=rundir, before=before, after=after,
                text=text, records=records,
                seconds={"eval_0": eval0_s, "train": train_s, last: eval_s},
                launches={"eval_0": eval0_launches, "train": train_launches,
                          last: eval_launches})


def check_cli_run(run, label, trunk_kernels):
    """The gates of a CLI run: steps, quality, files and exact launches."""
    args, rundir = run["args"], run["rundir"]
    check(run["before"]["step"] == 0 and run["after"]["step"] == CLI_STEPS,
          f"{label}: evaluated steps {run['before']['step']} and {run['after']['step']}")
    before, after = quality_of(run["before"]), quality_of(run["after"])
    check(all(math.isfinite(v) for q in (before, after) for v in q.values())
          and all(math.isfinite(v[k]) for v in run["after"]["views"] for k in QUALITY),
          f"{label}: finite metrics {before} {after}")
    check(after["psnr"] >= before["psnr"] + CLI_PSNR_GAIN_DB,
          f"{label}: held-out PSNR {after['psnr']} at step {CLI_STEPS} vs "
          f"{before['psnr']} at step 0, want +{CLI_PSNR_GAIN_DB} dB")
    check(after["nll"] < before["nll"],
          f"{label}: held-out NLL {after['nll']} at step {CLI_STEPS} vs {before['nll']}")
    check(os.path.exists(os.path.join(rundir, f"{CLI_STEPS:06d}_01", ckpt.STATE_FILE)),
          f"{label}: checkpoint {CLI_STEPS:06d}_01")
    n_val = len(run["after"]["views"])
    testset = os.path.join(rundir, f"testset_{CLI_STEPS:06d}")
    check(sorted(os.listdir(testset)) == sorted(
        f"{i:03d}{s}.png" for i in range(n_val) for s in ("", "_std")),
        f"{label}: test-set PNGs {sorted(os.listdir(testset))}")
    for kind in ("rgb", "disp"):
        frames = os.path.join(rundir, f"{args.expname}_spiral_{CLI_STEPS:06d}_{kind}")
        check(os.path.isdir(frames) and sorted(os.listdir(frames)) == [
            f"{i:03d}.png" for i in range(CLI_SPIRAL_FRAMES)],
            f"{label}: the {kind} video as {CLI_SPIRAL_FRAMES} PNG frames in {frames}")
    for step in (0, CLI_STEPS):
        evaldir = os.path.join(rundir, f"eval_{step:06d}")
        want = {"metrics.json"} | {f"{v['view']:03d}_{s}" for v in run["after"]["views"]
                                   for s in ("pred.png", "std.png", "panel.png", "ause.png",
                                             "uncertainty.ply")}
        check(set(os.listdir(evaldir)) == want,
              f"{label}: {evaldir} holds {sorted(os.listdir(evaldir))}")
    steps = [r["step"] for r in run["records"]]
    check(steps == list(range(CLI_PRINT, CLI_STEPS + 1, CLI_PRINT))
          and all({"val/psnr", "val/nll", "iter_time", "train/depth_loss"} <= set(r)
                  and all(math.isfinite(v) for v in r.values()) for r in run["records"]),
          f"{label}: metrics.jsonl steps {steps}")
    # exact launches, predicted from the cadences
    fwd, bwd = (render_core.fused_flow_composite.__name__,
                render_core.fused_flow_composite_bwd.__name__)
    renders = CLI_STEPS // CLI_PRINT + n_val + CLI_SPIRAL_FRAMES
    want = {"eval_0": {fwd: n_val, bwd: 0}, "train": {fwd: CLI_STEPS + renders, bwd: CLI_STEPS},
            f"eval_{CLI_STEPS}": {fwd: n_val, bwd: 0}}
    for part, counts in want.items():
        if trunk_kernels:  # a trunk forward beside every render-core one
            counts = dict(counts, trunk_encode=counts[fwd], trunk_encode_bwd=counts[bwd])
        else:
            counts = dict(counts, trunk_encode=0, trunk_encode_bwd=0)
        check(run["launches"][part] == counts,
              f"{label}: {part} launched {run['launches'][part]}, want {counts}")


def cli_report(run, label):
    """The phase's line: quality before and after, the loop's rates."""
    t = {r["step"]: r["t"] for r in run["records"]}
    rays = N_RAND + N_DEPTH
    loop_s = t[CLI_STEPS] - t[CLI_PRINT]
    call_rate = CLI_STEPS * rays / run["seconds"]["train"]
    loop_rate = (CLI_STEPS - CLI_PRINT) * rays / loop_s
    RATES[label] = loop_rate
    emit(label, nvidia_smi=nvidia_smi_line(), steps=CLI_STEPS, rays_per_step=rays,
         quality={"step_0": quality_of(run["before"]),
                  f"step_{CLI_STEPS}": quality_of(run["after"])},
         views=run["after"]["views"], seconds=run["seconds"], launches=run["launches"],
         call_rays_per_s=call_rate,
         loop_rays_per_s=loop_rate, loop_steps=[CLI_PRINT, CLI_STEPS],
         iter_time_ms_median=1e3 * statistics.median(r["iter_time"] for r in run["records"]),
         iter_time_ms=[1e3 * r["iter_time"] for r in run["records"]],
         val_psnr=[r["val/psnr"] for r in run["records"]],
         train_psnr=[r["train/psnr"] for r in run["records"]],
         train_phase_rays_per_s=RATES.get("train"), data_train_rays_per_s=RATES.get(
             "data_train"),
         gates={"psnr_gain_db": CLI_PSNR_GAIN_DB, "nll": "lower at step 500"})


def phase_cli(tmp):
    """cli_train and cli_train_pallas: the CLI's 500 steps on train_NF.sh's
    flags, f32 trunk, then the trunk kernels in a fresh run dir; each
    evaluated at step 0 and 500.  Returns both runs."""
    datadir = shutil.copytree(CAPTURE, os.path.join(tmp, "minicapture"))
    basedir = os.path.join(tmp, "logs")
    runs = {}
    for label, expname, extra in (("cli_train", "cli_f32", ()),
                                  ("cli_train_pallas", "cli_pallas", ("--trunk_impl", "pallas"))):
        t0 = time.perf_counter()
        run = cli_run(datadir, basedir, expname, *extra)
        check_cli_run(run, label, trunk_kernels=bool(extra))
        cli_report(run, label)
        run["phase_s"] = time.perf_counter() - t0
        runs[label] = run
    per_seed = {"f32": [quality_of(runs["cli_train"]["after"])],
                "pallas": [quality_of(runs["cli_train_pallas"]["after"])]}
    for seed in CLI_SPREAD_SEEDS:
        for name, extra in (("f32", ()), ("pallas", ("--trunk_impl", "pallas"))):
            run = cli_run(datadir, basedir, f"cli_{name}_seed{seed}", "--seed", str(seed),
                          *extra)
            check_cli_run(run, f"cli_train ({name}, seed {seed})", trunk_kernels=bool(extra))
            per_seed[name].append(quality_of(run["after"]))
    diffs = {k: [p[k] - f[k] for f, p in zip(per_seed["f32"], per_seed["pallas"])]
             for k in QUALITY}

    def spread(values):
        return {"mean": statistics.mean(values), "std": statistics.stdev(values),
                "min": min(values), "max": max(values)}

    emit("cli_quality", nvidia_smi=nvidia_smi_line(), step=CLI_STEPS,
         f32=quality_of(runs["cli_train"]["after"]),
         pallas=quality_of(runs["cli_train_pallas"]["after"]),
         step_0={"f32": quality_of(runs["cli_train"]["before"]),
                 "pallas": quality_of(runs["cli_train_pallas"]["before"])},
         seeds=[0, *CLI_SPREAD_SEEDS], per_seed=per_seed,
         spread={name: {k: spread([q[k] for q in qs]) for k in QUALITY}
                 for name, qs in per_seed.items()},
         pallas_minus_f32={"per_seed": diffs, **{k: spread(v) for k, v in diffs.items()}},
         note="reported, not gated: the two trajectories differ by bf16 rounding; "
              "each seed's runs are gated as cli_train's")
    return runs


def phase_cli_render_only(run):
    """The CLI without --is_train on the finished f32 run: resumes at step
    500 and renders the spiral, its frames bitwise the PNG frames that the
    loop's i_video wrote at step 500."""
    fwd = render_core.fused_flow_composite
    fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, text = with_output(cli_train.main, run["flags"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fwd.launches
    rundir = run["rundir"]
    path = os.path.join(rundir, f"{CLI_STEPS:06d}_01")
    savedir = os.path.join(rundir, f"renderonly_path_{CLI_STEPS:06d}")
    check(f"Reloading from {path}" in text and f"Done rendering {savedir}" in text,
          "cli_render_only resumed at step 500 and rendered into renderonly_path_000500")
    check(launches == CLI_SPIRAL_FRAMES,
          f"cli_render_only launched the render core {launches} times, "
          f"want {CLI_SPIRAL_FRAMES}")
    video = os.path.join(rundir, f"{run['args'].expname}_spiral_{CLI_STEPS:06d}_rgb")
    equal = [np.array_equal(imread_png(os.path.join(savedir, f"{i:03d}.png")),
                            imread_png(os.path.join(video, f"{i:03d}.png")))
             for i in range(CLI_SPIRAL_FRAMES)]
    check(all(equal), f"render-only frames bitwise the step-500 video frames: {equal}")
    check(sorted(os.listdir(os.path.join(savedir, "video"))) == [
        f"{i:03d}.png" for i in range(CLI_SPIRAL_FRAMES)], "the render-only video as PNGs")
    emit("cli_render_only", nvidia_smi=nvidia_smi_line(), frames=CLI_SPIRAL_FRAMES,
         seconds=seconds, frames_per_s=CLI_SPIRAL_FRAMES / seconds, launches=launches,
         frames_bitwise_equal_video=sum(equal))
    return launches


def phase_entry():
    """cfnerf_torch.entry.entry() on the card against the same fn with
    device="cpu": the flagship, 256 rays, test mode."""
    fn, args = entry()
    fwd = render_core.fused_flow_composite
    fn(*args)  # warm-up
    fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fwd.launches
    check(launches == 1, f"entry launched the render core {launches} times, want 1")
    fn_cpu, args_cpu = entry(device="cpu")
    ref = fn_cpu(*args_cpu)
    errs = []
    for name, a, b in zip(("rgb_map", "disp_map", "depth_map"), out, ref):
        check(tuple(a.shape) == tuple(b.shape) and bool(torch.isfinite(a).all()),
              f"entry {name}: shape {tuple(a.shape)}, finite")
        a = a.cpu()
        errs.append(float((a - b).abs().max()))
        check(torch.allclose(a, b, rtol=ENTRY_RTOL, atol=ENTRY_ATOL),
              f"entry {name} card vs CPU: max abs err {errs[-1]}")
    emit("entry", nvidia_smi=nvidia_smi_line(), rays=int(args[1].shape[0]),
         rgb_shape=list(out[0].shape), ms=1e3 * seconds, launches=launches,
         max_abs_err_vs_cpu=max(errs), tolerance={"rtol": ENTRY_RTOL, "atol": ENTRY_ATOL})
    return launches


# ---------------------------------------------------------------------- #
# slice 7: the other flow families, the baselines, sample / interpolation
# ---------------------------------------------------------------------- #

FAMILIES_GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_families_golden.npz"
FAMILY_NAMES = ("no_flow", "householder", "orthogonal", "planar", "IAF")
BASELINE_NAMES = ("nerf", "nerf_dropout", "nerf_wild")
# the golden's gates (tests/test_torch_families.py states each): maps and
# metrics rtol = atol = 1e-4, bf16 2e-3; gradients per leaf relative RMS
# 1e-3 and cosine 0.9999 (bf16 2e-2; planar 1e-2: at Z = 1 its u^ divides
# by |w|^2, which the amortizer makes as a sum that cancels, so where |w|
# is small the last bits of that sum move the point's density by O(1));
# a leaf whose JAX gradient is rounding noise (every entry <= 1e-6: the
# Z = 1 Householder / orthogonal amor_q, whose Q is +-1 whatever it
# gives) by its absolute error, <= 1e-6
FAM_TOL, FAM_BF16_TOL = 1e-4, 2e-3
FAM_REL_RMS, FAM_BF16_REL_RMS, FAM_PLANAR_REL_RMS, FAM_MIN_COS = 1e-3, 2e-2, 1e-2, 0.9999
FAM_NOISE = 1e-6
FAM_MAPS = ("rgb_map", "depth_map", "acc_map")
# tests/test_torch_train.py's TRAIN_KW, the step the golden was taken with
FAM_TRAIN = dict(H=10, W=10, focal=10.0, ndc=False, near=2.0, far=6.0, k_samples=8,
                 lrate=5e-4, beta1=0.01, colmap_depth=True, depth_lambda=0.01)
FAM_VIEW = dict(H=10, W=10, focal=10.0, ndc=False, use_viewdirs=True, near=2.0, far=6.0)
# families_serve / families_train: each family and baseline at the
# flagship's widths, the f32 trunk; householder and IAF also with the trunk
# kernels (one trunk forward a tile; a trunk forward and backward a step)
FAMILY_CELLS = ([(f, dict(type_flows=f), "xla") for f in FAMILY_NAMES]
                + [(f"{f} pallas", dict(type_flows=f), "pallas")
                   for f in ("householder", "IAF")]
                + [(m, dict(model=m), "xla") for m in BASELINE_NAMES])
FAMILY_TRAIN_STEPS = {"nerf_dropout": 3}  # 32 trunk passes a step
# sample / interpolation on the flagship net: their point counts
SAMPLE_POINTS, INTERP_POINTS = 1 << 20, 1 << 18


def golden_draws(g, prefix):
    """tests/test_torch_families.py:load_draws on the card: the eps pair,
    nerf_wild's (K, 3) eps, nerf_dropout's K mask lists, or None."""
    keys = [k for k in g.files if k.startswith(prefix + "/")]
    if not keys:
        return None
    if f"{prefix}/a" in keys:
        return (g[f"{prefix}/a"], g[f"{prefix}/r"])
    if f"{prefix}/wild" in keys:
        return g[f"{prefix}/wild"]
    n_k = 1 + max(int(k.split("/")[-2]) for k in keys)
    n_j = 1 + max(int(k.split("/")[-1]) for k in keys)
    return [[torch.as_tensor(g[f"{prefix}/{k}/{j}"], device="cuda") for j in range(n_j)]
            for k in range(n_k)]


def golden_family_model(g, name):
    """The port's model of golden entry `name` on the card, JAX's weights
    and test draws carried across by convert.state_dict_from_jax."""
    D, Wd, K, F, ha, hr = (int(v) for v in g["config"][:6])
    params = {}
    for k in g.files:
        if k.startswith(f"{name}/p/"):
            node = params
            *parents, leaf = k[len(name) + 3:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = g[k]
    kind = name.replace("_bf16", "")
    if name in FAMILY_NAMES:
        model = NeRFFlows(net_depth=D, net_width=Wd, skips=(D // 2,), h_alpha_size=ha,
                          h_rgb_size=hr, n_flows=F, k_samples=K, type_flows=name)
        eps = (g[f"{name}/test_eps_a"], g[f"{name}/test_eps_r"])
        model.load_state_dict(state_dict_from_jax(params, None, name, eps))
        return model.cuda(), None
    model = KSampleBaseline(kind, K, net_depth=D, net_width=Wd, skips=(D // 2,),
                            compute_dtype=torch.bfloat16 if name.endswith("_bf16")
                            else torch.float32)
    eps = g[f"{name}/test_eps"] if f"{name}/test_eps" in g.files else None
    model.load_state_dict(state_dict_from_jax(params, kind, test_eps=eps))
    return model.cuda(), kind


def phase_families_golden():
    """Each family and baseline's JAX test render and training step (D4/W64,
    K8, F2; tests/fixtures) through the card's unfused path: maps, metrics
    and gradients against JAX's; no kernel of the port runs here."""
    counters = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                flow_stack.fused_flow_stack, flow_stack.fused_flow_stack_bwd,
                trunk.trunk_encode, trunk.trunk_encode_bwd)
    results = {}
    with np.load(FAMILIES_GOLDEN) as g:
        S_render, S = (int(v) for v in g["config"][6:8])
        names = sorted({k.split("/")[0] for k in g.files if "/p/" in k})
        check(set(names) == set(FAMILY_NAMES + BASELINE_NAMES + ("nerf_wild_bf16",)),
              f"families golden holds {names}")
        for name in names:
            before = [c.launches for c in counters]
            model, kind = golden_family_model(g, name)
            bf16 = name.endswith("_bf16")
            tol = FAM_BF16_TOL if bf16 else FAM_TOL
            rel_rms = (FAM_BF16_REL_RMS if bf16 else
                       FAM_PLANAR_REL_RMS if name == "planar" else FAM_REL_RMS)
            render = make_render_rays(model, RenderConfig(
                n_samples=S_render, perturb=False, use_viewdirs=True, white_bkgd=True,
                fused="off"))
            rays = prepare_rays(torch.as_tensor(g["render/rays_o"], device="cuda"),
                                torch.as_tensor(g["render/rays_d"], device="cuda"), **FAM_VIEW)
            with torch.no_grad():
                out = render(*rays, None, is_test=True,
                             eps=golden_draws(g, f"{name}/render_draws"))
            errs, bad = {}, []
            for k in FAM_MAPS:
                ref = torch.as_tensor(g[f"{name}/jax/{k}"], device="cuda")
                d = (out[k] - ref).abs()
                errs[k] = float(d.max())
                if not bool((d <= tol + tol * ref.abs()).all()):
                    bad.append(k)
            cfg = TrainConfig(**FAM_TRAIN, loss_mode=loss_mode_for_model(kind))
            step, _ = make_train_step(model, RenderConfig(n_samples=S, fused="off"), cfg)
            t_rand = torch.as_tensor(g["t_rand"], device="cuda")
            R = t_rand.shape[0]
            z_vals = stratified_perturb(
                sample_z_vals(torch.full((R, 1), FAM_TRAIN["near"], device="cuda"),
                              torch.full((R, 1), FAM_TRAIN["far"], device="cuda"),
                              S).expand(R, S), t_rand=t_rand)
            batch = {k[6:]: g[k] for k in g.files if k.startswith("batch/")}
            loss, metrics = step.loss_fn(batch, None, z_vals=z_vals,
                                         eps=golden_draws(g, f"{name}/step_draws"))
            loss.backward()
            torch.cuda.synchronize()
            for k in FLAT_METRICS:
                ref = float(g[f"{name}/jax/{k}"])
                errs[k] = abs(float(metrics[k].detach()) - ref)
                if not errs[k] <= tol + tol * abs(ref):
                    bad.append(k)
            worst_rel, worst_cos = 0.0, 1.0
            for n, p in model.named_parameters():
                want = g[f"{name}/grad/{n}"].astype(np.float64)
                got = (np.zeros_like(want) if p.grad is None
                       else p.grad.detach().cpu().numpy().astype(np.float64))
                if np.abs(want).max() <= FAM_NOISE:
                    if np.abs(got - want).max() > FAM_NOISE:
                        bad.append(f"grad/{n}")
                    continue
                rel = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
                cos = float(np.sum(got * want)
                            / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-30))
                worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
                if not (rel <= rel_rms and cos >= FAM_MIN_COS):
                    bad.append(f"grad/{n}")
            errs.update(grad_worst_rel_rms=worst_rel, grad_worst_cos=worst_cos)
            check([c.launches for c in counters] == before,
                  f"families_golden {name}: no kernel of the port on the unfused path")
            check(not bad, f"families_golden {name} past the tolerance: {bad} ({errs})")
            results[name] = errs
            del model, step, loss
    emit("families_golden", source=str(FAMILIES_GOLDEN.relative_to(ROOT)),
         max_abs_err_vs_jax=results,
         tolerance={"maps_metrics": FAM_TOL, "bf16_maps_metrics": FAM_BF16_TOL,
                    "grad_rel_rms": FAM_REL_RMS, "bf16_grad_rel_rms": FAM_BF16_REL_RMS,
                    "planar_grad_rel_rms": FAM_PLANAR_REL_RMS, "grad_min_cos": FAM_MIN_COS,
                    "noise_leaf_atol": FAM_NOISE})


def family_args(over, trunk_impl):
    """The flagship's flags (scripts/train_NF.sh's widths) for one cell."""
    return types.SimpleNamespace(**{**FLAGSHIP, **over, "trunk_impl": trunk_impl})


def dropout_masks(model, n_points, seed):
    """K draws' masks of a nerf_dropout net, drawn on the card: the same
    masks for the card's and the CPU's forward."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [model.base.draw_masks(n_points, g) for _ in range(model.k_samples)]


SERVE_COUNTERS = (render_core.fused_flow_composite, flow_stack.fused_flow_stack,
                  trunk.trunk_encode)


def phase_families_serve():
    """One 8192-ray tile of the 400x400 view (N128, K32) for each family and
    baseline at the flagship's widths: counted (render core 0, flow stack 0,
    trunk forward 1 a pallas tile, else 0), timed, peak memory, 64 rays
    against the CPU's plain path on the same weights (nerf_dropout on the
    same masks); the householder f32 tile profiled."""
    rays = view_rays(pose_spherical(30.0, -30.0, 4.0))
    tile_rays = [t[:TILE] for t in rays]
    pick = torch.randperm(H * W, generator=torch.Generator().manual_seed(4))[:64].cuda()
    sub = [t[pick] for t in rays]
    cells, launches = {}, {}
    for label, over, impl in FAMILY_CELLS:
        model, _, rc = build_model(family_args(over, impl))
        model.eval()
        check(rc.fused == "off", f"families_serve {label}: --fused_render auto is off")
        render_rays = make_render_rays(model, rc)
        torch.cuda.synchronize()
        for c in SERVE_COUNTERS:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = render_rays(*tile_rays, None, is_test=True)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in SERVE_COUNTERS}
        want = {"fused_flow_composite": 0, "fused_flow_stack": 0,
                "trunk_encode": 1 if impl == "pallas" else 0}
        check(counts == want, f"families_serve {label}: launched {counts}, want {want}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        K = FLAGSHIP["K_samples"]
        check(tuple(out["rgb_map"].shape) == (TILE, 3, K), f"{label} rgb_map shape")
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"families_serve {label}: {k} finite")
        std = float(std_over_k(out["rgb_map"]).mean())
        del out
        t0 = time.perf_counter()
        with torch.inference_mode():
            render_rays(*tile_rays, None, is_test=True)
        torch.cuda.synchronize()
        tile_s = time.perf_counter() - t0
        # 64 rays on the CPU through the plain versions, the same weights
        # (and for nerf_dropout the same masks)
        eps = (dropout_masks(model, 64 * FLAGSHIP["N_samples"], 5)
               if over.get("model") == "nerf_dropout" else None)
        cpu_model = copy.deepcopy(model).cpu()  # pallas: the trunk kernel's plain version
        with torch.inference_mode():
            a = render_rays(*sub, None, is_test=True, eps=eps)
            b = make_render_rays(cpu_model, rc)(
                *[t.cpu() for t in sub], None, is_test=True,
                eps=None if eps is None else [[m.cpu() for m in ms] for ms in eps])
        torch.cuda.synchronize()
        tol = (TRUNK_MAP_RTOL, TRUNK_MAP_ATOL) if impl == "pallas" else (E2E_RTOL, E2E_ATOL)
        errs = compare_maps(a, b, ("rgb_map", "depth_map", "acc_map"), *tol,
                            f"families_serve {label}: card vs CPU plain path")
        del cpu_model, a, b
        if label == "householder":
            def one_tile():
                with torch.inference_mode():
                    render_rays(*tile_rays, None, is_test=True)

            emit("families_serve_profile", cell=label, tile_rays=TILE,
                 **profile_device(one_tile))
        RATES[f"families_serve ({label})"] = TILE / tile_s
        cells[label] = dict(trunk_impl=impl, launches=counts, first_tile_s=first_s,
                            tile_s=tile_s, rays_per_s=TILE / tile_s, peak_mem_gb=peak_gb,
                            mean_std_over_k=std, card_vs_cpu_64_rays=errs,
                            tolerance={"rtol": tol[0], "atol": tol[1]})
        launches[label] = counts
        del model, render_rays
        torch.cuda.empty_cache()
    emit("families_serve", nvidia_smi=nvidia_smi_line(), tile=TILE,
         samples=FLAGSHIP["N_samples"], K=FLAGSHIP["K_samples"], cells=cells)
    return launches


def phase_families_train():
    """Training steps of each family and baseline at the flagship's widths on
    the flagship's batches (512 + 128 rays, N128, K32): 1 warm-up, then 10
    counted and timed steps (nerf_dropout 3), finite metrics, the loss
    mode of the model, exact launches (no render core, no flow stack; with
    pallas a trunk forward and backward a step), peak memory."""
    counters = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                flow_stack.fused_flow_stack, flow_stack.fused_flow_stack_bwd,
                trunk.trunk_encode, trunk.trunk_encode_bwd)
    next_batch = flagship_batches()
    cells, launches = {}, {}
    for label, over, impl in FAMILY_CELLS:
        args = family_args(over, impl)
        model, _, rc = build_model(args)
        mode = loss_mode_for_model(over.get("model"))
        cfg = TrainConfig(H=H, W=W, focal=FOCAL, ndc=False, near=NEAR, far=FAR,
                          k_samples=FLAGSHIP["K_samples"], loss_mode=mode, **TRAIN_CFG)
        step, _ = make_train_step(model, rc, cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        step(next_batch(), gen)  # warm-up
        torch.cuda.synchronize()
        n_steps = FAMILY_TRAIN_STEPS.get(label, TRAIN_STEPS)
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        for _ in range(n_steps):
            batch = next_batch()
            t0 = time.perf_counter()
            m = step(batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = {c.__name__: c.launches for c in counters}
        per = n_steps if impl == "pallas" else 0
        want = {"fused_flow_composite": 0, "fused_flow_composite_bwd": 0,
                "fused_flow_stack": 0, "fused_flow_stack_bwd": 0,
                "trunk_encode": per, "trunk_encode_bwd": per}
        check(counts == want, f"families_train {label}: launched {counts}, want {want}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for m in metrics:
            check(all(math.isfinite(v) for v in m.values()),
                  f"families_train {label}: finite metrics {m}")
        check(set(metrics[0]) == set(FLAT_METRICS), f"{label}: metrics {sorted(metrics[0])}")
        if mode == "mse":
            check(all(m["loss_nll"] == 0.0 for m in metrics), f"{label}: the mse loss mode")
        moved = sum(not torch.equal(p.detach(), start[n]) for n, p in model.named_parameters())
        check(moved > 0, f"families_train {label}: no parameter moved")
        step_s = statistics.median(times)
        RATES[f"families_train ({label})"] = (N_RAND + N_DEPTH) / step_s
        cells[label] = dict(trunk_impl=impl, loss_mode=mode, steps=n_steps, launches=counts,
                            step_ms=1e3 * step_s, step_ms_all=[1e3 * t for t in times],
                            train_rays_per_s=(N_RAND + N_DEPTH) / step_s,
                            peak_mem_gb=peak_gb, first_loss=metrics[0]["loss"],
                            last_metrics=metrics[-1],
                            parameters_moved=f"{moved}/{len(start)}")
        launches[label] = counts
        del model, step, start
        torch.cuda.empty_cache()
    emit("families_train", nvidia_smi=nvidia_smi_line(), rays_per_step=N_RAND + N_DEPTH,
         samples=FLAGSHIP["N_samples"], K=FLAGSHIP["K_samples"], cells=cells)
    return launches


def phase_sample_interp():
    """NeRFFlows.sample on 2^20 points and interpolation (K = 21) on 2^18
    through the flagship net: counted (1 and 2 flow-stack launches), timed,
    and each against the same call with the flow stack's plain version on
    the card (the trunk's outputs shared, so only the flow stack differs),
    rtol = atol = 1e-5, the kernel phase's rule."""
    model, _, _ = build_model(types.SimpleNamespace(**FLAGSHIP))
    model.eval()
    g = torch.Generator(device="cuda").manual_seed(6)
    fwd = flow_stack.fused_flow_stack
    report, launches = {}, 0
    for label, n, call, want in (("sample", SAMPLE_POINTS, model.sample, 1),
                                 ("interpolation", INTERP_POINTS, model.interpolation, 2)):
        x = torch.rand(n, 90, generator=g, device="cuda") * 2 - 1
        torch.cuda.synchronize()
        fwd.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = call(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counted = fwd.launches
        check(counted == want, f"{label}: flow stack launched {counted}, want {want}")
        launches += counted
        K = model.k_samples if label == "sample" else 21
        check(tuple(out.shape) == (n, K, 1 if label == "sample" else 4)
              and bool(torch.isfinite(out).all()), f"{label}: shape {tuple(out.shape)}, finite")
        # the flow stack's plain version on the same trunk outputs
        with torch.inference_mode():
            h = model.encode(x)
            model.encode = lambda _x, h=h: h
            try:
                kernel = call(x)
                model.flow_impl = "xla"
                plain = call(x)
            finally:
                model.flow_impl = "auto"
                del model.encode
        d = (kernel - plain).abs()
        check(bool((d <= FLOW_ATOL + FLOW_RTOL * plain.abs()).all()),
              f"{label}: kernel vs plain flow stack, max abs err {float(d.max())}")
        t0 = time.perf_counter()
        with torch.inference_mode():
            call(x)
        torch.cuda.synchronize()
        report[label] = dict(points=n, K=K, launches=counted, first_s=seconds,
                             s=time.perf_counter() - t0, max_abs_err_vs_plain=float(d.max()))
        del x, out, kernel, plain, h
    emit("sample_interp", nvidia_smi=nvidia_smi_line(), **report,
         tolerance={"rtol": FLOW_RTOL, "atol": FLOW_ATOL})
    return launches


CLI_FAMILY_STEPS, CLI_FAMILY_PRINT = 100, 50
CLI_FAMILY_CADENCES = ["--n_iters", str(CLI_FAMILY_STEPS), "--i_print", str(CLI_FAMILY_PRINT),
                       "--i_weights", str(CLI_FAMILY_STEPS), "--i_testset",
                       str(CLI_FAMILY_STEPS), "--i_video", str(CLI_FAMILY_STEPS)]


def cli_family_flags(datadir, basedir, expname, *extra, drop_type_flows=False):
    flags = cli_flags(datadir, basedir, expname, *extra)
    if drop_type_flows:  # the parser's default: no_flow
        i = flags.index("--type_flows")
        flags = flags[:i] + flags[i + 2:]
    return flags


def phase_cli_families(tmp):
    """python -m cfnerf_torch.cli.train's path (cli.train.main) with
    scripts/train_NF.sh's flags on a copy of the capture, 100 steps each:
    (a) --model nerf_wild, (b) --type_flows householder --trunk_impl pallas,
    (c) no --type_flows (the parser's no_flow); each then cli.eval at step
    100: finite metrics, exact launches (no render core or flow stack; (b)
    a trunk forward a step, val batch and rendered tile, a backward a
    step)."""
    datadir = shutil.copytree(CAPTURE, os.path.join(tmp, "minicapture"))
    basedir = os.path.join(tmp, "logs")
    counters = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                flow_stack.fused_flow_stack, flow_stack.fused_flow_stack_bwd,
                trunk.trunk_encode, trunk.trunk_encode_bwd)
    runs, launches = {}, {}
    for label, expname, extra, drop in (
            ("nerf_wild", "cli_wild", ("--model", "nerf_wild"), False),
            ("householder pallas", "cli_householder",
             ("--type_flows", "householder", "--trunk_impl", "pallas"), False),
            ("no_flow (parser default)", "cli_noflow", (), True)):
        flags = cli_family_flags(datadir, basedir, expname, *extra, drop_type_flows=drop)
        args = parse_args(flags)
        parts = {}
        for part, fn, argv in (("train", cli_train.main, flags + ["--is_train"]
                                + CLI_FAMILY_CADENCES),
                               (f"eval_{CLI_FAMILY_STEPS}", cli_eval.evaluate,
                                parse_args(flags))):
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result, _ = with_output(fn, argv)
            torch.cuda.synchronize()
            parts[part] = dict(seconds=time.perf_counter() - t0,
                               launches={c.__name__: c.launches for c in counters},
                               result=result)
        summary = parts[f"eval_{CLI_FAMILY_STEPS}"]["result"]
        check(summary["step"] == CLI_FAMILY_STEPS,
              f"cli_families {label}: evaluated step {summary['step']}")
        quality = quality_of(summary)
        check(all(math.isfinite(v) for v in quality.values()),
              f"cli_families {label}: finite metrics {quality}")
        n_val = len(summary["views"])
        pallas = "--trunk_impl" in extra
        renders = CLI_FAMILY_STEPS // CLI_FAMILY_PRINT + n_val + CLI_SPIRAL_FRAMES
        want = {"train": {"trunk_encode": CLI_FAMILY_STEPS + renders if pallas else 0,
                          "trunk_encode_bwd": CLI_FAMILY_STEPS if pallas else 0},
                f"eval_{CLI_FAMILY_STEPS}": {"trunk_encode": n_val if pallas else 0,
                                             "trunk_encode_bwd": 0}}
        for part, counts in want.items():
            counts = dict(counts, fused_flow_composite=0, fused_flow_composite_bwd=0,
                          fused_flow_stack=0, fused_flow_stack_bwd=0)
            check(parts[part]["launches"] == counts,
                  f"cli_families {label}: {part} launched {parts[part]['launches']}, "
                  f"want {counts}")
        rundir = ckpt.run_dir(args.basedir, args.dataname, args.type_flows, args.expname)
        check(os.path.exists(os.path.join(rundir, f"{CLI_FAMILY_STEPS:06d}_01",
                                          ckpt.STATE_FILE)),
              f"cli_families {label}: checkpoint at step {CLI_FAMILY_STEPS}")
        with open(os.path.join(args.basedir, args.dataname, "summaries", expname,
                               "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        prints = list(range(CLI_FAMILY_PRINT, CLI_FAMILY_STEPS + 1, CLI_FAMILY_PRINT))
        check([r["step"] for r in records] == prints
              and all(math.isfinite(v) for r in records for v in r.values()),
              f"cli_families {label}: metrics.jsonl {[r['step'] for r in records]}")
        rays = N_RAND + N_DEPTH
        loop_rate = CLI_FAMILY_PRINT * rays / (records[-1]["t"] - records[-2]["t"])
        RATES[f"cli_families ({label})"] = loop_rate
        runs[label] = dict(model=args.model, type_flows=args.type_flows,
                           trunk_impl=args.trunk_impl, steps=CLI_FAMILY_STEPS,
                           quality=quality, train_psnr=[r["train/psnr"] for r in records],
                           seconds={p: v["seconds"] for p, v in parts.items()},
                           launches={p: v["launches"] for p, v in parts.items()},
                           loop_rays_per_s=loop_rate)
        launches[label] = {c.__name__: sum(v["launches"][c.__name__] for v in parts.values())
                           for c in counters}
    emit("cli_families", nvidia_smi=nvidia_smi_line(), runs=runs)
    return launches


# ---------------------------------------------------------------------- #
# ensemble: serial members, the mixture eval and the member axis (slice 8)
# ---------------------------------------------------------------------- #

ENS_MEMBERS = 3
# 20 steps a member: (a)-(e) were cut from 100 to 50 to keep the script
# within its time when the phase grew (g)-(i), and to 20 for (j)-(l)
ENS_STEPS, ENS_PRINT = 20, 10
# no image, video or test-set cadence: the val batch at each i_print and the
# checkpoints at the last step
ENS_CADENCES = ["--n_iters", str(ENS_STEPS), "--i_print", str(ENS_PRINT),
                "--i_weights", str(ENS_STEPS), "--i_img", "0", "--i_testset", "0",
                "--i_video", "0"]
# --parallel against the serial members' checkpoints, per tensor, relative
# to its largest magnitude: the same steps, each member's arithmetic in the
# member-batched launches that of its own launches (phase_member_kernels
# holds them bitwise), so 0 is expected
ENS_CKPT_RTOL = 1e-5
# (c)'s loop rays/s against (a)'s: the same work, (c) one member-batched
# step a dispatch for all members where (a) takes M single steps; the floor
# leaves room for the host clocks' spread between two runs
ENS_RATE_FLOOR = 0.95
ENS_COUNTERS = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                flow_stack.fused_flow_stack, flow_stack.fused_flow_stack_bwd,
                trunk.trunk_encode, trunk.trunk_encode_bwd)
# eval label -> the flags that pick its members, and the members it must mix
# (None: --members auto, whatever the gate keeps)
ENS_EVALS = (("all", [], [1, 2, 3]), ("m1-3", ["--members", "1,3"], [1, 3]),
             ("m1", ["--members", "1"], [1]), ("m2", ["--members", "2"], [2]),
             ("m3", ["--members", "3"], [3]),
             ("auto_train_psnr", ["--members", "auto"], None),
             ("auto_val_nll", ["--members", "auto", "--gate_metric", "val_nll"], None))


def ens_run(argv):
    """cli.ensemble.main(argv) with every kernel's launches counted (reset
    just before, read just after) and its seconds on the host clock."""
    for c in ENS_COUNTERS:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, text = with_output(cli_ensemble.main, argv)
    torch.cuda.synchronize()
    return dict(result=result, text=text, seconds=time.perf_counter() - t0,
                launches={c.__name__: c.launches for c in ENS_COUNTERS})


def ens_want(fwd=0, bwd=0, trunk_kernels=False, flow_fwd=0, flow_bwd=0, trunk_fwd=0,
             trunk_bwd=0):
    counts = dict.fromkeys((c.__name__ for c in ENS_COUNTERS), 0)
    counts[render_core.fused_flow_composite.__name__] = fwd
    counts[render_core.fused_flow_composite_bwd.__name__] = bwd
    counts[flow_stack.fused_flow_stack.__name__] = flow_fwd
    counts[flow_stack.fused_flow_stack_bwd.__name__] = flow_bwd
    counts[trunk.trunk_encode.__name__] = trunk_fwd
    counts[trunk.trunk_encode_bwd.__name__] = trunk_bwd
    if trunk_kernels:  # a trunk forward beside every render-core one
        counts[trunk.trunk_encode.__name__] = fwd
        counts[trunk.trunk_encode_bwd.__name__] = bwd
    return counts


def ens_records(basedir, expname="ens"):
    with open(os.path.join(basedir, "minicapture", "summaries", expname, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def ens_train_checks(label, run, records, n_members, steps, parallel, trunk_kernels=False,
                     want=None):
    """A training run's gates: launches exact from the cadences (serial: a
    render-core forward and backward a member step, a forward a member's
    val batch; --parallel: one of each a dispatch for all members, the
    member-batched step, and a forward a val batch for all members, the
    batched val render), or `want` where given; the records at every
    i_print, finite; returns the loop's rays/s over the records' clock
    (first to last i_print, every member)."""
    prints = list(range(ENS_PRINT, steps + 1, ENS_PRINT))
    if want is None:
        steps_launches = steps if parallel else n_members * steps
        val_launches = len(prints) if parallel else n_members * len(prints)
        want = ens_want(steps_launches + val_launches, steps_launches, trunk_kernels)
    check(run["launches"] == want, f"ensemble {label}: launched {run['launches']}, want {want}")
    if parallel:
        check(f"ensemble step: {n_members} members batched" in run["text"],
              f"ensemble {label}: the member-batched step ran")
    rays = N_RAND + N_DEPTH
    if parallel:
        tagged = {f"{k}_m{m:02d}" for k in ("train/psnr", "val/psnr", "val/nll")
                  for m in range(1, n_members + 1)}
        check([r["step"] for r in records] == prints
              and all(tagged | {"train/loss", "val/mse", "iter_time"} <= set(r)
                      and all(math.isfinite(v) for v in r.values()) for r in records),
              f"ensemble {label}: metrics.jsonl steps {[r['step'] for r in records]}")
        segments = [records]
    else:
        check([r["step"] for r in records] == prints * n_members
              and all({"train/psnr", "val/psnr", "val/nll"} <= set(r)
                      and all(math.isfinite(v) for v in r.values()) for r in records),
              f"ensemble {label}: metrics.jsonl steps {[r['step'] for r in records]}")
        segments = [records[i:i + len(prints)] for i in range(0, len(records), len(prints))]
    loop_s = sum(seg[-1]["t"] - seg[0]["t"] for seg in segments)
    return (steps - ENS_PRINT) * n_members * rays / loop_s


def ens_eval_checks(label, run, rundir, want_members, n_val):
    summary = run["result"]
    members = summary["members"]
    if want_members is None:
        check("--members auto:" in run["text"] and set(members) <= {1, 2, 3} and members,
              f"ensemble eval {label}: --members auto kept {members}")
    else:
        check(members == want_members, f"ensemble eval {label}: members {members}")
    check(all(math.isfinite(summary[k]) for k in QUALITY)
          and all(math.isfinite(v[k]) for v in summary["views"] for k in QUALITY),
          f"ensemble eval {label}: finite metrics {quality_of(summary)}")
    want = ens_want(len(members) * n_val)  # one tile a member's view
    check(run["launches"] == want,
          f"ensemble eval {label}: launched {run['launches']}, want {want}")
    tag = (f"eval_ensemble{ENS_MEMBERS}" if len(members) == ENS_MEMBERS
           else "eval_ensemble_m" + "-".join(str(m) for m in members))
    outdir = os.path.join(rundir, f"{tag}_{ENS_STEPS:06d}")
    files = {f"{v['view']:03d}_{s}" for v in summary["views"] for s in ("pred.png", "std.png")}
    check(set(os.listdir(outdir)) == files | {"metrics.json"},
          f"ensemble eval {label}: {outdir} holds {sorted(os.listdir(outdir))}")
    return {"members": members, **quality_of(summary), "seconds": run["seconds"],
            "launches": run["launches"]}


def ens_checkpoint_err(path_a, path_b, steps=ENS_STEPS):
    """Largest per-tensor |a - b| / max|b| over two checkpoints' tensors
    (weights, eps buffers, Adam's moments), both at step `steps`."""
    a, b = (torch.load(os.path.join(p, ckpt.STATE_FILE), map_location="cpu",
                       weights_only=True) for p in (path_a, path_b))
    check(a["global_step"] == b["global_step"] == steps,
          f"checkpoint steps {a['global_step']} / {b['global_step']}")
    return ens_state_err((a["params"], a["opt_state"]), (b["params"], b["opt_state"]))


def ens_state_err(a, b):
    """Largest per-tensor |a - b| / max|b| over two states (nested mappings
    and sequences of tensors: a module's state_dict(), an optimizer's
    state, a checkpoint's), and the number of tensors; every other value
    equal."""
    errs = []

    def walk(x, y, where):
        if isinstance(x, dict):
            check(set(x) == set(y), f"state keys at {where}")
            for k in x:
                walk(x[k], y[k], f"{where}/{k}")
        elif isinstance(x, (tuple, list)):
            check(len(x) == len(y), f"state length at {where}")
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{where}/{i}")
        elif isinstance(x, torch.Tensor):
            check(x.shape == y.shape, f"state shape at {where}")
            scale = float(y.abs().max()) if y.numel() else 0.0
            diff = float((x - y).abs().max()) if x.numel() else 0.0
            errs.append(diff / scale if scale > 0 else diff)
        else:
            check(x == y, f"state value at {where}: {x} vs {y}")

    walk(a, b, "")
    return max(errs), len(errs)


# (e): the occ stage from step 10 of 20 (N12 placed samples from 128
# candidates): each member's proposal distilled at the boundary (2^18
# points, four density queries of 65,536, two flow-stack launches each),
# then a co-training density query a step (two launches; --parallel: one
# query for all members); (f): the unfused render, 20 steps, two flow-stack
# launches each way a step (--parallel: a dispatch), two a val batch
ENS_OCC_FROM = 10
ENS_OCC_FLAGS = ["--occ_train", "12", "--occ_train_from", str(ENS_OCC_FROM)]
ENS_DISTILL_QUERIES = (1 << 18) // DENSITY_CHUNK
ENS_UNFUSED_FLAGS = ["--fused_render", "off"]
ENS_UNFUSED_STEPS = 20


def ens_cadences(steps):
    return ["--n_iters", str(steps), "--i_print", str(ENS_PRINT), "--i_weights", str(steps),
            "--i_img", "0", "--i_testset", "0", "--i_video", "0"]


def ens_serial_parallel(datadir, tmp, tag, extra, steps, trunk_kernels=False,
                        wants=(None, None)):
    """A serial and a --parallel run of ENS_MEMBERS members x `steps` at
    scripts/train_NF.sh's flags plus `extra`, each gated by
    ens_train_checks (launches `wants`: serial, parallel, or the cadences'
    render-core counts), every --parallel checkpoint tensor against its
    serial one at ENS_CKPT_RTOL.  Returns (report, serial run, parallel
    run)."""
    n = ["--n_members", str(ENS_MEMBERS)]
    runs, rates, rundirs = [], [], []
    for parallel, want in zip((False, True), wants):
        label = f"{'parallel' if parallel else 'serial'} {tag}"
        flags = cli_flags(datadir, os.path.join(tmp, label.replace(" ", "_")), "ens",
                          *extra) + n
        torch.cuda.reset_peak_memory_stats()
        run = ens_run(["train", *flags, "--is_train", *(["--parallel"] if parallel else []),
                       *ens_cadences(steps)])
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        args = cli_ensemble.parser().parse_args(flags)
        rates.append(ens_train_checks(label, run, ens_records(args.basedir), ENS_MEMBERS,
                                      steps, parallel=parallel, trunk_kernels=trunk_kernels,
                                      want=want))
        runs.append(run)
        rundirs.append(ckpt.run_dir(args.basedir, args.dataname, args.type_flows, "ens"))
    errs = {}
    for m in range(1, ENS_MEMBERS + 1):
        name = f"{steps:06d}_{m:02d}"
        err, n_tensors = ens_checkpoint_err(os.path.join(rundirs[1], name),
                                            os.path.join(rundirs[0], name), steps)
        errs[f"m{m:02d}"] = {"max_rel_err": err, "tensors": n_tensors}
        check(err <= ENS_CKPT_RTOL,
              f"member {m}'s --parallel {tag} checkpoint vs its serial one: relative max {err}")
    check(rates[1] >= ENS_RATE_FLOOR * rates[0],
          f"--parallel {tag} loop {rates[1]} rays/s vs serial {rates[0]}")
    report = dict(steps=steps, flags=list(extra),
                  serial={"seconds": runs[0]["seconds"], "launches": runs[0]["launches"],
                          "loop_rays_per_s": rates[0], "peak_gb": runs[0]["peak_gb"]},
                  parallel={"seconds": runs[1]["seconds"], "launches": runs[1]["launches"],
                            "loop_rays_per_s": rates[1], "rate_vs_serial": rates[1] / rates[0],
                            "peak_gb": runs[1]["peak_gb"], "checkpoints_vs_serial": errs})
    print(f"ensemble {tag}: --parallel vs serial checkpoints, largest per-tensor relative "
          f"difference {max(e['max_rel_err'] for e in errs.values())}; loops "
          f"{rates[1]:.0f} vs {rates[0]:.0f} rays/s; peak {runs[1]['peak_gb']:.2f} vs "
          f"{runs[0]['peak_gb']:.2f} GB", flush=True)
    return report, runs[0], runs[1]


# (g) householder through the trunk kernels and (h) IAF on the f32 trunk,
# each through cli.ensemble (the unfused render, the family's eager flows);
# (i) the triangular model with remat on the fused render, through the
# library steps the CLI builds (remat has no flag in either package's CLI:
# TrainConfig.remat).  20 steps a member each ((i) 10; all 30 until the
# baselines' sub-runs came), serially and --parallel.  The baselines (unfused, no
# kernel): (j) nerf_wild through cli.ensemble, 30 steps, its KDE NLL and
# one val render for all members; (k) nerf_dropout (32 trunk passes a
# step, ~1.45 s) and (l) nerf, MSE both, through the library's steps, 3
# and 10 steps.
ENS_FAMILY_STEPS = 20
ENS_HOUSEHOLDER_FLAGS = ["--type_flows", "householder", "--trunk_impl", "pallas"]
ENS_IAF_FLAGS = ["--type_flows", "IAF"]
ENS_WILD_FLAGS = ["--model", "nerf_wild"]
ENS_REMAT_STEPS = 10
ENS_WILD_STEPS, ENS_DROPOUT_STEPS, ENS_NERF_STEPS = 30, 3, 10


def ens_library_batches(steps):
    """`steps` flagship batches of each member (member m's stream of the
    synthetic scene shuffled from seed m): batches[j][m]."""
    streams = [flagship_batches(seed=m) for m in range(ENS_MEMBERS)]
    return [[next_batch() for next_batch in streams] for _ in range(steps)]


def ens_library_run(tag, over, batches, fused, wants, remat=False):
    """ENS_MEMBERS flagship members (build_model at FLAGSHIP's flags and
    `over`, seed 1000 m, as cli.ensemble seeds member m) trained a step a
    batch of `batches` (ens_library_batches, drawn once for every library
    run: a stream's build precomputes the scene's rays) in the model's
    loss mode, with TrainConfig(remat=remat), from the same generators:
    serially, each member's make_train_step in turn, then member-batched
    (make_ensemble_train_step).  Launches exact (`wants`: serial, then
    --parallel); every tensor of each member's weights and Adam state
    against its serial one at ENS_CKPT_RTOL; both loops' rays/s over steps
    2..N (the host clock, ending in synchronize) and peak memory.  Returns
    (report, serial launches, parallel launches)."""
    M, rays, steps = ENS_MEMBERS, N_RAND + N_DEPTH, len(batches)
    seeds = [1000 * m for m in range(1, M + 1)]
    cfg = TrainConfig(H=H, W=W, focal=FOCAL, ndc=False, near=NEAR, far=FAR,
                      k_samples=FLAGSHIP["K_samples"], remat=remat,
                      loss_mode=loss_mode_for_model(over.get("model")), **TRAIN_CFG)

    def members():
        built = [build_model(types.SimpleNamespace(**dict(FLAGSHIP, **over, seed=s)))
                 for s in seeds]
        return [b[0] for b in built], built[0][2]

    def run(parallel):
        models, rc = members()
        check(rc.fused == fused, f"ensemble {tag}: the render {rc.fused}, want {fused}")
        gens = member_generators(seeds, "cuda")
        if parallel:
            step, optimizers = make_ensemble_train_step(models, rc, cfg, M)
            check(step.batched, f"ensemble {tag}: the member-batched step")
            calls = [lambda j: step({k: np.stack([b[k] for b in batches[j]])
                                     for k in batches[j][0]}, gens)]
        else:
            singles = [make_train_step(model, rc, cfg) for model in models]
            optimizers = [opt for _, opt in singles]
            calls = [lambda j, m=m: singles[m][0](batches[j][m], gens[m]) for m in range(M)]
        for c in ENS_COUNTERS:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds, metrics = 0.0, []
        for j in range(steps):
            t0 = time.perf_counter()
            metrics += [call(j) for call in calls]
            torch.cuda.synchronize()
            if j > 0:
                seconds += time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {c.__name__: c.launches for c in ENS_COUNTERS}
        check(all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values()),
              f"ensemble {tag}: finite metrics")
        states = [(model.state_dict(), opt.state_dict()["state"])
                  for model, opt in zip(models, optimizers)]
        return dict(launches=launches, peak_gb=peak,
                    loop_rays_per_s=(steps - 1) * M * rays / seconds), states

    serial, serial_states = run(False)
    parallel, parallel_states = run(True)
    check(serial["launches"] == wants[0], f"ensemble {tag} serial: launched "
          f"{serial['launches']}, want {wants[0]}")
    check(parallel["launches"] == wants[1], f"ensemble {tag} --parallel: launched "
          f"{parallel['launches']}, want {wants[1]}")
    errs = {}
    for m, (a, b) in enumerate(zip(parallel_states, serial_states), 1):
        err, n = ens_state_err(a, b)
        errs[f"m{m:02d}"] = {"max_rel_err": err, "tensors": n}
        check(err <= ENS_CKPT_RTOL, f"member {m}'s --parallel {tag} state vs serial: {err}")
    check(parallel["loop_rays_per_s"] >= ENS_RATE_FLOOR * serial["loop_rays_per_s"],
          f"--parallel {tag} {parallel['loop_rays_per_s']} rays/s vs serial "
          f"{serial['loop_rays_per_s']}")
    parallel["rate_vs_serial"] = parallel["loop_rays_per_s"] / serial["loop_rays_per_s"]
    parallel["checkpoints_vs_serial"] = errs
    print(f"ensemble {tag}: --parallel vs serial weights and Adam, largest per-tensor "
          f"relative difference {max(e['max_rel_err'] for e in errs.values())}; loops "
          f"{parallel['loop_rays_per_s']:.0f} vs {serial['loop_rays_per_s']:.0f} rays/s; "
          f"peak {parallel['peak_gb']:.2f} vs {serial['peak_gb']:.2f} GB", flush=True)
    report = dict(steps=steps, remat=remat, flags=over, serial=serial, parallel=parallel)
    return report, {"launches": serial["launches"]}, {"launches": parallel["launches"]}


def phase_ensemble(tmp):
    """cfnerf_torch.cli.ensemble on a copy of the capture at
    scripts/train_NF.sh's flags: (a) serial training of 3 members, 20
    steps each; (b) the mixture eval of all three, of members 1 and 3, of
    each alone and of --members auto under train_psnr and val_nll; (c)
    --parallel training of 3 members in a fresh run dir, each member's
    checkpoint against its serial one, the tagged scalars, its mixture
    eval, its loop rate against (a)'s, its peak memory; (d) --trunk_impl
    pallas, 3 members, 20 steps, serial and --parallel, each --parallel
    checkpoint against its serial one, both loops' rates; (e) the occ
    stage (ENS_OCC_FLAGS), 3 members x 20 steps, and (f) the unfused
    render (ENS_UNFUSED_FLAGS), 3 members x 20 steps, both serial and
    --parallel, checkpoints and rates as (d); (g) householder with the
    trunk kernels and (h) IAF, 3 members x 20 steps through the CLI, and
    (i) remat on the fused render, 3 members x 10 steps through the
    library's steps
    (ens_library_run), each serial and --parallel, checkpoints, rates and
    peak memory as (d); the baselines, no kernel on their path: (j)
    nerf_wild, 3 members x 30 steps through the CLI, (k) nerf_dropout x 3
    and (l) nerf x 10 through the library's steps, each serial and
    --parallel, as (d).  --parallel runs the member-batched step: one
    render-core forward and backward (and, with pallas, one trunk forward
    and backward) a dispatch for all members, or unfused two flow-stack
    launches each way; in the occ stage one co-training density query for
    all; one val batch render for all.  Launches exact everywhere.
    Returns each kernel's launches by path: its serial runs, the mixture
    evals, the --parallel runs."""
    t_phase = time.perf_counter()
    datadir = shutil.copytree(CAPTURE, os.path.join(tmp, "minicapture"))
    n = ["--n_members", str(ENS_MEMBERS)]

    # (a) serial
    flags_a = cli_flags(datadir, os.path.join(tmp, "serial"), "ens") + n
    args_a = cli_ensemble.parser().parse_args(flags_a)
    rundir_a = ckpt.run_dir(args_a.basedir, args_a.dataname, args_a.type_flows, "ens")
    serial = ens_run(["train", *flags_a, "--is_train", *ENS_CADENCES])
    serial_records = ens_records(args_a.basedir)
    serial_rate = ens_train_checks("serial", serial, serial_records, ENS_MEMBERS, ENS_STEPS,
                                   parallel=False)
    RATES["ensemble_serial"] = serial_rate

    # (b) the mixture evals of the serial run
    evals, eval_runs = {}, []
    n_val = None
    for label, extra, want_members in ENS_EVALS:
        run = ens_run(["eval", *flags_a, *extra])
        n_val = n_val or len(run["result"]["views"])
        evals[label] = ens_eval_checks(label, run, rundir_a, want_members, n_val)
        eval_runs.append(run)

    # (c) --parallel in a fresh run dir
    flags_c = cli_flags(datadir, os.path.join(tmp, "parallel"), "ens") + n
    args_c = cli_ensemble.parser().parse_args(flags_c)
    rundir_c = ckpt.run_dir(args_c.basedir, args_c.dataname, args_c.type_flows, "ens")
    torch.cuda.reset_peak_memory_stats()
    parallel = ens_run(["train", *flags_c, "--is_train", "--parallel", *ENS_CADENCES])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    parallel_records = ens_records(args_c.basedir)
    parallel_rate = ens_train_checks("parallel", parallel, parallel_records, ENS_MEMBERS,
                                     ENS_STEPS, parallel=True)
    RATES["ensemble_parallel"] = parallel_rate
    ckpt_errs = {}
    for m in range(1, ENS_MEMBERS + 1):
        name = f"{ENS_STEPS:06d}_{m:02d}"
        err, n_tensors = ens_checkpoint_err(os.path.join(rundir_c, name),
                                            os.path.join(rundir_a, name))
        ckpt_errs[f"m{m:02d}"] = {"max_rel_err": err, "tensors": n_tensors}
        check(err <= ENS_CKPT_RTOL,
              f"member {m}'s --parallel checkpoint vs its serial one: relative max {err}")
    print(f"ensemble: --parallel vs serial checkpoints, largest per-tensor relative "
          f"difference {max(e['max_rel_err'] for e in ckpt_errs.values())}", flush=True)
    per_print = len(parallel_records)
    psnr_diff = max(abs(r[f"train/psnr_m{m:02d}"] - serial_records[(m - 1) * per_print + i][
        "train/psnr"]) for i, r in enumerate(parallel_records) for m in range(1, ENS_MEMBERS + 1))
    check(parallel_rate >= ENS_RATE_FLOOR * serial_rate,
          f"--parallel loop {parallel_rate} rays/s vs serial {serial_rate}")
    run = ens_run(["eval", *flags_c])
    parallel_eval = ens_eval_checks("parallel", run, rundir_c, [1, 2, 3], n_val)
    eval_runs.append(run)

    # (d) through the trunk kernels: serial, then --parallel
    pallas_report, pallas_serial, pallas = ens_serial_parallel(
        datadir, tmp, "pallas", ["--trunk_impl", "pallas"], ENS_STEPS, trunk_kernels=True)
    RATES["ensemble_serial_pallas"] = pallas_report["serial"]["loop_rays_per_s"]
    RATES["ensemble_parallel_pallas"] = pallas_report["parallel"]["loop_rays_per_s"]

    # (e) the occ stage: serial, then --parallel
    M, prints = ENS_MEMBERS, ENS_STEPS // ENS_PRINT
    occ_steps = ENS_STEPS - ENS_OCC_FROM + 1
    distill = 2 * ENS_DISTILL_QUERIES  # a member's distillation's flow-stack launches
    occ_report, occ_serial, occ_parallel = ens_serial_parallel(
        datadir, tmp, "occ", ENS_OCC_FLAGS, ENS_STEPS,
        wants=(ens_want(M * (ENS_STEPS + prints), M * ENS_STEPS,
                        flow_fwd=M * (distill + 2 * occ_steps)),
               ens_want(ENS_STEPS + prints, ENS_STEPS, flow_fwd=M * distill + 2 * occ_steps)))
    check("ensemble step: 3 members batched" in occ_parallel["text"]
          and "density query" in occ_parallel["text"],
          "ensemble occ: the member-batched occ step ran")
    RATES["ensemble_serial_occ"] = occ_report["serial"]["loop_rays_per_s"]
    RATES["ensemble_parallel_occ"] = occ_report["parallel"]["loop_rays_per_s"]

    # (f) the unfused render: serial, then --parallel
    steps_f, prints_f = ENS_UNFUSED_STEPS, ENS_UNFUSED_STEPS // ENS_PRINT
    unfused_report, unfused_serial, unfused_parallel = ens_serial_parallel(
        datadir, tmp, "unfused", ENS_UNFUSED_FLAGS, steps_f,
        wants=(ens_want(flow_fwd=M * 2 * (steps_f + prints_f), flow_bwd=M * 2 * steps_f),
               ens_want(flow_fwd=2 * (steps_f + prints_f), flow_bwd=2 * steps_f)))
    check("flow-stack launch a chain" in unfused_parallel["text"],
          "ensemble unfused: the member-batched unfused step ran")
    RATES["ensemble_serial_unfused"] = unfused_report["serial"]["loop_rays_per_s"]
    RATES["ensemble_parallel_unfused"] = unfused_report["parallel"]["loop_rays_per_s"]

    # (g) householder through the trunk kernels, (h) IAF: serial, then
    # --parallel; the flows eager (no render core, no flow stack), a trunk
    # forward a step and a val batch with pallas, a backward a step
    steps_g, prints_g = ENS_FAMILY_STEPS, ENS_FAMILY_STEPS // ENS_PRINT
    hh_report, hh_serial, hh_parallel = ens_serial_parallel(
        datadir, tmp, "householder_pallas", ENS_HOUSEHOLDER_FLAGS, steps_g,
        wants=(ens_want(trunk_fwd=M * (steps_g + prints_g), trunk_bwd=M * steps_g),
               ens_want(trunk_fwd=steps_g + prints_g, trunk_bwd=steps_g)))
    check("the householder flows once on the joined points" in hh_parallel["text"],
          "ensemble householder: the member-batched step ran")
    iaf_report, iaf_serial, iaf_parallel = ens_serial_parallel(
        datadir, tmp, "IAF", ENS_IAF_FLAGS, steps_g, wants=(ens_want(), ens_want()))
    check("the IAF flows member by member" in iaf_parallel["text"],
          "ensemble IAF: the member-batched step ran")
    # (i) remat on the fused render, through the library's steps
    steps_i = ENS_REMAT_STEPS
    batches = ens_library_batches(max(steps_i, ENS_DROPOUT_STEPS, ENS_NERF_STEPS))
    remat_report, remat_serial, remat_parallel = ens_library_run(
        "remat", {}, batches[:steps_i], "on",
        (ens_want(2 * M * steps_i, M * steps_i), ens_want(2 * steps_i, steps_i)), remat=True)
    # (j) nerf_wild through the CLI, (k) nerf_dropout and (l) nerf through
    # the library's steps: the baselines' nets member by member, no kernel
    wild_report, wild_serial, wild_parallel = ens_serial_parallel(
        datadir, tmp, "nerf_wild", ENS_WILD_FLAGS, ENS_WILD_STEPS,
        wants=(ens_want(), ens_want()))
    check("the nerf_wild nets member by member" in wild_parallel["text"],
          "ensemble nerf_wild: the member-batched step ran")
    dropout_report, dropout_serial, dropout_parallel = ens_library_run(
        "nerf_dropout", {"model": "nerf_dropout"}, batches[:ENS_DROPOUT_STEPS], "off",
        (ens_want(), ens_want()))
    nerf_report, nerf_serial, nerf_parallel = ens_library_run(
        "nerf", {"model": "nerf"}, batches[:ENS_NERF_STEPS], "off", (ens_want(), ens_want()))
    for tag, rep in (("householder_pallas", hh_report), ("iaf", iaf_report),
                     ("remat", remat_report), ("nerf_wild", wild_report),
                     ("nerf_dropout", dropout_report), ("nerf", nerf_report)):
        RATES[f"ensemble_serial_{tag}"] = rep["serial"]["loop_rays_per_s"]
        RATES[f"ensemble_parallel_{tag}"] = rep["parallel"]["loop_rays_per_s"]

    emit("ensemble", nvidia_smi=nvidia_smi_line(), members=ENS_MEMBERS, steps=ENS_STEPS,
         rays_per_step=N_RAND + N_DEPTH, n_val=n_val,
         serial={"seconds": serial["seconds"], "launches": serial["launches"],
                 "loop_rays_per_s": serial_rate,
                 "train_psnr": [r["train/psnr"] for r in serial_records]},
         evals=evals,
         parallel={"seconds": parallel["seconds"], "launches": parallel["launches"],
                   "loop_rays_per_s": parallel_rate, "peak_gb": peak_gb,
                   "rate_vs_serial": parallel_rate / serial_rate,
                   "checkpoints_vs_serial": ckpt_errs,
                   "train_psnr_max_abs_diff_vs_serial": psnr_diff,
                   "eval": parallel_eval,
                   "iter_time_ms": [1e3 * r["iter_time"] for r in parallel_records]},
         pallas=pallas_report, occ=occ_report, unfused=unfused_report,
         householder_pallas=hh_report, iaf=iaf_report, remat=remat_report,
         nerf_wild=wild_report, nerf_dropout=dropout_report, nerf=nerf_report,
         dispatches={"parallel": ENS_STEPS, "parallel_pallas": ENS_STEPS,
                     "parallel_occ": ENS_STEPS, "parallel_unfused": ENS_UNFUSED_STEPS,
                     "parallel_householder_pallas": ENS_FAMILY_STEPS,
                     "parallel_iaf": ENS_FAMILY_STEPS, "parallel_remat": ENS_REMAT_STEPS,
                     "parallel_nerf_wild": ENS_WILD_STEPS,
                     "parallel_nerf_dropout": ENS_DROPOUT_STEPS,
                     "parallel_nerf": ENS_NERF_STEPS},
         phase_s=time.perf_counter() - t_phase,
         gates={"checkpoint_rel_err": ENS_CKPT_RTOL, "parallel_rate_floor": ENS_RATE_FLOOR})
    by_path = {"ensemble_serial": [serial, pallas_serial], "ensemble_eval": eval_runs,
               "ensemble_parallel": [parallel, pallas],
               "ensemble_occ_serial": [occ_serial], "ensemble_occ_parallel": [occ_parallel],
               "ensemble_unfused_serial": [unfused_serial],
               "ensemble_unfused_parallel": [unfused_parallel],
               "ensemble_householder_serial": [hh_serial],
               "ensemble_householder_parallel": [hh_parallel],
               "ensemble_iaf_serial": [iaf_serial], "ensemble_iaf_parallel": [iaf_parallel],
               "ensemble_remat_serial": [remat_serial],
               "ensemble_remat_parallel": [remat_parallel],
               "ensemble_nerf_wild_serial": [wild_serial],
               "ensemble_nerf_wild_parallel": [wild_parallel],
               "ensemble_nerf_dropout_serial": [dropout_serial],
               "ensemble_nerf_dropout_parallel": [dropout_parallel],
               "ensemble_nerf_serial": [nerf_serial], "ensemble_nerf_parallel": [nerf_parallel]}
    return {path: {c.__name__: sum(r["launches"][c.__name__] for r in part)
                   for c in ENS_COUNTERS} for path, part in by_path.items()}


# the mesh phase: the port's several-device paths on one card.  (a) a one-rank NCCL group through cli.train's mesh path
# against the same run without a group: the same kernels on the same
# inputs in the same order, a one-rank all-reduce copies, so 0 is expected;
# the gate is 1e-6 of each tensor's largest magnitude.  (b) two ranks on
# the card over gloo (NCCL takes one rank a GPU): the first step's reduced
# gradients against one process's at 1e-5 of each leaf's largest magnitude
# (the batch's sums split in two halves and added in another order; with
# the trunk kernels by relative RMS, their weight-gradient pass rounding
# its accumulator not to nearest: twice trunk_wgrad_rel of the rows); the
# parameters' change over the run by relative RMS and cosine (Adam turns a
# near-zero gradient's rounding into a whole step of lr, as the *_golden
# phases' rule says); each --parallel ensemble member's checkpoint against
# its serial run at ENS_CKPT_RTOL (one member a rank, a data axis of 1: 0
# expected)
MESH_STEPS, MESH_PRINT = 10, 5
MESH_A_RTOL = 1e-6
MESH_GRAD_RTOL = 1e-5
MESH_PALLAS_MIN_COS = 0.99999
MESH_REL_RMS, MESH_MIN_COS = 2.5e-2, 0.9995
MESH_N_RAND = 1024  # (b): 512 rays a rank, beside 128 depth rays (64 a rank)
MESH_PALLAS_STEPS = 5
# the tensor-parallel step gathers every layer's output over gloo through the
# host: fewer rays, the flagship's widths
MESH_TP_RAYS, MESH_TP_DEPTH, MESH_TP_STEPS = 128, 32, 3
MESH_LAUNCH_S = 400
MESH_COUNTERS = (render_core.fused_flow_composite, render_core.fused_flow_composite_bwd,
                 flow_stack.fused_flow_stack, flow_stack.fused_flow_stack_bwd,
                 trunk.trunk_encode, trunk.trunk_encode_bwd)


def mesh_counts():
    return {c.__name__: c.launches for c in MESH_COUNTERS}


def mesh_reset():
    for c in MESH_COUNTERS:
        c.launches = 0


def mesh_want(fwd=0, bwd=0, trunk_kernels=False):
    counts = dict.fromkeys((c.__name__ for c in MESH_COUNTERS), 0)
    counts.update(fused_flow_composite=fwd, fused_flow_composite_bwd=bwd)
    if trunk_kernels:
        counts.update(trunk_encode=fwd, trunk_encode_bwd=bwd)
    return counts


def mesh_cli_flags(datadir, basedir, *extra):
    return cli_flags(datadir, basedir, "mesh", "--is_train", "--n_iters", str(MESH_STEPS),
                     "--i_print", str(MESH_PRINT), "--i_weights", str(MESH_STEPS),
                     "--i_img", "0", "--i_testset", "0", "--i_video", "0", *extra)


def mesh_view(flags, mesh):
    """The first held-out view of the run of `flags`, from its checkpoint,
    over `mesh` (None: no group), counted: (rgb_map, launches)."""
    args = parse_args(flags)
    scene = load_dataset(args)
    model, model_fine, rc, start = create_nerf(args)
    check(start == MESH_STEPS, f"mesh view: resumed at {start}")
    view = scene["i_val"][0]
    mesh_reset()
    out = render_image(make_render_rays(model, rc, model_fine), scene["poses"][view],
                       H=scene["H"], W=scene["W"], focal=scene["focal"],
                       ndc=args.dataset_type == "llff" and not args.no_ndc,
                       use_viewdirs=args.use_viewdirs, near=scene["near"], far=scene["far"],
                       tile=args.chunk, mesh=mesh)
    torch.cuda.synchronize()
    return out["rgb_map"].cpu(), mesh_counts()


def mesh_cli_run(flags):
    """cli.train.main(flags), counted and timed, and its metrics records."""
    mesh_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_train.main(flags)
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, mesh_counts()
    args = parse_args(flags)
    with open(os.path.join(args.basedir, args.dataname, "summaries", "mesh",
                           "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return dict(seconds=seconds, launches=launches, records=records)


def _mesh_a_rank(rank, flags):
    """(a) in its one-rank NCCL group: cli.train's mesh path (create_mesh(1))
    and one view through render_image's mesh path."""
    from cfnerf_torch.parallel.mesh import create_mesh

    run = mesh_cli_run(flags)
    rgb, view_launches = mesh_view(flags, create_mesh(1))
    return dict(run, rgb=rgb, view_launches=view_launches)


def mesh_batches(n_rand, n_depth):
    """next_batch() over the synthetic scene: n_rand rgb and n_depth depth
    rays, the same stream on every rank."""
    images, poses, depth_gts = synthetic_scene(seed=0)
    i_train = list(range(len(images)))
    rays = RayBatcher(precompute_rays(images, poses, FOCAL, i_train, seed=0), n_rand, seed=0)
    depth_rays = DepthRayBatcher(
        precompute_depth_rays(depth_gts, poses, H, W, FOCAL, i_train, seed=0), n_depth, seed=0)

    def next_batch():
        batch = rays.next()
        batch.update(depth_rays.next())
        batch.pop("ray_weights")
        return batch

    return next_batch


def mesh_steps(mesh, n_rand, n_depth, steps, trunk_impl="xla"):
    """`steps` flagship training steps over `mesh` (None: this process
    alone, no group) on the synthetic scene's batches, this rank's share:
    the first step's (reduced) gradients, the parameters at the start and
    the end, whole (a tensor-parallel net's gathered), the metrics, the
    step times after the first, the launches."""
    from cfnerf_torch.parallel import mesh as pmesh

    model, _, rc = build_model(types.SimpleNamespace(**FLAGSHIP, trunk_impl=trunk_impl))
    if mesh is not None:
        pmesh.replicate(mesh, model)
        pmesh.shard_params_tp(mesh, model)
    cfg = TrainConfig(H=H, W=W, focal=FOCAL, ndc=False, near=NEAR, far=FAR,
                      k_samples=FLAGSHIP["K_samples"], **TRAIN_CFG)
    step, _ = make_train_step(model, rc, cfg, mesh=mesh)
    next_batch = mesh_batches(n_rand, n_depth)
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = {k: v.detach().cpu().clone() for k, v in pmesh.full_state_dict(model).items()}

    def whole_grads():
        grads = {}
        for name, m in model.named_modules():
            for leaf, p in m.named_parameters(recurse=False):
                if p.grad is None:
                    continue
                g = p.grad
                if isinstance(m, pmesh.ColumnParallelLinear):
                    g = pmesh.all_gather(g, m.tp_group, dim=0)
                grads[f"{name}.{leaf}" if name else leaf] = g.detach().cpu().clone()
        return grads

    mesh_reset()
    torch.cuda.synchronize()
    times, metrics, first = [], [], None
    for i in range(steps):
        batch = next_batch()
        if mesh is not None:
            batch = pmesh.shard_batch(mesh, batch)
        t0 = time.perf_counter()
        m = step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = whole_grads()
    launches = mesh_counts()
    end = {k: v.detach().cpu().clone() for k, v in pmesh.full_state_dict(model).items()}
    return dict(grads=first, start=start, end=end, metrics=metrics, times=times[1:],
                launches=launches)


def _mesh_b_rank(rank, ens_flags):
    """(b): two ranks on the card over gloo.  Returns each part's launches
    (every rank) and, from rank 0, the parts' results."""
    from cfnerf_torch.parallel.mesh import create_mesh

    out = {}
    dp = mesh_steps(create_mesh(2), MESH_N_RAND, N_DEPTH, MESH_STEPS)
    pallas = mesh_steps(create_mesh(2), MESH_N_RAND, N_DEPTH, MESH_PALLAS_STEPS,
                        trunk_impl="pallas")
    mesh_reset()
    t0 = time.perf_counter()
    cli_ensemble.main(["train", *ens_flags])
    torch.cuda.synchronize()
    ens = dict(seconds=time.perf_counter() - t0, launches=mesh_counts())
    tp = mesh_steps(create_mesh(2, model_parallel=2), MESH_TP_RAYS, MESH_TP_DEPTH,
                    MESH_TP_STEPS)
    for name, part in (("dp", dp), ("pallas", pallas), ("ensemble", ens), ("tp", tp)):
        out[name] = part if rank == 0 else {"launches": part["launches"]}
    return out


def mesh_gates(part, ref, label, trunk_rows=None):
    """(b)'s gates for one part against its one-process run: the first
    step's gradients per leaf against 1e-5 of the leaf's largest magnitude
    (with the trunk kernels, whose weight-gradient pass rounds its
    accumulator not to nearest, by relative RMS against twice
    trunk_wgrad_rel of the step's rows, cosine MESH_PALLAS_MIN_COS), the
    parameters' change over the run by relative RMS and cosine, the metrics
    finite.  Returns what the phase reports."""
    check(set(part["grads"]) == set(ref["grads"]), f"{label}: the same leaves get gradients")
    worst = 0.0
    for name, want in ref["grads"].items():
        scale = float(want.abs().max())
        diff = float((part["grads"][name] - want).abs().max())
        rel = diff / scale if scale > 0 else diff
        worst = max(worst, rel)
        if trunk_rows is None:
            check(rel <= MESH_GRAD_RTOL,
                  f"{label}: first step's gradient {name}: relative {rel}")
    first = None
    if trunk_rows is not None:
        first = gate_leaves(leaf_errors(part["grads"], ref["grads"]),
                            2 * trunk_wgrad_rel(trunk_rows), MESH_PALLAS_MIN_COS,
                            f"{label}: the first step's gradients")
    moved = {k: part["end"][k] - part["start"][k] for k in ref["end"]}
    moved_ref = {k: ref["end"][k] - ref["start"][k] for k in ref["end"]}
    change = gate_leaves(leaf_errors(moved, moved_ref), MESH_REL_RMS, MESH_MIN_COS,
                         f"{label}: the parameters' change over the run")
    check(all(math.isfinite(v) for m in part["metrics"] for v in m.values()),
          f"{label}: finite metrics")
    return {"first_step_grad_max_rel": worst, "first_step_grads": first,
            "change_vs_one_process": change,
            "loss": [m["loss"] for m in part["metrics"]],
            "loss_one_process": [m["loss"] for m in ref["metrics"]]}


def phase_mesh(tmp):
    """The port's several-device paths on the one card: (a) a one-rank NCCL
    group (launch(..., 1), create_mesh(1), cli.train's mesh path) against
    the same run without a group, and a mesh render of one view; (b) two
    ranks on the card over gloo: the flagship data-parallel step (1024 +
    128 rays, 512 + 64 a rank), the same with the trunk kernels, cli.ensemble
    train --parallel with 2 members on create_ensemble_mesh(2, 2), and the
    (data 1, model 2) tensor-parallel step in f32, each against one process.
    Launches exact on every rank.  Returns each kernel's launches over the
    phase's ranks."""
    from cfnerf_torch.parallel.mesh import launch

    t_phase = time.perf_counter()
    datadir = shutil.copytree(CAPTURE, os.path.join(tmp, "minicapture"))
    rays = N_RAND + N_DEPTH
    fwd_name, bwd_name = "fused_flow_composite", "fused_flow_composite_bwd"
    prints = MESH_STEPS // MESH_PRINT
    want_train = mesh_want(MESH_STEPS + prints, MESH_STEPS)

    # (a) the one-rank group against no group
    flags_ref = mesh_cli_flags(datadir, os.path.join(tmp, "a_ref"), "--mesh_devices", "1")
    ref = mesh_cli_run(flags_ref)
    ref_rgb, _ = mesh_view(flags_ref, None)
    flags_grp = mesh_cli_flags(datadir, os.path.join(tmp, "a_group"), "--mesh_devices", "1")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (grp,) = launch(_mesh_a_rank, 1, flags_grp, timeout=MESH_LAUNCH_S)
    a_call_s = time.perf_counter() - t0
    for label, run in (("no group", ref), ("one-rank group", grp)):
        check(run["launches"] == want_train,
              f"mesh (a) {label}: launched {run['launches']}, want {want_train}")
    want_view = mesh_want(1)  # the 48x64 view is one tile of --chunk rays
    check(grp["view_launches"] == want_view,
          f"mesh (a) view: launched {grp['view_launches']}, want {want_view}")
    name = f"{MESH_STEPS:06d}_01"
    rundir = ckpt.run_dir(os.path.join(tmp, "a_ref"), "minicapture", "triangular", "mesh")
    a_ckpt_err, n_tensors = ens_checkpoint_err(
        os.path.join(ckpt.run_dir(os.path.join(tmp, "a_group"), "minicapture", "triangular",
                                  "mesh"), name), os.path.join(rundir, name), MESH_STEPS)
    check(a_ckpt_err <= MESH_A_RTOL, f"mesh (a): checkpoint vs no group, relative {a_ckpt_err}")
    a_metrics_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                        for a, b in zip(grp["records"], ref["records"])
                        for k in b if k.startswith(("train/", "val/")))
    check(len(grp["records"]) == len(ref["records"]) == prints
          and a_metrics_err <= MESH_A_RTOL,
          f"mesh (a): metrics vs no group, relative {a_metrics_err}")
    a_view_err = float((grp["rgb"] - ref_rgb).abs().max())
    check(a_view_err <= MESH_A_RTOL * float(ref_rgb.abs().max()),
          f"mesh (a): the mesh render vs no group, max abs {a_view_err}")

    def loop_rate(records):
        t = {r["step"]: r["t"] for r in records}
        return (MESH_STEPS - MESH_PRINT) * rays / (t[MESH_STEPS] - t[MESH_PRINT])

    a_rate, ref_rate = loop_rate(grp["records"]), loop_rate(ref["records"])
    RATES["mesh_a_one_rank_group"] = a_rate

    # (b) two ranks on the card over gloo, each part against one process
    ens_common = ["--n_members", "2", "--n_iters", str(MESH_STEPS), "--i_print",
                  str(MESH_PRINT), "--i_weights", str(MESH_STEPS), "--i_img", "0",
                  "--i_testset", "0", "--i_video", "0", "--is_train"]
    ens_serial = cli_flags(datadir, os.path.join(tmp, "ens_serial"), "mesh") + ens_common + [
        "--mesh_devices", "1"]
    ens_mesh = cli_flags(datadir, os.path.join(tmp, "ens_mesh"), "mesh") + ens_common + [
        "--parallel", "--mesh_devices", "2"]
    ref_dp = mesh_steps(None, MESH_N_RAND, N_DEPTH, MESH_STEPS)
    ref_pallas = mesh_steps(None, MESH_N_RAND, N_DEPTH, MESH_PALLAS_STEPS, trunk_impl="pallas")
    ref_tp = mesh_steps(None, MESH_TP_RAYS, MESH_TP_DEPTH, MESH_TP_STEPS)
    cli_ensemble.main(["train", *ens_serial])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(_mesh_b_rank, 2, ens_mesh, device="cuda:0", timeout=MESH_LAUNCH_S)
    b_call_s = time.perf_counter() - t0
    b = ranks[0]
    want_b = {"dp": mesh_want(MESH_STEPS, MESH_STEPS),
              "pallas": mesh_want(MESH_PALLAS_STEPS, MESH_PALLAS_STEPS, trunk_kernels=True),
              "ensemble": mesh_want(MESH_STEPS + prints, MESH_STEPS),  # one member a rank
              "tp": mesh_want(MESH_TP_STEPS, MESH_TP_STEPS)}
    for r, res in enumerate(ranks):
        for part, want in want_b.items():
            check(res[part]["launches"] == want,
                  f"mesh (b) {part}, rank {r}: launched {res[part]['launches']}, want {want}")
    dp = mesh_gates(b["dp"], ref_dp, "mesh (b) data-parallel")
    pallas = mesh_gates(b["pallas"], ref_pallas, "mesh (b) data-parallel, trunk kernels",
                        trunk_rows=(MESH_N_RAND + N_DEPTH) * FLAGSHIP["N_samples"])
    tp = mesh_gates(b["tp"], ref_tp, "mesh (b) tensor-parallel")
    ens_errs = {}
    for m in (1, 2):
        rundir_of = lambda base: ckpt.run_dir(os.path.join(tmp, base), "minicapture",
                                              "triangular", "mesh")
        err, _ = ens_checkpoint_err(os.path.join(rundir_of("ens_mesh"), f"{name[:-2]}{m:02d}"),
                                    os.path.join(rundir_of("ens_serial"), f"{name[:-2]}{m:02d}"),
                                    MESH_STEPS)
        ens_errs[f"m{m:02d}"] = err
        check(err <= ENS_CKPT_RTOL,
              f"mesh (b) ensemble: member {m}'s checkpoint vs its serial run, relative {err}")
    b_rate = (MESH_N_RAND + N_DEPTH) / statistics.median(b["dp"]["times"])
    b_ref_rate = (MESH_N_RAND + N_DEPTH) / statistics.median(ref_dp["times"])
    RATES["mesh_b_two_ranks_gloo"] = b_rate
    launches = {c: sum(r[p]["launches"][c] for r in ranks for p in want_b)
                + grp["launches"][c] + grp["view_launches"][c] for c in want_train}
    emit("mesh", nvidia_smi=nvidia_smi_line(),
         a={"ranks": 1, "backend": "nccl", "steps": MESH_STEPS, "rays_per_step": rays,
            "launches_per_rank": {"train": grp["launches"], "view": grp["view_launches"]},
            "checkpoint_max_rel_err_vs_no_group": a_ckpt_err, "tensors": n_tensors,
            "metrics_max_rel_err_vs_no_group": a_metrics_err,
            "view_max_abs_err_vs_no_group": a_view_err,
            "loop_rays_per_s": a_rate, "loop_rays_per_s_no_group": ref_rate,
            "train_phase_rays_per_s": RATES.get("train"), "call_s": a_call_s},
         b={"ranks": 2, "backend": "gloo", "device": "cuda:0",
            "launches_per_rank": [{p: r[p]["launches"] for p in want_b} for r in ranks],
            "data_parallel": dict(dp, rays_per_step=MESH_N_RAND + N_DEPTH,
                                  step_ms=1e3 * statistics.median(b["dp"]["times"]),
                                  step_ms_one_process=1e3 * statistics.median(ref_dp["times"]),
                                  rays_per_s=b_rate, rays_per_s_one_process=b_ref_rate),
            "data_parallel_trunk_kernels": dict(
                pallas, step_ms=1e3 * statistics.median(b["pallas"]["times"]),
                step_ms_one_process=1e3 * statistics.median(ref_pallas["times"])),
            "ensemble": {"members": 2, "mesh": {"ensemble": 2, "data": 1},
                         "checkpoint_max_rel_err_vs_serial": ens_errs,
                         "seconds": b["ensemble"]["seconds"]},
            "tensor_parallel": dict(tp, rays_per_step=MESH_TP_RAYS + MESH_TP_DEPTH,
                                    step_ms=1e3 * statistics.median(b["tp"]["times"]),
                                    step_ms_one_process=1e3 * statistics.median(
                                        ref_tp["times"])),
            "call_s": b_call_s},
         phase_s=time.perf_counter() - t_phase,
         gates={"a_rel": MESH_A_RTOL, "b_first_step_grad_rel": MESH_GRAD_RTOL,
                "b_pallas_first_step_rel_rms": 2 * trunk_wgrad_rel(
                    (MESH_N_RAND + N_DEPTH) * FLAGSHIP["N_samples"]),
                "b_pallas_first_step_min_cos": MESH_PALLAS_MIN_COS,
                "b_change_rel_rms": MESH_REL_RMS, "b_change_min_cos": MESH_MIN_COS,
                "ensemble_ckpt_rel": ENS_CKPT_RTOL})
    return launches


def kernel_entry(name, source, replaces, launches_by_path, stats):
    """`launches` totals the per-path counts; `launches_by_path` keeps each
    path's own count, reset just before that path and read just after."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": sum(launches_by_path.values()),
             "launches_by_path": launches_by_path,
             "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
             "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
             "bound_by": stats["bound_by"], "library_ms": None}
    if "shape" in stats:
        entry["timed_at"] = stats["shape"]
    for extra in ("fwd_save_acts_max_abs_err",
                  "xla_f32_ms", "bf16_matmul_ms", "bf16_matmul_reduced_ms",
                  "fwd_plus_bwd_ms", "bf16_matmul_autograd_ms",
                  "bf16_matmul_autograd_reduced_ms", "fwd_save_max_abs_err", "fwd_save_ms",
                  "fwd_save_plain_ms", "fwd_save_bound_ms", "fwd_save_bound_by",
                  "fwd_save_timed_at", "members"):
        if extra in stats:
            entry[extra] = stats[extra]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         optional_libraries={name: importlib.util.find_spec(name) is not None
                             for name in ("imageio", "PIL", "cv2", "matplotlib",
                                          "tensorboard")})

    t0 = time.perf_counter()
    logs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, kernels=list(logs),
         ptxas=[ln.strip() for log in logs.values() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    fwd_stats = phase_kernel_checks()
    bwd_stats = phase_bwd_checks()
    phase_many_flows_step()
    flow_stats = phase_flow_stack_time(*phase_flow_stack_checks())
    trunk_stats = phase_trunk_time(phase_trunk_checks())
    trunk_stats["fwd_save_acts_max_abs_err"] = phase_trunk_save_checks()
    phase_trunk_wgrad_checks()
    trunk_bwd_stats, trunk_save_stats = phase_trunk_bwd_time(phase_trunk_bwd_checks())
    trunk_stats.update(trunk_save_stats)
    members = phase_member_kernels()
    for stats, name in ((fwd_stats, "render_core_fwd"), (bwd_stats, "render_core_bwd"),
                        (flow_stats["fwd"], "flow_stack_fwd"),
                        (flow_stats["bwd"], "flow_stack_bwd"),
                        (trunk_stats, "trunk_fwd"), (trunk_bwd_stats, "trunk_bwd")):
        stats["members"] = members[name]
    serve_launches, unfused_launches = phase_serve()
    phase_golden()
    train = phase_train()
    phase_train_golden()
    hier_serve_launches = phase_hier_serve()
    phase_hier_golden()
    hier_train = phase_hier_train()
    phase_graph_step()
    trunk_flat, trunk_hier = phase_trunk_serve()
    trunk_flat_launches = trunk_flat[trunk.trunk_encode.__name__]
    trunk_flat_core = trunk_flat[render_core.fused_flow_composite.__name__]
    trunk_hier_launches = trunk_hier[trunk.trunk_encode.__name__]
    phase_trunk_golden()
    trunk_train, trunk_hier_train = phase_trunk_train()
    phase_trunk_grad_golden()
    bf16_serve = phase_bf16_serve()
    bf16_train = phase_bf16_train()
    phase_bf16_golden()
    occ_serve = phase_occ_serve()
    occ_prop_serve = phase_occ_prop_serve()
    occ_train = phase_occ_train()
    phase_occ_golden()
    data_train = phase_data_train()
    jpeg_train = phase_jpeg()
    with tempfile.TemporaryDirectory(prefix="cfnerf_cli_") as tmp:
        cli_runs = phase_cli(tmp)
        render_only_launches = phase_cli_render_only(cli_runs["cli_train"])
    entry_launches = phase_entry()
    phase_families_golden()
    fam_serve = phase_families_serve()
    fam_train = phase_families_train()
    sample_interp_launches = phase_sample_interp()
    with tempfile.TemporaryDirectory(prefix="cfnerf_cli_families_") as tmp:
        cli_fam = phase_cli_families(tmp)
    with tempfile.TemporaryDirectory(prefix="cfnerf_ensemble_") as tmp:
        ens = phase_ensemble(tmp)
    with tempfile.TemporaryDirectory(prefix="cfnerf_mesh_") as tmp:
        mesh = phase_mesh(tmp)
    emit("rates", rays_per_s=RATES)

    def fam(part, name):
        return sum(counts[name] for counts in part.values())

    # slice 7's paths: the families and baselines take the unfused path, so
    # the render core runs on none of them (0, counted); the trunk kernels
    # run in the pallas cells (a forward a tile; a forward and backward a
    # step); sample and interpolation launch the flow stack (1 + 2)
    core = render_core.fused_flow_composite.__name__
    slice7_core = {"families_serve": fam(fam_serve, core),
                   "families_train": fam(fam_train, core), "cli_families": fam(cli_fam, core)}

    def cli_launches(label, name):
        return sum(part[name] for part in cli_runs[label]["launches"].values())

    # serving: 20 render-core launches a view; training: one render-core
    # forward and backward a step; hierarchical: 4 flow-stack launches (two
    # chains, two passes) a tile or a step, and 4 backward launches a step;
    # trunk_impl="pallas": a trunk launch per pass, 20 a flat view (beside 20
    # render-core launches) and 40 a hierarchical one; training, a trunk
    # forward and backward per pass (the backward's four kernels count as one
    # launch), beside the render core's (flat) or the flow stack's
    # (hierarchical); bf16 on the xla trunk as f32 (20 a view, 1 + 1 a
    # step); placed serving: 20 render-core launches a view, the grid's bake
    # or the proposal's distillation through the flow stack (two launches a
    # density query of 65,536 points); occ training: a render-core forward
    # and backward a step, and two flow-stack launches for the co-training
    # target; data_train: a render-core forward and backward in each of its
    # 10 steps and its resumed step, a forward in each tile of its two views;
    # jpeg_train: a render-core forward and backward in each of its 10 CLI
    # steps, a forward for the val batch and the held-out view, nothing else;
    # cli_train and cli_train_pallas: a render-core forward and backward a
    # step and a forward a val batch, a test-set view, a spiral frame and an
    # evaluated view (a trunk forward beside each with pallas, a trunk
    # backward a step); cli_render_only: a forward a spiral frame; entry: one;
    # ensemble_serial: a render-core forward and backward a member step, a
    # forward a member's val batch, a trunk forward and backward beside them
    # in its pallas run; ensemble_parallel: the member-batched step, one
    # render-core forward and backward (and with pallas one trunk forward and
    # backward) a dispatch for all members, and a forward a val batch for
    # all members; ensemble_eval: a forward a member's evaluated view;
    # ensemble_occ_*: as ensemble_* on the dense steps and the placed ones,
    # the flow stack two launches a density query (a member's distillation,
    # serial: a member's co-training step, --parallel: a dispatch's);
    # ensemble_unfused_*: no render core, the flow stack two launches each
    # way a member step (--parallel: a dispatch), two a val batch (serial: a
    # member's); ensemble_householder_*: a trunk forward a member step and a
    # member's val batch and a backward a member step (--parallel: a
    # dispatch, a val batch for all); ensemble_iaf_*: none; ensemble_remat_*:
    # a render-core forward, its recompute and a backward a member step
    # (--parallel: a dispatch); ensemble_nerf_wild_*, ensemble_nerf_dropout_*,
    # ensemble_nerf_*: none (the baselines' nets, no kernel); mesh: the same
    # per rank on each of its paths,
    # summed over the ranks (phase_mesh)
    def ens_paths(name):
        return {path: counts[name] for path, counts in ens.items()}

    fwd_name, bwd_name = (render_core.fused_flow_composite.__name__,
                          render_core.fused_flow_composite_bwd.__name__)
    print(json.dumps({"kernels": [
        kernel_entry("render_core_fwd", render_core.SOURCE, render_core.REPLACES,
                     {"serve": serve_launches, "train": train["fused_flow_composite"],
                      "trunk_serve": trunk_flat_core,
                      "trunk_train": trunk_train["fused_flow_composite"],
                      "bf16_serve": bf16_serve,
                      "bf16_train": bf16_train["fused_flow_composite"],
                      "occ_serve": occ_serve["view"], "occ_prop_serve": occ_prop_serve["view"],
                      "occ_train": occ_train["fused_flow_composite"],
                      "data_train": data_train["fused_flow_composite"],
                      "jpeg_train": jpeg_train[fwd_name],
                      "cli_train": cli_launches("cli_train", fwd_name),
                      "cli_train_pallas": cli_launches("cli_train_pallas", fwd_name),
                      "cli_render_only": render_only_launches, "entry": entry_launches,
                      **slice7_core, **ens_paths(fwd_name), "mesh": mesh[fwd_name]},
                     fwd_stats),
        kernel_entry("render_core_bwd", render_core.SOURCE_BWD, render_core.REPLACES_BWD,
                     {"train": train["fused_flow_composite_bwd"],
                      "trunk_train": trunk_train["fused_flow_composite_bwd"],
                      "bf16_train": bf16_train["fused_flow_composite_bwd"],
                      "occ_train": occ_train["fused_flow_composite_bwd"],
                      "data_train": data_train["fused_flow_composite_bwd"],
                      "jpeg_train": jpeg_train[bwd_name],
                      "cli_train": cli_launches("cli_train", bwd_name),
                      "cli_train_pallas": cli_launches("cli_train_pallas", bwd_name),
                      "families_train": fam(fam_train, "fused_flow_composite_bwd"),
                      "cli_families": fam(cli_fam, "fused_flow_composite_bwd"),
                      **ens_paths(bwd_name), "mesh": mesh[bwd_name]},
                     bwd_stats),
        kernel_entry("flow_stack_fwd", flow_stack.SOURCE, flow_stack.REPLACES,
                     {"hier_serve": hier_serve_launches,
                      "hier_train": hier_train["fused_flow_stack"],
                      "serve_unfused_check": unfused_launches,
                      "trunk_hier_train": trunk_hier_train["fused_flow_stack"],
                      "occ_serve": occ_serve["bake"], "occ_prop_serve": occ_prop_serve["distill"],
                      "occ_train": occ_train["fused_flow_stack"],
                      "sample_interp": sample_interp_launches,
                      "jpeg_train": jpeg_train["fused_flow_stack"],
                      "families_serve": fam(fam_serve, "fused_flow_stack"),
                      "families_train": fam(fam_train, "fused_flow_stack"),
                      "cli_families": fam(cli_fam, "fused_flow_stack"),
                      **ens_paths("fused_flow_stack"), "mesh": mesh["fused_flow_stack"]},
                     flow_stats["fwd"]),
        kernel_entry("flow_stack_bwd", flow_stack.SOURCE_BWD, flow_stack.REPLACES_BWD,
                     {"hier_train": hier_train["fused_flow_stack_bwd"],
                      "trunk_hier_train": trunk_hier_train["fused_flow_stack_bwd"],
                      "jpeg_train": jpeg_train["fused_flow_stack_bwd"],
                      **ens_paths("fused_flow_stack_bwd"),
                      "mesh": mesh["fused_flow_stack_bwd"]},
                     flow_stats["bwd"]),
        kernel_entry("trunk_fwd", trunk.SOURCE, trunk.REPLACES,
                     {"trunk_serve": trunk_flat_launches,
                      "trunk_hier_serve": trunk_hier_launches,
                      "trunk_train": trunk_train["trunk_encode"],
                      "trunk_hier_train": trunk_hier_train["trunk_encode"],
                      "cli_train_pallas": cli_launches("cli_train_pallas", "trunk_encode"),
                      "jpeg_train": jpeg_train["trunk_encode"],
                      "families_serve": fam(fam_serve, "trunk_encode"),
                      "families_train": fam(fam_train, "trunk_encode"),
                      "cli_families": fam(cli_fam, "trunk_encode"),
                      **ens_paths("trunk_encode"), "mesh": mesh["trunk_encode"]},
                     trunk_stats),
        kernel_entry("trunk_bwd", trunk.SOURCE_BWD, ", ".join(trunk.REPLACES_BWD),
                     {"trunk_train": trunk_train["trunk_encode_bwd"],
                      "trunk_hier_train": trunk_hier_train["trunk_encode_bwd"],
                      "cli_train_pallas": cli_launches("cli_train_pallas", "trunk_encode_bwd"),
                      "jpeg_train": jpeg_train["trunk_encode_bwd"],
                      "families_train": fam(fam_train, "trunk_encode_bwd"),
                      "cli_families": fam(cli_fam, "trunk_encode_bwd"),
                      **ens_paths("trunk_encode_bwd"), "mesh": mesh["trunk_encode_bwd"]},
                     trunk_bwd_stats),
    ]}), flush=True)
    emit("wall", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
