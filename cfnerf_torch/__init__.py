"""cfnerf_torch — the PyTorch + CUDA (Hopper) port of cfnerf_tpu.

Layout mirrors cfnerf_tpu so each module's counterpart is easy to find:

  ops/          positional encoding, rays, z schedules, compositing, metrics,
                proposal-placed sampling (occupancy)
  ops/kernels/  hand-written CUDA kernels for sm_90a, their wrappers, plain
                PyTorch versions and the nvcc build (kernel sources: csrc/)
  flows/        the flow families' steps (triangular and general Sylvester,
                planar, IAF) and their amortization; the conv flow layers
  models/       NeRFFlows, the baselines (NeRF, MC-dropout, NeRF-W) and
                their K-sample adapter, the model factory
  render/       ray-batch renderer and the tiled full-image renderer
  train/        losses, Adam with the exponential schedule, the train step
                (and its occ stage), the stage schedules, the dataset
                dispatch, checkpoints and resume
  data/         LLFF and Blender loaders, COLMAP files, pose math, PNG I/O
                and the two resamplers (image_io), the JPEG decoder (jpeg),
                host-side ray precompute, batch samplers and the batch
                prefetcher
  parallel/     several devices over torch.distributed (the mesh, its
                launch) and the ensemble's member axis
  utils/        the flag parser (the JAX package's flags), device selection
  convert.py    weights (and gradients) carried across from a cfnerf_tpu
                params pytree

The package imports torch and never jax or cfnerf_tpu.  Entry points run on
the CUDA device unless the caller passes device="cpu"; on the CPU every
kernel wrapper runs its plain PyTorch version.
"""

import torch as _torch


def _warm_cpu_vector_math() -> None:
    """Run ATen's CPU vector-math library once, single-threaded.

    On the CPU, torch.sin, cos, exp, log, tanh and others call MKL's vector
    math (VML) over each OpenMP thread's share of the tensor.  The first
    such call of a process, when several threads enter it at once, can
    compute one thread's share with the wrong arithmetic: ~1e-4 relative
    error in sin, for every element of that share, in about 2% of fresh
    processes (any of those functions, whichever comes first; later calls
    are right).  A call on 8 elements runs on the calling thread alone
    (below ATen's parallel grain), so the library is set up before any
    parallel call.  The proposal's positional encoding, cast to bf16 and
    inverted through a CDF, turned that into placed depths that changed
    from process to process."""
    _torch.sin(_torch.zeros(8))


_warm_cpu_vector_math()

