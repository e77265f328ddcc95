"""Device selection for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
With no CUDA device and no explicit device="cpu" they raise: they never run
on the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None means the CUDA device.  Raises when CUDA is asked for (or
    defaulted to) and absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        # Full f32 products everywhere: TF32 keeps ~3 decimal digits and
        # would move the trunk away from the f32 reference.  PyTorch's
        # matmul default is already off, cuDNN's is on; both set explicitly.
        # bf16 products (--compute_dtype bfloat16) sum in f32 and round once,
        # as XLA's do: no bf16 partial sums between split-K slices.  These
        # settings are process-wide: every product of the process follows
        # them once a CUDA device has been resolved.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
