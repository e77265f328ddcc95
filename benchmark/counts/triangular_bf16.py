"""The work of a step and a tile of the triangular_bf16 family: CF-NeRF's
model with its trunk on the port's bf16 trunk kernels (`--trunk_impl
pallas`), summed from the kernel counts of benchmark/counts/work.py.
Everything but the trunk is counted as benchmark/counts/triangular.py
counts it.

Two peaks.  The trunk's products run on the tensor cores in bf16, so its
operations are held to the bf16 peak (989 TFLOP/s); everything else (the
amortizers' nn.Linears in f32, the flows, the composite) to the f32 peak
(67 TFLOP/s).  `model_ops` gives f32-peak-equivalent operations: the
trunk's operations x 67 / 989, plus the rest.  `mfu` (benchmark/readers.py)
divides them by the f32 peak and the window, so it reads the step's least
time with each operation at its own peak, over the window's time.  (Held
to the f32 peak, the trunk's ~1.14 TFLOP a training step would read well
over 100% of it.)

The trunk kernels' launches: one forward a pass of a render (the serving
variant `trunk_fwd`, or in training `trunk_fwd_save`, which also writes
every bf16 activation for the backward: `trunk_acts`), and in training one
backward (`trunk_bwd`, its four device kernels as one launch), each at the
larger of its operations at the bf16 peak and its bytes at the HBM
bandwidth.
"""
from __future__ import annotations

from typing import Dict

from benchmark.counts import triangular
from benchmark.counts.work import (
    BF16_OPS_PER_S,
    F32_OPS_PER_S,
    Z_ALPHA,
    Z_RGB,
    bound_ms,
    trunk_acts,
    trunk_bwd_work,
    trunk_work,
)


def trunk_kernel_work(m: Dict, B: int, train: bool, backward: bool, fine: bool = False):
    """(bytes, operations) of one trunk launch over B points: the forward
    (with `train`, the saving variant: its activations' bf16 writes added)
    or the backward."""
    net = triangular._net(m, fine)
    if backward:
        return trunk_bwd_work(B, *net)
    nbytes, ops = trunk_work(B, *net)
    return nbytes + (2 * B * trunk_acts(*net[:4]) if train else 0), ops


def trunk_ops(m: Dict, n_rays: int, train: bool) -> float:
    """The trunk's operations of a render of n_rays rays (forward, and in
    training the backward)."""
    return float(sum(trunk_kernel_work(m, B, train, backward, fine)[1]
                     for fine, B in triangular.passes(m, n_rays)
                     for backward in (False, True)[:1 + train]))


def _amortizer_outputs(F: int) -> int:
    """Outputs a point of both chains' amortizers (amor_d, diag1, diag2, b)."""
    return F * (Z_ALPHA ** 2 + 3 * Z_ALPHA) + F * (Z_RGB ** 2 + 3 * Z_RGB)


def linear_ops(m: Dict, n_rays: int, train: bool) -> float:
    """f32 operations of the nn.Linears of a render of n_rays rays, which
    are the amortizers' alone (the trunk is the kernels'): forward, and in
    training also the backward's weight and data gradients."""
    F = m["n_flows"]
    per = 2 * triangular.amortizer_macs(m["h_alpha_size"], m["h_rgb_size"], F)
    return float(sum(per * B * (3 if train else 1) for _, B in triangular.passes(m, n_rays)))


def linear_bytes(m: Dict, n_rays: int, train: bool) -> float:
    """Bytes the amortizers need at least, in f32: h_alpha and h_rgb read,
    their weights and biases read, their outputs written once; in training
    also the outputs' cotangents and the heads read again, the heads'
    gradients and the weight and bias gradients written."""
    ha, hr, F = m["h_alpha_size"], m["h_rgb_size"], m["n_flows"]
    outs = _amortizer_outputs(F)
    params = ha * F * (Z_ALPHA ** 2 + 3 * Z_ALPHA) + hr * F * (Z_RGB ** 2 + 3 * Z_RGB) + outs
    total = 0
    for _, B in triangular.passes(m, n_rays):
        total += 4 * (B * (ha + hr) + params + B * outs)
        if train:
            total += 4 * (B * outs + 2 * B * (ha + hr) + params)
    return float(total)


def model_ops(m: Dict, n_rays: int, train: bool) -> float:
    """The model's f32-peak-equivalent operations for a render of n_rays
    rays (with `train`, forward and backward of a training step): the
    trunk's at 67 / 989, the amortizers', the flows' and the composite's
    as triangular counts them; nothing recomputed, the embedding and the
    loss left out."""
    trunk = trunk_ops(m, n_rays, train)
    return triangular.model_ops(m, n_rays, train) - trunk + trunk * F32_OPS_PER_S / BF16_OPS_PER_S


def kernel_bound_ms(m: Dict, kernel: str, n_rays: int, train: bool, backward: bool) -> float:
    """The least time (ms) of a kernel family's launches in one render of
    n_rays rays: the trunk's one launch a pass at the bf16 peak, the other
    families as triangular bounds them."""
    if kernel != "trunk":
        return triangular.kernel_bound_ms(m, kernel, n_rays, train, backward)
    return sum(bound_ms(*trunk_kernel_work(m, B, train, backward, fine), BF16_OPS_PER_S)[0]
               for fine, B in triangular.passes(m, n_rays))


def launches_per_render(m: Dict, kernel: str) -> int:
    """Launches of a kernel family (each way) in one render: the trunk's one
    a pass, the others as triangular counts them."""
    if kernel == "trunk":
        return len(triangular.passes(m, 1))
    return triangular.launches_per_render(m, kernel)
