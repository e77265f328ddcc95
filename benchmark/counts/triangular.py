"""The work of a step and a tile of the triangular NeRF_Flows family
(CF-NeRF's published model, fused or hierarchical), summed from the kernel
counts of benchmark/counts/work.py, and the least time of the port's flow
and composite kernels on its path.  A configuration names its family
("family" in benchmark/configs/<config>.json), and the metric readers take
the counts from benchmark/counts/<family>.py."""
from __future__ import annotations

from typing import Dict

from benchmark.counts.work import (
    Z_ALPHA,
    Z_RGB,
    bound_ms,
    flow_stack_bwd_work,
    flow_stack_work,
    render_core_bwd_work,
    render_core_work,
    trunk_bwd_work,
    trunk_work,
)



def amortizer_macs(ha: int, hr: int, F: int) -> int:
    """Multiply-adds a point of the two triangular amortizers' heads: amor_d
    (F Z^2), amor_diag1, amor_diag2 and amor_b (F Z each) from h_alpha and
    h_rgb."""
    return ha * F * (Z_ALPHA ** 2 + 3 * Z_ALPHA) + hr * F * (Z_RGB ** 2 + 3 * Z_RGB)


def embed_channels(multires: int, multires_views: int):
    return 3 + 6 * multires, 3 + 6 * multires_views


def _net(m: Dict, fine: bool):
    depth = m["netdepth_fine"] if fine else m["netdepth"]
    width = m["netwidth_fine"] if fine else m["netwidth"]
    in_ch, v_ch = embed_channels(m["multires"], m["multires_views"])
    return depth, width, in_ch, v_ch, m["h_alpha_size"], m["h_rgb_size"]


def passes(m: Dict, n_rays: int):
    """Each pass of a render of n_rays rays: (is_fine, points)."""
    out = [(False, n_rays * m["N_samples"])]
    if m.get("N_importance", 0):
        out.append((True, n_rays * (m["N_samples"] + m["N_importance"])))
    return out


def linear_ops(m: Dict, n_rays: int, train: bool) -> float:
    """f32 operations of every nn.Linear of a render of n_rays rays (the
    trunk, its heads and the amortizers), forward, and in training also
    the backward's weight and data gradients (none into the embedding)."""
    total = 0
    F = m["n_flows"]
    for fine, B in passes(m, n_rays):
        net = _net(m, fine)
        total += trunk_work(B, *net)[1]
        amor = 2 * amortizer_macs(m["h_alpha_size"], m["h_rgb_size"], F) * B
        total += amor
        if train:
            total += trunk_bwd_work(B, *net)[1] + 2 * amor
    return float(total)


def linear_bytes(m: Dict, n_rays: int, train: bool) -> float:
    """Bytes that the same layers need at least: trunk_work's (and
    trunk_bwd_work's) count."""
    total = 0
    for fine, B in passes(m, n_rays):
        net = _net(m, fine)
        total += trunk_work(B, *net)[0] + (trunk_bwd_work(B, *net)[0] if train else 0)
    return float(total)


def flow_kernel_work(m: Dict, n_rays: int, train: bool, backward: bool):
    """(bytes, operations) of the flow and composite kernels of a render of
    n_rays rays: the render core's one launch without a fine pass, or the
    flow stack's two launches a pass (density and rgb chains) with one.
    Forward, or with `backward` the backward kernels'."""
    K, F, S = m["K_samples"], m["n_flows"], m["N_samples"]
    if not m.get("N_importance", 0):
        fn = render_core_bwd_work if backward else render_core_work
        return fn(n_rays, S, K, F, train)
    fn = flow_stack_bwd_work if backward else flow_stack_work
    nbytes = ops = 0
    for _, B in passes(m, n_rays):
        for Z in (Z_ALPHA, Z_RGB):
            b, o = fn(B, K, Z, F, train)
            nbytes, ops = nbytes + b, ops + o
    return nbytes, ops


# the unfused composite's operations a (point, draw), counted as in
# render_core_work (33 forward) and render_core_bwd_work (42 in reverse)
COMPOSITE_OPS, COMPOSITE_BWD_OPS = 33, 42


def model_ops(m: Dict, n_rays: int, train: bool) -> float:
    """The model's operations for a render of n_rays rays (with `train`,
    forward and backward of a training step): every nn.Linear, the flows
    and the composite; nothing recomputed, the embedding and the loss left
    out."""
    total = linear_ops(m, n_rays, train) + flow_kernel_work(m, n_rays, train, False)[1]
    if train:
        total += flow_kernel_work(m, n_rays, train, True)[1]
    if m.get("N_importance", 0):
        K = m["K_samples"]
        for _, B in passes(m, n_rays):
            total += B * K * (COMPOSITE_OPS + (COMPOSITE_BWD_OPS if train else 0))
    return float(total)


def kernel_bound_ms(m: Dict, kernel: str, n_rays: int, train: bool, backward: bool) -> float:
    """The least time (ms) of a kernel family's launches in one render of
    n_rays rays: the render core's one launch, or the flow stack's one a
    chain and pass, each at the larger of its operations over the f32 peak
    and its bytes over the HBM bandwidth."""
    K, F = m["K_samples"], m["n_flows"]
    if kernel == "render_core":
        fn = render_core_bwd_work if backward else render_core_work
        return bound_ms(*fn(n_rays, m["N_samples"], K, F, train))[0]
    fn = flow_stack_bwd_work if backward else flow_stack_work
    return sum(bound_ms(*fn(B, K, Z, F, train))[0]
               for _, B in passes(m, n_rays) for Z in (Z_ALPHA, Z_RGB))


def launches_per_render(m: Dict, kernel: str) -> int:
    """Launches of a kernel family (each way) in one render: the render
    core's one, or the flow stack's two (density and rgb chains) a pass."""
    return 1 if kernel == "render_core" else 2 * len(passes(m, 1))
