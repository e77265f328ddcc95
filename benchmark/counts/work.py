"""Operations and bytes of the port's kernels and of the model's work, and
the peaks they are held against.

The kernel counts (`render_core_work`, `render_core_bwd_work`,
`flow_stack_work`, `flow_stack_bwd_work`, `trunk_work`, `trunk_bwd_work`) and
`bound_ms` are copies of the repository's `chip_smoke.py` (its kernel phases
hold each kernel's time against them).  What a configuration's step or tile
adds up from them is its family's (benchmark/counts/<family>.py).
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # bf16 dense, tensor cores

Z_ALPHA, Z_RGB = 1, 3


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


def trunk_acts(depth, width, in_ch, v_ch):
    """bf16 values a row of the training forward saves for the backward:
    x, v, every layer's output, f and hv."""
    return in_ch + v_ch + depth * width + width + width // 2


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


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
