"""The plain reference of the triangular NeRF_Flows family with its trunk in
bf16 products, as the port's trunk kernels compute it (`--trunk_impl
pallas`), in PyTorch: the family triangular_bf16.

Everything but the trunk is benchmark/reference/triangular.py's, unchanged:
the weights and the step draws, the rays and depths, the encoding, the
amortizers, the flows and the composite in f32, the loss and Adam.  This
module adds the trunk's arithmetic and hands it to that module's render
and loss through the Precision object they take.

The trunk's arithmetic is the one documented for the JAX package's Pallas
trunk (cfnerf_tpu/ops/pallas/trunk.py: `_fwd_mlp` forward, `_trunk_bwd`
backward), which the trunk kernels carry:

  forward   the inputs, the weights and every activation rounded to bf16;
            a product of two bf16 values is exact in f32, and the products
            are summed in f32; the f32 bias added; ReLU on every layer but
            the feature layer and the two heads; the skip layer sums two
            products (x Wsx + h Wsh), the views layer too (f Wvf + v Wvv);
            h_alpha and h_rgb come out in f32;
  backward  both operands of every product rounded to bf16, the cotangents
            included, the sums in f32; the ReLU's mask where the bf16
            activation is positive; each bias gradient summed from the f32
            gradient; no gradient for the input (it is data).

It is written a layer at a time: each of the trunk's nn.Linears
(pts_linears, feature_linear, views_linear, h_alpha_linear, h_rgb_linear)
is a `_Rounded` product, and triangular.heads strings them together with
its ReLUs and concatenations.  That is the whole trunk's arithmetic above:
rounding to nearest keeps a value's sign, so rounding a ReLU's output (the
next product's operand) is the ReLU of the rounded value, and its mask is
where the rounded activation is positive; a concatenation makes one
product of two parts, whose f32 sum is the sum of the two products; the
gradient at a fork (the last layer's output feeds h_alpha and the feature)
is the f32 sum of its two products, rounded as the next product's operand.
It imports neither the program nor JAX.

Precision names, as the harness and benchmark/calibrate.py pass them:

  "f32"   the configuration's own precision: the trunk's operands in bf16,
          everything else in f32 with TF32 off;
  "tf32"  its control, the precision just below: the trunk's operands
          rounded to float8_e4m3fn, the H100's next tensor-core precision,
          each tensor first scaled by a power of two that puts its largest
          magnitude at or under e4m3's largest finite value (448), as an
          FP8 product is fed (else the cotangents, ~1e-6, would all round
          to zero); everything else as in "f32".

The harness's names (benchmark/reference/triangular.py's docstring):
make_weights, StepDraws, pixel_rays and PER_RAY_DRAWS are triangular's;
train_steps and render_test are triangular's with this family's Precision.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

from . import triangular as base
from .triangular import PER_RAY_DRAWS, StepDraws, make_weights, pixel_rays  # noqa: F401

E4M3_MAX = 448.0  # float8_e4m3fn's largest finite value

Round = Callable[[torch.Tensor], torch.Tensor]


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest), held in f32."""
    return t.to(torch.bfloat16).float()


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8_e4m3fn (to nearest) after a power-of-two scale
    that puts its largest magnitude at or under 448, held in f32 at t's
    scale."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = torch.exp2(torch.floor(torch.log2(E4M3_MAX / amax)))
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _Rounded(torch.autograd.Function):
    """One trunk layer's product, y = r(x) r(W)^T + b: both operands rounded
    by r, the products and their sums in f32, the f32 bias added after.
    Backward: dx = r(g) r(W) (only where x needs one), dW = r(g)^T r(x),
    db = the f32 g summed over the rows."""

    @staticmethod
    def forward(ctx, x, w, b, r: Round):
        xr, wr = r(x), r(w)
        ctx.r = r
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t() + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.r(g)
        dx = gr @ wr if ctx.needs_input_grad[0] else None
        return dx, gr.t() @ xr, g.sum(0), None


def trunk_layers(depth: int) -> List[str]:
    """The names of one net's trunk layers (triangular's weight names)."""
    return ([f"pts_linears.{i}" for i in range(depth)]
            + ["feature_linear", "views_linear", "h_alpha_linear", "h_rgb_linear"])


class Precision(base.Precision):
    """How this family multiplies: the trunk's layers, known by their weight
    tensors, as `_Rounded` products in bf16 ("f32") or e4m3 ("tf32");
    every other nn.Linear as triangular's Precision("f32"), which also
    keeps TF32 off on the card (`active`)."""

    def __init__(self, matmul: str, trunk_weights: Iterable[torch.Tensor]):
        if matmul not in ("f32", "tf32"):
            raise ValueError(f"matmul must be 'f32' or 'tf32', got {matmul!r}")
        super().__init__("f32")
        self.round = round_bf16 if matmul == "f32" else round_e4m3
        self.trunk = {id(w) for w in trunk_weights}

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if id(w) in self.trunk:
            return _Rounded.apply(x, w, b, self.round)
        return super().linear(x, w, b)


def _trunk_weights(nets: Dict[str, base.Weights], m: base.Model) -> List[torch.Tensor]:
    depth = {"coarse": m.depth, "fine": m.depth_fine}
    return [w[f"{name}.weight"] for n, w in nets.items() for name in trunk_layers(depth[n])]


def render_test(nets: Dict[str, base.Weights], flags: Dict, rays_o, rays_d, near: float,
                far: float, matmul: str = "f32",
                block: int = 1024) -> Dict[str, torch.Tensor]:
    """Test-mode maps of rays (R, 3), as triangular.render_test gives them,
    the trunk in this family's precision `matmul`."""
    m = base.model_of(flags)
    p = Precision(matmul, _trunk_weights(nets, m))
    eps = {k: (v["test_eps_a"], v["test_eps_r"]) for k, v in nets.items()}
    z = base.depth_schedule(m.n_samples, near, far, rays_o.device)
    parts = []
    with torch.no_grad(), p.active():
        for lo in range(0, rays_o.shape[0], block):
            o, d = rays_o[lo:lo + block], rays_d[lo:lo + block]
            out = base.render(p, nets, m, o, d, z.expand(o.shape[0], -1), eps, train=False)
            parts.append({k: out[k] for k in ("rgb_map", "depth_map", "acc_map")})
    return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}


def train_steps(nets: Dict[str, base.Weights], flags: Dict,
                steps: Sequence[Tuple[dict, dict]], near: float, far: float,
                matmul: str = "f32"):
    """Steps from the given weights over (batch, draws) pairs, as
    triangular.train_steps takes them, the trunk in this family's precision
    `matmul`.  Returns each step's loss, the first step's gradient by leaf
    ("net/name") and each leaf's change over all the steps."""
    m = base.model_of(flags)
    leaves = {f"{n}/{k}": v.detach().clone().requires_grad_(True)
              for n, net in nets.items() for k, v in net.items() if not k.startswith("test_eps")}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    weights = {n: {k: leaves[f"{n}/{k}"] for k in net if not k.startswith("test_eps")}
               for n, net in nets.items()}
    p = Precision(matmul, _trunk_weights(weights, m))
    opt = base.Adam(leaves.values(), m.lrate, m.lrate_decay)
    losses, first_grads = [], None
    with p.active():
        for batch, draws in steps:
            value = base.loss(p, weights, m, batch, draws, near, far)
            grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
            grads = [torch.zeros_like(q) if g is None else g for q, g in zip(leaves.values(), grads)]
            if first_grads is None:
                first_grads = dict(zip(leaves, (g.detach().clone() for g in grads)))
            opt.step(grads)
            losses.append(float(value.detach()))
    change = {k: (v.detach() - start[k]) for k, v in leaves.items()}
    return losses, first_grads, change
