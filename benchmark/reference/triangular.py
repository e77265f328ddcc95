"""The plain reference of CF-NeRF's render and training step, in PyTorch f32,
for the triangular NeRF_Flows family (fused or hierarchical), with the
random weights and the step draws that the benchmark hands to both sides.

It follows the published model (CF-NeRF, reference `run_nerf_uncertainty_NF.py`
and `model/models.py`; nerf-pytorch's hierarchical sampling) and nothing of
the program under test: it imports neither the port nor JAX, and takes only
what the benchmark hands both sides: the weights (as a state dict keyed by
the names below), the rays, the sample depths and the base draws.  It runs
eagerly, in blocks of rays, with no kernel of its own.

Matrix products run in f32 with TF32 off, or with `matmul="tf32"` in TF32:
on a CUDA device by turning TF32 on, on the CPU by rounding each product's
inputs to TF32's 10-bit mantissa.  TF32 is the control of a configuration
that states f32 with TF32 off: the precision just below it.

Weight names (one net; a hierarchical model has two, "coarse" and "fine"):
  pts_linears.{i}.weight/bias  the D trunk layers, a skip concat [x, h]
                               after layer D // 2
  feature_linear, views_linear, h_alpha_linear, h_rgb_linear  the heads
  alpha_mean, alpha_std, rgb_mean, rgb_std  the base Gaussians
  flows_{alpha,rgb}.amor_{d,diag1,diag2,b}.weight/bias  the amortizers of
                               the triangular Sylvester flows
  test_eps_a (K, 1), test_eps_r (K, 3)  the test-mode base draws

What the harness asks of a family's reference module
(benchmark/reference/<family>.py, named by a configuration's "family"):
make_weights(flags, seed, device), StepDraws(flags, camera, seed, device),
train_steps(nets, flags, steps, near, far, matmul), render_test(nets, flags,
rays_o, rays_d, near, far, matmul), pixel_rays(H, W, focal, c2w, pixels) and
PER_RAY_DRAWS, the step draws that hold a row a ray.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

LAST_DIST = 10.0    # the reference's last interval (1e1, not 1e10)
TRANS_EPS = 1e-10   # 1 - alpha + 1e-10 in the transmittance
LOGDET_EPS = 1e-8   # |1 + tanh' r1_ii r2_ii| + 1e-8
KDE_EPS = 1e-5
PDF_EPS = 1e-5
Z_ALPHA, Z_RGB = 1, 3

Weights = Dict[str, torch.Tensor]
# the step draws (StepDraws) that hold a row a ray, the rgb rays then the
# depth rays; the others are shared by every ray
PER_RAY_DRAWS = ("z_vals", "pdf_u")


@dataclass(frozen=True)
class Model:
    """The shape of one configuration, as the benchmark's config file
    states it."""

    depth: int = 8
    width: int = 512
    depth_fine: int = 8
    width_fine: int = 512
    multires: int = 10
    multires_views: int = 4
    h_alpha: int = 64
    h_rgb: int = 64
    n_flows: int = 4
    k: int = 32
    n_samples: int = 128
    n_importance: int = 0
    white_bkgd: bool = False
    beta1: float = 0.0
    colmap_depth: bool = False
    depth_lambda: float = 0.1
    lrate: float = 5e-4
    lrate_decay: int = 250


def model_of(flags: Dict) -> Model:
    """The reference's view of a configuration's flags."""
    return Model(
        depth=flags["netdepth"], width=flags["netwidth"],
        depth_fine=flags.get("netdepth_fine", 8), width_fine=flags.get("netwidth_fine", 256),
        multires=flags["multires"], multires_views=flags["multires_views"],
        h_alpha=flags["h_alpha_size"], h_rgb=flags["h_rgb_size"], n_flows=flags["n_flows"],
        k=flags["K_samples"], n_samples=flags["N_samples"],
        n_importance=flags.get("N_importance", 0), white_bkgd=flags.get("white_bkgd", False),
        beta1=flags.get("beta1", 0.0), colmap_depth=flags.get("colmap_depth", False),
        depth_lambda=flags.get("depth_lambda", 0.1), lrate=flags.get("lrate", 5e-4),
        lrate_decay=flags.get("lrate_decay", 250))


# ---------------------------------------------------------------------- #
# random weights and step draws, from the seed on the device
# ---------------------------------------------------------------------- #


def linear_shapes(m: Model, fine: bool) -> List[Tuple[str, int, int, bool]]:
    """(name, fan_out, fan_in, followed by a ReLU) of every nn.Linear of one
    net."""
    depth, width = (m.depth_fine, m.width_fine) if fine else (m.depth, m.width)
    in_ch, v_ch = 3 + 6 * m.multires, 3 + 6 * m.multires_views
    ha, hr, F = m.h_alpha, m.h_rgb, m.n_flows
    out, fan_in = [], in_ch
    for i in range(depth):
        out.append((f"pts_linears.{i}", width, fan_in, True))
        fan_in = width + in_ch if i == depth // 2 else width
    out += [("feature_linear", width, fan_in, False),
            ("views_linear", width // 2, width + v_ch, True),
            ("h_alpha_linear", ha, fan_in, False), ("h_rgb_linear", hr, width // 2, False)]
    for chain, h, z in (("flows_alpha", ha, Z_ALPHA), ("flows_rgb", hr, Z_RGB)):
        out += [(f"{chain}.amor_d", F * z * z, h, False), (f"{chain}.amor_diag1", F * z, h, False),
                (f"{chain}.amor_diag2", F * z, h, False), (f"{chain}.amor_b", F * z, h, False)]
    return out


def make_net(m: Model, fine: bool, generator: torch.Generator, device) -> Weights:
    """One net's state dict from one flat uniform draw, each leaf scaled so
    that activations keep their size through the net, as a trained net's
    do: a ReLU layer's weights U(+-sqrt(6/fan_in)) (He), every other layer's
    U(+-sqrt(3/fan_in)) (unit gain), biases U(+-1/sqrt(fan_in)).
    (torch.nn.Linear's default range, U(+-1/sqrt(fan_in)), shrinks a D8 ReLU
    trunk's signal about sixfold a layer, and leaves h_alpha and h_rgb all
    but the last biases.)  The base Gaussians and the test-mode draws come
    beside them."""
    shapes = linear_shapes(m, fine)
    total = sum(o * i + o for _, o, i, _ in shapes)
    flat = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    net, at = {}, 0
    for name, fan_out, fan_in, relu in shapes:
        w = flat[at:at + fan_out * fan_in].view(fan_out, fan_in)
        at += fan_out * fan_in
        b = flat[at:at + fan_out]
        at += fan_out
        net[f"{name}.weight"] = w * ((6.0 if relu else 3.0) / fan_in) ** 0.5
        net[f"{name}.bias"] = b * fan_in ** -0.5
    base = torch.rand(8, generator=generator, device=device) * 0.2 - 0.1
    net["alpha_mean"], net["rgb_mean"] = base[:1].clone(), base[1:4].clone()
    net["alpha_std"], net["rgb_std"] = 1.0 + base[4:5], 1.0 + base[5:8]
    eps = torch.randn(m.k, Z_ALPHA + Z_RGB, generator=generator, device=device)
    eps[-1] = 0.0  # the test draws' last is the mean draw
    net["test_eps_a"], net["test_eps_r"] = eps[:, :1].contiguous(), eps[:, 1:].contiguous()
    return net


def make_weights(flags: Dict, seed: int, device) -> Dict[str, Weights]:
    """{"coarse": state dict[, "fine": state dict]} from the seed, one draw
    a net on the device; the harness hands the same tensors to the program
    and to the reference."""
    m = model_of(flags)
    g = torch.Generator(device=device).manual_seed(seed)
    nets = {"coarse": make_net(m, False, g, device)}
    if m.n_importance:
        nets["fine"] = make_net(m, True, g, device)
    return nets


class StepDraws:
    """The draws of each training step, from the seed, on the device, under
    the program's step's keywords: z_vals, the sample depths of all rays
    (the schedule jittered by uniforms); eps, each net's base draws ((K, 1),
    (K, 3)); and with a fine pass pdf_u, its (R, N_importance) resampling
    uniforms, and eps_fine.  Made in step order by one generator."""

    def __init__(self, flags: Dict, camera: Dict, seed: int, device):
        self.m = model_of(flags)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.z = depth_schedule(self.m.n_samples, camera["near"], camera["far"], device)
        self.device = device

    def __call__(self, n_rays: int) -> Dict:
        g, K, dev = self.gen, self.m.k, self.device
        u = torch.rand(n_rays, self.z.shape[0], generator=g, device=dev)
        out = {"z_vals": jitter(self.z.expand(n_rays, -1), u)}
        eps = torch.randn(K, 4, generator=g, device=dev)
        out["eps"] = (eps[:, :1].contiguous(), eps[:, 1:].contiguous())
        if self.m.n_importance:
            out["pdf_u"] = torch.rand(n_rays, self.m.n_importance, generator=g, device=dev)
            eps = torch.randn(K, 4, generator=g, device=dev)
            out["eps_fine"] = (eps[:, :1].contiguous(), eps[:, 1:].contiguous())
        return out


# ---------------------------------------------------------------------- #
# precision
# ---------------------------------------------------------------------- #


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (8-bit exponent, 10-bit mantissa), to nearest; the
    gradient passes through the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - x.detach())


class Precision:
    """How the reference multiplies matrices: "f32" or "tf32"."""

    def __init__(self, matmul: str = "f32"):
        if matmul not in ("f32", "tf32"):
            raise ValueError(f"matmul must be 'f32' or 'tf32', got {matmul!r}")
        self.matmul = matmul

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.matmul == "tf32" and x.device.type == "cpu":
            x, w = _round_tf32(x), _round_tf32(w)
        return torch.nn.functional.linear(x, w, b)

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        """Within the block, CUDA products run in this precision."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        tf32 = self.matmul == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------------- #
# rays and depths
# ---------------------------------------------------------------------- #


def pixel_rays(H: int, W: int, focal: float, c2w: torch.Tensor,
               pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays through pixels (flat indices j * W + i) of a pinhole camera
    looking down -z: direction [(i - W/2)/f, -(j - H/2)/f, -1] rotated by
    c2w (nerf-pytorch's get_rays: the products summed over the last axis),
    origin c2w's translation."""
    j = torch.div(pixels, W, rounding_mode="floor").to(torch.float32)
    i = (pixels % W).to(torch.float32)
    dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                        -torch.ones_like(i)], -1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    return c2w[:3, 3].expand_as(rays_d), rays_d


def depth_schedule(n: int, near: float, far: float, device) -> torch.Tensor:
    """CF-NeRF's sample depths: 3/4 of them uniform over the first half of
    [near, far], the rest over the second half including far (at n = 128:
    96 + 32, the reference's hard-coded schedule)."""
    n_near = 96 if n == 128 else (3 * n) // 4
    t = np.concatenate([np.linspace(0.0, 0.5, n_near + 1)[:-1], np.linspace(0.5, 1.0, n - n_near)])
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    return near * (1.0 - t) + far * t


def jitter(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stratified jitter: a depth drawn by u in (0, 1) inside the bin that
    the midpoints to its neighbours bound (the ends clamped)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF resampling (nerf-pytorch): depths drawn by u (R, N) from
    the piecewise-constant density `weights` (R, M) over `bins` (R, M+1)."""
    weights = weights + PDF_EPS
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (above - 1).clamp(min=0)
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    span = c1 - c0
    span = torch.where(span < PDF_EPS, torch.ones_like(span), span)
    return b0 + (u - c0) / span * (b1 - b0)


# ---------------------------------------------------------------------- #
# the field
# ---------------------------------------------------------------------- #


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(x), cos(x), sin(2x), cos(2x), ...], each block over all of
    x's coordinates."""
    out = [x]
    for f in range(n_freqs):
        out += [torch.sin(x * 2.0 ** f), torch.cos(x * 2.0 ** f)]
    return torch.cat(out, -1)


def _lin(p: Precision, w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return p.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def heads(p: Precision, w: Weights, depth: int, x_pts: torch.Tensor,
          x_views: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ReLU trunk (skip after layer depth // 2) and its two heads:
    h_alpha from the trunk, h_rgb from the view branch."""
    h = x_pts
    for i in range(depth):
        h = torch.relu(_lin(p, w, f"pts_linears.{i}", h))
        if i == depth // 2:
            h = torch.cat([x_pts, h], -1)
    h_alpha = _lin(p, w, "h_alpha_linear", h)
    feature = _lin(p, w, "feature_linear", h)
    hv = torch.relu(_lin(p, w, "views_linear", torch.cat([feature, x_views], -1)))
    return h_alpha, _lin(p, w, "h_rgb_linear", hv)


def flow_params(p: Precision, w: Weights, name: str, h: torch.Tensor, z: int, f: int):
    """A triangular Sylvester amortizer: per point r1, r2 (B, f, z, z)
    upper-triangular with tanh diagonals (r2's strict upper triangle is the
    transpose of r1's source) and b (B, f, z).  The heads' outputs read
    (z, z, f) and (z, f) with f minor."""
    B = h.shape[0]
    full = _lin(p, w, f"{name}.amor_d", h).reshape(B, z, z, f).permute(0, 3, 1, 2)
    d1 = torch.tanh(_lin(p, w, f"{name}.amor_diag1", h)).reshape(B, z, f).transpose(1, 2)
    d2 = torch.tanh(_lin(p, w, f"{name}.amor_diag2", h)).reshape(B, z, f).transpose(1, 2)
    b = _lin(p, w, f"{name}.amor_b", h).reshape(B, z, f).transpose(1, 2)
    strict = torch.triu(torch.ones(z, z, device=h.device), diagonal=1)
    r1 = full * strict + torch.diag_embed(d1)
    r2 = full.transpose(-1, -2) * strict + torch.diag_embed(d2)
    return r1, r2, b


def flows(z0: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor, b: torch.Tensor,
          log_det: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """F triangular Sylvester steps on z (B, K, Z), the coordinates reversed
    on odd steps: z' = z + P R1 tanh(R2 P z + b).  Returns z and the summed
    log |det J| (B, K)."""
    z, ldj = z0, None
    for k in range(r1.shape[1]):
        flip = k % 2 == 1
        zp = z.flip(-1) if flip else z
        pre = torch.einsum("bij,bkj->bki", r2[:, k], zp) + b[:, k, None, :]
        t = torch.tanh(pre)
        upd = torch.einsum("bij,bkj->bki", r1[:, k], t)
        z = z + (upd.flip(-1) if flip else upd)
        if log_det:
            diag = (torch.diagonal(r1[:, k], dim1=-2, dim2=-1)
                    * torch.diagonal(r2[:, k], dim1=-2, dim2=-1))[:, None, :]
            term = torch.log(torch.abs(1.0 + (1.0 - t * t) * diag) + LOGDET_EPS).sum(-1)
            ldj = term if ldj is None else ldj + term
    return z, ldj


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def field(p: Precision, w: Weights, m: Model, depth: int, rays_o, rays_d, z_vals,
          eps: Tuple[torch.Tensor, torch.Tensor], train: bool):
    """The radiance field's K draws at each sample of each ray: density
    before its softplus (R, S, K), rgb (R, S, K, 3) after its sigmoid, and
    the per-point log-det sums of the entropy (with the final activations'
    corrections), summed over points and draws, with the point-draw count."""
    R, S = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    views = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    x_pts = encode(pts.reshape(R * S, 3), m.multires)
    x_views = encode(views, m.multires_views)[:, None, :].expand(R, S, -1).reshape(R * S, -1)
    h_alpha, h_rgb = heads(p, w, depth, x_pts, x_views)
    eps_a, eps_r = eps
    z0_a = eps_a * w["alpha_std"] + w["alpha_mean"]
    z0_r = eps_r * w["rgb_std"] + w["rgb_mean"]
    B, K = R * S, eps_a.shape[0]
    za, lda = flows(z0_a[None].expand(B, K, Z_ALPHA), *flow_params(
        p, w, "flows_alpha", h_alpha, Z_ALPHA, m.n_flows), log_det=train)
    zr, ldr = flows(z0_r[None].expand(B, K, Z_RGB), *flow_params(
        p, w, "flows_rgb", h_rgb, Z_RGB, m.n_flows), log_det=train)
    entropy = None
    if train:
        base_a = (-0.5 * (2.0 * torch.log(w["alpha_std"])
                          + (z0_a - w["alpha_mean"]) ** 2 / w["alpha_std"] ** 2)).mean()
        base_r = (-0.5 * (2.0 * torch.log(w["rgb_std"])
                          + (z0_r - w["rgb_mean"]) ** 2 / w["rgb_std"] ** 2)).mean()
        ld_a = lda + (za - softplus(za)).sum(-1)
        ld_r = ldr + (zr - 2.0 * softplus(zr)).sum(-1)
        entropy = base_a - ld_a.mean() + base_r - ld_r.mean()
    return (za[..., 0].reshape(R, S, K), torch.sigmoid(zr).reshape(R, S, K, 3), entropy)


def composite(density, rgb, z_vals, rays_d, white_bkgd: bool):
    """Alpha compositing of each draw along the ray: alpha = 1 -
    exp(-softplus(density) * interval * |d|), transmittance the exclusive
    product of (1 - alpha + 1e-10).  Returns rgb (R, 3, K), depth (R, K),
    acc (R, K) and the weights (R, S, K)."""
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full_like(z_vals[:, :1], LAST_DIST)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-softplus(density) * dists[..., None])
    trans = torch.cumprod(1.0 - alpha + TRANS_EPS, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
    weights = alpha * trans
    rgb_map = (weights[..., None] * rgb).sum(1).transpose(1, 2)
    depth = (weights * z_vals[..., None]).sum(1)
    acc = weights.sum(1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None, :])
    return rgb_map, depth, acc, weights


def render(p: Precision, nets: Dict[str, Weights], m: Model, rays_o, rays_d, z_vals,
           eps: Dict[str, Tuple[torch.Tensor, torch.Tensor]], train: bool,
           pdf_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The render of rays at coarse depths z_vals (R, S): one pass through
    nets["coarse"], and with m.n_importance a fine pass through
    nets["fine"] at the union of z_vals and m.n_importance depths resampled
    from the coarse pass's mean-over-K weights (u: pdf_u in training,
    evenly spaced in test mode).  eps holds each net's base draws.
    Returns rgb_map, depth_map, acc_map (and rgb0 and the entropy in
    training)."""
    density, rgb, entropy = field(p, nets["coarse"], m, m.depth, rays_o, rays_d, z_vals,
                                  eps["coarse"], train)
    rgb_map, depth, acc, weights = composite(density, rgb, z_vals, rays_d, m.white_bkgd)
    out = dict(rgb_map=rgb_map, depth_map=depth, acc_map=acc, entropy=entropy)
    if not m.n_importance:
        return out
    mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    if pdf_u is None:
        pdf_u = torch.linspace(0.0, 1.0, m.n_importance,
                               device=z_vals.device).expand(z_vals.shape[0], -1)
    fine = sample_pdf(mids, weights.detach().mean(-1)[:, 1:-1], pdf_u).detach()
    z_all = torch.sort(torch.cat([z_vals, fine], -1), -1).values
    density, rgb, entropy_f = field(p, nets["fine"], m, m.depth_fine, rays_o, rays_d, z_all,
                                    eps["fine"], train)
    rgb_f, depth_f, acc_f, _ = composite(density, rgb, z_all, rays_d, m.white_bkgd)
    return dict(rgb_map=rgb_f, depth_map=depth_f, acc_map=acc_f, rgb0=rgb_map,
                entropy=None if entropy is None else entropy + entropy_f)


def render_test(nets: Dict[str, Weights], flags: Dict, rays_o, rays_d, near: float,
                far: float, matmul: str = "f32",
                block: int = 1024) -> Dict[str, torch.Tensor]:
    """Test-mode maps of rays (R, 3), in blocks of `block` rays, each net's
    fixed test draws: rgb_map (R, 3, K), depth_map and acc_map (R, K)."""
    p, m = Precision(matmul), model_of(flags)
    eps = {k: (v["test_eps_a"], v["test_eps_r"]) for k, v in nets.items()}
    z = depth_schedule(m.n_samples, near, far, rays_o.device)
    parts = []
    with torch.no_grad(), p.active():
        for lo in range(0, rays_o.shape[0], block):
            o, d = rays_o[lo:lo + block], rays_d[lo:lo + block]
            out = render(p, nets, m, o, d, z.expand(o.shape[0], -1), eps, train=False)
            parts.append({k: out[k] for k in ("rgb_map", "depth_map", "acc_map")})
    return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #


def kde_nll(rgbs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-log of the Parzen density of the target under the K draws (R, 3, K),
    bandwidth from their (detached) unbiased std, scaled n / (n - 1)."""
    n = rgbs.shape[-1]
    std = torch.std(rgbs, dim=-1, correction=1) * n / (n - 1)
    h = (std.detach() * (0.8 / n) ** (-1.0 / 7.0) + KDE_EPS)[..., None]
    kernel = torch.exp(-((rgbs - target[..., None]) ** 2) / (2.0 * h * h))
    p = (kernel * ((2.0 * math.pi) ** (-1.5) / h)).mean(-1) + KDE_EPS
    return -torch.log(p).mean()


def loss(p: Precision, nets: Dict[str, Weights], m: Model, batch: Dict[str, torch.Tensor],
         draws: Dict[str, torch.Tensor], near: float, far: float) -> torch.Tensor:
    """One step's loss: the KDE NLL of the rgb rays' draws, beta1 times the
    flows' entropy, depth_lambda times the mean-over-K depth's MSE on the
    COLMAP rays (colmap_depth), and with a fine pass the coarse render's
    NLL.  The batch holds rays_o, rays_d, target (and depth_rays_o,
    depth_rays_d, target_depth); draws hold z_vals for all rays (rgb then
    depth), each net's eps, and pdf_u with a fine pass."""
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    n_rgb = rays_o.shape[0]
    if m.colmap_depth:
        rays_o = torch.cat([rays_o, batch["depth_rays_o"]])
        rays_d = torch.cat([rays_d, batch["depth_rays_d"]])
    eps = {"coarse": draws["eps"]}
    if m.n_importance:
        eps["fine"] = draws["eps_fine"]
    out = render(p, nets, m, rays_o, rays_d, draws["z_vals"], eps, train=True,
                 pdf_u=draws.get("pdf_u"))
    total = kde_nll(out["rgb_map"][:n_rgb], batch["target"])
    if m.beta1:
        total = total + m.beta1 * out["entropy"]
    if m.colmap_depth:
        d = out["depth_map"][n_rgb:].mean(-1)
        total = total + m.depth_lambda * torch.mean((d - batch["target_depth"]) ** 2)
    if m.n_importance:
        total = total + kde_nll(out["rgb0"][:n_rgb], batch["target"])
    return total


class Adam:
    """Adam (0.9, 0.999, eps 1e-8) with the reference's decay: update t
    (from 0) at lrate * 0.1^(t / (lrate_decay * 1000))."""

    def __init__(self, params: Sequence[torch.Tensor], lrate: float, lrate_decay: int):
        self.params = list(params)
        self.m = [torch.zeros_like(q) for q in self.params]
        self.v = [torch.zeros_like(q) for q in self.params]
        self.lrate, self.decay_steps, self.t = lrate, lrate_decay * 1000, 0

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        lr = self.lrate * 0.1 ** (self.t / self.decay_steps)
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        with torch.no_grad():
            for q, g, m, v in zip(self.params, grads, self.m, self.v):
                m.mul_(0.9).add_(g, alpha=0.1)
                v.mul_(0.999).addcmul_(g, g, value=0.001)
                q.sub_(lr / c1 * m / ((v / c2).sqrt() + 1e-8))


def train_steps(nets: Dict[str, Weights], flags: Dict, steps: Sequence[Tuple[dict, dict]],
                near: float, far: float, matmul: str = "f32"):
    """Steps from the given weights over (batch, draws) pairs.  Returns
    each step's loss, the first step's gradient by leaf ("net/name") and
    each leaf's change over all the steps."""
    p, m = Precision(matmul), model_of(flags)
    leaves = {f"{n}/{k}": v.detach().clone().requires_grad_(True)
              for n, net in nets.items() for k, v in net.items() if not k.startswith("test_eps")}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = Adam(leaves.values(), m.lrate, m.lrate_decay)
    losses, first_grads = [], None
    with p.active():
        for batch, draws in steps:
            weights = {n: {k: leaves[f"{n}/{k}"] for k in net if not k.startswith("test_eps")}
                       for n, net in nets.items()}
            value = loss(p, weights, m, batch, draws, near, far)
            grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
            grads = [torch.zeros_like(q) if g is None else g for q, g in zip(leaves.values(), grads)]
            if first_grads is None:
                first_grads = dict(zip(leaves, (g.detach().clone() for g in grads)))
            opt.step(grads)
            losses.append(float(value.detach()))
    change = {k: (v.detach() - start[k]) for k, v in leaves.items()}
    return losses, first_grads, change
