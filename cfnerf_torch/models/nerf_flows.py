"""NeRFFlows — the CF-NeRF probabilistic radiance field; counterpart of
cfnerf_tpu/models/nerf_flows.py (reference model/models.py:13-291), with
every flow family the JAX package implements: triangular (the flagship),
householder and orthogonal (general Sylvester), planar, IAF and no_flow.

A D x W ReLU trunk with a skip concat after layer D//2 emits two
conditioning vectors, h_alpha (density) and h_rgb (view-dependent rgb).
Global learnable base parameters (alpha_mean/std, rgb_mean/std) define
N(mu, sigma^2); K base draws z0 = mu + sigma * eps, with eps SHARED across
all points (models.py:234,246), go through two amortized flow stacks of the
family `type_flows` (no_flow: none; it has no amortizers, its draws do not
depend on x, and so the trunk gets no gradient, as in the JAX package).
Outputs are pre-softplus density and pre-sigmoid rgb; their activation
log-det corrections fold into the entropy term.

The trunk runs as nn.Linear layers (trunk_impl="xla", the default, as in
the JAX package), in f32 or, with compute_dtype=torch.bfloat16, in bf16 on
f32 parameters, or, with trunk_impl="pallas", through the trunk
kernels' bf16 products (cfnerf_torch/ops/kernels/trunk.py), forward and
backward, within the kernels' domain (trunk.supported); trunk_impl=
"interpret" runs their plain versions within JAX's domain for its Pallas
trunk (interpret_supported), which is wider.  The unfused forward's flow stacks run through the flow-stack
kernel (flow_impl "auto" or "pallas") or its plain version ("xla" or
"interpret"); the fused forward's render core through its kernel or, with
interpret=True, its plain version.  Both kernels are the triangular
family's: the other families' flows are plain PyTorch (no Pallas kernel
computes them either) and take the unfused forward only.

`forward_composited_members` runs M ensemble members' fused forwards at
once: the trunk kernels and the render core launched once for all of them
(a member axis), the xla trunk and the amortizers member by member through
each member's own modules; forward_composited is it at one member.
`forward_members` does the same for the unfused forward of any family:
the triangular flow-stack kernel launched once a chain for all members, the
other families' eager flows once on the members' joined points (IAF's
through each member's own MADE layers); forward is it at one member.

Test mode uses fixed eps buffers with the LAST of the K draws zeroed (the
mean sample) and skips the log-dets.  A fresh model draws its buffers from
torch.Generator(test_eps_seed); torch cannot reproduce JAX's PRNG, so these
differ from the JAX model's `_test_eps`.  Loading converted weights
(cfnerf_torch.convert) carries the JAX buffers across.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from cfnerf_torch.flows.amortized import (
    AmortizedGeneralSylvester,
    AmortizedPlanar,
    AmortizedTriangularSylvester,
)
from cfnerf_torch.flows.iaf import IAFNeRF
from cfnerf_torch.flows.sylvester import general_sylvester_step, planar_step
from cfnerf_torch.ops.compositing import softplus
from cfnerf_torch.ops.kernels.flow_stack import fused_flow_stack, fused_flow_stack_plain
from cfnerf_torch.ops.kernels.render_core import (
    fused_flow_composite,
    fused_flow_composite_plain,
)
from cfnerf_torch.ops.kernels.trunk import (
    MAX_WIDTH,
    pack_member_trunk_weights,
    pack_trunk_weights,
    trunk_encode,
)
from cfnerf_torch.ops.kernels.trunk import supported as trunk_supported
from cfnerf_torch.utils.trace import count, span

Z_ALPHA = 1  # density latent dim
Z_RGB = 3    # rgb latent dim
TRUNK_IMPLS = ("xla", "pallas", "interpret")
# --compute_dtype: the xla trunk's arithmetic (cfnerf_tpu/models/factory.py:33)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the flow-stack kernel ("auto", "pallas") or its plain version ("xla",
# "interpret"), as cfnerf_tpu's --flow_impl picks the Pallas kernel or XLA
FLOW_IMPLS = ("auto", "xla", "pallas", "interpret")

FLOW_FAMILIES = ("triangular", "householder", "orthogonal", "planar", "IAF", "no_flow")
INTERP_STEPS = 21  # the latent walk: 10 steps z1 -> mean, 11 mean -> z2

Eps = Tuple[torch.Tensor, torch.Tensor]
LANE = 128  # JAX's Pallas trunk tiles its widths by the TPU's 128 lanes


def interpret_supported(depth: int, width: int, use_viewdirs: bool,
                        skips: Sequence[int]) -> bool:
    """The domain of trunk_impl="interpret": JAX's own rule for its Pallas
    trunk (cfnerf_tpu/ops/pallas/trunk.py:supported, with the skip check of
    cfnerf_tpu/models/nerf_flows.py:encode): the viewdirs topology with one
    skip after layer depth // 2, depth >= 3, widths W and W / 2 in whole
    128-lane tiles, any head widths.  The plain version it runs has no
    limit of its own beyond the topology."""
    return (use_viewdirs and tuple(skips) == (depth // 2,) and depth >= 3
            and width % LANE == 0 and (width // 2) % LANE == 0)


def _dense_f32(layer: nn.Linear, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """One nn.Linear over the concatenation of `parts`."""
    return layer(parts[0] if len(parts) == 1 else torch.cat(parts, -1))


def _dense_bf16(layer: nn.Linear, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """cfnerf_tpu's TorchDense in bf16 (cfnerf_tpu/utils/init.py:71-78):
    weight and bias cast per call, y = bias + p0 @ W0 + p1 @ W1 + ..., one
    product per part of the concatenation over its columns of the weight,
    each product and each add rounded to bf16 in that order.  addmm would
    add the bias before the rounding and differ from JAX in the last bit.
    A column-parallel layer (parallel/mesh.py) computes its own columns so
    and gathers them: a column split changes no column's arithmetic."""
    enter = getattr(layer, "enter", None)
    if enter is not None:
        parts = [enter(p) for p in parts]
    w = layer.weight.to(torch.bfloat16)
    y = layer.bias.to(torch.bfloat16)
    off = 0
    for p in parts:
        n = p.shape[-1]
        y = y + p @ w[:, off:off + n].T
        off += n
    return y if enter is None else layer.leave(y)


def fixed_eps(k_samples: int, seed: int) -> Eps:
    g = torch.Generator().manual_seed(seed)
    eps_a = torch.randn(k_samples, Z_ALPHA, generator=g)
    eps_r = torch.randn(k_samples, Z_RGB, generator=g)
    eps_a[-1] = 0.0
    eps_r[-1] = 0.0
    return eps_a, eps_r


def flow_chain(type_flows: str, n_flows: int, z0: torch.Tensor, params: Sequence,
               compute_log_det: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eager flow stack of the householder, orthogonal and planar
    families (and no_flow's identity) on (B, K, Z) latents, given their
    amortizer's per-point parameters (B, ...) (the flow steps of
    cfnerf_tpu/models/nerf_flows.py:316-346).  Every operation is per point
    (the sums run over the tiny Z axis), so the points may be several
    members' joined.  Returns (z, log-det (B, K))."""
    zeros = torch.zeros(z0.shape[:-1], dtype=z0.dtype, device=z0.device)
    if type_flows == "no_flow":
        return z0, zeros
    z, ldj = z0, zeros
    if type_flows == "planar":
        u, w, b = params
        for k in range(n_flows):
            z, ld = planar_step(z, u[..., k], w[..., k], b[..., k])
            ldj = ldj + ld
        return z, (ldj if compute_log_det else zeros)
    if type_flows not in ("householder", "orthogonal"):
        raise ValueError(f"flow_chain has no {type_flows!r} flows")
    r1, r2, q, b = params
    for k in range(n_flows):
        z, ld = general_sylvester_step(z, r1[..., k], r2[..., k], q[..., k], b[..., k],
                                       compute_log_det=compute_log_det)
        ldj = ldj + ld
    return z, ldj


class NeRFFlows(nn.Module):
    def __init__(
        self,
        net_depth: int = 8,
        net_width: int = 256,
        input_ch: int = 63,
        input_ch_views: int = 27,
        skips: Sequence[int] = (4,),
        h_alpha_size: int = 32,
        h_rgb_size: int = 64,
        n_flows: int = 4,
        k_samples: int = 64,
        use_viewdirs: bool = True,
        type_flows: str = "triangular",
        test_eps_seed: int = 0,
        trunk_impl: str = "xla",
        flow_impl: str = "auto",
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if type_flows not in FLOW_FAMILIES:
            # realnvp / glow: the reference's CLI lists them, their sources
            # were deleted upstream (the JAX package's message)
            raise ValueError(
                f"type_flows={type_flows!r} has no implementation "
                "(the reference's realnvp/glow sources were deleted; its "
                "CLI silently trained triangular instead). Supported: "
                "triangular, householder, orthogonal, planar, IAF, no_flow."
            )
        if trunk_impl not in TRUNK_IMPLS:
            raise ValueError(f"trunk_impl must be one of {TRUNK_IMPLS}, got {trunk_impl!r}")
        if flow_impl not in FLOW_IMPLS:
            raise ValueError(f"flow_impl must be one of {FLOW_IMPLS}, got {flow_impl!r}")
        if compute_dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES.values())}, "
                             f"got {compute_dtype!r}")
        # never silently ignore an explicit implementation choice
        if trunk_impl == "pallas" and not trunk_supported(
                net_depth, net_width, use_viewdirs, skips, h_alpha_size, h_rgb_size,
                input_ch, input_ch_views):
            raise ValueError(
                f"trunk_impl='pallas' (the trunk kernels) requires use_viewdirs, skips "
                f"== (depth//2,), 3 <= depth <= 32, width % 32 == 0 and <= {MAX_WIDTH}, "
                f"and head widths % 16 == 0 and <= width; got depth={net_depth}, "
                f"width={net_width}, "
                f"skips={tuple(skips)}, use_viewdirs={use_viewdirs}, heads="
                f"({h_alpha_size}, {h_rgb_size}). Use trunk_impl='interpret' or 'xla' "
                "for this configuration."
            )
        if trunk_impl == "interpret" and not interpret_supported(
                net_depth, net_width, use_viewdirs, skips):
            raise ValueError(
                "trunk_impl='interpret' requires what JAX's Pallas trunk takes: "
                "use_viewdirs, skips == (depth//2,), depth >= 3, width % 128 == 0 and "
                f"(width // 2) % 128 == 0; got depth={net_depth}, width={net_width}, "
                f"skips={tuple(skips)}, use_viewdirs={use_viewdirs}. Use "
                "trunk_impl='xla' for this configuration."
            )
        self.net_depth, self.net_width = net_depth, net_width
        self.input_ch, self.input_ch_views = input_ch, input_ch_views
        self.skips = tuple(skips)
        self.k_samples = k_samples
        self.test_eps_seed = test_eps_seed
        self.use_viewdirs = use_viewdirs
        self.type_flows = type_flows
        self.trunk_impl = trunk_impl
        self.flow_impl = flow_impl
        self.compute_dtype = compute_dtype

        W = net_width
        layers, fan_in = [], input_ch
        for i in range(net_depth):
            layers.append(nn.Linear(fan_in, W))
            fan_in = W + input_ch if i in self.skips else W
        self.pts_linears = nn.ModuleList(layers)
        if use_viewdirs:
            self.feature_linear = nn.Linear(fan_in, W)
            self.views_linear = nn.Linear(W + input_ch_views, W // 2)
            self.h_alpha_linear = nn.Linear(fan_in, h_alpha_size)
            self.h_rgb_linear = nn.Linear(W // 2, h_rgb_size)
        else:
            # the reference crashes here; the intended behaviour: both
            # conditioning vectors from the trunk output
            self.h_alpha_linear = nn.Linear(fan_in, h_alpha_size)
            self.h_rgb_linear = nn.Linear(fan_in, h_rgb_size)

        self.alpha_mean = nn.Parameter(torch.zeros(Z_ALPHA))
        self.alpha_std = nn.Parameter(torch.ones(Z_ALPHA))
        self.rgb_mean = nn.Parameter(torch.zeros(Z_RGB))
        self.rgb_std = nn.Parameter(torch.ones(Z_RGB))

        self.n_flows = n_flows
        # no_flow has no amortizers: JAX never calls its flow submodules, so
        # its params hold none
        self.flows_alpha = self.flows_rgb = None
        if type_flows == "triangular":
            self.flows_alpha = AmortizedTriangularSylvester(h_alpha_size, Z_ALPHA, n_flows)
            self.flows_rgb = AmortizedTriangularSylvester(h_rgb_size, Z_RGB, n_flows)
        elif type_flows in ("householder", "orthogonal"):
            self.flows_alpha = AmortizedGeneralSylvester(h_alpha_size, Z_ALPHA, n_flows,
                                                         q_mode=type_flows)
            self.flows_rgb = AmortizedGeneralSylvester(h_rgb_size, Z_RGB, n_flows,
                                                       q_mode=type_flows)
        elif type_flows == "planar":
            self.flows_alpha = AmortizedPlanar(h_alpha_size, Z_ALPHA, n_flows)
            self.flows_rgb = AmortizedPlanar(h_rgb_size, Z_RGB, n_flows)
        elif type_flows == "IAF":
            self.flows_alpha = IAFNeRF(h_alpha_size, Z_ALPHA, n_flows)
            self.flows_rgb = IAFNeRF(h_rgb_size, Z_RGB, n_flows)

        eps_a, eps_r = fixed_eps(k_samples, test_eps_seed)
        self.register_buffer("test_eps_a", eps_a)
        self.register_buffer("test_eps_r", eps_r)

    # ------------------------------------------------------------------ #

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Trunk + heads (models.py:165-186).  x: (B, input_ch [+ views]).
        Returns (h_alpha, h_rgb) in f32.

        trunk_impl "xla" runs the nn.Linear layers in compute_dtype: f32, or
        bf16 as cfnerf_tpu/models/nerf_flows.py:230-266 computes it (inputs
        cast to bf16, each weight and bias cast per call, so the parameters
        and Adam's state stay f32; the skip and views concatenations as one
        product per part); "pallas" the trunk kernels (their plain versions
        for CPU tensors) on bf16 products; "interpret" the kernels' plain
        versions on any device, as JAX's interpret mode runs the Pallas
        kernels' arithmetic without the kernels.  "pallas" and "interpret"
        ignore compute_dtype, as JAX's pallas_encode does.  Every path
        differentiates as JAX's does.  Their packing of the weights is the
        span cfnerf.trunk.pack and the counter trunk.packs (utils/trace.py,
        while a profile records)."""
        if self.trunk_impl != "xla":
            with span("cfnerf.trunk.pack"):
                packed = pack_trunk_weights(self)
            count("trunk.packs")
            lead = x.shape[:-1]
            x2 = x.reshape(-1, x.shape[-1])
            h_alpha, h_rgb = trunk_encode(packed, x2,
                                          interpret=self.trunk_impl == "interpret")
            return h_alpha.reshape(*lead, -1), h_rgb.reshape(*lead, -1)
        dense = _dense_f32 if self.compute_dtype == torch.float32 else _dense_bf16
        x = x.to(self.compute_dtype)
        input_pts = x[..., : self.input_ch]
        input_views = x[..., self.input_ch:]
        h = (input_pts,)
        for i, layer in enumerate(self.pts_linears):
            h = (torch.relu(dense(layer, h)),)
            if i in self.skips:
                h = (input_pts, h[0])
        if self.use_viewdirs:
            h_alpha = dense(self.h_alpha_linear, h)
            feature = dense(self.feature_linear, h)
            hv = torch.relu(dense(self.views_linear, (feature, input_views)))
            h_rgb = dense(self.h_rgb_linear, (hv,))
        else:
            h_alpha = dense(self.h_alpha_linear, h)
            h_rgb = dense(self.h_rgb_linear, h)
        return h_alpha.float(), h_rgb.float()

    # ------------------------------------------------------------------ #

    def _draw_eps(self, is_test: bool, generator: Optional[torch.Generator],
                  eps: Optional[Eps]) -> Eps:
        """Shared-K base draws for both forward paths: injected eps (test
        mode still zeroes the last draw), the fixed test buffers, or fresh
        training draws from `generator`."""
        dev = self.alpha_mean.device
        if eps is not None:
            eps_a, eps_r = (torch.as_tensor(e, dtype=torch.float32, device=dev)
                            for e in eps)
            if is_test:
                eps_a, eps_r = eps_a.clone(), eps_r.clone()
                eps_a[-1] = 0.0
                eps_r[-1] = 0.0
            return eps_a, eps_r
        if is_test:
            return self.test_eps_a, self.test_eps_r
        if generator is None:
            raise ValueError("a training forward needs a torch.Generator")
        K = self.k_samples
        eps_a = torch.randn(K, Z_ALPHA, generator=generator, device=generator.device)
        eps_r = torch.randn(K, Z_RGB, generator=generator, device=generator.device)
        return eps_a.to(dev), eps_r.to(dev)

    def train_eps(self, n_points: int, generator: Optional[torch.Generator],
                  eps: Optional[Eps]) -> Eps:
        """The draws of a training forward (on any number of points: they
        are shared over them), made ahead of it (the step's activation
        checkpointing replays them)."""
        return self._draw_eps(False, generator, eps)

    def test_draws(self, n_points: int) -> Eps:
        """The test-mode draws of a forward (on any number of points): the
        fixed buffers, the mean draw last."""
        return self._draw_eps(True, None, None)

    def at_k(self, k: int) -> "NeRFFlows":
        """This net drawing k samples: a shallow copy that shares every
        parameter, its own test-mode eps rebuilt at k from the same seed (the
        mean draw last), as JAX's model.clone(k_samples=k) does."""
        view = copy.copy(self)
        view._buffers = dict(self._buffers)  # the eps below replace only the copy's
        view.k_samples = k
        dev = self.test_eps_a.device
        view.test_eps_a, view.test_eps_r = (e.to(dev) for e in fixed_eps(k, self.test_eps_seed))
        return view

    def _base_draws(self, eps_a, eps_r) -> Eps:
        return (eps_a * self.alpha_std + self.alpha_mean,
                eps_r * self.rgb_std + self.rgb_mean)

    def _base_log_density_mean(self, z0_a, z0_r) -> Tuple[torch.Tensor, torch.Tensor]:
        """Elementwise base log-density means (no -0.5 log 2pi;
        models.py:268,283) on the (K, Z) draws: eps is shared over points,
        so this equals the reference's mean over the B-expanded tensor."""
        base_a = -0.5 * (2.0 * torch.log(self.alpha_std)
                         + (z0_a - self.alpha_mean) ** 2 / self.alpha_std ** 2)
        base_r = -0.5 * (2.0 * torch.log(self.rgb_std)
                         + (z0_r - self.rgb_mean) ** 2 / self.rgb_std ** 2)
        return base_a.mean(), base_r.mean()

    def _apply_flows(self, z0: torch.Tensor, h: torch.Tensor, which: str,
                     compute_log_det: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, K, Z) latents through the family's amortized flow stack
        (cfnerf_tpu/models/nerf_flows.py:316-346).  Returns (z, log-det
        (B, K)).  The triangular stack runs through `fused_flow_stack` (the
        flow-stack kernels on the card) or, with flow_impl "xla" or
        "interpret", its plain version; it gets z0 as given (an expanded z0
        is read through a zero point stride) and its parameters contiguous
        (r2 is built from a transpose).  The other families' flows are
        flow_chain's, IAF's its module's."""
        if self.type_flows == "no_flow":
            return flow_chain("no_flow", 0, z0, (), compute_log_det)
        amor = self.flows_alpha if which == "alpha" else self.flows_rgb
        if self.type_flows == "IAF":
            return amor(z0, h, compute_log_det)
        if self.type_flows != "triangular":
            return flow_chain(self.type_flows, self.n_flows, z0, amor(h), compute_log_det)
        stack = (fused_flow_stack if self.flow_impl in ("auto", "pallas")
                 else fused_flow_stack_plain)
        return stack(z0, *(t.contiguous() for t in amor(h)), compute_log_det)

    def forward(
        self,
        x: torch.Tensor,
        *,
        is_test: bool = False,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Eps] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Unfused forward (models.py:188-291): the path of hierarchical
        sampling and applied density noise, and the oracle of the fused path.
        Both flow stacks run through `fused_flow_stack` (the flow-stack
        kernels on the card, as flow_impl="pallas" on the TPU) or, with
        flow_impl "xla" or "interpret", its plain version.

        Returns raw (B, K, 4): pre-sigmoid rgb then pre-softplus density,
        and the entropy loss (0 in test mode).  This is forward_members at
        one member."""
        eps = self._draw_eps(is_test, generator, eps)
        raw, entropy = forward_members([self], x[None], [eps], is_test=is_test)
        return raw, entropy[0]

    def forward_composited(
        self,
        x: torch.Tensor,
        z_pts: torch.Tensor,
        d_pts: torch.Tensor,
        s_per_ray: int,
        *,
        is_test: bool = False,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Eps] = None,
        interpret: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fused render forward: trunk + amortization here, then flows and
        the K-sample composite in the render core (the CUDA kernel on the
        card; with interpret=True its plain version on any device, as
        --fused_render interpret runs JAX's kernel in its interpreter), so
        the (B, K, 4) raw tensor never exists.

        x: (B, input_ch [+ views]), B = R * s_per_ray, sample minor;
        z_pts (B,) sample depths; d_pts (B,) interval * |rays_d|.
        Returns (rgb_map (R, 3, K), depth (R, K), acc (R, K), entropy).
        The triangular family only; any other raises ValueError."""
        if self.type_flows != "triangular":
            raise ValueError(
                "forward_composited requires type_flows='triangular' "
                f"(got {self.type_flows!r})")
        eps = self._draw_eps(is_test, generator, eps)
        rgb_map, depth, acc, entropy = forward_composited_members(
            [self], x[None], z_pts[None], d_pts[None], s_per_ray, [eps], is_test=is_test,
            interpret=interpret)
        return rgb_map, depth, acc, entropy[0]

    # ---------------- latent-space diagnostics (models.py:69-163) ------ #

    def sample(self, x: torch.Tensor) -> torch.Tensor:
        """Density-only K draws through the alpha flow (models.py:69-96):
        the test-mode eps buffers (mean draw last), no log-det.  Returns
        (B, K, 1)."""
        h_alpha, _ = self.encode(x)
        z0_a = self.test_eps_a * self.alpha_std + self.alpha_mean
        z0_a = z0_a[None].expand(h_alpha.shape[0], self.k_samples, Z_ALPHA)
        return self._apply_flows(z0_a, h_alpha, "alpha", False)[0]

    def interpolation(self, x: torch.Tensor, eps: Optional[Eps] = None) -> torch.Tensor:
        """Latent walks z1 -> mean -> z2 through both flows
        (models.py:98-163): 10 steps from z1 to the mean, then 11 from the
        mean to z2, no log-det.  The two end draws eps ((2, 1), (2, 3))
        default to torch.Generator(test_eps_seed + 1), which cannot
        reproduce JAX's PRNGKey(test_eps_seed + 1): pass JAX's draws to match
        it.  Returns (B, 21, 4): rgb then density."""
        h_alpha, h_rgb = self.encode(x)
        dev = self.alpha_mean.device
        if eps is None:
            g = torch.Generator().manual_seed(self.test_eps_seed + 1)
            eps = (torch.randn(2, Z_ALPHA, generator=g), torch.randn(2, Z_RGB, generator=g))
        eps_a, eps_r = (torch.as_tensor(e, dtype=torch.float32).to(dev) for e in eps)
        betas1 = torch.arange(10, dtype=torch.float32, device=dev)[:, None] / 10.0
        betas2 = torch.arange(11, dtype=torch.float32, device=dev)[:, None] / 10.0

        def walk(e, mean, std, zdim):
            z_ends = e * std + mean  # (2, Z)
            mean_b = mean.expand(zdim)
            seg1 = (1 - betas1) * z_ends[0] + betas1 * mean_b
            seg2 = (1 - betas2) * mean_b + betas2 * z_ends[1]
            return torch.cat([seg1, seg2], 0)  # (21, Z)

        B = h_alpha.shape[0]
        walk_a = walk(eps_a, self.alpha_mean, self.alpha_std, Z_ALPHA)
        walk_r = walk(eps_r, self.rgb_mean, self.rgb_std, Z_RGB)
        z_a, _ = self._apply_flows(walk_a[None].expand(B, INTERP_STEPS, Z_ALPHA),
                                   h_alpha, "alpha", False)
        z_r, _ = self._apply_flows(walk_r[None].expand(B, INTERP_STEPS, Z_RGB),
                                   h_rgb, "rgb", False)
        return torch.cat([z_r, z_a], -1)


def _member_heads(models: Sequence[NeRFFlows], x: torch.Tensor) -> list:
    """Each member's (h_alpha, h_rgb) of x (M, B, C): a "pallas" or
    "interpret" trunk runs the members' stacked trunks in one call of the
    trunk kernels (pack_member_trunk_weights), an "xla" trunk (and one
    member's trunk) each member's own encode."""
    first = models[0]
    if first.trunk_impl == "xla" or len(models) == 1:  # one member: its own encode
        return [m.encode(x[i]) for i, m in enumerate(models)]
    h_alpha, h_rgb = trunk_encode(pack_member_trunk_weights(models), x,
                                  interpret=first.trunk_impl == "interpret")
    return list(zip(h_alpha, h_rgb))


def _joined(parts):
    """Members' per-point tensors joined along the points: the kernels read
    contiguous arrays (r2 is built from a transpose), and cat copies each
    member's share in."""
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)


def _cat(parts):
    """Members' per-point tensors joined along the points; one member's as
    it is (an expanded z0 stays a view)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _member_chain(models: Sequence[NeRFFlows], heads: list, z0: list, i: int, B: int,
                  compute_ld: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chain i (0: density, 1: rgb) of M NeRFFlows of one family on their
    points, member-major: each member's (K, Z) base draws expanded over its
    own B points.  The triangular family's stack is one `fused_flow_stack`
    call for all members, its (M, K, Z) base draws beside their joined flow
    parameters (the flow-stack kernel's member axis); the householder,
    orthogonal and planar families' eager flows run once on the joined
    points and parameters (flow_chain); IAF's MADE layers hold each
    member's weights, so each member's chain runs through its own module.
    The amortizers run member by member.  Returns (z (M * B, K, Z), log-det
    (M * B, K))."""
    first = models[0]
    family = first.type_flows
    which = ("flows_alpha", "flows_rgb")[i]
    if family == "triangular":
        stack = (fused_flow_stack if first.flow_impl in ("auto", "pallas")
                 else fused_flow_stack_plain)
        params = [getattr(m, which)(h[i]) for m, h in zip(models, heads)]
        return stack(torch.stack([z[i] for z in z0]), *(_joined(t) for t in zip(*params)),
                     compute_ld)
    K = first.k_samples
    draws = [z[i][None].expand(B, K, z[i].shape[-1]) for z in z0]
    if family == "IAF":
        chains = [getattr(m, which)(d, h[i], compute_ld)
                  for m, h, d in zip(models, heads, draws)]
        return tuple(_cat(t) for t in zip(*chains))
    params = ([] if family == "no_flow" else
              [getattr(m, which)(h[i]) for m, h in zip(models, heads)])
    return flow_chain(family, first.n_flows, _cat(draws), [_cat(t) for t in zip(*params)],
                      compute_ld)


def forward_members(
    models: Sequence[NeRFFlows],
    x: torch.Tensor,
    eps: Sequence[Eps],
    *,
    is_test: bool = False,
) -> Tuple[torch.Tensor, list]:
    """The unfused forward (NeRFFlows.forward) of M NeRFFlows of one
    family and shape at once, the member axis first: x (M, B, input_ch [+
    views]), eps each member's base draws (NeRFFlows._draw_eps).  Member
    m's arithmetic is its own forward's: the trunks as
    forward_composited_members runs them, then each chain (density, rgb)
    for all members as _member_chain runs it (one flow-stack launch a chain
    for the triangular family), then the final-activation log-det
    corrections and each member's entropy from its own points.
    NeRFFlows.forward is this at one member.  Returns raw (M * B, K, 4),
    the points member-major, and the M entropies (0 in test mode)."""
    M, B = x.shape[:2]
    if len({m.type_flows for m in models}) > 1:
        raise ValueError("forward_members takes members of one flow family")
    heads = _member_heads(models, x)
    z0 = [m._base_draws(*e) for m, e in zip(models, eps)]
    compute_ld = not is_test
    z_alpha, ldj_alpha = _member_chain(models, heads, z0, 0, B, compute_ld)
    z_rgb, ldj_rgb = _member_chain(models, heads, z0, 1, B, compute_ld)
    raw = torch.cat([z_rgb, z_alpha], -1)
    if is_test:
        return raw, [torch.zeros((), dtype=raw.dtype, device=raw.device)] * M
    entropy = []
    for i, m in enumerate(models):
        pts = slice(i * B, (i + 1) * B)
        za, zr = z_alpha[pts], z_rgb[pts]
        # final-activation log-det corrections (models.py:261-278)
        ld_a = ldj_alpha[pts] + (za - softplus(za)).sum(-1)
        ld_r = ldj_rgb[pts] + (zr - 2.0 * softplus(zr)).sum(-1)
        base_a, base_r = m._base_log_density_mean(*z0[i])
        entropy.append(base_a - ld_a.mean() + base_r - ld_r.mean())
    return raw, entropy


def forward_composited_members(
    models: Sequence[NeRFFlows],
    x: torch.Tensor,
    z_pts: torch.Tensor,
    d_pts: torch.Tensor,
    s_per_ray: int,
    eps: Sequence[Eps],
    *,
    is_test: bool = False,
    interpret: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, list]:
    """The fused forward (NeRFFlows.forward_composited) of M triangular
    NeRFFlows of one shape at once, the member axis first: x (M, B,
    input_ch [+ views]), z_pts and d_pts (M, B), eps each member's base
    draws (NeRFFlows._draw_eps).  Member m's arithmetic is its own
    forward_composited's: a "pallas" or "interpret" trunk runs the members'
    stacked trunks in one call of the trunk kernels
    (pack_member_trunk_weights), an "xla" trunk (and one member's trunk)
    and the amortizers run member by member through each member's modules;
    the render core takes every member's draws and flow parameters in one
    call.  NeRFFlows.forward_composited is this at one member.  Returns rgb_map
    (M * R, 3, K), depth and acc (M * R, K), the rays member-major, and the
    M entropies (0 in test mode)."""
    first = models[0]
    if any(m.type_flows != "triangular" for m in models):
        raise ValueError("forward_composited_members requires type_flows='triangular'")
    M, B = x.shape[:2]
    heads = _member_heads(models, x)
    z0 = [m._base_draws(*e) for m, e in zip(models, eps)]
    flows_a = [m.flows_alpha(h[0]) for m, h in zip(models, heads)]
    flows_r = [m.flows_rgb(h[1]) for m, h in zip(models, heads)]
    flat = [torch.stack([z[0] for z in z0]), *(_joined(t) for t in zip(*flows_a)),
            torch.stack([z[1] for z in z0]), *(_joined(t) for t in zip(*flows_r)),
            z_pts.reshape(-1).contiguous(), d_pts.reshape(-1).contiguous()]
    core = fused_flow_composite_plain if interpret else fused_flow_composite
    rgb_map, depth, acc, ldj = core(*flat, s_per_ray, not is_test)
    if is_test:
        return rgb_map, depth, acc, [torch.zeros((), dtype=acc.dtype, device=acc.device)] * M
    # as forward(): base terms mean over (K, Z), log-det terms mean over
    # (B, K), each member's rays (the core returns per-ray sums)
    R, denom = B // s_per_ray, B * first.k_samples
    entropy = []
    for i, m in enumerate(models):
        base_a, base_r = m._base_log_density_mean(*z0[i])
        rays = slice(i * R, (i + 1) * R)
        entropy.append(base_a - ldj[0, rays].sum() / denom + base_r - ldj[1, rays].sum() / denom)
    return rgb_map, depth, acc, entropy
