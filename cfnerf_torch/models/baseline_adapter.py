"""K-sample adapters for the baseline NeRF models; counterpart of
cfnerf_tpu/models/baseline_adapter.py.  Each baseline answers the call
contract of NeRFFlows.forward,

    forward(x, *, is_test, generator, eps) -> (raw (B, K, 4), 0),

so that the renderer, the train step, the loop and eval run it as they run
the flow model (through the unfused path: the render core is the
triangular flows' kernel):

  * nerf          the one prediction broadcast over the K draws (std over
                  K = 0; trained with MSE);
  * nerf_dropout  K dropout draws a point: fresh masks from the generator
                  in training, fixed ones in test mode, drawn on each call
                  from a generator seeded test_eps_seed (the MC-dropout eval
                  recipe); trained with MSE on the mean draw.  `eps`, where
                  given, is the K draws' masks (a sequence of K mask lists,
                  as NeRFDropout.mask_shapes orders them).  A training
                  forward checkpoints each draw (torch.utils.checkpoint, its
                  masks drawn first): at D8/W512 and 81,920 points the 32
                  draws' activations would need ~80 GB;
  * nerf_wild     K Gaussian draws mu + std * eps with std = softplus + 1e-4,
                  eps (K, 3) shared over points like the flow model's; in
                  test mode the test_eps buffer (its last draw zeroed: the
                  mean sample last), which the converter fills with JAX's
                  draws; trained with the KDE NLL.

baseline_forward_members runs M members of one kind and shape at once (an
ensemble's member-batched step, JAX's vmap of the adapter), each member's
base net on its own points; forward is it at one member.

JAX's dropout masks and eps come from its PRNG, which torch cannot
reproduce: the seams (`eps`, the buffer) carry JAX's draws in tests.
"""
from __future__ import annotations

import copy
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cfnerf_torch.models.nerf import NeRF, NeRFDropout, NeRFWild
from cfnerf_torch.ops.compositing import softplus

BASELINE_KINDS = ("nerf", "nerf_dropout", "nerf_wild")


def wild_test_eps(k_samples: int, seed: int) -> torch.Tensor:
    """nerf_wild's test-mode draws: (K, 3) from torch.Generator(seed), the
    last zeroed (the mean sample)."""
    eps = torch.randn(k_samples, 3, generator=torch.Generator().manual_seed(seed))
    eps[-1] = 0.0
    return eps


class KSampleBaseline(nn.Module):
    """A baseline model (`base`) under the (B, K, 4) raw contract of
    NeRFFlows.  --trunk_impl and --flow_impl do not reach it, as in the JAX
    package; compute_dtype does."""

    def __init__(self, kind: str, k_samples: int, net_depth: int = 8, net_width: int = 256,
                 input_ch: int = 63, input_ch_views: int = 27, skips: Sequence[int] = (4,),
                 use_viewdirs: bool = True, dropout_rate: float = 0.2,
                 compute_dtype: torch.dtype = torch.float32, test_eps_seed: int = 0):
        super().__init__()
        common = dict(depth=net_depth, width=net_width, input_ch=input_ch,
                      input_ch_views=input_ch_views, skips=skips,
                      use_viewdirs=use_viewdirs, compute_dtype=compute_dtype)
        if kind == "nerf":
            self.base = NeRF(**common)
        elif kind == "nerf_dropout":
            self.base = NeRFDropout(**common, dropout_rate=dropout_rate)
        elif kind == "nerf_wild":
            self.base = NeRFWild(**common)
        else:
            raise ValueError(
                f"unknown baseline model {kind!r}; choose from "
                f"{BASELINE_KINDS} or the default flow model"
            )
        self.kind = kind
        self.k_samples = k_samples
        self.test_eps_seed = test_eps_seed
        if kind == "nerf_wild":
            self.register_buffer("test_eps", wild_test_eps(k_samples, test_eps_seed))

    def at_k(self, k: int) -> "KSampleBaseline":
        """This net drawing k samples: a shallow copy that shares every
        parameter (nerf_wild: its own test eps at k from the same seed), as
        JAX's model.clone(k_samples=k) does."""
        view = copy.copy(self)
        view._buffers = dict(self._buffers)
        view.k_samples = k
        if self.kind == "nerf_wild":
            view.test_eps = wild_test_eps(k, self.test_eps_seed).to(self.test_eps.device)
        return view

    def _draws(self, is_test: bool, n_points: int, generator: Optional[torch.Generator],
               eps):
        """The draws of a forward on n_points points: injected `eps`
        (nerf_wild's (K, 3), test mode with its last draw zeroed; nerf_
        dropout's K mask lists), the fixed test draws, or fresh training
        draws from `generator` (nerf_dropout's K mask lists, each in
        NeRFDropout.mask_shapes order, as its forward consumes them;
        nerf_wild's (K, 3) eps); None for nerf."""
        dev = self.base.trunk.pts_linears[0].weight.device
        if self.kind == "nerf":
            return None
        if eps is not None:
            if self.kind == "nerf_dropout":
                return [[torch.as_tensor(m, dtype=torch.bool).to(dev) for m in masks]
                        for masks in eps]
            eps = torch.as_tensor(eps, dtype=torch.float32).to(dev)
            if is_test:  # the mean sample last, as the flows do
                eps = eps.clone()
                eps[-1] = 0.0
            return eps
        if is_test:
            if self.kind == "nerf_dropout":
                return _FixedMasks(self.base, self.k_samples, n_points, self.test_eps_seed, dev)
            return self.test_eps
        if generator is None:
            # a stochastic model trained without draws would freeze its masks
            # or eps into a fixed ensemble
            raise ValueError(f"a training forward of {self.kind} needs a torch.Generator")
        if self.kind == "nerf_dropout":
            return [self.base.draw_masks(n_points, generator) for _ in range(self.k_samples)]
        return torch.randn(self.k_samples, 3, generator=generator,
                           device=generator.device).to(dev)

    def train_eps(self, n_points: int, generator: Optional[torch.Generator], eps):
        """The draws of a training forward on n_points points, made ahead of
        it (the step's activation checkpointing replays them; the batched
        loss draws before it embeds the points)."""
        return self._draws(False, n_points, generator, eps)

    def test_draws(self, n_points: int):
        """The test-mode draws of a forward on n_points points: nerf_wild's
        test_eps, nerf_dropout's fixed masks (drawn anew from
        torch.Generator(test_eps_seed) on each pass over them), None for
        nerf; the counterpart of NeRFFlows.test_draws."""
        return self._draws(True, n_points, None, None)

    def forward(self, x: torch.Tensor, *, is_test: bool = False,
                generator: Optional[torch.Generator] = None,
                eps=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw (B, K, 4) and the entropy 0: baseline_forward_members at one
        member."""
        draws = self._draws(is_test, x.shape[0], generator, eps)
        raw, entropy = baseline_forward_members([self], x[None], [draws], is_test=is_test)
        return raw, entropy[0]


class _FixedMasks:
    """nerf_dropout's test-mode draws: K mask lists from a generator seeded
    test_eps_seed on the device, drawn anew on each pass, one draw's masks
    at a time (a serving tile's K draws' masks would not fit at once)."""

    def __init__(self, base: NeRFDropout, k: int, n_points: int, seed: int, device):
        self.base, self.k, self.n_points, self.seed, self.device = (
            base, k, n_points, seed, device)

    def __iter__(self) -> Iterator[List[torch.Tensor]]:
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        for _ in range(self.k):
            yield self.base.draw_masks(self.n_points, generator)


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    """Members' per-point tensors joined along the points; one member's as
    it is."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def baseline_forward_members(models: Sequence[KSampleBaseline], x: torch.Tensor,
                             draws: Sequence, *, is_test: bool = False
                             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The forward of M baselines of one kind and shape at once, the member
    axis first: x (M, B, input_ch [+ views]), draws each member's
    (KSampleBaseline.train_eps / test_draws).  Each member's base net runs
    on its own points through its own nn.Linear layers, and so does
    nerf_wild's f32 tail (softplus of the std head, mu + std * eps with the
    member's (K, 3) eps): member m's arithmetic is its own forward's.
      * nerf: the prediction expanded over K (the members' predictions
        joined, then expanded: a stride-0 view, as one member's);
      * nerf_dropout: each member's K draws on its own masks, each draw
        checkpointed in a training forward (its activations recomputed in
        the backward from its masks: the K draws' would not fit);
      * nerf_wild: mu + std * eps over the K draws, the density expanded.
    KSampleBaseline.forward is this at one member.  Returns raw (M * B, K,
    4), the points member-major, and the M entropies, 0."""
    first = models[0]
    if len({m.kind for m in models}) > 1:
        raise ValueError("baseline_forward_members takes members of one kind")
    M, B = x.shape[:2]
    K = first.k_samples
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if first.kind == "nerf":
        pred = _cat([m.base(x[i]) for i, m in enumerate(models)])
        return pred[:, None, :].expand(M * B, K, 4), [zero] * M
    raws = []
    if first.kind == "nerf_dropout":
        replay = torch.is_grad_enabled() and not is_test
        for i, (m, masks_k) in enumerate(zip(models, draws)):
            out = []
            for masks in masks_k:
                if replay:
                    # the backward recomputes one draw's trunk at a time from
                    # its masks: the K draws' activations are never all held
                    out.append(checkpoint(m.base, x[i], masks=masks, use_reentrant=False))
                else:
                    out.append(m.base(x[i], masks=masks))
            raws.append(torch.stack(out, 1))
        return _cat(raws), [zero] * M
    for i, (m, eps_r) in enumerate(zip(models, draws)):
        out = m.base(x[i])  # rgb (3), raw std (1), density (1)
        std = softplus(out[..., 3:4]) + 1e-4  # (B, 1)
        rgb_k = out[:, None, :3] + std[:, None, :] * eps_r[None]  # (B, K, 3)
        raws.append(torch.cat([rgb_k, out[:, None, 4:5].expand(B, K, 1)], -1))
    return _cat(raws), [zero] * M
