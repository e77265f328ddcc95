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

JAX's dropout masks and eps come from its PRNG, which torch cannot
reproduce: the seams (`eps`, the buffer) carry JAX's draws in tests.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

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

    def train_eps(self, x: torch.Tensor, generator: Optional[torch.Generator], eps):
        """The draws of a training forward on x, made ahead of it (the step's
        activation checkpointing replays them): nerf_dropout's K mask lists,
        nerf_wild's (K, 3) eps, nothing for nerf."""
        if eps is not None or self.kind == "nerf":
            return eps
        self._need_generator(False, generator)
        if self.kind == "nerf_dropout":
            return [self.base.draw_masks(x.shape[0], generator) for _ in range(self.k_samples)]
        return torch.randn(self.k_samples, 3, generator=generator, device=generator.device)

    def _need_generator(self, is_test, generator) -> None:
        if not is_test and generator is None:
            # a stochastic model trained without draws would freeze its masks
            # or eps into a fixed ensemble
            raise ValueError(f"a training forward of {self.kind} needs a torch.Generator")

    def forward(self, x: torch.Tensor, *, is_test: bool = False,
                generator: Optional[torch.Generator] = None,
                eps=None) -> Tuple[torch.Tensor, torch.Tensor]:
        B, K = x.shape[0], self.k_samples
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.kind == "nerf":
            return self.base(x)[:, None, :].expand(B, K, 4), zero
        if eps is None:
            self._need_generator(is_test, generator)

        if self.kind == "nerf_dropout":
            if eps is None and is_test:  # fixed masks: the same on every call
                generator = torch.Generator(device=x.device).manual_seed(self.test_eps_seed)
            replay = torch.is_grad_enabled() and not is_test
            draws = []
            for k in range(K):
                masks = eps[k] if eps is not None else self.base.draw_masks(B, generator)
                if replay:
                    # the backward recomputes one draw's trunk at a time from
                    # its masks: the K draws' activations are never all held
                    draws.append(checkpoint(self.base, x, masks=masks, use_reentrant=False))
                else:
                    draws.append(self.base(x, masks=masks))
            return torch.stack(draws, 1), zero

        out = self.base(x)  # rgb (3), raw std (1), density (1)
        std = softplus(out[..., 3:4]) + 1e-4  # (B, 1)
        if eps is not None:
            eps_r = torch.as_tensor(eps, dtype=torch.float32).to(x.device)
            if is_test:  # the mean sample last, as the flows do
                eps_r = eps_r.clone()
                eps_r[-1] = 0.0
        elif is_test:
            eps_r = self.test_eps
        else:
            eps_r = torch.randn(K, 3, generator=generator, device=generator.device).to(x.device)
        rgb_k = out[:, None, :3] + std[:, None, :] * eps_r[None]  # (B, K, 3)
        raw = torch.cat([rgb_k, out[:, None, 4:5].expand(B, K, 1)], -1)
        return raw, zero
