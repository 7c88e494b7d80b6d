"""Latent priors (counterpart of scldm_tpu/nn/priors.py)."""

from __future__ import annotations

import torch

from scldm_torch.ops.distributions import normal_log_prob


class StandardPrior:
    """N(0, I) over a latent of `n_latent` dimensions; draws come from an
    explicit generator, on its device."""

    def __init__(self, n_latent: int):
        self.n_latent = n_latent

    def sample(self, generator: torch.Generator, n_samples: int) -> torch.Tensor:
        return torch.randn((n_samples, self.n_latent), generator=generator,
                           device=generator.device)

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        return normal_log_prob(z, torch.zeros_like(z), torch.ones_like(z))
