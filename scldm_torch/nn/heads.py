"""Likelihood head over decoder hidden states (counterpart of scldm_tpu/nn/heads.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


class NegativeBinomialTransformerHead(nn.Module):
    """Per-gene NB head with shared theta.

    mu = softmax(Linear(E -> 1)(h), over genes) * library_size, in f32;
    theta = exp(theta_table[genes]) from an (n_genes + 1, 1) table."""

    def __init__(self, n_genes: int, n_embed: int):
        super().__init__()
        self.params = nn.Linear(n_embed, 1)
        self.theta = nn.Embedding(n_genes + 1, 1)

    def forward(
        self,
        h: torch.Tensor,  # (B, G, E)
        genes: torch.Tensor,  # (G,) or (B, G) gene ids
        library_size: torch.Tensor,  # (B, 1)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = self.params(h).squeeze(-1)
        theta = torch.exp(self.theta(genes.long()).float()).squeeze(-1)
        mu = torch.softmax(mu.float(), dim=1) * library_size
        return mu, theta
