"""Likelihood head over decoder hidden states (counterpart of scldm_tpu/nn/heads.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from scldm_torch.nn.layers import Linear, linear_f32


class NegativeBinomialTransformerHead(nn.Module):
    """Per-gene NB head with shared theta.

    mu = softmax(Linear(E -> 1)(h), over genes) * library_size, the logit of
    compute-dtype products summed in f32 (`linear_f32`) and the softmax in
    f32; theta = exp(theta_table[genes]) from an (n_genes + 1, 1) f32 table,
    in f32."""

    def __init__(self, n_genes: int, n_embed: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.params = Linear(n_embed, 1, compute_dtype=dtype)
        self.theta = nn.Embedding(n_genes + 1, 1)

    def forward(
        self,
        h: torch.Tensor,  # (B, G, E)
        genes: torch.Tensor,  # (G,) or (B, G) gene ids
        library_size: torch.Tensor,  # (B, 1)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = linear_f32(h, self.params, self.params.compute_dtype).squeeze(-1)
        theta = torch.exp(self.theta(genes.long()).float()).squeeze(-1)
        mu = torch.softmax(mu.float(), dim=1) * library_size
        return mu, theta
