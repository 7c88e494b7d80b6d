"""Likelihood heads over decoder hidden states, and the scVI baseline's
posterior and NB heads (counterpart of scldm_tpu/nn/heads.py)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from scldm_torch.nn.layers import LayerNormFP32, Linear, linear_f32


def softmax_genes(x: torch.Tensor) -> torch.Tensor:
    """The softmax over the gene axis of (B, G) logits."""
    return torch.softmax(x, dim=1)


class NegativeBinomialTransformerHead(nn.Module):
    """Per-gene NB head.

    mu = softmax(logit / t, over genes) * library_size, the logit of
    compute-dtype products summed in f32 (`linear_f32`) and the softmax in
    f32. With `shared_theta` the logit is Linear(E -> 1)(h) and theta =
    exp(theta_table[genes]) from an (n_genes + 1, 1) f32 table; without it
    `params` is Linear(E -> 2)(h), the logit and log-theta of each gene token.
    theta is exponentiated in f32. `softmax` takes the scaled logits (B, G)
    to their softmax over the genes: under gene-SP each rank holds a range
    of the genes, and `parallel.gene_sp.GeneSP.softmax` spans the ranks."""

    def __init__(self, n_genes: int, n_embed: int, dtype: torch.dtype = torch.float32,
                 shared_theta: bool = True, t: float = 1.0):
        super().__init__()
        self.shared_theta, self.t = shared_theta, t
        self.params = Linear(n_embed, 1 if shared_theta else 2, compute_dtype=dtype)
        if shared_theta:
            self.theta = nn.Embedding(n_genes + 1, 1)

    def forward(
        self,
        h: torch.Tensor,  # (B, G, E)
        genes: torch.Tensor,  # (G,) or (B, G) gene ids
        library_size: torch.Tensor,  # (B, 1)
        softmax: Callable[[torch.Tensor], torch.Tensor] = softmax_genes,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = linear_f32(h, self.params, self.params.compute_dtype)
        if self.shared_theta:
            mu, log_theta = out.squeeze(-1), self.theta(genes.long()).squeeze(-1)
        else:
            mu, log_theta = out[..., 0], out[..., 1]
        theta = torch.exp(log_theta.float())
        mu = softmax(mu.float() / self.t) * library_size
        return mu, theta


class GaussianTransformerHead(nn.Module):
    """The Gaussian head's mean: LayerNorm then Linear(E -> 1) per gene
    token, in the compute dtype (no theta)."""

    def __init__(self, n_embed: int, layernorm_eps: float = 1e-8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNormFP32(n_embed, layernorm_eps)
        self.params = Linear(n_embed, 1, compute_dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.params(self.ln(h)).squeeze(-1)


class GaussianLinearHead(nn.Module):
    """Gaussian posterior head of the scVI baseline: (loc, scale) from two
    dense layers, the log-scale clipped to [-7, 5] and exponentiated in f32."""

    def __init__(self, n_hidden: int, n_latent: int):
        super().__init__()
        self.loc = Linear(n_hidden, n_latent)
        self.scale = Linear(n_hidden, n_latent)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        log_scale = torch.clamp(self.scale(x), -7.0, 5.0)
        return self.loc(x), torch.exp(log_scale.float())


class NegativeBinomialLinearHead(nn.Module):
    """Dense NB head of the scVI baseline: mu = softmax(Linear(h), over genes)
    in f32 times the library; theta = softplus of a per-gene vector (shared,
    initialised to ones) or of a second dense layer (per cell), in f32."""

    def __init__(self, n_genes: int, n_hidden: int, shared_theta: bool = False):
        super().__init__()
        self.n_genes = n_genes
        self.mu = Linear(n_hidden, n_genes)
        if shared_theta:
            self.theta = nn.Parameter(torch.ones(n_genes))
        else:
            self.theta = Linear(n_hidden, n_genes)

    def forward(
        self,
        h: torch.Tensor,  # (B, n_hidden)
        library_size: torch.Tensor,  # (B, 1)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        theta_raw = self.theta if isinstance(self.theta, nn.Parameter) else self.theta(h)
        theta = F.softplus(theta_raw.float())
        mu = torch.softmax(self.mu(h).float(), dim=1) * library_size
        return mu, theta
