"""Scaled-dot-product attention, plain PyTorch (counterpart of
scldm_tpu/ops/attention.py `sdpa_xla` and `sdpa_shared_q_xla`).

Layout (batch, seq, heads, head_dim) throughout; scores and softmax in f32.
The TPU package's flash kernels (long self-attention, many-query cross
attention) are not on the ported path yet, so there is no dispatch here.
"""

from __future__ import annotations

import math

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v: q (B, M, H, D), k/v (B, S, H, D) -> (B, M, H, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bmhd,bshd->bhms", q.float(), k.float())
    probs = torch.softmax(scores * scale, dim=-1)
    return torch.einsum("bhms,bshd->bmhd", probs.to(v.dtype), v)


def sdpa_shared_q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention with a batch-shared query set: q (M, H, D), k/v (B, S, H, D)
    -> (B, M, H, D). The decoder's canonical gene queries take this path."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("mhd,bshd->bhms", q.float(), k.float())
    probs = torch.softmax(scores * scale, dim=-1)
    return torch.einsum("bhms,bshd->bmhd", probs.to(v.dtype), v)
