"""Transformer building blocks (counterpart of scldm_tpu/nn/layers.py).

Module and parameter names follow the reference's PyTorch modules, which is
what `scldm_tpu.utils.torch_import.export_torch_state_dict` emits, so
weights move between the two packages with a plain `load_state_dict`.
Matmuls run in the parameters' dtype; LayerNorm and softmax run in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scldm_torch.ops.attention import sdpa, sdpa_shared_q


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Adaptive LayerNorm modulation."""
    return x * (1.0 + scale) + shift


class LayerNormFP32(nn.Module):
    """LayerNorm computed in f32 and cast back; `affine=False` has no params."""

    def __init__(self, n: int, eps: float = 1e-8, affine: bool = True):
        super().__init__()
        self.n, self.eps = n, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(n))
            self.bias = nn.Parameter(torch.zeros(n))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), (self.n,), w, b, self.eps).to(x.dtype)


class InputTransformerVAE(nn.Module):
    """Gene-embedding table (row 0 is <MASK>) scaled by log1p(count): the
    `agg_func: log1p` input layer every shipped config uses."""

    def __init__(self, n_genes: int, n_embed: int):
        super().__init__()
        self.gene_embedding = nn.Embedding(n_genes + 1, n_embed)

    def forward(self, counts: torch.Tensor, genes: torch.Tensor) -> torch.Tensor:
        emb = self.gene_embedding(genes)
        return emb * torch.log1p(counts[..., None].to(emb.dtype))

    def embed_genes(self, genes: torch.Tensor) -> torch.Tensor:
        return self.gene_embedding(genes)


class SelfAttention(nn.Module):
    """Fused-qkv multi-head self-attention."""

    def __init__(self, n_embed: int, n_head: int, bias: bool = False):
        super().__init__()
        self.n_head = n_head
        self.c_attn = nn.Linear(n_embed, 3 * n_embed, bias=bias)
        self.c_proj = nn.Linear(n_embed, n_embed, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        q, k, v = (a.reshape(B, S, self.n_head, D // self.n_head)
                   for a in self.c_attn(x).chunk(3, dim=-1))
        return self.c_proj(sdpa(q, k, v).reshape(B, S, D))


class CrossAttention(nn.Module):
    """Cross-attention: k/v from x, queries projected separately. 2-D queries
    (M, E) are shared by the whole batch; 3-D queries (B, M, E) are not."""

    def __init__(self, n_embed: int, n_head: int, bias: bool = False):
        super().__init__()
        self.n_head = n_head
        self.c_attn = nn.Linear(n_embed, 2 * n_embed, bias=bias)
        self.c_attn_q = nn.Linear(n_embed, n_embed, bias=bias)
        self.c_proj = nn.Linear(n_embed, n_embed, bias=bias)

    def forward(self, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        M, D = q.shape[-2], q.shape[-1]
        hd = D // self.n_head
        k, v = (a.reshape(B, S, self.n_head, hd) for a in self.c_attn(x).chunk(2, dim=-1))
        q = self.c_attn_q(q)
        if q.ndim == 2:
            y = sdpa_shared_q(q.reshape(M, self.n_head, hd), k, v)
        else:
            y = sdpa(q.reshape(B, M, self.n_head, hd), k, v)
        return self.c_proj(y.reshape(B, M, D))


class MLP(nn.Module):
    """SwiGLU MLP, hidden = 2/3 * 4E rounded up to a multiple of `multiple_of`."""

    def __init__(self, n_embed: int, multiple_of: int = 4):
        super().__init__()
        hidden = int(2 * (n_embed * 4) / 3)
        hidden = multiple_of * ((hidden + multiple_of - 1) // multiple_of)
        self.w1 = nn.Linear(n_embed, hidden, bias=False)
        self.w2 = nn.Linear(n_embed, hidden, bias=False)
        self.c_proj = nn.Linear(hidden, n_embed, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.silu(self.w1(x)) * self.w2(x))


class Block(nn.Module):
    """Pre-LN transformer block, optionally adaLN-zero conditioned."""

    def __init__(
        self,
        n_embed: int,
        n_head: int,
        bias: bool = False,
        multiple_of: int = 4,
        layernorm_eps: float = 1e-8,
        use_adaln: bool = False,
        elementwise_affine: bool = True,
    ):
        super().__init__()
        self.use_adaln = use_adaln
        self.ln_1 = LayerNormFP32(n_embed, layernorm_eps, elementwise_affine)
        self.ln_2 = LayerNormFP32(n_embed, layernorm_eps, elementwise_affine)
        self.attn = SelfAttention(n_embed, n_head, bias)
        self.mlp = MLP(n_embed, multiple_of)
        if use_adaln:
            self.adaln_modulation = nn.Sequential(nn.SiLU(), nn.Linear(n_embed, 6 * n_embed))

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.use_adaln:
            x = x + self.attn(self.ln_1(x))
            return x + self.mlp(self.ln_2(x))
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = (
            self.adaln_modulation(condition).chunk(6, dim=-1)
        )
        # the reference calls modulate() with swapped arguments: the chunk
        # named shift multiplies and the one named scale shifts
        x = x + gate_a * self.attn(modulate(self.ln_1(x), scale_a, shift_a))
        return x + gate_m * self.mlp(modulate(self.ln_2(x), scale_m, shift_m))


class CrossAttentionBlock(nn.Module):
    """The MCAB. With `n_inducing_points > 0` learned queries pool the token
    axis; with 0 the caller's queries unpool it. out = q + attn(ln(x), ln(q)),
    then a SwiGLU residual."""

    def __init__(
        self,
        n_embed: int,
        n_inducing_points: int,
        n_head: int,
        bias: bool = False,
        multiple_of: int = 4,
        layernorm_eps: float = 1e-8,
    ):
        super().__init__()
        if n_inducing_points > 0:
            self.inducing_points = nn.Parameter(torch.zeros(n_inducing_points, n_embed))
        self.ln_1 = LayerNormFP32(n_embed, layernorm_eps)
        self.ln_1q = LayerNormFP32(n_embed, layernorm_eps)
        self.ln_2 = LayerNormFP32(n_embed, layernorm_eps)
        self.attn = CrossAttention(n_embed, n_head, bias)
        self.mlp = MLP(n_embed, multiple_of)

    def forward(self, x: torch.Tensor, q: Optional[torch.Tensor] = None) -> torch.Tensor:
        if q is None:
            q = self.inducing_points.to(x.dtype).expand(x.shape[0], -1, -1)
        out = self.attn(self.ln_1(x), self.ln_1q(q)) + (q[None] if q.ndim == 2 else q)
        return out + self.mlp(self.ln_2(out))


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding -> 2-layer MLP."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            nn.Linear(frequency_embedding_size, hidden_size),
            nn.SiLU(),
            nn.Linear(hidden_size, hidden_size),
        )

    @staticmethod
    def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10_000) -> torch.Tensor:
        half = dim // 2
        freqs = torch.exp(
            -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t_freq = self.timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(t_freq.to(self.mlp[0].weight.dtype))


def get_1d_sincos_pos_embed(embed_dim: int, seq_len: int) -> np.ndarray:
    """Frozen 1-D sin-cos positional table (seq_len, embed_dim), numpy."""
    if embed_dim % 2:
        raise ValueError("embedding dimension must be even")
    positions = np.arange(seq_len, dtype=np.float32).reshape(-1, 1)
    omega = np.arange(embed_dim // 2, dtype=np.float32) / (embed_dim / 2.0)
    omega = 1.0 / (10_000**omega)
    out = positions * omega.reshape(1, -1)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


class FinalLayerDiT(nn.Module):
    """adaLN-modulated output projection (zero-initialised in the reference)."""

    def __init__(
        self, n_embed: int, n_embed_input: int, bias: bool = True, layernorm_eps: float = 1e-8
    ):
        super().__init__()
        self.adaln_modulation = nn.Sequential(nn.SiLU(), nn.Linear(n_embed, 2 * n_embed, bias=bias))
        self.norm_final = LayerNormFP32(n_embed, layernorm_eps, affine=False)
        self.linear = nn.Linear(n_embed, n_embed_input, bias=bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaln_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(self.norm_final(x), shift, scale))
