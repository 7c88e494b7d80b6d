"""Scaled-dot-product attention (counterpart of scldm_tpu/ops/attention.py
`sdpa_xla`, `sdpa_shared_q` and `sdpa_shared_q_xla`).

Layout (batch, seq, heads, head_dim) throughout; scores and softmax in f32.
`sdpa_shared_q` dispatches to the flash cross-attention kernel
(`ops.fused_cross.flash_cross_attention`) under JAX's own opt-in gate: with
`SCLDM_FLASH_CROSS=1` in the environment, on CUDA tensors (JAX: on a TPU),
at a wide model unpooling a long query axis into few keys (the census
decoder's gene queries). The long self-attention kernel of the JAX package
(`ops.flash_attention`) is not ported yet: `sdpa` is plain attention.
"""

from __future__ import annotations

import math
import os

import torch

# JAX's flash-cross gates, carried over: off unless SCLDM_FLASH_CROSS=1 (JAX
# measured the kernel a loss inside its census train step); at least 4,096
# queries, at most 128 keys, E >= 256 and a head width that is a multiple of 8.
_FLASH_CROSS_ENABLED = os.environ.get("SCLDM_FLASH_CROSS", "0") == "1"
_FLASH_CROSS_MIN_Q = 4096
_FLASH_CROSS_MAX_KV = 128
_FLASH_CROSS_MIN_E = 256


def _flash_cross_shapes_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """JAX's shape gates: q (M, H, D), k (B, S, H, D)."""
    M_, H, hd = q.shape
    return (
        M_ >= _FLASH_CROSS_MIN_Q
        and k.shape[1] <= _FLASH_CROSS_MAX_KV
        and H * hd >= _FLASH_CROSS_MIN_E
        and hd % 8 == 0
    )


def _use_flash_cross(q: torch.Tensor, k: torch.Tensor) -> bool:
    """JAX `_use_flash_cross`, its TPU backend test become CUDA tensors. A
    shape the kernel is not built for (`fused_cross.KERNEL_SHAPES`) passes
    and raises at launch: it never quietly takes the plain path instead."""
    return _FLASH_CROSS_ENABLED and q.is_cuda and _flash_cross_shapes_ok(q, k)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v: q (B, M, H, D), k/v (B, S, H, D) -> (B, M, H, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bmhd,bshd->bhms", q.float(), k.float())
    probs = torch.softmax(scores * scale, dim=-1)
    return torch.einsum("bhms,bshd->bmhd", probs.to(v.dtype), v)


def sdpa_shared_q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention with a batch-shared query set: q (M, H, D), k/v (B, S, H, D)
    -> (B, M, H, D). The decoder's canonical gene queries take this path;
    under the flash-cross gate it is the kernel (heads are contiguous in E,
    so the split and the flatten cost nothing)."""
    if _use_flash_cross(q, k):
        from scldm_torch.ops.fused_cross import flash_cross_attention

        M_, H, hd = q.shape
        B, S = k.shape[0], k.shape[1]
        y = flash_cross_attention(q.reshape(M_, H * hd).contiguous(),
                                  k.reshape(B, S, H * hd).contiguous(),
                                  v.reshape(B, S, H * hd).contiguous(), H)
        return y.reshape(B, M_, H, hd)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("mhd,bshd->bhms", q.float(), k.float())
    probs = torch.softmax(scores * scale, dim=-1)
    return torch.einsum("bhms,bshd->bmhd", probs.to(v.dtype), v)
