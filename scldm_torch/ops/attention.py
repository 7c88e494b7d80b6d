"""Scaled-dot-product attention (counterpart of scldm_tpu/ops/attention.py
`sdpa`, `sdpa_xla`, `sdpa_shared_q` and `sdpa_shared_q_xla`).

Layout (batch, seq, heads, head_dim) throughout; scores and softmax in f32.
`sdpa` dispatches to the long-axis flash attention kernel
(`ops.flash_attention.flash_attention`) under JAX's gate, its TPU test
become CUDA tensors: once both the query and the key axis reach
`_FLASH_MIN_SEQ` = 1,024 tokens, and only where no gradient flows (JAX's
kernel has no backward: under a gradient its trace fails inside `sdpa`'s
`try`, and JAX computes plain attention; the port tests for the gradient
instead). Otherwise it is the plain path, `sdpa_plain` (JAX `sdpa_xla`).
`sdpa_shared_q` dispatches to the flash cross-attention kernel
(`ops.fused_cross.flash_cross_attention`) under JAX's own opt-in gate: with
`SCLDM_FLASH_CROSS=1` in the environment, on CUDA tensors (JAX: on a TPU),
at a wide model unpooling a long query axis into few keys (the census
decoder's gene queries). Neither gate falls back: a kernel that does not
build or launch raises.
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


# JAX's length gate, kept (scldm_tpu/ops/attention.py:34): both axes at
# least 1,024 tokens. It puts the kernel on the long-latent path (1,024
# inducing points). The H100 crossover (benchmarks_torch/flash_crossover.py,
# in PERF.md and ROADMAP's dispatch constants) lies lower; a redesign of the
# kernel re-derives the constant from a new sweep.
_FLASH_MIN_SEQ = 1024


def _flash_lengths_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """JAX `_use_flash`'s length test: q (B, M, H, D), k (B, S, H, D)."""
    return q.shape[1] >= _FLASH_MIN_SEQ and k.shape[1] >= _FLASH_MIN_SEQ


def records_graph(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether autograd records a graph through q, k or v."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def _use_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """JAX `_use_flash`, its TPU backend test become CUDA tensors, and the
    no-gradient condition that JAX reaches through its failing trace."""
    return q.is_cuda and _flash_lengths_ok(q, k) and not records_graph(q, k, v)


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention (JAX `sdpa_xla`): softmax(q k^T / sqrt(d)) v with f32
    scores and softmax; q (B, M, H, D), k/v (B, S, H, D) -> (B, M, H, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bmhd,bshd->bhms", q.float(), k.float())
    probs = torch.softmax(scores * scale, dim=-1)
    return torch.einsum("bhms,bshd->bmhd", probs.to(v.dtype), v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dispatching attention: the flash attention kernel for long axes on
    CUDA tensors where no gradient flows, the plain path otherwise."""
    if _use_flash(q, k, v):
        from scldm_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v)
    return sdpa_plain(q, k, v)


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
