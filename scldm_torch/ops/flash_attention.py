"""Long-axis flash attention, forward only, as a hand-written CUDA kernel.

Counterpart of scldm_tpu/ops/flash_attention.py: `flash_attention` replaces
the Pallas `flash_attention` (`_flash_kernel`), softmax(q k^T / sqrt(D)) v
with a streaming softmax, no mask, not causal, for q (B, M, H, D) and k, v
(B, S, H, D) -> (B, M, H, D) in q's dtype (float32 or bfloat16 operands;
scores, softmax and accumulator in f32). The kernel
(`scldm_torch/kernels/csrc/flash_attention.cu`) runs both products on the
tensor cores, three TF32 passes a product with f32 operands (which keeps f32
accuracy) and one bf16 pass with bf16 operands; it keeps the (B, H, M, S)
scores out of device memory, takes any M and S, any head width up to 128
(zero-padded on load to a compiled width, as JAX pads to 128 lanes; D > 128
raises) and reads the operands through their strides, so the fused qkv and
kv projections' chunk views need no copy (the head width itself must be
contiguous).

Like JAX's function it has no backward (JAX's raises under `jvp` and
`grad`): called while autograd records a graph through q, k or v it raises
a `RuntimeError`, on every device. `ops.attention.sdpa` takes it only where
no gradient flows, once both axes reach 1,024 tokens.

On CUDA tensors `flash_attention` launches the kernel (or raises on operands
it does not take); on CPU tensors it runs the plain version,
`flash_attention_reference`; any other device raises.
`FLASH_ATTENTION_LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from scldm_torch.ops.attention import records_graph, sdpa_plain
from scldm_torch.ops.fused_dit import LaunchCounter

#: the widest head the kernel takes (JAX pads every head to 128 lanes)
KERNEL_MAX_HEAD_DIM = 128

FLASH_ATTENTION_LAUNCHES = LaunchCounter()

#: The plain version: `sdpa`'s plain path (JAX `sdpa_xla`), f32 scores and
#: softmax materialized, the probabilities cast to v's dtype for the second
#: product. One function serves both.
flash_attention_reference = sdpa_plain


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention needs q (B, M, H, D), k and v (B, S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, M, H, D = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, H, D) or tuple(v.shape) != (B, S, H, D):
        raise ValueError(f"k and v must be (B, S, H, D) = ({B}, S, {H}, {D}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= D <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes head widths 1..{KERNEL_MAX_HEAD_DIM}, "
                         f"got D = {D}")
    if S < 1:
        raise ValueError("flash_attention needs at least one key")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k and v must share one device and one dtype")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the flash_attention kernel needs each head's width contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v: q (B, M, H, D), k and v (B, S, H, D) ->
    (B, M, H, D) in q's dtype. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors; no backward on either."""
    if records_graph(q, k, v):
        raise RuntimeError("flash_attention has no backward (nor has JAX's): call it where no "
                           "gradient flows through q, k or v, or call ops.attention.sdpa, which "
                           "takes the plain path under a gradient")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    _check(q, k, v)
    B, M, H, D = q.shape
    S = k.shape[1]
    out = torch.empty((B, M, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    from scldm_torch.kernels import build

    lib = build.load()
    # the library's CUDA runtime launches on the current device: make it q's
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.scldm_flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, M, S, H, D,
            *(t.stride(i) for t in (q, k, v) for i in (0, 1, 2)),
            int(q.dtype == torch.bfloat16), stream)
    build.check(lib, code, "scldm_flash_attention_forward launch")
    FLASH_ATTENTION_LAUNCHES.count += 1
    return out
