"""Flash cross-attention for many batch-shared queries into few keys (the
decoder's gene queries into the latent tokens), forward as a hand-written
CUDA kernel.

Counterpart of scldm_tpu/ops/fused_cross.py: `flash_cross_attention`
replaces the Pallas `flash_cross_attention` (`_fwd_kernel`), with the same
custom VJP: the backward replays plain f32 attention (`_attn_reference`)
through autograd, as JAX's `_flash_bwd` replays `jax.vjp` of its einsum
reference; the JAX package has no backward kernel. The forward computes

    y[b, g, h] = softmax(qp_h[g] k_h[b]^T / sqrt(hd)) v_h[b]

for qp (G, E), k and v (B, M, E) and n_head heads of hd = E / n_head
columns, with qp, k and v rounded to bf16, the scores in f32 and the
probabilities rounded to bf16 before the second product, in v's dtype; no
(B, H, G, M) tensor reaches device memory. The kernel
(`scldm_torch/kernels/csrc/flash_cross.cu`) runs each head's two products on
the tensor cores (bf16 in, f32 accumulate); it is built for M = 64 keys and
hd = 64 (`KERNEL_SHAPES`, the census decoder's) and raises on other widths.

On CUDA tensors `flash_cross_attention` launches the kernel (or raises on
operands it does not take); on CPU tensors it runs the plain version,
`flash_cross_reference`; any other device raises. `FLASH_CROSS_LAUNCHES`
counts the forward's launches.
"""

from __future__ import annotations

import math

import torch

from scldm_torch.ops.fused_dit import LaunchCounter

#: (keys M, head width hd) the CUDA kernel is built for
KERNEL_SHAPES = ((64, 64),)

FLASH_CROSS_LAUNCHES = LaunchCounter()


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32: where the kernel rounds its operands."""
    return t.to(torch.bfloat16).float()


def _heads(qp, k, v, n_head):
    G, E = qp.shape
    B, M, _ = k.shape
    hd = E // n_head
    return (qp.reshape(G, n_head, hd), k.reshape(B, M, n_head, hd), v.reshape(B, M, n_head, hd),
            1.0 / math.sqrt(hd))


def _attn_reference(qp: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int) -> torch.Tensor:
    """Plain f32 attention on the pre-projected operands (JAX
    `_attn_reference`, the same as `ops.attention.sdpa_shared_q`): the
    function the backward differentiates. -> (B, G, E)."""
    q4, k4, v4, scale = _heads(qp, k, v, n_head)
    s = torch.einsum("ghd,bmhd->bhgm", q4.float(), k4.float())
    p = torch.softmax(s * scale, dim=-1)
    y = torch.einsum("bhgm,bmhd->bghd", p.to(v.dtype), v4)
    return y.reshape(k.shape[0], qp.shape[0], qp.shape[1])


def flash_cross_reference(qp: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_head: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (JAX `_fwd_kernel`'s math): qp, k
    and v rounded to bf16, scores and softmax in f32, the probabilities
    rounded to bf16 before the second product. -> (B, G, E) in v's dtype."""
    q4, k4, v4, scale = _heads(_bf(qp), _bf(k), _bf(v), n_head)
    s = torch.einsum("ghd,bmhd->bhgm", q4, k4)
    p = torch.softmax(s * scale, dim=-1)
    y = torch.einsum("bhgm,bmhd->bghd", _bf(p), v4)
    return y.reshape(k.shape[0], qp.shape[0], qp.shape[1]).to(v.dtype)


def _check(qp, k, v, n_head) -> tuple:
    """Validate the kernel's operands; returns (G, B, M, E)."""
    if qp.ndim != 2 or k.ndim != 3:
        raise ValueError(f"flash_cross needs qp (G, E) and k, v (B, M, E), got {tuple(qp.shape)}, "
                         f"{tuple(k.shape)}")
    G, E = qp.shape
    B, M, _ = k.shape
    if tuple(k.shape) != (B, M, E) or tuple(v.shape) != (B, M, E):
        raise ValueError(f"k and v must be (B, M, E) with E = {E}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if E % n_head:
        raise ValueError(f"flash_cross needs E % n_head == 0 (E={E}, n_head={n_head})")
    if (M, E // n_head) not in KERNEL_SHAPES:
        raise ValueError(f"the flash_cross kernel is built for (M, hd) in {KERNEL_SHAPES}, got "
                         f"({M}, {E // n_head})")
    for t in (qp, k, v):
        if t.device != qp.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the flash_cross kernel needs contiguous float32 tensors on one "
                             "device")
    return G, B, M, E


def flash_cross_fwd(qp: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_head: int) -> torch.Tensor:
    """The forward: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. (B, G, E) in v's dtype. bf16 qp, k and v (all three) are
    upcast for the kernel, which rounds them to bf16 again, so it computes
    what it computes on their f32 values; y is rounded to bf16 as JAX's
    kernel stores it in v's dtype."""
    if qp.device.type == "cpu":
        with torch.no_grad():
            return flash_cross_reference(qp, k, v, n_head)
    if qp.device.type != "cuda":
        raise ValueError(f"flash_cross runs on cuda or cpu tensors, got {qp.device}")
    out_dtype = v.dtype
    if all(t.dtype == torch.bfloat16 for t in (qp, k, v)):
        qp, k, v = (t.float().contiguous() for t in (qp, k, v))
    G, B, M, E = _check(qp, k, v, n_head)
    from scldm_torch.kernels import build

    lib = build.load()
    y = torch.empty((B, G, E), dtype=torch.float32, device=qp.device)
    workspace = torch.empty(2 * B * M * E, dtype=torch.bfloat16, device=qp.device)
    # the library's CUDA runtime launches on the current device: make it qp's
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        code = lib.scldm_flash_cross_forward(qp.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             y.data_ptr(), workspace.data_ptr(), G, B, M, E,
                                             n_head, stream)
    build.check(lib, code, "scldm_flash_cross_forward launch")
    FLASH_CROSS_LAUNCHES.count += 1
    return y.to(out_dtype)


class _FlashCross(torch.autograd.Function):
    """The kernel forward; the backward replays plain attention (JAX
    `_flash_bwd`)."""

    @staticmethod
    def forward(ctx, qp, k, v, n_head):
        ctx.save_for_backward(qp, k, v)
        ctx.n_head = n_head
        return flash_cross_fwd(qp, k, v, n_head)

    @staticmethod
    def backward(ctx, dy):
        qp, k, v = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (qp, k, v)]
        with torch.enable_grad():
            y = _attn_reference(*leaves, ctx.n_head)
            dqp, dk, dv = torch.autograd.grad(y, leaves, dy.to(v.dtype))
        return dqp.to(qp.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_cross_attention(
    qp: torch.Tensor,  # (G, E) projected batch-shared queries
    k: torch.Tensor,  # (B, M, E) projected keys
    v: torch.Tensor,  # (B, M, E) projected values
    n_head: int,
) -> torch.Tensor:
    """softmax(qp_h k_h^T / sqrt(hd)) v_h, heads concatenated -> (B, G, E):
    the kernel forward (on CPU tensors its plain version), differentiable in
    qp, k and v through the replayed plain attention."""
    return _FlashCross.apply(qp, k, v, n_head)
