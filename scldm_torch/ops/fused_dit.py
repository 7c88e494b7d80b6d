"""The adaLN-zero DiT block as one hand-written CUDA kernel.

Counterpart of scldm_tpu/ops/fused_dit.py: `dit_block` replaces the Pallas
`fused_dit_block` and `fused_dit_forward` drives it through a whole DiT in
the CFG sampler. The kernel is `scldm_torch/kernels/csrc/dit_block.cu`.

`dit_block` launches the kernel on a CUDA tensor and runs the plain PyTorch
version `dit_block_reference` on a CPU tensor; any other device raises.
`DIT_BLOCK_LAUNCHES` counts kernel launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

#: fused-kernel weight order; matrices are (in, out) row-major, biases (out,)
WEIGHT_NAMES = ("wada", "bada", "wqkv", "bqkv", "wproj", "bproj", "w1", "w2", "wmlp")

#: shared memory one CTA may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024


class LaunchCounter:
    """Number of kernel launches since the last reset."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


DIT_BLOCK_LAUNCHES = LaunchCounter()


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Non-affine LayerNorm over the last dim, f32."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def dit_block_reference(
    x: torch.Tensor, c: torch.Tensor, weights: Dict[str, torch.Tensor], n_head: int, eps: float
) -> torch.Tensor:
    """Plain f32 PyTorch version of one block (`_block_math` in the JAX package).

    x (R, T, E), c (R, E) -> (R, T, E) f32."""
    w = {k: weights[k].float() for k in WEIGHT_NAMES}
    R, T, E = x.shape
    x = x.float()
    mod = F.silu(c.float()) @ w["wada"] + w["bada"]
    # chunk 0 multiplies and chunk 1 shifts (the reference's swapped modulate)
    scale_a, shift_a, gate_a, scale_m, shift_m, gate_m = mod[:, None, :].chunk(6, dim=-1)

    h = _ln(x, eps) * (1.0 + scale_a) + shift_a
    q, k, v = (h @ w["wqkv"] + w["bqkv"]).chunk(3, dim=-1)
    hd = E // n_head
    q, k, v = (a.reshape(R, T, n_head, hd).transpose(1, 2) for a in (q, k, v))
    p = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / hd**0.5), dim=-1)
    attn = (p @ v).transpose(1, 2).reshape(R, T, E)
    x = x + gate_a * (attn @ w["wproj"] + w["bproj"])

    h2 = _ln(x, eps) * (1.0 + scale_m) + shift_m
    mlp = (F.silu(h2 @ w["w1"]) * (h2 @ w["w2"])) @ w["wmlp"]
    return x + gate_m * mlp


def dit_block_smem_bytes(T: int, E: int, n_head: int, hidden: int) -> int:
    """Dynamic shared memory of one CTA: x, h, qkv-or-hidden, silu(c), mod and
    the scores (the layout in dit_block.cu)."""
    return 4 * (2 * T * E + T * max(3 * E, hidden) + 7 * E + n_head * T * T)


def _check_shapes(x, c, weights, n_head) -> int:
    R, T, E = x.shape
    hidden = weights["w1"].shape[1]
    want = {
        "wada": (E, 6 * E), "bada": (6 * E,), "wqkv": (E, 3 * E), "bqkv": (3 * E,),
        "wproj": (E, E), "bproj": (E,), "w1": (E, hidden), "w2": (E, hidden),
        "wmlp": (hidden, E),
    }
    if tuple(c.shape) != (R, E):
        raise ValueError(f"c must be (R, E) = {(R, E)}, got {tuple(c.shape)}")
    for name, shape in want.items():
        if tuple(weights[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(weights[name].shape)}")
    if E % 4 or hidden % 4 or E % n_head:
        raise ValueError(
            "dit_block needs E % 4 == 0, hidden % 4 == 0 and E % n_head == 0 "
            f"(E={E}, hidden={hidden}, n_head={n_head})"
        )
    smem = dit_block_smem_bytes(T, E, n_head, hidden)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"dit_block needs {smem} bytes of shared memory per row at T={T}, E={E}, "
            f"hidden={hidden}; one CTA has at most {MAX_SMEM_BYTES}"
        )
    return smem


def dit_block(
    x: torch.Tensor, c: torch.Tensor, weights: Dict[str, torch.Tensor], n_head: int, eps: float
) -> torch.Tensor:
    """One adaLN-zero DiT block, x (R, T, E) f32, c (R, E) f32 -> (R, T, E) f32.

    CUDA tensors run the hand-written kernel on the current stream; CPU
    tensors run `dit_block_reference`."""
    if x.device.type == "cpu":
        return dit_block_reference(x, c, weights, n_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"dit_block runs on cuda or cpu tensors, got {x.device}")
    tensors = [x, c, *(weights[k] for k in WEIGHT_NAMES)]
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("dit_block needs contiguous float32 tensors on one device")
    smem = _check_shapes(x, c, weights, n_head)

    from scldm_torch.kernels import build

    lib = build.load()
    R, T, E = x.shape
    out = torch.empty_like(x)
    # the library's CUDA runtime launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_dit_block_forward(
            *(t.data_ptr() for t in tensors), out.data_ptr(),
            R, T, E, n_head, weights["w1"].shape[1], eps, smem, stream,
        )
    build.check(lib, code, "dit_block launch")
    DIT_BLOCK_LAUNCHES.count += 1
    return out


def extract_block_params(block) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from one adaLN `nn.layers.Block`: (in, out)
    contiguous f32 matrices (torch Linear keeps (out, in))."""
    def mat(lin):
        return lin.weight.detach().float().t().contiguous()

    def vec(lin):
        if lin.bias is None:
            return torch.zeros(lin.weight.shape[0], device=lin.weight.device)
        return lin.bias.detach().float().contiguous()

    ada = block.adaln_modulation[1]
    return {
        "wada": mat(ada), "bada": vec(ada),
        "wqkv": mat(block.attn.c_attn), "bqkv": vec(block.attn.c_attn),
        "wproj": mat(block.attn.c_proj), "bproj": vec(block.attn.c_proj),
        "w1": mat(block.mlp.w1), "w2": mat(block.mlp.w2), "wmlp": mat(block.mlp.c_proj),
    }


def fused_dit_forward(
    dit,
    x: torch.Tensor,  # (R, T, E_in)
    t: torch.Tensor,  # (R,)
    cond_vals: Dict[str, torch.Tensor],  # name -> (R,) int ids, nulls included
    block_params: Sequence[Dict[str, torch.Tensor]] | None = None,
) -> torch.Tensor:
    """Whole DiT forward with every block through `dit_block`.

    The condition embedding is the no-dropout sum over the class tables (the
    sampling semantics of `DiT.forward_with_cfg_batched`). `block_params`
    (from `extract_block_params`, one per block) can be made once per
    sampling call instead of once per drift evaluation."""
    if block_params is None:
        block_params = [extract_block_params(b) for b in dit.blocks]
    t_emb = dit.t_embedder(t).float()
    for name, vals in cond_vals.items():
        t_emb = t_emb + dit.class_embeddings[name].weight.float()[vals.long()]

    h = dit.input_proj(x.float()).float()
    h = h + dit.pos_embed.to(h.dtype)
    h = h.contiguous()
    c = t_emb.contiguous()
    for kp in block_params:
        h = dit_block(h, c, kp, dit.n_head, dit.layernorm_eps)

    fl = dit.final_layer
    shift, scale = fl.adaln_modulation(t_emb).chunk(2, dim=-1)
    hf = _ln(h, dit.layernorm_eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return fl.linear(hf).float()

