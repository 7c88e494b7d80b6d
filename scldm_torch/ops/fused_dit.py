"""The adaLN-zero DiT block, forward and backward, as hand-written CUDA kernels.

Counterpart of scldm_tpu/ops/fused_dit.py: `dit_block` replaces the Pallas
`fused_dit_block` (kernel `scldm_torch/kernels/csrc/dit_block.cu`),
`dit_block_bwd` its recompute backward `_bwd_pallas`
(`scldm_torch/kernels/csrc/dit_block_bwd.cu`), and `dit_block_trainable`
joins the two under autograd, as `fused_dit_block_trainable` does.
`fused_dit_forward` drives the forward through a whole DiT in the CFG
sampler, `fused_dit_train_apply` both through the DiT trunk in LDM training.

The forward has one design, "tiled": tensor-core GEMMs over all R*T tokens
(a 64-token tile feeds each staged weight tile), a LayerNorm kernel and an
attention that streams the keys, with intermediates in a device workspace
(`dit_block_smem_bytes`, `dit_block_workspace_floats`); no CTA holds a row,
so every T runs. From T = TILED_FLASH_MIN_T its attention stage launches the
long-axis flash attention kernel (`ops/flash_attention.py`'s) on views of the
workspace, from the C side: `FLASH_ATTENTION_LAUNCHES` does not count those,
`DIT_BLOCK_LAUNCHES` counts the block once.

The backward has one design too, on the same stages: it recomputes the
forward into its workspace, runs the backward's token products on the same
GEMM, streams 64-token tiles through an attention backward, takes the
LayerNorm backwards one warp a token, and the weight gradients as
tensor-core GEMMs over the token axis (`dit_block_bwd_smem_bytes`; the C
side sizes its workspace). Its shared memory does not grow with T either,
so T = 16, 64 and 1,024 all run.

`dit_block` and `dit_block_bwd` launch their kernels on CUDA tensors and run
the plain PyTorch versions (`dit_block_reference`,
`dit_block_backward_reference`) on CPU tensors; any other device raises.
`DIT_BLOCK_LAUNCHES` and `DIT_BLOCK_BWD_LAUNCHES` count the wrappers'
launches (one each, whatever the number of kernels behind it), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

#: fused-kernel weight order; matrices are (in, out) row-major, biases (out,)
WEIGHT_NAMES = ("wada", "bada", "wqkv", "bqkv", "wproj", "bproj", "w1", "w2", "wmlp")
#: the matrices among them; the backward kernel also reads these as (out, in)
MATRIX_NAMES = ("wada", "wqkv", "wproj", "w1", "w2", "wmlp")

#: shared memory one CTA may use on Hopper (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
#: tokens per CTA of the tiled products and attention (kBM, kQ in dit_tiled.cuh)
TILED_TOKENS = 64
#: stages in the ring of its products (kStages in dit_tiled.cuh)
TILED_STAGES = 3
#: the widest E its LayerNorm kernel keeps in registers (kMaxVec float4s a lane)
TILED_MAX_E = 512
#: the T from which its attention stage takes the long-axis flash attention
#: kernel (kFlashMinT in dit_block.cu)
TILED_FLASH_MIN_T = 128


class LaunchCounter:
    """Number of kernel launches since the last reset."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


DIT_BLOCK_LAUNCHES = LaunchCounter()
DIT_BLOCK_BWD_LAUNCHES = LaunchCounter()


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Non-affine LayerNorm over the last dim."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def dit_block_reference(
    x: torch.Tensor, c: torch.Tensor, weights: Dict[str, torch.Tensor], n_head: int, eps: float
) -> torch.Tensor:
    """Plain PyTorch version of one block (`_block_math` in the JAX package),
    in f32, or in f64 for f64 inputs.

    x (R, T, E), c (R, E) -> (R, T, E)."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    w = {k: weights[k].to(dtype) for k in WEIGHT_NAMES}
    R, T, E = x.shape
    x = x.to(dtype)
    mod = F.silu(c.to(dtype)) @ w["wada"] + w["bada"]
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


def dit_block_backward_reference(
    x: torch.Tensor, c: torch.Tensor, weights: Dict[str, torch.Tensor], dy: torch.Tensor,
    n_head: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of the block's backward: autograd through
    `dit_block_reference` (the in-kernel `jax.vjp` of the JAX package).
    Returns (dx, dc, the nine weight gradients in `weights`' layout)."""
    leaves = [t.detach().requires_grad_() for t in (x, c, *(weights[k] for k in WEIGHT_NAMES))]
    with torch.enable_grad():
        out = dit_block_reference(leaves[0], leaves[1], dict(zip(WEIGHT_NAMES, leaves[2:])),
                                  n_head, eps)
        grads = torch.autograd.grad(out, leaves, dy)
    return grads[0], grads[1], dict(zip(WEIGHT_NAMES, grads[2:]))


def _head_pad(hd: int) -> int:
    """The forward attention's compiled head width: hd zero-padded to 16, 32 or 64."""
    return 16 if hd <= 16 else 32 if hd <= 32 else 64


def dit_block_smem_bytes(T: int, E: int, n_head: int, hidden: int) -> Dict[str, int]:
    """Dynamic shared memory of one CTA of each kernel of the forward
    (namespace `tiled` in dit_tiled.cuh), by kernel: the GEMM's ring of three
    stages of 64 x 32 of A (pitch 36) and 32 x 64 of weights (pitch 72); the
    attention's 64 queries and two stages of 64 keys and values (pitch DP +
    4, DP the head width padded to 16, 32 or 64). The LayerNorm and silu
    kernels take none. None grows with T."""
    return {
        "gemm": 4 * TILED_STAGES * (TILED_TOKENS * 36 + 32 * 72),
        "attention": 4 * 5 * TILED_TOKENS * (_head_pad(E // n_head) + 4),
    }


def dit_block_bwd_smem_bytes(T: int, E: int, n_head: int, hidden: int) -> Dict[str, int]:
    """Dynamic shared memory of one CTA of each kernel of the backward
    (dit_block_bwd.cu): the forward's GEMM and attention (`gemm` also runs the
    backward's products and the weight gradients); the attention backward's
    64 tokens of its side, two stages of 64 of the other (two rows of DP + 4
    each) and their softmax statistics; the LayerNorm backward's sums, four
    of E per warp of eight; dc's four rows of dmod (6E) and its sixteen
    warps' sums of 4 x 32, all f64. None grows with T."""
    fwd = dit_block_smem_bytes(T, E, n_head, hidden)
    return {**fwd,
            "attention_bwd": 4 * (6 * TILED_TOKENS * (_head_pad(E // n_head) + 4)
                                  + 4 * TILED_TOKENS),
            "ln_bwd": 4 * 8 * 4 * E,
            "dc_rows": 8 * (4 * 6 * E + 16 * 4 * 32)}


def dit_block_workspace_floats(R: int, T: int, E: int, hidden: int) -> int:
    """Device workspace of the forward, in floats: per row mod (6E); per token
    qkv (3E), h and then the attention output (E), the residual stream after
    the attention branch (E) and the SwiGLU hidden (`launch_tiled` in
    dit_block.cu; silu(c) and h2 reuse slots that are free by then)."""
    return 6 * R * E + R * T * (5 * E + hidden)


def _check_shapes(x, c, weights, n_head, backward: bool = False) -> None:
    """Validate the shapes, the widths the kernels take and their shared memory."""
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
    hd = E // n_head
    if E > TILED_MAX_E or hd % 4 or hd > 64:
        raise ValueError(
            f"dit_block{'_bwd' if backward else ''} needs E <= {TILED_MAX_E} and a head width "
            f"that is a multiple of 4 up to 64 (E={E}, n_head={n_head})"
        )
    need = (dit_block_bwd_smem_bytes if backward else dit_block_smem_bytes)(T, E, n_head, hidden)
    kernel, most = max(need.items(), key=lambda kv: kv[1])
    if most > MAX_SMEM_BYTES:
        raise ValueError(
            f"dit_block{'_bwd' if backward else ''} needs {most} bytes of shared memory per CTA "
            f"in its {kernel} kernel at T={T}, E={E}, n_head={n_head}, hidden={hidden}; one CTA "
            f"has at most {MAX_SMEM_BYTES}"
        )


def _check_tensors(tensors, what: str, device: torch.device) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous float32 tensors on one device")


def dit_block(
    x: torch.Tensor, c: torch.Tensor, weights: Dict[str, torch.Tensor], n_head: int, eps: float
) -> torch.Tensor:
    """One adaLN-zero DiT block, x (R, T, E) f32, c (R, E) f32 -> (R, T, E) f32.

    CUDA tensors run the hand-written kernels on the current stream; CPU
    tensors run `dit_block_reference`."""
    if x.device.type == "cpu":
        return dit_block_reference(x, c, weights, n_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"dit_block runs on cuda or cpu tensors, got {x.device}")
    tensors = [x, c, *(weights[k] for k in WEIGHT_NAMES)]
    _check_tensors(tensors, "dit_block", x.device)
    _check_shapes(x, c, weights, n_head)

    from scldm_torch.kernels import build

    lib = build.load()
    R, T, E = x.shape
    out = torch.empty_like(x)
    hidden = weights["w1"].shape[1]
    workspace = torch.empty(dit_block_workspace_floats(R, T, E, hidden), dtype=torch.float32,
                            device=x.device)
    # the library's CUDA runtime launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_dit_block_forward(
            *(t.data_ptr() for t in tensors), out.data_ptr(), workspace.data_ptr(),
            R, T, E, n_head, hidden, eps, stream,
        )
    build.check(lib, code, "dit_block launch")
    DIT_BLOCK_LAUNCHES.count += 1
    return out


def dit_block_bwd(
    x: torch.Tensor,
    c: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    dy: torch.Tensor,
    n_head: int,
    eps: float,
    weights_t: Dict[str, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Recompute backward of one block: (dx (R, T, E), dc (R, E), the nine
    weight gradients, summed over the rows, in `weights`' (in, out) layout).

    CUDA tensors run the hand-written kernels on the current stream; CPU
    tensors run `dit_block_backward_reference`. The kernels also read the
    matrices in nn.Linear's (out, in) layout: `weights_t` (contiguous, keyed
    by MATRIX_NAMES) or, if None, transposed copies made here. The matrix
    gradients come back as transposed views of (out, in) tensors."""
    if x.device.type == "cpu":
        return dit_block_backward_reference(x, c, weights, dy, n_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"dit_block_bwd runs on cuda or cpu tensors, got {x.device}")
    if weights_t is None:
        weights_t = {k: weights[k].t().contiguous() for k in MATRIX_NAMES}
    ws_in = [weights[k] for k in WEIGHT_NAMES]
    ws_t = [weights_t[k] for k in MATRIX_NAMES]
    _check_tensors([x, c, dy, *ws_in, *ws_t], "dit_block_bwd", x.device)
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    for k in MATRIX_NAMES:
        if weights_t[k].shape != weights[k].shape[::-1]:
            raise ValueError(f"weights_t[{k!r}] must be {tuple(weights[k].shape[::-1])}")
    _check_shapes(x, c, weights, n_head, backward=True)

    from scldm_torch.kernels import build

    lib = build.load()
    R, T, E = x.shape
    hidden = weights["w1"].shape[1]
    dx, dc = torch.empty_like(x), torch.empty_like(c)
    dw_t = {k: torch.empty_like(weights_t[k]) for k in ("wada", "wqkv", "wproj", "wmlp")}
    dw12_t = torch.empty((2 * hidden, E), dtype=x.dtype, device=x.device)
    db = {k: torch.empty_like(weights[k]) for k in ("bada", "bqkv", "bproj")}
    workspace = torch.empty(lib.scldm_dit_block_backward_workspace_floats(R, T, E, n_head, hidden),
                            dtype=torch.float32, device=x.device)
    outs = [dx, dc, dw_t["wada"], db["bada"], dw_t["wqkv"], db["bqkv"], dw_t["wproj"],
            db["bproj"], dw12_t, dw_t["wmlp"], workspace]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_dit_block_backward(
            x.data_ptr(), c.data_ptr(), *(t.data_ptr() for t in ws_in),
            *(t.data_ptr() for t in ws_t), dy.data_ptr(), *(t.data_ptr() for t in outs),
            R, T, E, n_head, hidden, eps, stream,
        )
    build.check(lib, code, "dit_block_bwd launch")
    DIT_BLOCK_BWD_LAUNCHES.count += 1
    grads = {
        "wada": dw_t["wada"].t(), "bada": db["bada"], "wqkv": dw_t["wqkv"].t(),
        "bqkv": db["bqkv"], "wproj": dw_t["wproj"].t(), "bproj": db["bproj"],
        "w1": dw12_t[:hidden].t(), "w2": dw12_t[hidden:].t(), "wmlp": dw_t["wmlp"].t(),
    }
    return dx, dc, grads


class _DiTBlockTrainable(torch.autograd.Function):
    """The block with a recompute VJP: it saves only its inputs (and, on
    CUDA tensors, the matrices in both layouts the kernels read)."""

    @staticmethod
    def forward(ctx, x, c, n_head, eps, *ws):
        weights = {k: w.contiguous() for k, w in zip(WEIGHT_NAMES, ws)}
        # (out, in): free where `ws` are transposed views of nn.Linear weights
        weights_t = ({k: w.t().contiguous() for k, w in zip(WEIGHT_NAMES, ws) if k in MATRIX_NAMES}
                     if x.is_cuda else {})
        ctx.save_for_backward(x, c, *weights.values(), *weights_t.values())
        ctx.n_head, ctx.eps = n_head, eps
        return dit_block(x, c, weights, n_head, eps)

    @staticmethod
    def backward(ctx, dy):
        x, c, *saved = ctx.saved_tensors
        weights = dict(zip(WEIGHT_NAMES, saved))
        weights_t = dict(zip(MATRIX_NAMES, saved[len(WEIGHT_NAMES):])) or None
        dx, dc, grads = dit_block_bwd(x, c, weights, dy.contiguous(), ctx.n_head, ctx.eps,
                                      weights_t)
        return (dx, dc, None, None, *(grads[k] for k in WEIGHT_NAMES))


def dit_block_trainable(
    x: torch.Tensor, c: torch.Tensor, weights: Dict[str, torch.Tensor], n_head: int, eps: float
) -> torch.Tensor:
    """`dit_block`, differentiable in x, c and the weights: the forward kernel
    on the way in and the backward kernels on the way back, which recompute
    the forward (on CPU tensors, the plain versions both ways). The
    counterpart of the JAX `fused_dit_block_trainable`."""
    return _DiTBlockTrainable.apply(x.contiguous(), c.contiguous(), n_head, eps,
                                    *(weights[k] for k in WEIGHT_NAMES))


def block_weights(block) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from one adaLN `nn.layers.Block`, as views of
    its parameters that autograd differentiates through: the matrices are
    transposes of the nn.Linear (out, in) weights, so (in, out)."""
    def vec(lin):
        if lin.bias is None:
            return torch.zeros(lin.weight.shape[0], device=lin.weight.device)
        return lin.bias

    ada = block.adaln_modulation[1]
    attn, mlp = block.attn, block.mlp
    return {
        "wada": ada.weight.t(), "bada": vec(ada),
        "wqkv": attn.c_attn.weight.t(), "bqkv": vec(attn.c_attn),
        "wproj": attn.c_proj.weight.t(), "bproj": vec(attn.c_proj),
        "w1": mlp.w1.weight.t(), "w2": mlp.w2.weight.t(), "wmlp": mlp.c_proj.weight.t(),
    }


def extract_block_params(block) -> Dict[str, torch.Tensor]:
    """`block_weights` detached, as contiguous f32 copies: the sampler's
    weights, made once per sampling call."""
    return {k: w.detach().float().contiguous() for k, w in block_weights(block).items()}


def _final_layer(dit, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """adaLN shift/scale from c, non-affine LN, linear: plain PyTorch in f32."""
    fl = dit.final_layer
    f32 = torch.float32
    shift, scale = fl.adaln_modulation[1](F.silu(c), f32).chunk(2, dim=-1)
    hf = _ln(h, dit.layernorm_eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return fl.linear(hf, f32)


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
    sampling call instead of once per drift evaluation. Everything is f32
    whatever the DiT's compute dtype, as JAX's kernel path computes."""
    if block_params is None:
        block_params = [extract_block_params(b) for b in dit.blocks]
    t_emb = dit.t_embedder(t, torch.float32)
    for name, vals in cond_vals.items():
        t_emb = t_emb + dit.class_embeddings[name].weight.float()[vals.long()]

    h = dit.input_proj(x.float(), torch.float32)
    h = h + dit.pos_embed.to(h.dtype)
    h = h.contiguous()
    c = t_emb.contiguous()
    for kp in block_params:
        h = dit_block(h, c, kp, dit.n_head, dit.layernorm_eps)
    return _final_layer(dit, h, t_emb)


def fused_dit_train_apply(
    dit,
    x: torch.Tensor,  # (R, T, E_in)
    t_emb: torch.Tensor,  # (R, E) from DiT.embed_condition
) -> torch.Tensor:
    """Differentiable DiT trunk with every block through `dit_block_trainable`
    (forward and backward kernels); the input projection, the positional
    table and the final layer are plain PyTorch, so autograd composes them
    with the blocks. f32 throughout whatever the DiT's compute dtype: `t_emb`
    (the module's, in that dtype) is upcast, as JAX's
    `fused_dit_train_apply` does."""
    c = t_emb.float()
    h = dit.input_proj(x.float(), torch.float32) + dit.pos_embed.float()
    for block in dit.blocks:
        h = dit_block_trainable(h, c, block_weights(block), dit.n_head, dit.layernorm_eps)
    return _final_layer(dit, h, c)
