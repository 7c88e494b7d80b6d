"""The adaLN-zero DiT block, forward and backward, as hand-written CUDA kernels.

Counterpart of scldm_tpu/ops/fused_dit.py: `dit_block` replaces the Pallas
`fused_dit_block` (kernel `scldm_torch/kernels/csrc/dit_block.cu`),
`dit_block_bwd` its recompute backward `_bwd_pallas`
(`scldm_torch/kernels/csrc/dit_block_bwd.cu`), and `dit_block_trainable`
joins the two under autograd, as `fused_dit_block_trainable` does.
`fused_dit_forward` drives the forward through a whole DiT in the CFG
sampler, `fused_dit_train_apply` both through the DiT trunk in LDM training.

Each direction has two designs, both hand-written. The row design keeps a
whole DiT row in one CTA's shared memory (`dit_block_row_smem_bytes`,
`dit_block_bwd_row_smem_bytes`); the split design splits the block by what
each stage needs (one CTA per row and token tile, per row and head, or per
tile of rows) and hands intermediates on through a device workspace, so that
its shared memory is bounded by a token tile and one head's scores rather
than by the row (`dit_block_smem_bytes`, `dit_block_bwd_smem_bytes`). The
wrappers take the row design wherever a row fits one CTA (the dentate DiT's
T = 16 latent tokens, where it is the faster of the two) and the split
design elsewhere (the census DiT's T = 64); `pick_design` says which, and
the need is checked before launch.

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
#: tokens per CTA of the kernels' token-wise stages (kTok in dit_common.cuh)
TOKEN_TILE = 16
#: rows per CTA of their per-row products (kRowTile in dit_common.cuh)
ROW_TILE = 8


class LaunchCounter:
    """Number of kernel launches since the last reset."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


DIT_BLOCK_LAUNCHES = LaunchCounter()
DIT_BLOCK_BWD_LAUNCHES = LaunchCounter()


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


def _rows_gemm_bytes(K: int) -> int:
    """rows_gemm's CTA: ROW_TILE staged input rows of K and its eight warps'
    partial sums (dit_common.cuh)."""
    return 4 * (ROW_TILE * K + 8 * ROW_TILE * 32)


def _attention_bytes(T: int, hd: int) -> int:
    """The attention forward's CTA, one (row, head): q, k (padded), v and
    the (T, T) scores."""
    return 4 * (2 * T * hd + T * (hd + 1) + T * T)


def dit_block_row_smem_bytes(T: int, E: int, n_head: int, hidden: int) -> int:
    """Dynamic shared memory of the forward's row kernel, one CTA per row: x,
    h, qkv-or-hidden, silu(c), mod and the scores (dit_block.cu)."""
    return 4 * (2 * T * E + T * max(3 * E, hidden) + 7 * E + n_head * T * T)


def dit_block_bwd_row_smem_bytes(T: int, E: int, n_head: int, hidden: int) -> int:
    """Dynamic shared memory of the backward's row kernel: the forward's,
    plus the score cotangents, dmod and the LayerNorm statistics
    (dit_block_bwd.cu)."""
    return 4 * (2 * T * E + T * max(3 * E, hidden) + 2 * n_head * T * T + 13 * E + 4 * T)


def pick_design(T: int, E: int, n_head: int, hidden: int, backward: bool = False) -> str:
    """The design the wrappers take: "row" where a row fits one CTA, "split"
    elsewhere."""
    row = (dit_block_bwd_row_smem_bytes if backward else dit_block_row_smem_bytes)(
        T, E, n_head, hidden)
    return "row" if row <= MAX_SMEM_BYTES else "split"


def dit_block_smem_bytes(T: int, E: int, n_head: int, hidden: int) -> Dict[str, int]:
    """Dynamic shared memory of one CTA of each kernel of the forward's split
    design (the layouts in dit_block.cu and dit_common.cuh), by kernel:
    bounded by a token tile and by one head's scores, not by the row."""
    return {
        "rows_gemm": _rows_gemm_bytes(E),
        "ln_qkv": 4 * TOKEN_TILE * E,
        "attention": _attention_bytes(T, E // n_head),
        "block_post": 4 * TOKEN_TILE * (2 * E + hidden),
    }


def dit_block_bwd_smem_bytes(T: int, E: int, n_head: int, hidden: int) -> Dict[str, int]:
    """Dynamic shared memory of one CTA of each kernel of the backward's split
    design (the layouts in dit_block_bwd.cu): the forward's first three, then
    the MLP branch's backward per token tile, the attention's per (row,
    head), the qkv product's per token tile, and dc over ROW_TILE rows of
    dmod (6E)."""
    hd = E // n_head
    fwd = dit_block_smem_bytes(T, E, n_head, hidden)
    return {
        "rows_gemm": fwd["rows_gemm"],
        "ln_qkv": fwd["ln_qkv"],
        "attention": fwd["attention"],
        "mlp_bwd": 4 * (TOKEN_TILE * (2 * E + hidden) + 2 * TOKEN_TILE),
        "attention_bwd": 4 * (2 * T * hd + 2 * T * (hd + 1) + 2 * T * T),
        "qkv_bwd": 4 * (TOKEN_TILE * 5 * E + 2 * TOKEN_TILE),
        "dc": _rows_gemm_bytes(6 * E),
    }


def dit_block_workspace_floats(R: int, T: int, E: int) -> int:
    """Device workspace of the forward's split design, in floats: per row
    mod (6E), per token qkv and the attention output (4E) (dit_block.cu)."""
    return 6 * R * E + 4 * R * T * E


def dit_block_bwd_workspace_floats(R: int, T: int, E: int, hidden: int) -> int:
    """Device workspace of the backward, in floats: per token h, qkv, attn,
    proj, h2, dm, d(attention output) (9E) and [a | b], g (3 hidden); per
    row silu(c) and mod (7E); per row and token tile a partial of dmod (6E)
    (`carve` in dit_block_bwd.cu). Both designs take the same layout; the
    row design leaves d(attention output) and the partials unused."""
    tiles = -(-T // TOKEN_TILE)
    return R * T * (9 * E + 3 * hidden) + 7 * R * E + 6 * R * tiles * E


def _check_shapes(x, c, weights, n_head, backward: bool = False,
                  design: str | None = None) -> str:
    """Validate the shapes and the shared memory of `design` (None: the one
    `pick_design` takes); returns the design."""
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
    design = design or pick_design(T, E, n_head, hidden, backward)
    if design == "row":
        need = {"row": (dit_block_bwd_row_smem_bytes if backward else dit_block_row_smem_bytes)(
            T, E, n_head, hidden)}
    elif design == "split":
        split = dit_block_bwd_smem_bytes if backward else dit_block_smem_bytes
        need = split(T, E, n_head, hidden)
    else:
        raise ValueError(f"design must be 'row', 'split' or None, got {design!r}")
    kernel, most = max(need.items(), key=lambda kv: kv[1])
    if most > MAX_SMEM_BYTES:
        raise ValueError(
            f"dit_block{'_bwd' if backward else ''} needs {most} bytes of shared memory per CTA "
            f"in its {kernel} kernel at T={T}, E={E}, n_head={n_head}, hidden={hidden}; one CTA "
            f"has at most {MAX_SMEM_BYTES}"
        )
    return design


def _check_tensors(tensors, what: str, device: torch.device) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous float32 tensors on one device")


def dit_block(
    x: torch.Tensor, c: torch.Tensor, weights: Dict[str, torch.Tensor], n_head: int, eps: float,
    design: str | None = None,
) -> torch.Tensor:
    """One adaLN-zero DiT block, x (R, T, E) f32, c (R, E) f32 -> (R, T, E) f32.

    CUDA tensors run the hand-written kernels on the current stream, of
    `design` ("row" or "split"; None: `pick_design`'s); CPU tensors run
    `dit_block_reference`."""
    if x.device.type == "cpu":
        return dit_block_reference(x, c, weights, n_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"dit_block runs on cuda or cpu tensors, got {x.device}")
    tensors = [x, c, *(weights[k] for k in WEIGHT_NAMES)]
    _check_tensors(tensors, "dit_block", x.device)
    design = _check_shapes(x, c, weights, n_head, design=design)

    from scldm_torch.kernels import build

    lib = build.load()
    R, T, E = x.shape
    out = torch.empty_like(x)
    workspace = torch.empty(dit_block_workspace_floats(R, T, E) if design == "split" else 0,
                            dtype=torch.float32, device=x.device)
    # the library's CUDA runtime launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_dit_block_forward(
            *(t.data_ptr() for t in tensors), out.data_ptr(), workspace.data_ptr(),
            R, T, E, n_head, weights["w1"].shape[1], eps, int(design == "row"), stream,
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
    design: str | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Recompute backward of one block: (dx (R, T, E), dc (R, E), the nine
    weight gradients, summed over the rows, in `weights`' (in, out) layout).

    CUDA tensors run the hand-written kernels on the current stream, of
    `design` as in `dit_block`; CPU tensors run
    `dit_block_backward_reference`. The kernels also read the
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
    design = _check_shapes(x, c, weights, n_head, backward=True, design=design)

    from scldm_torch.kernels import build

    lib = build.load()
    R, T, E = x.shape
    hidden = weights["w1"].shape[1]
    dx, dc = torch.empty_like(x), torch.empty_like(c)
    dw_t = {k: torch.empty_like(weights_t[k]) for k in ("wada", "wqkv", "wproj", "wmlp")}
    dw12_t = torch.empty((2 * hidden, E), dtype=x.dtype, device=x.device)
    db = {k: torch.empty_like(weights[k]) for k in ("bada", "bqkv", "bproj")}
    workspace = torch.empty(dit_block_bwd_workspace_floats(R, T, E, hidden),
                            dtype=torch.float32, device=x.device)
    outs = [dx, dc, dw_t["wada"], db["bada"], dw_t["wqkv"], db["bqkv"], dw_t["wproj"],
            db["bproj"], dw12_t, dw_t["wmlp"], workspace]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_dit_block_backward(
            x.data_ptr(), c.data_ptr(), *(t.data_ptr() for t in ws_in),
            *(t.data_ptr() for t in ws_t), dy.data_ptr(), *(t.data_ptr() for t in outs),
            R, T, E, n_head, hidden, eps, int(design == "row"), stream,
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
    """adaLN shift/scale from c, non-affine LN, linear: plain PyTorch."""
    fl = dit.final_layer
    shift, scale = fl.adaln_modulation(c).chunk(2, dim=-1)
    hf = _ln(h, dit.layernorm_eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return fl.linear(hf).float()


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
    return _final_layer(dit, h, t_emb)


def fused_dit_train_apply(
    dit,
    x: torch.Tensor,  # (R, T, E_in)
    t_emb: torch.Tensor,  # (R, E) from DiT.embed_condition
) -> torch.Tensor:
    """Differentiable DiT trunk with every block through `dit_block_trainable`
    (forward and backward kernels); the input projection, the positional
    table and the final layer are plain PyTorch, so autograd composes them
    with the blocks. JAX: `fused_dit_train_apply`."""
    c = t_emb.float()
    h = dit.input_proj(x.float()).float() + dit.pos_embed.float()
    for block in dit.blocks:
        h = dit_block_trainable(h, c, block_weights(block), dit.n_head, dit.layernorm_eps)
    return _final_layer(dit, h, c)
