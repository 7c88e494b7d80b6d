"""The whole trunk of the VAE's encoder or decoder (all L plain Blocks) as
hand-written CUDA kernels: one launch forward, three backward.

Counterpart of scldm_tpu/ops/fused_trunk.py. `fused_trunk_blocks` replaces
the Pallas `fused_trunk_blocks` (the forward, no saving),
`fused_trunk_fwd_saving` its `_fwd_saving` (the forward that also writes each
layer's input) and `fused_trunk_bwd` its `_bwd_pallas` (the whole-trunk
backward from the saved inputs); the source of all three is
`scldm_torch/kernels/csrc/fused_trunk.cu`. `fused_trunk_blocks_trainable`
joins them under autograd, as `fused_trunk_blocks_trainable` does in JAX:
where a gradient is wanted the saving forward on the way in and the
backward on the way back, elsewhere the forward that saves nothing.

The weights: JAX stacks each of the nine per-layer tensors into an (L, ...)
array in (in, out) layout. The port keeps the L layers' parameters as they
are, in nn.Linear's (out, in) layout, as a dict from each name of
`TRUNK_WEIGHT_NAMES` to a sequence of L tensors (`extract_trunk_params`):
the kernels take a table of pointers, so nothing is stacked, transposed or
copied on the way in, and the gradients come back in the parameters' own
layout, so nothing is copied on the way back.

The wrappers launch the kernels on CUDA tensors (f32, contiguous, 16-byte
aligned; E % 4 == 0, hidden % 4 == 0, E % n_head == 0 and the shared memory
of `trunk_smem_bytes` within one CTA's, else they raise) and run the plain
PyTorch versions (`fused_trunk_reference`, `fused_trunk_saving_reference`,
`fused_trunk_backward_reference`) on CPU tensors; any other device raises. JAX's `block_rows` and the
`SCLDM_TRUNK_BR` / `SCLDM_TRUNK_BBR` tile sizes are TPU tiles and have no
counterpart. `TRUNK_FWD_LAUNCHES`, `TRUNK_FWD_SAVING_LAUNCHES` and
`TRUNK_BWD_LAUNCHES` count the wrappers' launches (one each, whatever the
number of kernels behind it), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from scldm_torch.ops.fused_dit import MAX_SMEM_BYTES, LaunchCounter

#: the nine per-layer tensors, in the order of the JAX package's stacked weights
TRUNK_WEIGHT_NAMES = ("g1", "b1", "wqkv", "wproj", "g2", "b2", "w1", "w2", "wmlp")
#: layers per launch (kMaxLayers in fused_trunk.cu); a deeper trunk takes more
LAYERS_PER_LAUNCH = 8

TRUNK_FWD_LAUNCHES = LaunchCounter()
TRUNK_FWD_SAVING_LAUNCHES = LaunchCounter()
TRUNK_BWD_LAUNCHES = LaunchCounter()

TrunkWeights = Dict[str, Sequence[torch.Tensor]]


def trunk_kernel_ok(n_embed: int, bias: bool, dropout: float, use_adaln: bool) -> bool:
    """The JAX gate of the whole-trunk kernel: the reference trunk (bias-free
    attention and MLP, affine LayerNorm, no dropout, no adaLN) at E <= 128."""
    return (not bias) and dropout == 0.0 and (not use_adaln) and n_embed <= 128


def _ln_affine(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def _layer(x: torch.Tensor, w: Dict[str, torch.Tensor], n_head: int, eps: float) -> torch.Tensor:
    """One block of `_trunk_math`, f32; matrices in (out, in) layout."""
    R, T, E = x.shape
    hd = E // n_head
    h = _ln_affine(x, w["g1"], w["b1"], eps)
    q, k, v = (a.reshape(R, T, n_head, hd).transpose(1, 2)
               for a in (h @ w["wqkv"].t()).chunk(3, dim=-1))
    p = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / hd**0.5), dim=-1)
    x = x + (p @ v).transpose(1, 2).reshape(R, T, E) @ w["wproj"].t()
    h2 = _ln_affine(x, w["g2"], w["b2"], eps)
    return x + (F.silu(h2 @ w["w1"].t()) * (h2 @ w["w2"].t())) @ w["wmlp"].t()


def _n_layer(weights: TrunkWeights) -> int:
    return len(weights["wqkv"])


def _layer_weights(weights: TrunkWeights, layer: int) -> Dict[str, torch.Tensor]:
    return {k: weights[k][layer].float() for k in TRUNK_WEIGHT_NAMES}


def fused_trunk_saving_reference(
    x: torch.Tensor, weights: TrunkWeights, n_head: int, eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the saving forward: the trunk's output and each
    layer's input, (L, R, T, E) f32."""
    x = x.float()
    inputs = []
    for layer in range(_n_layer(weights)):
        inputs.append(x)
        x = _layer(x, _layer_weights(weights, layer), n_head, eps)
    return x, torch.stack(inputs)


def fused_trunk_reference(
    x: torch.Tensor, weights: TrunkWeights, n_head: int, eps: float = 1e-8
) -> torch.Tensor:
    """Plain f32 PyTorch version of the whole trunk (`_trunk_math` in the JAX
    package): x (R, T, E) -> (R, T, E) f32."""
    x = x.float()
    for layer in range(_n_layer(weights)):
        x = _layer(x, _layer_weights(weights, layer), n_head, eps)
    return x


def _flat(weights: TrunkWeights) -> List[torch.Tensor]:
    """The 9 * L tensors layer by layer, each layer in TRUNK_WEIGHT_NAMES order."""
    return [weights[k][layer] for layer in range(_n_layer(weights)) for k in TRUNK_WEIGHT_NAMES]


def _unflat(flat: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
    n = len(TRUNK_WEIGHT_NAMES)
    return {k: list(flat[i::n]) for i, k in enumerate(TRUNK_WEIGHT_NAMES)}


def fused_trunk_backward_reference(
    x: torch.Tensor, weights: TrunkWeights, dy: torch.Tensor, n_head: int, eps: float = 1e-8
) -> Tuple[torch.Tensor, Dict[str, List[torch.Tensor]]]:
    """Plain version of the trunk's backward: autograd through
    `fused_trunk_reference` (the in-kernel `jax.vjp` of the JAX package).
    Returns (dx, the weight gradients in `weights`' layout)."""
    leaves = [t.detach().requires_grad_() for t in (x, *_flat(weights))]
    with torch.enable_grad():
        out = fused_trunk_reference(leaves[0], _unflat(leaves[1:]), n_head, eps)
        grads = torch.autograd.grad(out, leaves, dy)
    return grads[0], _unflat(grads[1:])


def _r8(v: int) -> int:
    return (v + 7) // 8 * 8


def trunk_smem_bytes(T: int, E: int, n_head: int, hidden: int, backward: bool) -> int:
    """Dynamic shared memory of one CTA (one row) of the forward or of the
    backward's row kernel (`act_floats` in fused_trunk.cu, which
    `scldm_fused_trunk_smem_bytes` there reports): T tokens of each buffer,
    widths padded to 8 with pitches 4 past that (forward x, h, and qkv or the
    SwiGLU hidden; backward x, x1, dx, a staging tile, qkv, and [a | b] or
    dqkv, then the softmax statistics and delta (T, n_head each) and the
    LayerNorm statistics), and the LayerNorm affines of two layers. The
    weights are read from global memory, not staged."""
    ldE, ldQ = _r8(E) + 4, _r8(3 * E) + 4
    if backward:
        ldB = max(ldQ, 2 * _r8(hidden) + 4)
        floats = T * (4 * ldE + ldQ + ldB + 2 * n_head + 4) + 8 * E
    else:
        floats = T * (2 * ldE + max(ldQ, _r8(hidden) + 4)) + 8 * E
    return 4 * floats


def trunk_workspace_floats(R: int, T: int, E: int, hidden: int, n_layer: int) -> int:
    """Device workspace of the backward, in floats, per layer of a launch
    (LAYERS_PER_LAUNCH at most): per token h, dqkv, attn, dproj, h2, m (8E),
    [da | db] and g (3 hidden), per row and each of eight token groups the
    LayerNorm affine partials (32E) (`slots` in fused_trunk.cu), and the
    weight gradients' chunk partials, eight a gradient (`grad_part_floats`).
    10.4M floats, 42 MB, at the VAE's R = 128 rows of T = 16 tokens, E = 32,
    hidden 88, L = 8. The wrapper allocates what the kernels' own count,
    `scldm_fused_trunk_workspace_floats`, says; a GPU test holds the two
    equal."""
    per_layer = R * T * (8 * E + 3 * hidden) + 32 * R * E
    partials = 8 * (4 * E * E + 3 * E * hidden + 9 * E + 2 * hidden)
    return min(n_layer, LAYERS_PER_LAUNCH) * (per_layer + partials)


def _grad_floats(E: int, hidden: int) -> int:
    """One layer's gradients in the backward's output buffer: the four
    LayerNorm vectors, then dwqkv, dwproj, dw1, dw2, dwmlp (fused_trunk.cu)."""
    return 4 * E + 4 * E * E + 3 * hidden * E


def _shape_error(T: int, E: int, n_head: int, hidden: int) -> Optional[str]:
    """Why the trunk kernels do not take rows of T tokens at these widths, or
    None where they do: E % 4 == 0, hidden % 4 == 0, E % n_head == 0 and the
    shared memory of `trunk_smem_bytes` within one CTA's."""
    need = max(trunk_smem_bytes(T, E, n_head, hidden, b) for b in (False, True))
    if E % 4 or hidden % 4 or E % n_head or need > MAX_SMEM_BYTES:
        return ("the trunk kernels take E % 4 == 0, hidden % 4 == 0, E % n_head == 0 and at "
                f"most {MAX_SMEM_BYTES} bytes of shared memory per row; got E={E}, "
                f"hidden={hidden}, n_head={n_head}, T={T} ({need} bytes)")
    return None


def _check(x: torch.Tensor, weights: TrunkWeights, n_head: int) -> Tuple[int, int]:
    """Validate the CUDA operands; returns (L, hidden)."""
    if x.device.type != "cuda":
        raise ValueError(f"the trunk kernels run on cuda or cpu tensors, got {x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be (R, T, E), got {tuple(x.shape)}")
    R, T, E = x.shape
    L = _n_layer(weights)
    if L < 1 or any(len(weights[k]) != L for k in TRUNK_WEIGHT_NAMES):
        raise ValueError("the trunk needs L >= 1 layers of each of "
                         + ", ".join(TRUNK_WEIGHT_NAMES))
    hidden = weights["w1"][0].shape[0]
    want = {"g1": (E,), "b1": (E,), "wqkv": (3 * E, E), "wproj": (E, E), "g2": (E,),
            "b2": (E,), "w1": (hidden, E), "w2": (hidden, E), "wmlp": (E, hidden)}
    for k, shape in want.items():
        for w in weights[k]:
            if tuple(w.shape) != shape:
                raise ValueError(f"{k} must be {shape}, got {tuple(w.shape)}")
    for t in (x, *_flat(weights)):
        if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("the trunk kernels need contiguous, 16-byte aligned float32 "
                             "tensors on one device")
    error = _shape_error(T, E, n_head, hidden)
    if error is not None:
        raise ValueError(error)
    return L, hidden


def _pointers(weights: TrunkWeights):
    flat = _flat(weights)
    return (ctypes.c_void_p * len(flat))(*(t.data_ptr() for t in flat))


def _forward(x: torch.Tensor, weights: TrunkWeights, n_head: int, eps: float, save: bool):
    L, hidden = _check(x, weights, n_head)
    from scldm_torch.kernels import build

    lib = build.load()
    R, T, E = x.shape
    out = torch.empty_like(x)
    xs = torch.empty((L, R, T, E), dtype=torch.float32, device=x.device) if save else None
    # the library's CUDA runtime launches on the current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.scldm_fused_trunk_forward(
            x.data_ptr(), _pointers(weights), out.data_ptr(),
            None if xs is None else xs.data_ptr(), R, T, E, n_head, hidden, L, eps, stream)
    build.check(lib, code, "fused_trunk forward launch")
    return out, xs


def fused_trunk_blocks(
    x: torch.Tensor, weights: TrunkWeights, n_head: int, eps: float = 1e-8
) -> torch.Tensor:
    """The whole trunk, x (R, T, E) f32 -> (R, T, E) f32, saving nothing.

    CUDA tensors run the hand-written kernel on the current stream; CPU
    tensors run `fused_trunk_reference`."""
    if x.device.type == "cpu":
        return fused_trunk_reference(x, weights, n_head, eps)
    out, _ = _forward(x, weights, n_head, eps, save=False)
    TRUNK_FWD_LAUNCHES.count += 1
    return out


def fused_trunk_fwd_saving(
    x: torch.Tensor, weights: TrunkWeights, n_head: int, eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole trunk, also returning each layer's input xs (L, R, T, E) f32
    for `fused_trunk_bwd`. CUDA tensors run the kernel, CPU tensors the
    plain version."""
    if x.device.type == "cpu":
        return fused_trunk_saving_reference(x, weights, n_head, eps)
    out, xs = _forward(x, weights, n_head, eps, save=True)
    TRUNK_FWD_SAVING_LAUNCHES.count += 1
    return out, xs


def fused_trunk_bwd(
    xs: torch.Tensor, weights: TrunkWeights, dy: torch.Tensor, n_head: int, eps: float = 1e-8
) -> Tuple[torch.Tensor, Dict[str, List[torch.Tensor]]]:
    """The whole trunk's backward from the saved layer inputs xs (L, R, T, E):
    (dx (R, T, E), the weight gradients, summed over every token, in
    `weights`' layout: per name a list of L tensors).

    CUDA tensors run the hand-written kernels on the current stream: the row
    kernel, then the weight-gradient GEMM and its ordered sum of chunk
    partials, per LAYERS_PER_LAUNCH layers;
    the gradients are views of one buffer. CPU tensors run
    `fused_trunk_backward_reference` from xs[0]."""
    if xs.device.type == "cpu":
        return fused_trunk_backward_reference(xs[0], weights, dy, n_head, eps)
    L, hidden = _check(xs[0], weights, n_head)
    if tuple(xs.shape[:1]) != (L,) or dy.shape != xs.shape[1:]:
        raise ValueError(f"xs must be (L={L}, R, T, E) and dy (R, T, E); got "
                         f"{tuple(xs.shape)} and {tuple(dy.shape)}")
    for t in (xs, dy):
        if t.device != xs.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_trunk_bwd needs contiguous float32 xs and dy on one device")
    from scldm_torch.kernels import build

    lib = build.load()
    _, R, T, E = xs.shape
    dx = torch.empty_like(dy)
    per_layer = _grad_floats(E, hidden)
    dw = torch.empty((L, per_layer), dtype=torch.float32, device=xs.device)
    workspace = torch.empty(lib.scldm_fused_trunk_workspace_floats(R, T, E, hidden, L),
                            dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        code = lib.scldm_fused_trunk_backward(
            xs.data_ptr(), _pointers(weights), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            workspace.data_ptr(), R, T, E, n_head, hidden, L, eps, stream)
    build.check(lib, code, "fused_trunk backward launch")
    TRUNK_BWD_LAUNCHES.count += 1
    sizes = {"g1": E, "b1": E, "g2": E, "b2": E, "wqkv": 3 * E * E, "wproj": E * E,
             "w1": hidden * E, "w2": hidden * E, "wmlp": E * hidden}
    order = ("g1", "b1", "g2", "b2", "wqkv", "wproj", "w1", "w2", "wmlp")  # the buffer's
    # per name one strided view over the L layers, split by unbind: nine views
    # instead of 9 * L, which cost the host more than the kernels take
    by_name, at = {}, 0
    for k in order:
        shape = tuple(weights[k][0].shape)
        by_name[k] = list(dw[:, at:at + sizes[k]].view(L, *shape).unbind(0))
        at += sizes[k]
    return dx, {k: by_name[k] for k in TRUNK_WEIGHT_NAMES}


class _FusedTrunk(torch.autograd.Function):
    """The trunk with a recompute VJP: it saves each layer's input (the
    saving forward's xs) and the weights, and its backward is
    `fused_trunk_bwd`."""

    @staticmethod
    def forward(ctx, x, n_head, eps, *flat):
        out, xs = fused_trunk_fwd_saving(x, _unflat(flat), n_head, eps)
        ctx.save_for_backward(xs, *flat)
        ctx.n_head, ctx.eps = n_head, eps
        return out

    @staticmethod
    def backward(ctx, dy):
        xs, *flat = ctx.saved_tensors
        dx, grads = fused_trunk_bwd(xs, _unflat(flat), dy.contiguous(), ctx.n_head, ctx.eps)
        return (dx, None, None, *_flat(grads))


def fused_trunk_blocks_trainable(
    x: torch.Tensor, weights: TrunkWeights, n_head: int, eps: float = 1e-8
) -> torch.Tensor:
    """The trunk, differentiable in x and the weights. Where autograd records
    (grad mode on and x or a weight needing a gradient): the saving forward
    kernel, then the backward kernels. Elsewhere: the forward kernel that
    saves nothing, as JAX's primal call outside `jax.grad`. On CPU tensors
    the plain versions both ways. The counterpart of the JAX
    `fused_trunk_blocks_trainable`: the kernels compute in f32 whatever x's
    dtype; a bf16 x is upcast here, the output returned in x's dtype and
    dx, through the casts, in x's dtype too."""
    dtype = x.dtype
    x = x.float().contiguous()
    flat = _flat(weights)
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in flat)):
        return _FusedTrunk.apply(x, n_head, eps, *flat).to(dtype)
    return fused_trunk_blocks(x, weights, n_head, eps).to(dtype)


def extract_trunk_params(blocks) -> Dict[str, List[torch.Tensor]]:
    """The kernels' weights of a sequence of plain `nn.layers.Block`s (an
    Encoder's `encoder_layers` or a Decoder's `decoder_layers`): per name of
    TRUNK_WEIGHT_NAMES the L parameters themselves, matrices in nn.Linear's
    (out, in) layout, so autograd carries the kernels' gradients straight
    to them."""
    return {
        "g1": [b.ln_1.weight for b in blocks], "b1": [b.ln_1.bias for b in blocks],
        "wqkv": [b.attn.c_attn.weight for b in blocks],
        "wproj": [b.attn.c_proj.weight for b in blocks],
        "g2": [b.ln_2.weight for b in blocks], "b2": [b.ln_2.bias for b in blocks],
        "w1": [b.mlp.w1.weight for b in blocks], "w2": [b.mlp.w2.weight for b in blocks],
        "wmlp": [b.mlp.c_proj.weight for b in blocks],
    }
