"""Transformer building blocks (counterpart of scldm_tpu/nn/layers.py).

Module and parameter names follow the reference's PyTorch modules, which is
what `scldm_tpu.utils.torch_import.export_torch_state_dict` emits, so
weights move between the two packages with a plain `load_state_dict`.

Compute dtype (JAX's `dtype`, flax semantics): the parameters are f32; each
dense layer casts its input, kernel and bias to the module's `dtype` and
multiplies in it (`linear`), so under bfloat16 the products and the residual
stream are bf16 while the gradients reaching the weights are f32. LayerNorm
runs in f32 and returns its input's dtype; attention scores and softmax run
in f32. Nothing here uses `torch.autocast`, whose policy would keep
LayerNorm outputs and residual sums in f32.

Dropout (JAX's `nn.Dropout` after each attention's output projection) is
drawn only where a forward is given a `Drops`, the draws of one training
pass; without one every module is deterministic, as JAX's at
`deterministic=True`.

Megatron tensor parallelism (`parallel/sharding_rules.shard_module_`): a
layer bound to a "model" group holds its slice of the sharded parameters in
`tp` (`parallel.tensor_parallel.TensorParallel`; None on one card, whose
code path is unchanged). An attention attends over its heads and a SwiGLU
over its hidden slice, their row-parallel `c_proj` sums all-reduced; an
adaLN `Linear` gathers its output, an embedding its lookups, and an
attention `Linear` whose heads do not split gathers its weights. Every
dropout site follows a reduction or a gather, so each model rank draws the
same mask from the same `Drops`.
"""

from __future__ import annotations

import copy
import math
import zlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from scldm_torch.ops.attention import sdpa, sdpa_shared_q
from scldm_torch.ops.transforms import COUNT_TRANSFORMS, LEARNED_TRANSFORMS


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=dtype)` on an f32 `layer`: input, kernel and bias
    cast to `dtype`, the product in it (no-op casts in f32). A Megatron
    `Linear` gathers its output or its weights (the module docstring)."""
    tp = getattr(layer, "tp", None)
    if tp is not None and layer.tp_mode == "output":
        return tp.gather(column(column_input(x, tp, dtype), layer, dtype))
    w, b = weights(layer)
    return _linear(x, w, b, dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    if w.dtype != dtype:
        w, b = w.to(dtype), None if b is None else b.to(dtype)
    return F.linear(x if x.dtype == dtype else x.to(dtype), w, b)


def linear_f32(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`linear` whose sum stays in f32: where JAX casts a dense layer's
    output to f32 at once (the NB head's logit, the DiT's output), XLA keeps
    the f32 sum of the `dtype` products rather than rounding it to `dtype`
    and back. The same as `linear` in f32."""
    w, b = weights(layer)
    bias = None if b is None else b.to(dtype).float()
    return F.linear(x.to(dtype).float(), w.to(dtype).float(), bias)


def weights(layer: nn.Linear):
    """(weight, bias) of `layer` as its product uses them: a Megatron layer
    that gathers its weights (`tp_mode` "weight") returns them whole, any
    other its own (a slice where it is sharded)."""
    w, b = layer.weight, layer.bias
    tp = getattr(layer, "tp", None)
    if tp is not None and layer.tp_mode == "weight":
        w = tp.gather(w, layer.tp_dim)
        if b is not None and layer.tp_dim == 0:
            b = tp.gather(b, 0)
    return w, b


def column_input(x: torch.Tensor, tp, dtype: torch.dtype) -> torch.Tensor:
    """A replicated activation entering column-parallel products under
    Megatron: rounded to `dtype` (the products' operand), held in f32, so
    that each rank's part of its gradient stays an f32 sum until the ranks'
    parts are summed (`copy_to`) and is rounded to `dtype` once, as one
    process's whole product rounds it."""
    return tp.copy_to(x.to(dtype).float())


def column(xc: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A column-parallel product of `column_input`'s operand with this rank's
    output rows of `layer`: the f32 sum of `dtype`-rounded operands, rounded
    to `dtype` once."""
    b = None if layer.bias is None else layer.bias.to(dtype).float()
    return F.linear(xc, layer.weight.to(dtype).float(), b).to(dtype)


def row_parallel(x: torch.Tensor, layer: nn.Linear, tp, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel product: this rank's input slice through its input
    columns of `layer`, in `dtype`'s rounding with f32 partial sums, the sums
    all-reduced over the group and rounded to `dtype` once, then the
    (replicated) bias."""
    y = tp.reduce_from(F.linear(x.to(dtype).float(), layer.weight.to(dtype).float())).to(dtype)
    return y if layer.bias is None else y + layer.bias.to(dtype)


class Linear(nn.Linear):
    """An f32 `nn.Linear` that computes in `compute_dtype` (`linear`); a call
    may name another dtype, as the kernel paths' f32 operands do. `tp`,
    `tp_mode` and `tp_dim` bind it to a Megatron group
    (`sharding_rules.shard_module_`)."""

    tp = None
    tp_mode: Optional[str] = None
    tp_dim = 0

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return linear(x, self, self.compute_dtype if dtype is None else dtype)


def embed(table: nn.Embedding, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax `Embed(dtype=dtype)` on an f32 table: the table cast to `dtype`,
    then the lookup; a feature-sharded (Megatron) table's lookups gathered."""
    out = F.embedding(ids, table.weight.to(dtype))
    tp = getattr(table, "tp", None)
    return out if tp is None else tp.gather(out)


def table(emb: nn.Embedding) -> torch.Tensor:
    """The whole (vocab, E) table of `emb`, gathered where it is
    feature-sharded (differentiable)."""
    tp = getattr(emb, "tp", None)
    return emb.weight if tp is None else tp.gather(emb.weight, 1)


def checkpointed(block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    """`block(*args)` recomputed in the backward (JAX `nn.remat`) where
    autograd records; the same numbers, less memory."""
    if torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def dropout(x: torch.Tensor, rate: float, keep: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's `nn.Dropout` at train time: entries kept where `keep` (drawn as
    uniform < 1 - rate from `generator` unless given) scaled by 1 / (1 -
    rate), the rest zero."""
    if keep is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Drops:
    """The dropout draws of one training forward of `root` (JAX's
    `deterministic=False` under a "dropout" rng). A site is a module that
    drops, named by its path in `root`; `call` tells apart the calls of one
    module over slices (the decoder's `cross_chunks`). Each site and call
    draws its keep mask from a generator seeded with `seed` and a checksum of
    its name and call, so that a forward recomputed in the backward
    (`checkpointed`) drops what the first one dropped. `keep` injects the
    masks instead: {site name: [mask of call 0, mask of call 1, ...]}."""

    def __init__(self, root: nn.Module, seed: int = 0,
                 keep: Optional[Dict[str, Sequence[torch.Tensor]]] = None, call: int = 0):
        self.names = {id(m): name for name, m in root.named_modules()}
        self.seed, self.keep, self.call = int(seed), dict(keep or {}), call

    @classmethod
    def draw(cls, root: nn.Module, generator: torch.Generator) -> "Drops":
        """The pass's seed drawn from `generator` (one draw a step)."""
        seed = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
        return cls(root, int(seed))

    def at_call(self, call: int) -> "Drops":
        out = copy.copy(self)
        out.call = call
        return out

    def __call__(self, x: torch.Tensor, rate: float, site: nn.Module) -> torch.Tensor:
        name = self.names[id(site)]
        if name in self.keep:
            return dropout(x, rate, self.keep[name][self.call].to(x.device))
        key = zlib.crc32(f"{name}/{self.call}".encode())
        generator = torch.Generator(x.device).manual_seed((self.seed + key) % 2**63)
        return dropout(x, rate, generator=generator)


def drop(x: torch.Tensor, rate: float, site: nn.Module, drops: Optional[Drops]) -> torch.Tensor:
    """`x` through `site`'s dropout at `rate` where the pass has draws."""
    return x if drops is None or rate <= 0.0 else drops(x, rate, site)


class _SiLULowPrecision(torch.autograd.Function):
    """`jax.nn.silu` in a low-precision dtype as XLA on the CPU computes it:
    y = 1 / (1 + exp(-x)) and x * y with each op rounded to the dtype, and
    its derivative as JAX's autodiff rounds it, g y + (1 - y) y (g x). Saves
    x alone, as `F.silu` does, and recomputes y in the backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _logistic(x).mul_(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        y = _logistic(x)
        gy = g * x
        out = (1.0 - y).mul_(y).mul_(gy)
        del gy  # three census-sized temporaries at most
        return out.add_(y.mul_(g))


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return torch.neg(x).exp_().add_(1.0).reciprocal_()  # in place: census-sized x


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`, x * sigmoid(x): `F.silu` in f32. In bf16 the JAX
    package's program rounds after each op of the sigmoid and after the
    product, where `F.silu` rounds once; the port rounds where it does."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return _SiLULowPrecision.apply(x)


class SiLU(nn.Module):
    """`silu` as a module (in place of `nn.SiLU`, no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(x)


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


class Projection(nn.Module):
    """`agg_func: proj`: a learned projection of the count added to the gene
    embedding."""

    def __init__(self, n_embed: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.count_embedding = Linear(1, n_embed, True, dtype)

    def forward(self, genes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        return genes + self.count_embedding(counts)


class ProjectionConcat(nn.Module):
    """`agg_func: projconcat`: [gene embedding, log1p(count)] mixed by a
    learned (2E -> E) projection."""

    def __init__(self, n_embed: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mix = Linear(2 * n_embed, n_embed, True, dtype)

    def forward(self, genes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        log_counts = torch.log1p(counts).expand(genes.shape)
        return self.mix(torch.cat([genes, log_counts], dim=-1))


class SoftBinProjection(nn.Module):
    """`agg_func: softbin`: the count soft-assigned to `n_bins` learned bin
    embeddings by a small MLP, the mixture added to the gene embedding."""

    def __init__(self, n_embed: int, n_bins: int = 10, hidden_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp_count_0 = Linear(1, hidden_dim, True, dtype)
        self.mlp_count_1 = Linear(hidden_dim, n_bins, True, dtype)
        self.bin_embeddings = nn.Parameter(torch.zeros(n_bins, n_embed))

    def forward(self, genes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        weights = torch.softmax(self.mlp_count_1(silu(self.mlp_count_0(counts))), dim=-1)
        return genes + weights @ self.bin_embeddings.to(self.dtype)


_PROJECTIONS = dict(zip(LEARNED_TRANSFORMS, (Projection, ProjectionConcat, SoftBinProjection)))


class InputTransformerVAE(nn.Module):
    """Gene-embedding table (row 0 is <MASK>) with the count injected by
    `agg_func`: one of the stateless `ops.transforms.COUNT_TRANSFORMS`
    (log1p, every shipped config's, log1pzero, anscombe, sqrt) or a learned
    projection (proj, projconcat, softbin). Another name raises, as in JAX."""

    def __init__(self, n_genes: int, n_embed: int, agg_func: str = "log1p",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.agg_func = dtype, agg_func
        self.gene_embedding = nn.Embedding(n_genes + 1, n_embed)
        if agg_func in _PROJECTIONS:
            self.projection = _PROJECTIONS[agg_func](n_embed, dtype=dtype)
        elif agg_func in COUNT_TRANSFORMS:
            self.transform = COUNT_TRANSFORMS[agg_func]
        else:
            raise ValueError(f"Unknown agg_func: {agg_func}")

    def forward(self, counts: torch.Tensor, genes: torch.Tensor) -> torch.Tensor:
        emb = self.embed_genes(genes)
        # the counts cast to the embedding's dtype first, as in JAX
        counts = counts[..., None].to(emb.dtype)
        if self.agg_func in _PROJECTIONS:
            return self.projection(emb, counts)
        return self.transform(emb, counts)

    def embed_genes(self, genes: torch.Tensor) -> torch.Tensor:
        return embed(self.gene_embedding, genes, self.dtype)


class SelfAttention(nn.Module):
    """Fused-qkv multi-head self-attention, dropout after the output
    projection."""

    tp = None  # a Megatron group: this rank's heads (`sharding_rules.shard_module_`)

    def __init__(self, n_embed: int, n_head: int, bias: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.n_head, self.dropout = n_head, dropout
        self.c_attn = Linear(n_embed, 3 * n_embed, bias, dtype)
        self.c_proj = Linear(n_embed, n_embed, bias, dtype)

    def forward(self, x: torch.Tensor, drops: Optional[Drops] = None) -> torch.Tensor:
        B, S, D = x.shape
        hd, heads = D // self.n_head, _local_heads(self)
        if self.tp is None:
            qkv = self.c_attn(x)
        else:
            dt = self.c_attn.compute_dtype
            qkv = column(column_input(x, self.tp, dt), self.c_attn, dt)
        q, k, v = (a.reshape(B, S, heads, hd) for a in qkv.chunk(3, dim=-1))
        y = _out_proj(self, sdpa(q, k, v).reshape(B, S, heads * hd))
        return drop(y, self.dropout, self, drops)


def _local_heads(attn: nn.Module) -> int:
    return attn.n_head if attn.tp is None else attn.n_head // attn.tp.size


def _out_proj(attn: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """The attention's output projection; row-parallel over its heads under
    Megatron."""
    if attn.tp is None:
        return attn.c_proj(y)
    return row_parallel(y, attn.c_proj, attn.tp, attn.c_proj.compute_dtype)


class CrossAttention(nn.Module):
    """Cross-attention: k/v from x, queries projected separately, dropout
    after the output projection. 2-D queries (M, E) are shared by the whole
    batch; 3-D queries (B, M, E) are not."""

    tp = None  # a Megatron group: this rank's heads (`sharding_rules.shard_module_`)

    def __init__(self, n_embed: int, n_head: int, bias: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.n_head, self.dropout = n_head, dropout
        self.c_attn = Linear(n_embed, 2 * n_embed, bias, dtype)
        self.c_attn_q = Linear(n_embed, n_embed, bias, dtype)
        self.c_proj = Linear(n_embed, n_embed, bias, dtype)

    def forward(self, x: torch.Tensor, q: torch.Tensor,
                drops: Optional[Drops] = None) -> torch.Tensor:
        B, S, _ = x.shape
        M, D = q.shape[-2], q.shape[-1]
        hd, heads = D // self.n_head, _local_heads(self)
        if self.tp is None:
            kv, q = self.c_attn(x), self.c_attn_q(q)
        else:
            dt = self.c_attn.compute_dtype
            kv = column(column_input(x, self.tp, dt), self.c_attn, dt)
            q = column(column_input(q, self.tp, dt), self.c_attn_q, dt)
        k, v = (a.reshape(B, S, heads, hd) for a in kv.chunk(2, dim=-1))
        if q.ndim == 2:
            y = sdpa_shared_q(q.reshape(M, heads, hd), k, v)
        else:
            y = sdpa(q.reshape(B, M, heads, hd), k, v)
        return drop(_out_proj(self, y.reshape(B, M, heads * hd)), self.dropout, self, drops)


class MLP(nn.Module):
    """SwiGLU MLP, hidden = 2/3 * 4E rounded up to a multiple of `multiple_of`;
    under Megatron (`tp`) over this rank's hidden slice."""

    tp = None

    def __init__(self, n_embed: int, multiple_of: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(2 * (n_embed * 4) / 3)
        hidden = multiple_of * ((hidden + multiple_of - 1) // multiple_of)
        self.w1 = Linear(n_embed, hidden, False, dtype)
        self.w2 = Linear(n_embed, hidden, False, dtype)
        self.c_proj = Linear(hidden, n_embed, False, dtype)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """In the module's dtype, or in `dtype` where a call names one."""
        if self.tp is None:
            return self.c_proj(silu(self.w1(x, dtype)) * self.w2(x, dtype), dtype)
        dt = self.w1.compute_dtype if dtype is None else dtype
        xc = column_input(x, self.tp, dt)
        h = silu(column(xc, self.w1, dt)) * column(xc, self.w2, dt)
        return row_parallel(h, self.c_proj, self.tp, dt)


def _adaln(n_embed: int, chunks: int, dtype: torch.dtype) -> nn.Sequential:
    """SiLU then Linear(E -> chunks * E): an adaLN modulation of the condition."""
    return nn.Sequential(SiLU(), Linear(n_embed, chunks * n_embed, compute_dtype=dtype))


class Block(nn.Module):
    """Pre-LN transformer block, optionally adaLN-zero conditioned; dropout
    inside the attention."""

    def __init__(
        self,
        n_embed: int,
        n_head: int,
        bias: bool = False,
        multiple_of: int = 4,
        layernorm_eps: float = 1e-8,
        use_adaln: bool = False,
        elementwise_affine: bool = True,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.use_adaln = use_adaln
        self.ln_1 = LayerNormFP32(n_embed, layernorm_eps, elementwise_affine)
        self.ln_2 = LayerNormFP32(n_embed, layernorm_eps, elementwise_affine)
        self.attn = SelfAttention(n_embed, n_head, bias, dtype, dropout)
        self.mlp = MLP(n_embed, multiple_of, dtype)
        if use_adaln:
            self.adaln_modulation = _adaln(n_embed, 6, dtype)

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None,
                drops: Optional[Drops] = None) -> torch.Tensor:
        if not self.use_adaln:
            x = x + self.attn(self.ln_1(x), drops)
            return x + self.mlp(self.ln_2(x))
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = (
            self.adaln_modulation(condition).chunk(6, dim=-1)
        )
        # the reference calls modulate() with swapped arguments: the chunk
        # named shift multiplies and the one named scale shifts
        x = x + gate_a * self.attn(modulate(self.ln_1(x), scale_a, shift_a), drops)
        return x + gate_m * self.mlp(modulate(self.ln_2(x), scale_m, shift_m))


class CrossAttentionBlock(nn.Module):
    """The MCAB. With `n_inducing_points > 0` learned queries pool the token
    axis; with 0 the caller's queries unpool it. out = q + attn(ln(x), ln(q)),
    then a SwiGLU residual. `use_adaln` modulates both LayerNorm'd inputs
    and gates both residuals from the condition (adaLN-zero, the queries'
    own `adaln_modulation_q`), with the reference's swapped modulate
    arguments, as `Block`."""

    def __init__(
        self,
        n_embed: int,
        n_inducing_points: int,
        n_head: int,
        bias: bool = False,
        multiple_of: int = 4,
        layernorm_eps: float = 1e-8,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
        use_adaln: bool = False,
    ):
        super().__init__()
        self.dtype, self.use_adaln = dtype, use_adaln
        if n_inducing_points > 0:
            self.inducing_points = nn.Parameter(torch.zeros(n_inducing_points, n_embed))
        self.ln_1 = LayerNormFP32(n_embed, layernorm_eps)
        self.ln_1q = LayerNormFP32(n_embed, layernorm_eps)
        self.ln_2 = LayerNormFP32(n_embed, layernorm_eps)
        self.attn = CrossAttention(n_embed, n_head, bias, dtype, dropout)
        self.mlp = MLP(n_embed, multiple_of, dtype)
        if use_adaln:
            self.adaln_modulation = _adaln(n_embed, 6, dtype)
            self.adaln_modulation_q = _adaln(n_embed, 2, dtype)

    def forward(self, x: torch.Tensor, q: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                drops: Optional[Drops] = None) -> torch.Tensor:
        if q is None:
            q = self.inducing_points.to(self.dtype).expand(x.shape[0], -1, -1)
        if not self.use_adaln:
            out = self.attn(self.ln_1(x), self.ln_1q(q), drops) + (q[None] if q.ndim == 2 else q)
            return out + self.mlp(self.ln_2(out))
        if q.ndim == 2:  # per-cell modulation of the queries: the batched layout
            q = q.expand(x.shape[0], -1, -1)
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = (
            self.adaln_modulation(condition).chunk(6, dim=-1)
        )
        shift_q, scale_q = self.adaln_modulation_q(condition).chunk(2, dim=-1)
        h_x = modulate(self.ln_1(x), scale_a, shift_a)
        h_q = modulate(self.ln_1q(q), scale_q, shift_q)
        out = q + gate_a * self.attn(h_x, h_q, drops)
        return out + gate_m * self.mlp(modulate(self.ln_2(out), scale_m, shift_m))


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding -> 2-layer MLP."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.dtype = dtype
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size, compute_dtype=dtype),
            SiLU(),
            Linear(hidden_size, hidden_size, compute_dtype=dtype),
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

    def forward(self, t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """In the module's dtype, or in `dtype` where a call names one."""
        dtype = self.dtype if dtype is None else dtype
        t_freq = self.timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp[2](silu(self.mlp[0](t_freq, dtype)), dtype)


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
        self, n_embed: int, n_embed_input: int, bias: bool = True, layernorm_eps: float = 1e-8,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.adaln_modulation = nn.Sequential(
            SiLU(), Linear(n_embed, 2 * n_embed, bias, dtype))
        self.norm_final = LayerNormFP32(n_embed, layernorm_eps, affine=False)
        self.linear = Linear(n_embed, n_embed_input, bias, dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """-> f32 (JAX casts the DiT's output to f32: `linear_f32`)."""
        shift, scale = self.adaln_modulation(c).chunk(2, dim=-1)
        h = modulate(self.norm_final(x), shift, scale)
        return linear_f32(h, self.linear, self.linear.compute_dtype)
