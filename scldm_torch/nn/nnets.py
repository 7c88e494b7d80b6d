"""Network cores: the scVI baseline's MLPs, the set Encoder/Decoder and the
DiT denoiser (counterpart of scldm_tpu/nn/nnets.py). The DiT's
sampling-time conditioning sums the class tables without dropout; its
training conditioning (`embed_condition`) adds CFG dropout and the random
class selection of the mutually exclusive strategy, with every draw from a
`torch.Generator` or injected.

`dtype` is JAX's compute dtype (`nn/layers.py`); `remat` recomputes each
trunk block in the backward (JAX `nn.remat` around `Block`), which changes
memory, not numbers. `dropout` acts in every attention of the trunks and
the cross blocks where a forward is given `drops` (`layers.Drops`). Cut to
a Megatron rank's slices (`parallel/sharding_rules.shard_module_`), the
Encoder, the Decoder (its own gene table too) and the DiT (its class tables
and adaLN projections) run on them through `nn/layers.py`'s layers."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from scldm_torch.nn.layers import (
    Block,
    CrossAttentionBlock,
    Drops,
    FinalLayerDiT,
    LayerNormFP32,
    Linear,
    TimestepEmbedder,
    checkpointed,
    dropout,
    embed,
    get_1d_sincos_pos_embed,
)


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over the last axis, which `nn.BatchNorm1d` with
    its defaults is not: running averages with momentum 0.99 (torch's 0.01),
    updated with the biased batch variance E[x^2] - E[x]^2 (clipped at 0,
    the variance it normalises by), eps 1e-5. With `train` the batch's
    statistics normalise and the buffers move; otherwise the running
    averages normalise. The buffers are JAX's `batch_stats` (`mean`, `var`).
    With `group` (the data ranks of a mesh) the batch is every rank's rows:
    the row sums of x and x^2 and the row count are summed over it
    (`parallel.data_parallel.sync_sum`), as JAX's statistics of a batch
    sharded over its mesh."""

    def __init__(self, n: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.group = None
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            dims = tuple(range(x.ndim - 1))
            if self.group is None:
                mean, mean_sq = x.mean(dims), x.square().mean(dims)
            else:
                from scldm_torch.parallel.data_parallel import sync_sum

                n = x.shape[-1]
                rows = x.new_tensor([x.numel() // n])
                sums = sync_sum(torch.cat([x.sum(dims), x.square().sum(dims), rows]), self.group)
                mean, mean_sq = sums[:n] / sums[-1], sums[n: 2 * n] / sums[-1]
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class _ScviMLP(nn.Module):
    """`n_layers` of Dense, BatchNorm, SiLU and (at train time, where
    `dropout` > 0) Dropout, the scVI baseline's encoder and decoder body.
    `keep` injects one dropout mask a layer in place of draws from
    `generator`."""

    def __init__(self, n_in: int, n_hidden: int, n_layers: int, dropout: float):
        super().__init__()
        self.n_layers, self.dropout = n_layers, dropout
        for i in range(n_layers):
            self.add_module(f"dense_{i}", Linear(n_in if i == 0 else n_hidden, n_hidden))
            self.add_module(f"bn_{i}", BatchNorm(n_hidden))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = F.silu(getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x), train))
            if train and self.dropout > 0:
                x = dropout(x, self.dropout, None if keep is None else keep[i], generator)
        return x


class EncoderScvi(_ScviMLP):
    """log1p(counts), then the MLP body: (B, n_genes) -> (B, n_hidden)."""

    def __init__(self, n_genes: int, n_hidden: int, n_layers: int, dropout: float = 0.0):
        super().__init__(n_genes, n_hidden, n_layers, dropout)

    def forward(self, x, train=False, generator=None, keep=None):
        return super().forward(torch.log1p(x), train, generator, keep)


class DecoderScvi(_ScviMLP):
    """The MLP body over the latent: (B, n_latent) -> (B, n_hidden)."""

    def __init__(self, n_latent: int, n_hidden: int, n_layers: int, dropout: float = 0.0):
        super().__init__(n_latent, n_hidden, n_layers, dropout)


class Encoder(nn.Module):
    """MCAB pooling of the gene tokens into `n_inducing_points` latent tokens,
    `n_layer` self-attention blocks, then Linear(E -> E_latent) + non-affine LN.

    With `positional_encoding` (every shipped config) `pos_embed` is the
    reference's all-zeros, never-trained positional table, kept so that its
    checkpoints load; without it there is no such parameter."""

    def __init__(
        self,
        n_layer: int,
        n_inducing_points: int,
        n_embed: int,
        n_embed_latent: int,
        n_head: int,
        n_head_cross: int,
        bias: bool = False,
        multiple_of: int = 4,
        layernorm_eps: float = 1e-8,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
        positional_encoding: bool = True,
    ):
        super().__init__()
        self.n_inducing_points = n_inducing_points
        self.n_embed, self.n_embed_latent = n_embed, n_embed_latent
        self.remat, self.dtype, self.dropout = remat, dtype, dropout
        self.ca_layer = CrossAttentionBlock(
            n_embed, n_inducing_points, n_head_cross, bias, multiple_of, layernorm_eps, dtype,
            dropout,
        )
        if positional_encoding:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, n_inducing_points, n_embed), requires_grad=False
            )
        else:
            self.pos_embed = None
        self.encoder_layers = nn.ModuleList(
            Block(n_embed, n_head, bias, multiple_of, layernorm_eps, dtype=dtype, dropout=dropout)
            for _ in range(n_layer)
        )
        self.encoder_latent_input = nn.Sequential(
            Linear(n_embed, n_embed_latent, bias, dtype),
            LayerNormFP32(n_embed_latent, layernorm_eps, affine=False),
        )

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.pos_embed is None else x + self.pos_embed.to(x.dtype)

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """The MCAB pooling and the frozen positional table (JAX
        `pool_only=True`): the (B, M, E) input of the blocks, for the
        whole-trunk kernel (`training/vae_task._encoder_trunk_tail`)."""
        return self._positions(self.ca_layer(x))

    def trunk(self, x: torch.Tensor, drops: Optional[Drops] = None) -> torch.Tensor:
        """Everything after the MCAB pooling, from the pooled (B, M, E) tokens
        (JAX `skip_pool=True`): the frozen positional table, the blocks, the
        latent projection and LN. The input of the fused encoder pools."""
        x = self._positions(x)
        for block in self.encoder_layers:
            x = checkpointed(block, x, None, drops) if self.remat else block(x, None, drops)
        return self.encoder_latent_input(x)

    def forward(self, x: torch.Tensor, drops: Optional[Drops] = None) -> torch.Tensor:
        return self.trunk(self.ca_layer(x, drops=drops), drops)


class Decoder(nn.Module):
    """Latent tokens -> per-gene hidden states through gene queries. With
    `shared_embedding` (every shipped config) the caller gives the queries
    pre-embedded from the input layer's table, (G, E) shared by the batch or
    (B, G, E) per cell; without it the decoder embeds gene ids, (G,) or
    (B, G), in a table of its own.

    `remat_cross` recomputes the gene-axis cross block in the backward, and
    `cross_chunks` runs it over that many slices of the gene axis (padded to
    a multiple, cut back after), which is exact: genes attend only to the
    latents. Together they bound the cross block's live memory by one
    slice's."""

    def __init__(
        self,
        n_genes: int,
        n_embed: int,
        n_embed_latent: int,
        n_head: int,
        n_head_cross: int,
        n_layer: int,
        bias: bool = False,
        multiple_of: int = 4,
        layernorm_eps: float = 1e-8,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
        shared_embedding: bool = True,
        remat_cross: bool = False,
        cross_chunks: int = 1,
    ):
        super().__init__()
        self.n_genes = n_genes
        self.n_embed = n_embed
        self.remat, self.dtype, self.dropout = remat, dtype, dropout
        self.shared_embedding = shared_embedding
        self.remat_cross, self.cross_chunks = remat_cross, cross_chunks
        self.decoder_latent_input = nn.Sequential(
            LayerNormFP32(n_embed_latent, layernorm_eps, affine=False),
            Linear(n_embed_latent, n_embed, bias, dtype),
        )
        self.decoder_layers = nn.ModuleList(
            Block(n_embed, n_head, bias, multiple_of, layernorm_eps, dtype=dtype, dropout=dropout)
            for _ in range(n_layer)
        )
        if not shared_embedding:
            self.gene_embedding = nn.Embedding(n_genes + 1, n_embed)
        self.decoder_cross_attention = CrossAttentionBlock(
            n_embed, 0, n_head_cross, bias, multiple_of, layernorm_eps, dtype, dropout
        )

    def trunk(self, x: torch.Tensor, drops: Optional[Drops] = None) -> torch.Tensor:
        """Latent LN + projection + the self-attention blocks: the (B, M, E)
        pre-cross latents (JAX `trunk_only=True`), the input of the fused tail."""
        x = self.decoder_latent_input(x)
        for block in self.decoder_layers:
            x = checkpointed(block, x, None, drops) if self.remat else block(x, None, drops)
        return x

    def _cross(self, x: torch.Tensor, q: torch.Tensor, drops: Optional[Drops]) -> torch.Tensor:
        cross = self.decoder_cross_attention
        if self.remat_cross:
            return checkpointed(cross, x, q, None, drops)
        return cross(x, q, None, drops)

    def forward(self, x: torch.Tensor, genes: torch.Tensor,
                drops: Optional[Drops] = None) -> torch.Tensor:
        if self.shared_embedding:
            if genes.ndim not in (2, 3) or not genes.is_floating_point():
                raise ValueError("the decoder expects pre-embedded gene queries (G, E) or "
                                 "(B, G, E)")
            q = genes
        else:
            q = embed(self.gene_embedding, genes, self.dtype)
        x = self.trunk(x, drops)
        if self.cross_chunks <= 1:
            return self._cross(x, q, drops)
        # the same module over slices of the gene axis, each call its own dropout draws
        G = q.shape[-2]
        cs = -(-G // self.cross_chunks)
        pad = cs * self.cross_chunks - G
        if pad:
            q = torch.cat([q, q.new_zeros(q.shape[:-2] + (pad, q.shape[-1]))], dim=-2)
        outs = [
            self._cross(x, q[..., i * cs : (i + 1) * cs, :],
                        None if drops is None else drops.at_call(i))
            for i in range(self.cross_chunks)
        ]
        return torch.cat(outs, dim=-2)[..., :G, :]


def build_cfg_segments(x, t, condition, cfg_scale, class_vocab_sizes, strategy):
    """The fused-CFG row layout [uncond(2B) | per-class cond(B) ...].

    Returns (seg_x, seg_t, seg_cond, scale_segments, batch, half); null ids
    equal the class's vocab size."""
    batch = x.shape[0]
    half = batch // 2
    class_names = tuple(sorted(class_vocab_sizes.keys()))

    def null(n, rows):
        return torch.full((rows,), class_vocab_sizes[n], dtype=torch.int64, device=x.device)

    if not (condition and cfg_scale and class_names):
        return x, t, {n: null(n, batch) for n in class_names}, [], batch, half

    if strategy == "joint":
        seg_x = torch.cat([x, x[half:]])
        seg_t = torch.cat([t, t[half:]])
        seg_cond = {
            n: torch.cat([
                null(n, batch),
                condition[n][half:].long() if n in condition else null(n, half),
            ])
            for n in class_names
        }
        scale_segments = [("__joint__", sum(cfg_scale.values()) / len(cfg_scale))]
    else:
        scale_names = sorted(cfg_scale.keys())
        seg_x = torch.cat([x] + [x[half:]] * len(scale_names))
        seg_t = torch.cat([t] + [t[half:]] * len(scale_names))
        seg_cond = {}
        for n in class_names:
            cols = [null(n, batch)]
            for name in scale_names:
                cols.append(
                    condition[n][half:].long()
                    if n == name and n in condition
                    else null(n, half)
                )
            seg_cond[n] = torch.cat(cols)
        scale_segments = [(name, cfg_scale[name]) for name in scale_names]
    return seg_x, seg_t, seg_cond, scale_segments, batch, half


def combine_cfg_segments(out, scale_segments, batch, half):
    """Fold the segmented output back into [uncond(B/2) | guided(B/2)]."""
    uncond_out = out[:batch]
    base_half = uncond_out[half:]
    guided = base_half
    for i, (_, scale) in enumerate(scale_segments):
        cond_pred = out[batch + i * half : batch + (i + 1) * half]
        guided = guided + scale * (cond_pred - base_half)
    return torch.cat([uncond_out[:half], guided])


class DiT(nn.Module):
    """Diffusion Transformer over latent tokens with adaLN-zero conditioning.

    Each class table holds one extra null row at index `vocab_size` (when
    `cfg_dropout_prob > 0`), the unconditional token of guidance. `dropout`
    acts in each block's attention where a training forward is given
    `drops`."""

    def __init__(
        self,
        n_embed: int,
        n_embed_input: int,
        n_layer: int,
        n_head: int,
        seq_len: int,
        bias: bool = True,
        multiple_of: int = 4,
        layernorm_eps: float = 1e-8,
        class_vocab_sizes: Optional[Dict[str, int]] = None,
        cfg_dropout_prob: float = 0.1,
        condition_strategy: str = "mutually_exclusive",
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.remat, self.dtype, self.dropout = remat, dtype, dropout
        self.n_embed, self.n_embed_input = n_embed, n_embed_input
        self.n_layer, self.n_head, self.seq_len = n_layer, n_head, seq_len
        self.layernorm_eps = layernorm_eps
        self.class_vocab_sizes = dict(class_vocab_sizes or {})
        self.cfg_dropout_prob = cfg_dropout_prob
        self.condition_strategy = condition_strategy
        extra = int(cfg_dropout_prob > 0)
        self.class_embeddings = nn.ModuleDict(
            {n: nn.Embedding(v + extra, n_embed) for n, v in sorted(self.class_vocab_sizes.items())}
        )
        self.t_embedder = TimestepEmbedder(n_embed, dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(n_embed, n_head, bias, multiple_of, layernorm_eps,
                  use_adaln=True, elementwise_affine=False, dtype=dtype, dropout=dropout)
            for _ in range(n_layer)
        )
        self.input_proj = Linear(n_embed_input, n_embed, bias, dtype)
        self.final_layer = FinalLayerDiT(n_embed, n_embed_input, bias, layernorm_eps, dtype)
        pos = torch.from_numpy(get_1d_sincos_pos_embed(n_embed, seq_len))[None]
        self.register_buffer("pos_embed", pos, persistent=False)

    def _check_null_rows(self) -> None:
        if self.cfg_dropout_prob <= 0:
            raise ValueError(
                "null tokens need the CFG embedding row, but cfg_dropout_prob=0 "
                "allocated none; train with cfg_dropout_prob>0 to use CFG"
            )

    def condition_embedding(self, condition: Dict[str, torch.Tensor], rows: int) -> torch.Tensor:
        """No-dropout sum over every class table; absent classes ride as null."""
        emb = torch.zeros((), dtype=self.dtype, device=self.pos_embed.device)
        for name in sorted(self.class_vocab_sizes):
            if name in condition:
                vals = condition[name].long()
            else:
                vals = self._null_tokens(name, rows)
            emb = emb + self._class_embedding(name, vals)
        return emb

    def _class_embedding(self, name: str, vals: torch.Tensor) -> torch.Tensor:
        return embed(self.class_embeddings[name], vals, self.dtype)

    def _null_tokens(self, name: str, rows: int) -> torch.Tensor:
        self._check_null_rows()
        return torch.full((rows,), self.class_vocab_sizes[name], dtype=torch.int64,
                          device=self.pos_embed.device)

    def _drop_mask(self, rows: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Per-row CFG dropout: uniform < cfg_dropout_prob -> null token."""
        if generator is None:
            raise ValueError("training CFG dropout needs a generator (or an injected drop_mask)")
        u = torch.rand(rows, generator=generator, device=generator.device)
        return u.to(self.pos_embed.device) < self.cfg_dropout_prob

    def _mutually_exclusive_embedding(self, condition, rows, force_drop, generator,
                                      selected, drop_mask) -> torch.Tensor:
        names = sorted(self.class_vocab_sizes)
        available = [n for n in names if n in condition]
        device = self.pos_embed.device
        drawn = generator is not None or selected is not None or drop_mask is not None
        if available and (force_drop or len(available) > 1) and drawn:
            if selected is None:
                if generator is None:
                    raise ValueError("class selection needs a generator (or an injected selected)")
                selected = torch.randint(0, len(available), (1,), generator=generator,
                                         device=generator.device)
            if not force_drop:
                drop_mask = None
            elif drop_mask is None:
                drop_mask = self._drop_mask(rows, generator)
        else:
            # no generator: the first available class, no dropout (JAX's no-rng branch)
            if force_drop:
                raise ValueError("training CFG dropout needs a generator (or injected draws)")
            selected, drop_mask = 0, None
        selected = torch.as_tensor(selected, device=device)

        emb = torch.zeros(rows, self.n_embed, dtype=self.dtype, device=device)
        single = len(names) == 1 and drop_mask is None
        for name in names:
            if name in available:
                vals = condition[name].long()
                if single:
                    # one class, no dropout: no null token is consumed
                    emb = emb + self._class_embedding(name, vals)
                    continue
                null = self._null_tokens(name, rows)
                cond_or_null = vals if drop_mask is None else torch.where(drop_mask, null, vals)
                vals = torch.where(selected == available.index(name), cond_or_null, null)
            else:
                vals = self._null_tokens(name, rows)
            emb = emb + self._class_embedding(name, vals)
        return emb

    def _joint_embedding(self, condition, rows, force_drop, generator, drop_mask) -> torch.Tensor:
        names = sorted(self.class_vocab_sizes)
        device = self.pos_embed.device
        emb = torch.zeros(rows, self.n_embed, dtype=self.dtype, device=device)
        if not any(n in condition for n in names):
            return emb
        if not force_drop:
            drop_mask = torch.zeros(rows, dtype=torch.bool, device=device)
        elif drop_mask is None:
            drop_mask = self._drop_mask(rows, generator)
        for name in names:
            null = self._null_tokens(name, rows)
            vals = torch.where(drop_mask, null, condition[name].long()) if name in condition else null
            emb = emb + self._class_embedding(name, vals)
        return emb

    def embed_condition(
        self,
        t: torch.Tensor,  # (B,)
        condition: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        *,
        selected: Optional[torch.Tensor] = None,
        drop_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Timestep plus class-condition embedding (B, n_embed), with the
        JAX module's training conditioning: at `train`, CFG dropout (a row
        whose uniform draw is below `cfg_dropout_prob` takes the null
        tokens) and, for the mutually exclusive strategy, one class drawn
        from those present; the others ride as null. `selected` (the index
        into the present classes, sorted) and `drop_mask` (B,) bool replace
        the draws from `generator`. Without a generator or injected draws
        the first present class is used, with no dropout."""
        c = self.t_embedder(t)
        if not (self.class_vocab_sizes and condition):
            return c
        rows = t.shape[0]
        if self.condition_strategy == "joint":
            return c + self._joint_embedding(condition, rows, train, generator, drop_mask)
        return c + self._mutually_exclusive_embedding(condition, rows, train, generator,
                                                      selected, drop_mask)

    def trunk(self, x: torch.Tensor, c: torch.Tensor,
              drops: Optional[Drops] = None) -> torch.Tensor:
        """The blocks and the final layer under a (B, n_embed) conditioning,
        with the dropout draws of `drops` where given."""
        c = c[:, None, :]
        x = self.input_proj(x)  # in the compute dtype, as the frozen table added to it
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = checkpointed(block, x, c, drops) if self.remat else block(x, c, drops)
        return self.final_layer(x, c).float()

    def forward(
        self,
        x: torch.Tensor,  # (B, seq_len, n_embed_input)
        t: torch.Tensor,  # (B,)
        condition: Optional[Dict[str, torch.Tensor]] = None,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        selected: Optional[torch.Tensor] = None,
        drop_mask: Optional[torch.Tensor] = None,
        drops: Optional[Drops] = None,
    ) -> torch.Tensor:
        """At `train`, the training conditioning of `embed_condition` and the
        blocks' dropout (`drops`, drawn from `generator` unless given, where
        `dropout` > 0); otherwise the sampling-time conditioning, class
        tables summed without dropout, and no dropout."""
        if train:
            c = self.embed_condition(t, condition, generator, train=True, selected=selected,
                                     drop_mask=drop_mask)
            if drops is None and self.dropout > 0:
                if generator is None:
                    raise ValueError("training dropout needs a generator (or injected drops)")
                drops = Drops.draw(self, generator)
            return self.trunk(x, c, drops)
        c = self.t_embedder(t)
        if self.class_vocab_sizes and condition:
            c = c + self.condition_embedding(condition, x.shape[0])
        return self.trunk(x, c)

    def forward_with_cfg_batched(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        condition: Optional[Dict[str, torch.Tensor]] = None,
        cfg_scale: Optional[Dict[str, float]] = None,
    ) -> torch.Tensor:
        """Doubled-batch CFG with every guidance branch in one model call:
        rows = [uncond(2B) | class_1 cond(B) | ... ]; the first half of the
        output is unconditional, the second half guided."""
        if cfg_scale:
            self._check_null_rows()
        seg_x, seg_t, seg_cond, scale_segments, batch, half = build_cfg_segments(
            x, t, condition, cfg_scale, self.class_vocab_sizes, self.condition_strategy
        )
        out = self(seg_x, seg_t, seg_cond)
        if not scale_segments:
            return out
        return combine_cfg_segments(out, scale_segments, batch, half)
