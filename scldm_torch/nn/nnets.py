"""Network cores: the set Encoder/Decoder and the DiT denoiser (counterpart
of scldm_tpu/nn/nnets.py). The DiT's sampling-time conditioning sums the
class tables without dropout; its training conditioning (`embed_condition`)
adds CFG dropout and the random class selection of the mutually exclusive
strategy, with every draw from a `torch.Generator` or injected."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from scldm_torch.nn.layers import (
    Block,
    CrossAttentionBlock,
    FinalLayerDiT,
    LayerNormFP32,
    TimestepEmbedder,
    get_1d_sincos_pos_embed,
)


class Encoder(nn.Module):
    """MCAB pooling of the gene tokens into `n_inducing_points` latent tokens,
    `n_layer` self-attention blocks, then Linear(E -> E_latent) + non-affine LN.

    `pos_embed` is the reference's all-zeros, never-trained positional table
    (`positional_encoding: true` in every shipped config), kept so that its
    checkpoints load."""

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
    ):
        super().__init__()
        self.n_inducing_points = n_inducing_points
        self.n_embed_latent = n_embed_latent
        self.ca_layer = CrossAttentionBlock(
            n_embed, n_inducing_points, n_head_cross, bias, multiple_of, layernorm_eps
        )
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_inducing_points, n_embed), requires_grad=False
        )
        self.encoder_layers = nn.ModuleList(
            Block(n_embed, n_head, bias, multiple_of, layernorm_eps) for _ in range(n_layer)
        )
        self.encoder_latent_input = nn.Sequential(
            nn.Linear(n_embed, n_embed_latent, bias=bias),
            LayerNormFP32(n_embed_latent, layernorm_eps, affine=False),
        )

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Everything after the MCAB pooling, from the pooled (B, M, E) tokens
        (JAX `skip_pool=True`): the frozen positional table, the blocks, the
        latent projection and LN. The input of the fused encoder pools."""
        x = x + self.pos_embed.to(x.dtype)
        for block in self.encoder_layers:
            x = block(x)
        return self.encoder_latent_input(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(self.ca_layer(x))


class Decoder(nn.Module):
    """Latent tokens -> per-gene hidden states through gene-embedding queries:
    (G, E) queries shared by the batch, or (B, G, E) per cell."""

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
    ):
        super().__init__()
        self.n_genes = n_genes
        self.n_embed = n_embed
        self.decoder_latent_input = nn.Sequential(
            LayerNormFP32(n_embed_latent, layernorm_eps, affine=False),
            nn.Linear(n_embed_latent, n_embed, bias=bias),
        )
        self.decoder_layers = nn.ModuleList(
            Block(n_embed, n_head, bias, multiple_of, layernorm_eps) for _ in range(n_layer)
        )
        self.decoder_cross_attention = CrossAttentionBlock(
            n_embed, 0, n_head_cross, bias, multiple_of, layernorm_eps
        )

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Latent LN + projection + the self-attention blocks: the (B, M, E)
        pre-cross latents (JAX `trunk_only=True`), the input of the fused tail."""
        x = self.decoder_latent_input(x)
        for block in self.decoder_layers:
            x = block(x)
        return x

    def forward(self, x: torch.Tensor, gene_queries: torch.Tensor) -> torch.Tensor:
        if gene_queries.ndim not in (2, 3) or not gene_queries.is_floating_point():
            raise ValueError("the decoder expects pre-embedded gene queries (G, E) or (B, G, E)")
        return self.decoder_cross_attention(self.trunk(x), gene_queries)


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
    `cfg_dropout_prob > 0`), the unconditional token of guidance."""

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
    ):
        super().__init__()
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
        self.t_embedder = TimestepEmbedder(n_embed)
        self.blocks = nn.ModuleList(
            Block(n_embed, n_head, bias, multiple_of, layernorm_eps,
                  use_adaln=True, elementwise_affine=False)
            for _ in range(n_layer)
        )
        self.input_proj = nn.Linear(n_embed_input, n_embed, bias=bias)
        self.final_layer = FinalLayerDiT(n_embed, n_embed_input, bias, layernorm_eps)
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
        emb = torch.zeros((), device=self.pos_embed.device)
        for name in sorted(self.class_vocab_sizes):
            if name in condition:
                vals = condition[name].long()
            else:
                vals = self._null_tokens(name, rows)
            emb = emb + self.class_embeddings[name](vals)
        return emb

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

        emb = torch.zeros(rows, self.n_embed, device=device)
        single = len(names) == 1 and drop_mask is None
        for name in names:
            if name in available:
                vals = condition[name].long()
                if single:
                    # one class, no dropout: no null token is consumed
                    emb = emb + self.class_embeddings[name](vals)
                    continue
                null = self._null_tokens(name, rows)
                cond_or_null = vals if drop_mask is None else torch.where(drop_mask, null, vals)
                vals = torch.where(selected == available.index(name), cond_or_null, null)
            else:
                vals = self._null_tokens(name, rows)
            emb = emb + self.class_embeddings[name](vals)
        return emb

    def _joint_embedding(self, condition, rows, force_drop, generator, drop_mask) -> torch.Tensor:
        names = sorted(self.class_vocab_sizes)
        device = self.pos_embed.device
        emb = torch.zeros(rows, self.n_embed, device=device)
        if not any(n in condition for n in names):
            return emb
        if not force_drop:
            drop_mask = torch.zeros(rows, dtype=torch.bool, device=device)
        elif drop_mask is None:
            drop_mask = self._drop_mask(rows, generator)
        for name in names:
            null = self._null_tokens(name, rows)
            vals = torch.where(drop_mask, null, condition[name].long()) if name in condition else null
            emb = emb + self.class_embeddings[name](vals)
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

    def trunk(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """The blocks and the final layer under a (B, n_embed) conditioning."""
        c = c[:, None, :]
        x = self.input_proj(x) + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x, c)
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
    ) -> torch.Tensor:
        """At `train`, the training conditioning of `embed_condition`;
        otherwise the sampling-time one, class tables summed without dropout."""
        if train:
            c = self.embed_condition(t, condition, generator, train=True, selected=selected,
                                     drop_mask=drop_mask)
        else:
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
