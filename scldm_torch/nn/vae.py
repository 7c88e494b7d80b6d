"""The transformer set-VAE and the scVI baseline (counterpart of
scldm_tpu/nn/vae.py).

The transformer VAE is deterministic in the LDM pipeline: the latent is the
LayerNorm'd linear output of the encoder. Every variant JAX's builder takes
is built: the seven input layers (`agg_func`), dropout, the encoder without
its positional table, the decoder with its own gene embedding, the NB head
with shared or per-token theta at any temperature or the Gaussian head, and
the decoder's `remat_cross` / `cross_chunks`. `ScviVAE` is the stochastic
MLP baseline with an explicit Gaussian posterior."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from scldm_torch.nn.heads import (
    GaussianLinearHead,
    GaussianTransformerHead,
    NegativeBinomialLinearHead,
    NegativeBinomialTransformerHead,
    softmax_genes,
)
from scldm_torch.nn.layers import Drops, InputTransformerVAE
from scldm_torch.nn.nnets import Decoder, DecoderScvi, Encoder, EncoderScvi


class TransformerVAE(nn.Module):
    """input_layer -> MCAB encoder -> equivariant decoder -> likelihood head.
    The head's parameters are {"mu", "theta"} (NB) or {"mu"} (Gaussian).
    `drops` (`layers.Drops`) gives a training forward its dropout draws."""

    def __init__(
        self,
        encoder: Encoder,
        decoder: Decoder,
        decoder_head: nn.Module,
        input_layer: InputTransformerVAE,
    ):
        super().__init__()
        self.input_layer = input_layer
        self.encoder = encoder
        self.decoder = decoder
        self.decoder_head = decoder_head

    def _decoder_queries(self, genes: torch.Tensor) -> torch.Tensor:
        """The decoder's queries: the input layer's embeddings of `genes`
        under the shared embedding, else the ids (the decoder embeds them)."""
        if self.decoder.shared_embedding:
            return self.input_layer.embed_genes(genes)
        return genes

    def _head_params(
        self, h_x: torch.Tensor, genes: torch.Tensor, library_size: torch.Tensor,
        softmax: Callable[[torch.Tensor], torch.Tensor] = softmax_genes,
    ) -> Dict[str, torch.Tensor]:
        if isinstance(self.decoder_head, GaussianTransformerHead):
            return {"mu": self.decoder_head(h_x)}
        mu, theta = self.decoder_head(h_x, genes, library_size, softmax)
        return {"mu": mu, "theta": theta}

    def forward(
        self,
        counts: torch.Tensor,  # noqa: ARG002 (unused: the reference's signature)
        genes: torch.Tensor,
        library_size: torch.Tensor,
        counts_subset: torch.Tensor,
        genes_subset: torch.Tensor,
        drops: Optional[Drops] = None,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The full call: encode the token window, decode every gene of
        `genes`. Returns (the head's parameters, h_z)."""
        h_z = self.encoder(self.input_layer(counts_subset, genes_subset), drops)
        h_x = self.decoder(h_z, self._decoder_queries(genes), drops)
        return self._head_params(h_x, genes, library_size), h_z

    def encode(
        self,
        counts: torch.Tensor,
        genes: torch.Tensor,
        counts_subset: Optional[torch.Tensor] = None,
        genes_subset: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        emb = self.input_layer(
            counts_subset if counts_subset is not None else counts,
            genes_subset if genes_subset is not None else genes,
        )
        return self.encoder(emb)

    def decode(
        self, z: torch.Tensor, genes: torch.Tensor, library_size: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """z (B, M, E_latent); genes (G,) shared by the batch or (B, G);
        library_size (B, 1) -> {"mu": (B, G), "theta": (G,) or (B, G)} (NB)
        or {"mu": (B, G)} (Gaussian)."""
        return self._head_params(
            self.decoder(z, self._decoder_queries(genes)), genes, library_size
        )


DECODER_HEADS = ("negative_binomial_shared_theta", "negative_binomial_unshared_theta", "gaussian")


def build_transformer_vae(
    *,
    n_genes: int,
    n_embed: int = 32,
    n_embed_latent: int = 16,
    n_layer: int = 8,
    n_inducing_points: int = 16,
    n_head: int = 8,
    n_head_cross: int = 4,
    dropout: float = 0.0,
    bias: bool = False,
    multiple_of: int = 4,
    layernorm_eps: float = 1e-8,
    positional_encoding: bool = True,
    shared_embedding: bool = True,
    agg_func: str = "log1p",
    decoder_head: str = "negative_binomial_shared_theta",
    head_temperature: float = 1.0,
    remat: bool = False,
    remat_cross: bool = False,
    cross_chunks: int = 1,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> TransformerVAE:
    """A TransformerVAE with the reference default architecture
    (configs/model/vae_base.yaml) unless told otherwise, with JAX's
    `build_transformer_vae` arguments, its f32 parameters built on `device`
    (the card unless the caller asks for the CPU; without a card "cuda"
    raises), computing in `dtype`, each trunk block recomputed in the
    backward with `remat`. An unknown `decoder_head` or `agg_func` raises a
    ValueError, as in JAX."""
    if decoder_head not in DECODER_HEADS:
        raise ValueError(f"Unknown decoder_head: {decoder_head}")
    with torch.device(device):
        encoder = Encoder(
            n_layer, n_inducing_points, n_embed, n_embed_latent, n_head, n_head_cross,
            bias, multiple_of, layernorm_eps, remat, dtype, dropout, positional_encoding,
        )
        decoder = Decoder(
            n_genes, n_embed, n_embed_latent, n_head, n_head_cross, n_layer,
            bias, multiple_of, layernorm_eps, remat, dtype, dropout, shared_embedding,
            remat_cross, cross_chunks,
        )
        if decoder_head == "gaussian":
            head = GaussianTransformerHead(n_embed, layernorm_eps, dtype)
        else:
            head = NegativeBinomialTransformerHead(
                n_genes, n_embed, dtype, shared_theta=decoder_head.endswith("_shared_theta"),
                t=head_temperature)
        return TransformerVAE(encoder, decoder, head,
                              InputTransformerVAE(n_genes, n_embed, agg_func, dtype))


class ScviVAE(nn.Module):
    """The scVI baseline: an MLP VAE with a Gaussian posterior and the
    reparameterised latent z = loc + eps * scale (counterpart of JAX's
    `ScviVAE`). Every draw (eps, the dropout masks) comes from `generator`
    unless `noise` gives it: {"eps": (B, n_latent), "keep": {"encoder":
    [mask a layer], "decoder": [...]}}, either key optional."""

    def __init__(self, encoder: EncoderScvi, encoder_head: GaussianLinearHead,
                 decoder: DecoderScvi, decoder_head: NegativeBinomialLinearHead):
        super().__init__()
        self.encoder = encoder
        self.encoder_head = encoder_head
        self.decoder = decoder
        self.decoder_head = decoder_head

    def forward(
        self,
        counts: torch.Tensor,  # (B, n_genes)
        library_size: torch.Tensor,  # (B, 1)
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Dict] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Returns ({"mu", "theta"}, (loc, scale), z)."""
        noise = noise or {}
        keep = noise.get("keep") or {}
        h = self.encoder(counts, train, generator, keep.get("encoder"))
        loc, scale = self.encoder_head(h)
        eps = noise.get("eps")
        if eps is None:
            eps = torch.randn(loc.shape, generator=generator, device=loc.device)
        z = loc + eps * scale
        h_x = self.decoder(z, train, generator, keep.get("decoder"))
        mu, theta = self.decoder_head(h_x, library_size)
        return {"mu": mu, "theta": theta}, (loc, scale), z

    def decode(self, z: torch.Tensor, library_size: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The decoder and NB head in evaluation mode (running averages, no
        dropout)."""
        mu, theta = self.decoder_head(self.decoder(z), library_size)
        return {"mu": mu, "theta": theta}


def build_scvi_vae(
    *,
    n_genes: int,
    n_hidden: int = 128,
    n_latent: int = 10,
    n_layers: int = 1,
    dropout: float = 0.1,
    shared_theta: bool = True,
    device: torch.device | str = "cuda",
) -> ScviVAE:
    """An ScviVAE (configs/model/vae_scvi.yaml's defaults) in f32 on
    `device` (the card unless the caller asks for the CPU)."""
    with torch.device(device):
        return ScviVAE(
            EncoderScvi(n_genes, n_hidden, n_layers, dropout),
            GaussianLinearHead(n_hidden, n_latent),
            DecoderScvi(n_latent, n_hidden, n_layers, dropout),
            NegativeBinomialLinearHead(n_genes, n_hidden, shared_theta),
        )
