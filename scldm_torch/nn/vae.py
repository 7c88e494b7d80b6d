"""The transformer set-VAE (counterpart of scldm_tpu/nn/vae.py).

Deterministic in the LDM pipeline: the latent is the LayerNorm'd linear
output of the encoder. Only the configuration of the shipped configs is
ported so far: log1p input, shared gene embedding, shared-theta NB head
at temperature 1."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from scldm_torch.nn.heads import NegativeBinomialTransformerHead
from scldm_torch.nn.layers import InputTransformerVAE
from scldm_torch.nn.nnets import Decoder, Encoder


class TransformerVAE(nn.Module):
    """input_layer -> MCAB encoder -> equivariant decoder -> NB head."""

    def __init__(
        self,
        encoder: Encoder,
        decoder: Decoder,
        decoder_head: NegativeBinomialTransformerHead,
        input_layer: InputTransformerVAE,
    ):
        super().__init__()
        self.input_layer = input_layer
        self.encoder = encoder
        self.decoder = decoder
        self.decoder_head = decoder_head

    def _head_params(
        self, h_x: torch.Tensor, genes: torch.Tensor, library_size: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        mu, theta = self.decoder_head(h_x, genes, library_size)
        return {"mu": mu, "theta": theta}

    def forward(
        self,
        counts: torch.Tensor,  # noqa: ARG002 (unused: the reference's signature)
        genes: torch.Tensor,
        library_size: torch.Tensor,
        counts_subset: torch.Tensor,
        genes_subset: torch.Tensor,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The full call: encode the token window, decode every gene of
        `genes`. Returns ({"mu", "theta"}, h_z)."""
        h_z = self.encoder(self.input_layer(counts_subset, genes_subset))
        h_x = self.decoder(h_z, self.input_layer.embed_genes(genes))
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
        library_size (B, 1) -> {"mu": (B, G), "theta": (G,) or (B, G)}."""
        return self._head_params(
            self.decoder(z, self.input_layer.embed_genes(genes)), genes, library_size
        )


def build_transformer_vae(
    *,
    n_genes: int,
    n_embed: int = 32,
    n_embed_latent: int = 16,
    n_layer: int = 8,
    n_inducing_points: int = 16,
    n_head: int = 8,
    n_head_cross: int = 4,
    bias: bool = False,
    multiple_of: int = 4,
    layernorm_eps: float = 1e-8,
) -> TransformerVAE:
    """A TransformerVAE with the reference default architecture
    (configs/model/vae_base.yaml)."""
    encoder = Encoder(
        n_layer, n_inducing_points, n_embed, n_embed_latent, n_head, n_head_cross,
        bias, multiple_of, layernorm_eps,
    )
    decoder = Decoder(
        n_genes, n_embed, n_embed_latent, n_head, n_head_cross, n_layer,
        bias, multiple_of, layernorm_eps,
    )
    head = NegativeBinomialTransformerHead(n_genes, n_embed)
    return TransformerVAE(encoder, decoder, head, InputTransformerVAE(n_genes, n_embed))
