"""Gene-id helpers (counterpart of scldm_tpu/ops/transforms.py)."""

from __future__ import annotations

import torch


def canonical_gene_ids(n_genes: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_genes,) gene-token ids 1..n_genes: the batch-shared decoder queries.

    1-D genes select the decoder's batch-free query path: the gene-embedding
    gather, query LayerNorm and q-projection run once, not per cell."""
    return torch.arange(1, n_genes + 1, dtype=torch.int64, device=device)
