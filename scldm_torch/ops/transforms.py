"""Count and gene-id transforms (counterpart of scldm_tpu/ops/transforms.py)."""

from __future__ import annotations

import torch

GENES_SUBSET, GENES = "genes_subset", "genes"
COUNTS_SUBSET, COUNTS, LIBRARY_SIZE = "counts_subset", "counts", "library_size"
#: batch keys that are not condition labels; every other key of a batch that
#: names a class table is a conditioning column (the JAX package's
#: constants.NON_CONDITION_KEYS)
NON_CONDITION_KEYS = (COUNTS, GENES, LIBRARY_SIZE, GENES_SUBSET, COUNTS_SUBSET)


# The stateless count injections of the input embedding (`agg_func`): each
# takes the gene embeddings (..., S, E) and the counts (..., S, 1), in the
# embeddings' dtype, and returns (..., S, E).
def log1p_transform(genes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """genes * log1p(counts)."""
    return genes * torch.log1p(counts)


def log1p_zero_transform(genes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """log1p with a zero count encoded as -1."""
    return genes * torch.where(counts == 0, -1.0, torch.log1p(counts))


def anscombe_transform(genes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """genes * asinh(sqrt(counts + 1))."""
    return genes * torch.asinh(torch.sqrt(counts + 1.0))


def sqrt_transform(genes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """genes * sqrt(counts + 1)."""
    return genes * torch.sqrt(counts + 1.0)


COUNT_TRANSFORMS = {
    "log1p": log1p_transform,
    "log1pzero": log1p_zero_transform,
    "anscombe": anscombe_transform,
    "sqrt": sqrt_transform,
}

#: the `agg_func` names with learned parameters (`nn.layers`' projections)
LEARNED_TRANSFORMS = ("proj", "projconcat", "softbin")


def canonical_gene_ids(n_genes: int, device: torch.device | str) -> torch.Tensor:
    """(n_genes,) gene-token ids 1..n_genes on `device`: the batch-shared
    decoder queries.

    1-D genes select the decoder's batch-free query path: the gene-embedding
    gather, query LayerNorm and q-projection run once, not per cell."""
    return torch.arange(1, n_genes + 1, dtype=torch.int64, device=device)


def widen_lean(batch: dict) -> dict:
    """Re-widen the uint16 wire format (scldm_tpu data/datamodule lean mode):
    gene-token ids -> int64, counts and library size -> float32. Batches that
    already carry wide dtypes pass through."""
    out = dict(batch)
    for key in (GENES_SUBSET, GENES):
        v = out.get(key)
        if v is not None and v.dtype not in (torch.int32, torch.int64):
            out[key] = v.long()
    for key in (COUNTS_SUBSET, COUNTS, LIBRARY_SIZE):
        v = out.get(key)
        if v is not None and v.dtype != torch.float32:
            out[key] = v.float()
    return out


def densify_expressed(
    genes_subset: torch.Tensor,  # (B, S) gene-token ids, 0 = <MASK> padding
    counts_subset: torch.Tensor,  # (B, S)
    n_genes: int,
    batch_chunk: int = 128,
) -> torch.Tensor:
    """The dense (B, n_genes) count matrix, scattered from the expressed
    (gene, count) pairs in slices of at most `batch_chunk` rows, as the JAX
    package does. Padding tokens (id 0) add nothing."""
    out = []
    for lo in range(0, genes_subset.shape[0], batch_chunk):
        genes = genes_subset[lo : lo + batch_chunk].long()
        cnts = counts_subset[lo : lo + batch_chunk]
        cols = (genes - 1).clamp(0, n_genes - 1)
        vals = torch.where(genes > 0, cnts, torch.zeros((), dtype=cnts.dtype, device=cnts.device))
        dense = torch.zeros((genes.shape[0], n_genes), dtype=cnts.dtype, device=cnts.device)
        out.append(dense.scatter_add_(1, cols, vals))
    return torch.cat(out) if len(out) > 1 else out[0]


def log1p_cpm(counts: torch.Tensor, library_size: torch.Tensor | None = None) -> torch.Tensor:
    """log1p(counts / library * 10_000); an all-zero row maps to zeros."""
    if library_size is None:
        library_size = counts.sum(dim=-1, keepdim=True)
    return torch.log1p(counts / library_size.clamp_min(1e-8) * 10_000.0)
