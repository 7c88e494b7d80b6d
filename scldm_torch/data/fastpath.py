"""CSR block -> tokenized batch (counterpart of scldm_tpu/data/fastpath.py).

Builds the "expressed" batch (dense counts, gene ids, left-packed expressed
subsets, library sizes) from a CSR block in a few flat numpy scatters, with
no Python loop over rows. It equals `tokenize_cells(sample_genes=
"expressed")` for CSR blocks with sorted column indices (the anndata
on-disk norm).

This is the numpy path alone: JAX's optional single-pass C++ packer
(scldm_tpu/data/_fastpack.cpp), whose only caller is its DataModule, is not
ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from scldm_torch.ops.transforms import (
    COUNTS,
    COUNTS_SUBSET,
    GENES,
    GENES_SUBSET,
    LIBRARY_SIZE,
)


def expressed_batch_from_csr(
    data: np.ndarray,  # (nnz,) float32
    indices: np.ndarray,  # (nnz,) column indices
    indptr: np.ndarray,  # (N+1,) local row offsets
    gene_row: np.ndarray,  # (G,) encoded gene-token ids of the file's var_names
    genes_seq_len: int,
    build_dense: bool = True,
) -> Dict[str, np.ndarray]:
    """The expressed batch of a CSR block. `build_dense=False` leaves out the
    dense (N, G) counts and gene rows: the lean wire batch, which the train
    step densifies on the device (`ops.transforms.densify_expressed`)."""
    n = len(indptr) - 1
    g = len(gene_row)
    nnz_per_row = np.diff(indptr)
    if (nnz_per_row > genes_seq_len).any():
        raise ValueError("genes_seq_len is smaller than number of expressed genes")

    row_rep = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    counts = None
    if build_dense:
        counts = np.zeros((n, g), np.float32)
        counts.ravel()[row_rep * g + indices] = data

    positions = np.arange(len(data), dtype=np.int64) - np.repeat(indptr[:-1], nnz_per_row)
    genes_sub = np.zeros((n, genes_seq_len), np.int32)  # mask token idx 0
    counts_sub = np.zeros((n, genes_seq_len), np.float32)
    flat = row_rep * genes_seq_len + positions
    genes_sub.ravel()[flat] = gene_row[indices]
    counts_sub.ravel()[flat] = data
    library = np.bincount(row_rep, weights=data, minlength=n).astype(np.float32)

    # int64 gene ids, as tokenize_cells' "expressed" output: a dataset that
    # mixes CSR and dense shards gives one dtype per key
    out = {
        GENES_SUBSET: genes_sub.astype(np.int64, copy=False),
        COUNTS_SUBSET: counts_sub,
        LIBRARY_SIZE: library.reshape(n, 1),
    }
    if build_dense:
        out[GENES] = np.broadcast_to(gene_row, (n, g))
        out[COUNTS] = counts
    return out
