"""Host-side tokenization of count matrices into gene-token sequences
(counterpart of scldm_tpu/data/tokenize.py, drawing the same numbers from
the same `np.random.default_rng(seed)` in the same order, so both packages
give the same batches bit for bit).

Six strategies, each vectorised over the batch: sampling without
replacement by sorting keys instead of sequential draws.

- `none`: the full gene row and counts;
- `random`: a uniform subset in uniform order, the first `genes_seq_len`
  columns of the argsort of iid uniform keys;
- `weighted`: the exponential race, keys Exp(1) / p_i with p_i the counts
  plus one over the gene's mean (the encoder's `gene_means`, aligned to the
  file's genes through their token ids); the smallest keys are a
  without-replacement sample ordered as sequential draws from p would be;
- `expressed`: the expressed genes left-packed into a fixed buffer by one
  flat scatter (the dense-input analog of `data.fastpath`);
- `expressed_zero`: the argsort of expressed + U(0, 1): non-expressed genes
  first, uniform order within each group;
- `random_expressed`: up to `genes_seq_len` expressed genes in uniform order,
  mask-padded: uniform keys on expressed genes, +inf elsewhere.

Output keys: genes / counts (the full gene row and counts), genes_subset /
counts_subset (the fixed-length expressed tokens, where the strategy makes
them) and library_size (each cell's total count before any subsetting).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from scldm_torch.ops.transforms import (
    COUNTS,
    COUNTS_SUBSET,
    GENES,
    GENES_SUBSET,
    LIBRARY_SIZE,
)

# each strategy: (ctx) -> output dict; registered where it is defined
_STRATEGIES: Dict[str, Callable] = {}


def _strategy(name: str):
    def register(fn):
        _STRATEGIES[name] = fn
        return fn

    return register


class _Ctx:
    """The state of one call that the strategies share."""

    __slots__ = ("counts", "gene_row", "seq_len", "rng", "encoder", "gk", "ck")

    def __init__(self, counts, gene_row, seq_len, rng, encoder, gk, ck):
        self.counts = counts
        self.gene_row = gene_row  # (G,) encoded token ids of the file's genes
        self.seq_len = seq_len
        self.rng = rng
        self.encoder = encoder
        self.gk = gk  # output key of the gene tokens
        self.ck = ck  # output key of the counts

    @property
    def shape(self):
        return self.counts.shape

    def gene_matrix(self) -> np.ndarray:
        """(N, G) token ids: a broadcast view, never a copy per row."""
        n = self.counts.shape[0]
        return np.broadcast_to(self.gene_row, (n, len(self.gene_row)))

    def library(self) -> np.ndarray:
        return self.counts.sum(1, keepdims=True)

    def gather(self, idx: np.ndarray):
        """(gene tokens, counts) at per-row column indices idx."""
        rows = np.arange(idx.shape[0])[:, None]
        return self.gene_row[idx], self.counts[rows, idx]


def _uniform_keys(ctx: _Ctx) -> np.ndarray:
    n, g = ctx.shape
    return ctx.rng.random((n, g))


@_strategy("none")
def _none(ctx: _Ctx) -> dict:
    return {ctx.gk: ctx.gene_matrix(), ctx.ck: ctx.counts, LIBRARY_SIZE: ctx.library()}


@_strategy("random")
def _random(ctx: _Ctx) -> dict:
    idx = np.argsort(_uniform_keys(ctx), axis=1)[:, : ctx.seq_len]
    genes, counts = ctx.gather(idx)
    return {ctx.gk: genes, ctx.ck: counts, LIBRARY_SIZE: ctx.library()}


@_strategy("weighted")
def _weighted(ctx: _Ctx) -> dict:
    means = getattr(ctx.encoder, "gene_means", None)
    if means is None:
        raise ValueError("encoder.metadata_genes must be set for weighted sampling")
    # gene_means follow the vocabulary's order, the counts' columns the file's:
    # align through the encoded gene row (token id = vocabulary index + 1).
    # Unknown genes (mask id 0) get an infinite mean, so they come last; a
    # floor of 1e-12 guards the division.
    means = np.asarray(means, np.float64)
    aligned = np.where(
        ctx.gene_row > 0,
        np.maximum(means[np.clip(ctx.gene_row - 1, 0, len(means) - 1)], 1e-12),
        np.inf,
    )
    p = (ctx.counts + 1) / aligned
    keys = ctx.rng.exponential(size=ctx.shape) / p  # p need not be normalized
    idx = np.argsort(keys, axis=1)[:, : ctx.seq_len]
    genes, counts = ctx.gather(idx)
    return {ctx.gk: genes, ctx.ck: counts, LIBRARY_SIZE: ctx.library()}


@_strategy("expressed")
def _expressed(ctx: _Ctx) -> dict:
    n, _ = ctx.shape
    mask_idx = ctx.encoder.mask_token_idx
    rows, cols = np.nonzero(ctx.counts)
    nnz = np.bincount(rows, minlength=n)
    if nnz.max(initial=0) > ctx.seq_len:
        raise ValueError("genes_seq_len is smaller than number of expressed genes")
    # the slot of each nonzero in its row: its rank overall less its row's start
    starts = np.concatenate(([0], np.cumsum(nnz)[:-1]))
    slots = np.arange(len(rows)) - starts[rows]

    genes_sub = np.full((n, ctx.seq_len), mask_idx, dtype=ctx.gene_row.dtype)
    counts_sub = np.zeros((n, ctx.seq_len), dtype=ctx.counts.dtype)
    flat = rows * ctx.seq_len + slots
    genes_sub.ravel()[flat] = ctx.gene_row[cols]
    counts_sub.ravel()[flat] = ctx.counts[rows, cols]
    return {
        ctx.gk: ctx.gene_matrix(),
        ctx.ck: ctx.counts,
        GENES_SUBSET: genes_sub,
        COUNTS_SUBSET: counts_sub,
        LIBRARY_SIZE: ctx.library(),
    }


@_strategy("expressed_zero")
def _expressed_zero(ctx: _Ctx) -> dict:
    expressed = ctx.counts > 0
    order = np.argsort(expressed + _uniform_keys(ctx), axis=1)[:, : ctx.seq_len]
    genes, counts = ctx.gather(order)
    return {
        ctx.gk: ctx.gene_matrix(),
        ctx.ck: ctx.counts,
        GENES_SUBSET: genes,
        COUNTS_SUBSET: counts,
        LIBRARY_SIZE: ctx.library(),
    }


@_strategy("random_expressed")
def _random_expressed(ctx: _Ctx) -> dict:
    mask_idx = ctx.encoder.mask_token_idx
    expressed = ctx.counts > 0
    keys = np.where(expressed, _uniform_keys(ctx), np.inf)
    idx = np.argsort(keys, axis=1)[:, : ctx.seq_len]
    genes, counts = ctx.gather(idx)
    pad = np.arange(ctx.seq_len) >= expressed.sum(1, keepdims=True)
    genes[pad] = mask_idx
    counts[pad] = 0
    return {ctx.gk: genes, ctx.ck: counts, LIBRARY_SIZE: ctx.library()}


def tokenize_cells(
    cell: np.ndarray,
    var_names: Sequence[str],
    encoder,
    genes_seq_len: int,
    sample_genes: str,
    gene_tokens_key: str = GENES,
    counts_key: str = COUNTS,
    seed: Optional[int] = None,
) -> dict:
    """Tokenize an (N, G) count matrix whose columns are `var_names` with the
    strategy `sample_genes`; the draws come from `np.random.default_rng(seed)`."""
    strategy = _STRATEGIES.get(sample_genes)
    if strategy is None:
        raise ValueError(f"Invalid sample_genes value: {sample_genes}")
    ctx = _Ctx(
        counts=cell,
        gene_row=encoder.encode_genes(var_names),
        seq_len=genes_seq_len,
        rng=np.random.default_rng(seed=seed),
        encoder=encoder,
        gk=gene_tokens_key,
        ck=counts_key,
    )
    return strategy(ctx)
