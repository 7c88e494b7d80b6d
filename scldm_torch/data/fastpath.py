"""CSR block -> tokenized batch (counterpart of scldm_tpu/data/fastpath.py).

Builds the "expressed" batch (dense counts, gene ids, left-packed expressed
subsets, library sizes) from a CSR block. It equals `tokenize_cells(
sample_genes="expressed")` for CSR blocks with sorted column indices (the
anndata on-disk norm).

Two paths give the same bits: the native single-pass packer
(`_fastpack.cpp`, built with g++ on first use into
`scldm_torch/kernels/_build/` and called through ctypes, which releases the
GIL for the call), and a few flat numpy scatters where no compiler is at
hand. JAX takes its packer for dense batches only; the port's also packs the
lean wire batch (no dense block). `NATIVE_PACKS` and `NUMPY_PACKS` count
the batches each path packed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

from scldm_torch.ops.transforms import (
    COUNTS,
    COUNTS_SUBSET,
    GENES,
    GENES_SUBSET,
    LIBRARY_SIZE,
)

_SRC = Path(__file__).resolve().parent / "_fastpack.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "_build"


class PackCounter:
    """Number of batches packed since the last reset (thread-safe: the
    DataModule packs on its prefetch threads)."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


NATIVE_PACKS = PackCounter()
NUMPY_PACKS = PackCounter()


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

    native = _native()
    if native is not None:
        counts, genes_sub, counts_sub, library = native(
            np.ascontiguousarray(data, np.float32), np.ascontiguousarray(indices, np.int64),
            np.ascontiguousarray(indptr, np.int64), gene_row, g, int(genes_seq_len),
            build_dense,
        )
        NATIVE_PACKS.add()
    else:
        counts, genes_sub, counts_sub, library = _numpy_pack(
            data, indices, indptr, gene_row, genes_seq_len, build_dense)
        NUMPY_PACKS.add()

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


def _numpy_pack(data, indices, indptr, gene_row, genes_seq_len, build_dense):
    n = len(indptr) - 1
    g = len(gene_row)
    nnz_per_row = np.diff(indptr)
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
    return counts, genes_sub, counts_sub, library


# ---------------------------------------------------------------------------
# the native packer
# ---------------------------------------------------------------------------
_NATIVE = None
_NATIVE_TRIED = False
_NATIVE_LOCK = threading.Lock()


def build_native() -> Path:
    """Compile `_fastpack.cpp` into `kernels/_build/` (once per source: the
    library's name carries the source's hash) and return the library's
    path. The build writes a temporary name and renames it, so processes
    that build at once never load a half-written library."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD_DIR / f"fastpack_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
    return so


def _native():
    """The packer's entry point wrapped for numpy arrays, or None (the numpy
    path) where it cannot be built."""
    global _NATIVE, _NATIVE_TRIED
    with _NATIVE_LOCK:
        if _NATIVE_TRIED:
            return _NATIVE
        _NATIVE_TRIED = True
        try:
            fn = ctypes.CDLL(str(build_native())).fastpack_expressed
        except (OSError, subprocess.SubprocessError):
            return None
        f32, i32, i64 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
                         for t in (np.float32, np.int32, np.int64))
        fn.argtypes = [
            f32, i64, i64, i64,  # data, indices, indptr, gene_row
            ctypes.c_void_p, i32, f32, f32,  # counts (or null), genes_sub, counts_sub, library
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        fn.restype = None

        def call(data, indices, indptr, gene_row, g, seq_len, build_dense):
            n = len(indptr) - 1
            counts = np.zeros((n, g), np.float32) if build_dense else None
            genes_sub = np.zeros((n, seq_len), np.int32)
            counts_sub = np.zeros((n, seq_len), np.float32)
            library = np.zeros(n, np.float32)
            fn(data, indices, indptr, np.ascontiguousarray(gene_row, np.int64),
               None if counts is None else counts.ctypes.data, genes_sub, counts_sub,
               library, n, g, seq_len)
            return counts, genes_sub, counts_sub, library

        _NATIVE = call
        return _NATIVE
