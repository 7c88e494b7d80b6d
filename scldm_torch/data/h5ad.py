"""A minimal AnnData-on-HDF5 (.h5ad) reader and writer on h5py
(counterpart of scldm_tpu/data/h5ad.py; each reads what the other writes).

The on-disk encoding subset that training and generation need:

- X / layers[key]: dense 2-D datasets or CSR groups (data / indices / indptr
  with attrs encoding-type="csr_matrix", shape);
- obs / var: dataframe groups (attrs _index, column-order) of plain datasets
  or categorical groups (categories + codes);
- obsm: a group of 2-D arrays.

The writer sets anndata's encoding-type / encoding-version attrs, so its
files open in the anndata toolchain. h5py is imported inside the functions
that open a file: the module itself loads on a machine without it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
from scipy import sparse


def _h5py():
    import h5py

    return h5py


def _decode(arr: np.ndarray) -> np.ndarray:
    """bytes -> str for HDF5 string datasets."""
    if arr.dtype.kind in ("S", "O"):
        return np.asarray([x.decode() if isinstance(x, bytes) else str(x) for x in arr])
    return arr


def _attr_str(value) -> str:
    return value.decode() if isinstance(value, bytes) else value


class H5ADFile:
    """Lazy, row-sliceable view of one .h5ad file."""

    def __init__(self, path: str | Path):
        self._h5 = _h5py()
        self.path = Path(path)
        self._f = self._h5.File(self.path, "r")
        self._indptr_cache: Dict[str, np.ndarray] = {}

    # -- basic shape ---------------------------------------------------------
    def _matrix_node(self, attr: str = "X", key: Optional[str] = None):
        node = self._f[attr]
        if key is not None:
            node = node[key]
        return node

    def _is_dataset(self, node) -> bool:
        return isinstance(node, self._h5.Dataset)

    def shape(self, attr: str = "X", key: Optional[str] = None) -> tuple[int, int]:
        node = self._matrix_node(attr, key)
        if self._is_dataset(node):
            return tuple(node.shape)
        return tuple(int(s) for s in node.attrs["shape"])

    @property
    def n_obs(self) -> int:
        return self.shape()[0]

    @property
    def n_vars(self) -> int:
        return self.shape()[1]

    # -- var / obs -------------------------------------------------------------
    def _index_col(self, df: str) -> str:
        return _attr_str(self._f[df].attrs.get("_index", "index"))

    @property
    def var_names(self) -> np.ndarray:
        return _decode(np.asarray(self._f["var"][self._index_col("var")][:]))

    @property
    def obs_names(self) -> np.ndarray:
        return _decode(np.asarray(self._f["obs"][self._index_col("obs")][:]))

    def obs_columns(self) -> list[str]:
        g = self._f["obs"]
        order = g.attrs.get("column-order", None)
        if order is not None:
            return [_attr_str(c) for c in order]
        return [k for k in g.keys() if k != self._index_col("obs")]

    def obs_column(self, name: str, rows: Optional[np.ndarray] = None) -> np.ndarray:
        """A decoded obs column (categoricals -> category strings, None for
        code -1)."""
        node = self._f["obs"][name]
        if not self._is_dataset(node):  # categorical encoding
            categories = _decode(np.asarray(node["categories"][:]))
            codes = np.asarray(node["codes"][:])
            if rows is not None:
                codes = codes[rows]
            return np.where(codes >= 0, categories[np.clip(codes, 0, None)], None)
        data = np.asarray(node[:] if rows is None else node[:][rows])
        return _decode(data)

    def obs_codes(self, name: str) -> Optional[tuple[np.ndarray, list[str]]]:
        """(codes, categories) of a categorical obs column, so a caller maps
        the categories once and slices integer codes per batch; None if the
        column is not categorical."""
        node = self._f["obs"][name]
        if not self._is_dataset(node):
            return np.asarray(node["codes"][:]), list(_decode(np.asarray(node["categories"][:])))
        return None

    def obs_categories(self, name: str) -> Optional[list[str]]:
        """The categories of a categorical obs column (None if not categorical)."""
        node = self._f["obs"][name]
        if not self._is_dataset(node):
            return list(_decode(np.asarray(node["categories"][:])))
        return None

    # -- matrix row slicing -----------------------------------------------------
    def is_csr(self, attr: str = "X", key: Optional[str] = None) -> bool:
        node = self._matrix_node(attr, key)
        if self._is_dataset(node):
            return False
        enc = _attr_str(node.attrs.get("encoding-type", b""))
        if enc == "csc_matrix":
            # a square CSC matrix would pass the indptr-length test below
            return False
        n_obs = self.shape(attr, key)[0]
        return enc == "csr_matrix" or (
            "indptr" in node and len(node["indptr"]) == n_obs + 1
        )

    def _indptr(self, node, attr: str, key: Optional[str]) -> np.ndarray:
        cache_key = f"{attr}/{key}"
        if cache_key not in self._indptr_cache:
            self._indptr_cache[cache_key] = np.asarray(node["indptr"][:])
        return self._indptr_cache[cache_key]

    def csr_block(self, lo: int, hi: int, attr: str = "X", key: Optional[str] = None):
        """Rows lo..hi of a CSR matrix as (data f32, indices, local indptr
        int64): one bulk read per array."""
        node = self._matrix_node(attr, key)
        indptr = self._indptr(node, attr, key)
        start, stop = int(indptr[lo]), int(indptr[hi])
        data = np.asarray(node["data"][start:stop], np.float32)
        indices = np.asarray(node["indices"][start:stop])
        local_indptr = (indptr[lo : hi + 1] - start).astype(np.int64)
        return data, indices, local_indptr

    def rows(
        self,
        row_idx: np.ndarray | slice,
        attr: str = "X",
        key: Optional[str] = None,
        dtype=np.float32,
    ) -> np.ndarray:
        """A dense (len(rows), n_vars) block of the given rows."""
        node = self._matrix_node(attr, key)
        n_obs, n_vars = self.shape(attr, key)
        if isinstance(row_idx, slice):
            row_idx = np.arange(*row_idx.indices(n_obs))
        row_idx = np.asarray(row_idx)

        if self._is_dataset(node):  # dense
            # h5py's fancy indexing takes sorted unique rows: gather, then invert
            order = np.argsort(row_idx, kind="stable")
            uniq, inv = np.unique(row_idx[order], return_inverse=True)
            block = node[uniq.tolist()]
            out = np.empty((len(row_idx), n_vars), dtype)
            out[order] = block[inv]
            return out

        enc = _attr_str(node.attrs.get("encoding-type", b""))
        if enc == "csc_matrix":
            # rows of a CSC file: convert the whole matrix once. Tested before
            # the CSR test, which a square CSC matrix would pass.
            if not hasattr(self, "_csc_dense"):
                mat = sparse.csc_matrix(
                    (node["data"][:], node["indices"][:], node["indptr"][:]),
                    shape=(n_obs, n_vars),
                )
                self._csc_dense = mat.tocsr()
            return np.asarray(self._csc_dense[row_idx].todense(), dtype)
        if self.is_csr(attr, key):
            indptr = self._indptr(node, attr, key)
            data_ds, indices_ds = node["data"], node["indices"]
            out = np.zeros((len(row_idx), n_vars), dtype)
            for i, r in enumerate(row_idx):
                lo, hi = int(indptr[r]), int(indptr[r + 1])
                if hi > lo:
                    out[i, indices_ds[lo:hi]] = data_ds[lo:hi]
            return out
        raise ValueError(f"Unsupported matrix encoding: {enc}")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _str_array(values) -> np.ndarray:
    return np.asarray([str(v) for v in values], dtype=_h5py().string_dtype(encoding="utf-8"))


def _set_encoding(node, kind: str, version: str = "0.2.0") -> None:
    node.attrs["encoding-type"] = kind
    node.attrs["encoding-version"] = version


def _write_df(group, index: np.ndarray, columns: Dict[str, np.ndarray]):
    _set_encoding(group, "dataframe")
    group.attrs["_index"] = "_index"
    group.attrs["column-order"] = _str_array(list(columns.keys()))
    group.create_dataset("_index", data=_str_array(index))
    _set_encoding(group["_index"], "string-array")
    for name, values in columns.items():
        values = np.asarray(values)
        if values.dtype.kind in ("U", "S", "O"):
            cats, codes = np.unique(values.astype(str), return_inverse=True)
            sub = group.create_group(name)
            _set_encoding(sub, "categorical")
            sub.attrs["ordered"] = False
            sub.create_dataset("categories", data=_str_array(cats))
            _set_encoding(sub["categories"], "string-array")
            sub.create_dataset("codes", data=codes.astype(np.int32))
            _set_encoding(sub["codes"], "array")
        else:
            group.create_dataset(name, data=values)
            _set_encoding(group[name], "array")


def _write_matrix(f, name, M, sparse_threshold: float):
    """Dense M with more than `sparse_threshold` zeros is stored as CSR."""
    if not sparse.issparse(M) and np.mean(np.asarray(M) == 0) > sparse_threshold:
        M = sparse.csr_matrix(M)
    if sparse.issparse(M):
        M = M.tocsr()
        g = f.create_group(name)
        _set_encoding(g, "csr_matrix", "0.1.0")
        g.attrs["shape"] = np.asarray(M.shape, np.int64)
        g.create_dataset("data", data=M.data.astype(np.float32))
        g.create_dataset("indices", data=M.indices.astype(np.int32))
        g.create_dataset("indptr", data=M.indptr.astype(np.int64))
    else:
        d = f.create_dataset(name, data=np.asarray(M, np.float32))
        _set_encoding(d, "array")


def write_h5ad(
    path: str | Path,
    X: np.ndarray | sparse.spmatrix,
    obs: Optional[Dict[str, np.ndarray]] = None,
    var_names: Optional[Sequence[str]] = None,
    obs_names: Optional[Sequence[str]] = None,
    obsm: Optional[Dict[str, np.ndarray]] = None,
    layers: Optional[Dict[str, np.ndarray | sparse.spmatrix]] = None,
    sparse_threshold: float = 0.5,
) -> None:
    """Write an anndata-compatible .h5ad: string obs columns as categoricals,
    numbers as arrays; dense X with more than half zeros stored as CSR."""
    n_obs, n_vars = X.shape
    obs = obs or {}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    with _h5py().File(path, "w") as f:
        _set_encoding(f, "anndata", "0.1.0")
        _write_matrix(f, "X", X, sparse_threshold)
        if obs_names is None:
            obs_names = np.asarray([str(i) for i in range(n_obs)], dtype=object)
        if var_names is None:
            var_names = np.asarray([f"g{i}" for i in range(n_vars)], dtype=object)
        _write_df(f.create_group("obs"), np.asarray(obs_names, object), obs)
        _write_df(f.create_group("var"), np.asarray(var_names, object), {})
        if obsm:
            g = f.create_group("obsm")
            _set_encoding(g, "dict", "0.1.0")
            for k, v in obsm.items():
                g.create_dataset(k, data=np.asarray(v, np.float32))
                _set_encoding(g[k], "array")
        if layers:
            g = f.create_group("layers")
            _set_encoding(g, "dict", "0.1.0")
            for k, v in layers.items():
                _write_matrix(g, k, v, sparse_threshold)


def read_shard_metadata(dir_path: str | Path) -> Optional[dict]:
    """The metadata.json of a sharded-h5ad directory ({n_cells, shard_size,
    last_shard_size}); None if there is none."""
    p = Path(dir_path) / "metadata.json"
    if p.exists():
        return json.loads(p.read_text())
    return None
