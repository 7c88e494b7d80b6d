"""Host data pipeline: sharded h5ad -> tokenized numpy batches (counterpart of
scldm_tpu/data/datamodule.py, which replaces the reference's cellarium-ml
DistributedAnnDataCollection + Lightning DataModule stack,
src/scldm/datamodule.py:37-594).

- three storage modes: single train/test h5ad files, sharded directories
  (adata_0.h5ad ... + metadata.json), or a tissue tree of shards;
- deterministic per-host partitioning of batch specs (host h of H takes specs
  h::H; one card is H = 1), resumable, reshuffled each epoch with seed + epoch
  like set_epoch (the reference's models.py:89-98);
- contiguous row-block reads from an LRU pool of open shards (max_cache_size,
  datamodule.py:315);
- tokenization ("expressed" packing etc.) into fixed-length arrays;
- a background prefetch thread (or an order-preserving thread pool) overlaps
  the HDF5 reads and the packing with the train step.

Batches are numpy arrays; the fit loop makes them tensors on the task's
device. Every batch equals the JAX DataModule's bit for bit.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from scldm_torch.data.fastpath import expressed_batch_from_csr
from scldm_torch.data.h5ad import H5ADFile, read_shard_metadata
from scldm_torch.data.tokenize import tokenize_cells
from scldm_torch.ops.transforms import COUNTS, COUNTS_SUBSET, GENES, GENES_SUBSET, LIBRARY_SIZE


def sort_h5ad_files(path: Path) -> List[str]:
    """adata_0.h5ad, adata_1.h5ad, ... in numeric order (reference _utils.py:111-115);
    files without a numeric _<n> suffix sort lexicographically after them."""

    def key(x: str):
        tail = x.replace(".h5ad", "").split("_")[-1]
        return (0, int(tail), "") if tail.isdigit() else (1, 0, x)

    return sorted([f.as_posix() for f in Path(path).glob("*.h5ad")], key=key)


def get_tissue_adata_files(base_path: str | Path, split: str = "train"):
    """Multi-tissue directory tree: <base>/<tissue>/<split>/adata_*.h5ad, each
    split dir carrying a metadata.json; drops every tissue's last (short)
    shard and requires a uniform shard_size (reference _utils.py:118-147).
    Returns (files, total_cells, shard_size)."""
    import json as _json

    base_path = Path(base_path)
    all_files: List[str] = []
    shard_sizes = set()
    total_cells = 0
    for tissue_dir in base_path.iterdir():
        if tissue_dir.is_dir() and "genes" not in str(tissue_dir):
            split_dir = tissue_dir / split
            if split_dir.exists():
                meta_file = split_dir / "metadata.json"
                if meta_file.exists():
                    meta = _json.loads(meta_file.read_text())
                    total_cells += meta["n_cells"] - meta["last_shard_size"]
                    shard_sizes.add(meta["shard_size"])
                files = sort_h5ad_files(split_dir)
                if files:
                    all_files.extend(files[:-1])
    assert len(shard_sizes) == 1, "shard_size mismatch"
    return sorted(all_files), total_cells, shard_sizes.pop()


def train_val_split_list(files: List[str], seed: int) -> Tuple[List[int], List[int]]:
    """Shard-level 10% val split, resampling only the first half of shards so the
    (possibly short) last shard stays in train (reference datamodule.py:837-847)."""
    rng = np.random.RandomState(seed)
    n_files = len(files)
    n_val = max(1, int(0.1 * n_files))
    n_resample = n_files // 2
    indices = np.arange(n_files)
    resample = rng.permutation(n_resample)
    train_idx = np.concatenate([resample[:-n_val], indices[n_resample:]])
    return train_idx.tolist(), resample[-n_val:].tolist()


class _ShardPool:
    """LRU cache of open H5ADFile handles.

    Eviction only drops the pool's reference — it must NOT close() the
    handle: with DataModule(workers>1) another thread may be mid-read on the
    evicted file, and closing under it raises (or corrupts the read). The
    h5py File closes itself when the last reference is garbage-collected, so
    the open-handle count stays bounded by max_open + in-flight readers."""

    def __init__(self, max_open: int = 10):
        self.max_open = max_open
        self._cache: OrderedDict[str, H5ADFile] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, path: str) -> H5ADFile:
        with self._lock:
            if path in self._cache:
                self._cache.move_to_end(path)
                return self._cache[path]
            f = H5ADFile(path)
            self._cache[path] = f
            if len(self._cache) > self.max_open:
                self._cache.popitem(last=False)
            return f


class DataModule:
    """Dataset orchestration + iterable batch sources.

    Batch dict contract (collate parity, reference datamodule.py:597-649):
      counts (B, G) f32, genes (B, G) i64, library_size (B, 1) f32,
      [genes_subset/counts_subset (B, genes_seq_len)], plus one int64 column
      per label in vocabulary_encoder.class_vocab_sizes.
    """

    def __init__(
        self,
        *,
        vocabulary_encoder,
        train_adata_path: Optional[str] = None,
        test_adata_path: Optional[str] = None,
        adata_attr: str = "X",
        adata_key: Optional[str] = None,
        batch_size: int = 128,
        test_batch_size: int = 256,
        seed: int = 42,
        sample_genes: str = "expressed",
        genes_seq_len: int = 2048,
        val_as_test: bool = False,
        val_fraction: float = 0.1,
        drop_incomplete_batch: bool = True,
        shuffle: bool = True,
        max_cache_size: int = 10,
        num_hosts: int = 1,
        host_index: int = 0,
        prefetch: int = 4,
        workers: int = 1,
        allow_missing_train: bool = False,
        dense_transfer: bool = True,
        lean_uint16: bool = True,
    ):
        self.vocabulary_encoder = vocabulary_encoder
        self.train_adata_path = train_adata_path
        self.test_adata_path = test_adata_path
        self.adata_attr = adata_attr
        self.adata_key = adata_key
        self.batch_size = batch_size
        self.test_batch_size = test_batch_size
        self.seed = seed
        self.sample_genes = sample_genes
        self.genes_seq_len = genes_seq_len
        self.val_as_test = val_as_test
        self.val_fraction = val_fraction
        self.drop_incomplete_batch = drop_incomplete_batch
        self.shuffle = shuffle
        self.num_hosts = num_hosts
        self.host_index = host_index
        self.prefetch = prefetch
        # >1: a thread pool tokenizes/packs batches concurrently (h5py reads
        # serialize on its internal lock; the ctypes packer and casts release
        # the GIL). Batch ORDER is identical to workers=1
        # (tests/torch_port/test_torch_port_datamodule.py).
        self.workers = workers
        self.allow_missing_train = allow_missing_train
        # False: omit the dense counts/genes from batches ("expressed" only) —
        # the train step rebuilds them on device (ops.transforms.densify_expressed)
        self.dense_transfer = dense_transfer
        self.lean_uint16 = lean_uint16

        self._pool = _ShardPool(max_cache_size)
        self._is_setup = False
        self._adata_inference: Optional[str] = None
        self.n_cells = 0
        # per-file caches: encoded gene row, encoded obs label columns
        self._gene_row_cache: Dict[str, np.ndarray] = {}
        self._label_cache: Dict[Tuple[str, str], np.ndarray] = {}

    # -- discovery -------------------------------------------------------------
    def _resolve_files(self, path: Optional[str], split: str = "train") -> List[str]:
        if path is None:
            return []
        p = Path(path)
        if p.is_dir():
            files = sort_h5ad_files(p)
            if files:
                return files
            # multi-tissue tree: <base>/<tissue>/<split>/adata_*.h5ad
            try:
                files, total_cells, _ = get_tissue_adata_files(p, split)
                self._tissue_cells = total_cells
                return files
            except (AssertionError, StopIteration, FileNotFoundError):
                return []
        return [p.as_posix()]

    def setup(self, stage: str = "fit") -> None:
        self._tissue_cells = None
        train_files = self._resolve_files(self.train_adata_path, "train")
        test_files = self._resolve_files(self.test_adata_path, "test")
        if not train_files and not self.allow_missing_train and stage == "fit":
            raise FileNotFoundError(f"no training h5ad at {self.train_adata_path}")

        self._train_specs: List[Tuple[str, int, int]] = []  # (file, start, stop)
        self._val_specs: List[Tuple[str, int, int]] = []
        self._test_specs: List[Tuple[str, int, int]] = []

        # n_cells from shard metadata when available (datamodule.py:86-91)
        meta = (
            read_shard_metadata(self.train_adata_path)
            if self.train_adata_path and Path(self.train_adata_path).is_dir()
            else None
        )

        if len(train_files) > 1:
            # shard-level split (reference datamodule.py:302-335)
            train_idx, val_idx = train_val_split_list(train_files, self.seed)
            tr_files = [train_files[i] for i in train_idx]
            va_files = [train_files[i] for i in val_idx]
            self._train_specs = self._file_row_specs(tr_files, self.batch_size)
            self._val_specs = self._file_row_specs(va_files, self.test_batch_size)
        elif len(train_files) == 1:
            # cell-level split within the single file (datamodule.py:337-375)
            f = self._pool.get(train_files[0])
            n = f.shape(self.adata_attr, self.adata_key)[0]
            if self.val_as_test:
                self._train_specs = self._row_specs(train_files[0], 0, n, self.batch_size)
                self._val_specs = []
            else:
                n_val = int(self.val_fraction * n)
                self._train_specs = self._row_specs(
                    train_files[0], 0, n - n_val, self.batch_size
                )
                self._val_specs = self._row_specs(
                    train_files[0], n - n_val, n, self.test_batch_size
                )
        if self.val_as_test and test_files:
            self._val_specs = self._file_row_specs(test_files, self.test_batch_size)
        if test_files:
            self._test_specs = self._file_row_specs(test_files, self.test_batch_size)

        # n_cells = the TRAIN-split cell count, not the collection total.
        # The shard-level split reserves ~10% of shards for validation, and
        # compute_max_steps(n_cells) drives both the step budget and the LR
        # schedule: the collection total would budget a validation split's
        # worth of steps the stream cannot deliver, and the decay would never
        # complete. _train_specs is exact (post-split, post
        # drop_incomplete_batch) and already built.
        if self._train_specs:
            self.n_cells = sum(s[2] - s[1] for s in self._train_specs)
        elif self._tissue_cells is not None:
            self.n_cells = int(self._tissue_cells)
        elif meta is not None:
            self.n_cells = int(meta["n_cells"])
        else:
            self.n_cells = 0
        self._is_setup = True

    def _row_specs(self, path: str, lo: int, hi: int, bs: int) -> List[Tuple[str, int, int]]:
        specs = []
        start = lo
        while start + bs <= hi:
            specs.append((path, start, start + bs))
            start += bs
        if start < hi and not self.drop_incomplete_batch:
            specs.append((path, start, hi))
        return specs

    def _file_row_specs(self, files: List[str], bs: int) -> List[Tuple[str, int, int]]:
        specs = []
        for path in files:
            n = self._pool.get(path).shape(self.adata_attr, self.adata_key)[0]
            specs.extend(self._row_specs(path, 0, n, bs))
        return specs

    # -- inference input (datamodule.py:116-198) ---------------------------------
    @property
    def adata_inference(self) -> Optional[str]:
        return self._adata_inference

    @adata_inference.setter
    def adata_inference(self, path: str) -> None:
        self._adata_inference = path

    # -- batch materialization ----------------------------------------------------
    def _gene_row(self, path: str, f: H5ADFile) -> np.ndarray:
        if path not in self._gene_row_cache:
            self._gene_row_cache[path] = self.vocabulary_encoder.encode_genes(f.var_names)
        return self._gene_row_cache[path]

    def _encoded_labels(self, path: str, f: H5ADFile, label: str) -> np.ndarray:
        """Whole-file label column encoded once: categorical codes map through
        a per-category lookup instead of per-cell string encoding."""
        key = (path, label)
        if key not in self._label_cache:
            codes_cats = f.obs_codes(label)
            if codes_cats is not None:
                codes, cats = codes_cats
                cat_idx = self.vocabulary_encoder.encode_metadata(cats, label)
                self._label_cache[key] = np.where(
                    codes >= 0, cat_idx[np.clip(codes, 0, None)], -1
                ).astype(np.int64)
            else:
                values = f.obs_column(label)
                self._label_cache[key] = self.vocabulary_encoder.encode_metadata(
                    values, label
                ).astype(np.int64)
        return self._label_cache[key]

    def _inference_keep_cols(self, path: str, f: H5ADFile) -> Optional[np.ndarray]:
        """Column filter for external inference AnnData: keep only genes present
        in the vocabulary (reference datamodule.py:116-128 `adata_inference`
        setter filtering; the census flow maps symbols->Ensembl first)."""
        key = ("__inference_cols__", path)
        if key not in self._label_cache:
            known = self.vocabulary_encoder._gene_token2idx
            mask_idx = self.vocabulary_encoder.mask_token_idx
            cols = np.asarray(
                [i for i, v in enumerate(f.var_names)
                 if known.get(str(v), mask_idx) != mask_idx],
                dtype=np.int64,
            )
            self._label_cache[key] = cols
        cols = self._label_cache[key]
        return cols if len(cols) < f.n_vars else None

    def _make_batch(
        self, spec: Tuple[str, int, int], seed: Optional[int], lean: bool = False
    ) -> Dict[str, np.ndarray]:
        path, lo, hi = spec
        f = self._pool.get(path)

        if path == self._adata_inference:
            keep = self._inference_keep_cols(path, f)
            if keep is not None:
                X = f.rows(slice(lo, hi), self.adata_attr, self.adata_key)[:, keep]
                var_names = np.asarray(f.var_names)[keep]
                batch = tokenize_cells(
                    X, var_names, self.vocabulary_encoder,
                    genes_seq_len=min(self.genes_seq_len, len(keep)),
                    sample_genes=self.sample_genes, seed=seed,
                )
                batch[COUNTS] = batch[COUNTS].astype(np.float32)
                batch[LIBRARY_SIZE] = batch[
                    LIBRARY_SIZE
                ].astype(np.float32)
                if COUNTS_SUBSET in batch:
                    batch[COUNTS_SUBSET] = batch[
                        COUNTS_SUBSET
                    ].astype(np.float32)
                # condition columns must ride along here too — otherwise
                # generation over an external AnnData silently runs fully
                # unconditional (the CLI intersects batch keys with the vocab)
                return self._attach_labels(batch, path, f, lo, hi)

        if self.sample_genes == "expressed" and f.is_csr(self.adata_attr, self.adata_key):
            # the single-read CSR fast path (data/fastpath.py)
            data, indices, indptr = f.csr_block(lo, hi, self.adata_attr, self.adata_key)
            batch = expressed_batch_from_csr(
                data, indices, indptr, self._gene_row(path, f), self.genes_seq_len,
                build_dense=not lean,
            )
        else:
            X = f.rows(slice(lo, hi), self.adata_attr, self.adata_key)
            batch = tokenize_cells(
                X,
                f.var_names,
                self.vocabulary_encoder,
                genes_seq_len=self.genes_seq_len,
                sample_genes=self.sample_genes,
                seed=seed,
            )
            batch[COUNTS] = batch[COUNTS].astype(np.float32)
            batch[LIBRARY_SIZE] = batch[
                LIBRARY_SIZE
            ].astype(np.float32)
            if COUNTS_SUBSET in batch:
                batch[COUNTS_SUBSET] = batch[
                    COUNTS_SUBSET
                ].astype(np.float32)

        return self._attach_labels(batch, path, f, lo, hi)

    def _attach_labels(self, batch, path: str, f: H5ADFile, lo: int, hi: int):
        """Encoded condition columns onto the batch. For the EXTERNAL
        inference AnnData a missing column is tolerated (generation falls
        back to null tokens); column presence is tested explicitly because
        encode_metadata raises KeyError for unknown categories and that
        error must stay loud — a blanket handler here would silently
        degrade conditional generation to unconditional. Training files
        always require their columns."""
        tolerate_missing = path == self._adata_inference
        present = set(f.obs_columns()) if tolerate_missing else None
        for label in self.vocabulary_encoder.class_vocab_sizes:
            if tolerate_missing and label not in present:
                continue
            batch[label] = self._encoded_labels(path, f, label)[lo:hi]
        return batch

    def _make_lean(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Drop the dense counts/genes (training stream only): the train step
        rebuilds them on device from the lossless expressed subsets.

        The surviving subsets travel as uint16 when lossless (gene ids fit for
        every reference vocabulary, counts clip at 65535, beyond any real UMI
        count), which halves the bytes copied to the device. Tasks re-widen on
        the device (`ops.transforms.widen_lean`)."""
        if self.sample_genes == "expressed" and COUNTS_SUBSET in batch:
            out = {
                k: v
                for k, v in batch.items()
                if k not in (COUNTS, GENES)
            }
            if self.lean_uint16:
                g = GENES_SUBSET
                c = COUNTS_SUBSET
                if g in out and int(self.vocabulary_encoder.n_genes or 1 << 30) < 65_535:
                    out[g] = out[g].astype(np.uint16)
                if c in out:
                    out[c] = np.minimum(out[c], 65_535.0).astype(np.uint16)
            return out
        return batch

    def _iter_specs(
        self,
        specs: List[Tuple[str, int, int]],
        epoch: int,
        shuffle: bool,
        lean: bool = False,
        skip: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(specs))
        if shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        # every host must yield the SAME number of batches per epoch: with
        # several processes each train step is a collective, so a ragged
        # [host::num_hosts] split (host 0 getting one extra spec) would have
        # one process enter an extra collective at epoch end and deadlock the
        # cluster. Truncate to the common multiple first; this also keeps
        # steps_per_epoch exact for every host (one card: num_hosts = 1).
        n_even = (len(order) // self.num_hosts) * self.num_hosts
        order = order[:n_even][self.host_index :: self.num_hosts]
        if skip:
            # mid-epoch resume fast-forward: drop the first `skip` already-
            # consumed batches WITHOUT assembling them (index slice only).
            # Seeding is per-spec, so the surviving batches are bit-identical
            # to positions [skip:] of the uninterrupted epoch.
            order = order[skip:]

        post = self._make_lean if lean else (lambda b: b)

        def make(i):
            return post(
                self._make_batch(
                    specs[i], seed=self.seed + epoch * 100_003 + int(i), lean=lean
                )
            )

        if self.prefetch <= 0:
            for i in order:
                yield make(i)
            return

        if self.workers > 1:
            # order-preserving windowed thread pool: up to `window` batches in
            # flight, yielded in the exact workers=1 sequence (host partition,
            # shuffle, and tokenizer seeding are all per-spec, so batches are
            # bit-identical to the single-worker path)
            import itertools
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            window = max(self.prefetch, self.workers)
            with ThreadPoolExecutor(max_workers=self.workers) as ex:
                it = iter(order)
                pending = deque(
                    ex.submit(make, i) for i in itertools.islice(it, window)
                )
                while pending:
                    batch = pending.popleft().result()
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(ex.submit(make, nxt))
                    yield batch
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a plain q.put() would block FOREVER if the consumer abandons the
            # iterator with the queue full (e.g. `next(iter(batches))` for an
            # example batch): the finally's stop.set() cannot unblock it, and
            # the thread + its queued batches leak for the process lifetime.
            # Bounded-wait puts re-check the stop flag instead.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for i in order:
                    if stop.is_set():
                        return
                    if not put(
                        post(
                            self._make_batch(
                                specs[i],
                                seed=self.seed + epoch * 100_003 + int(i),
                                lean=lean,
                            )
                        )
                    ):
                        return
            except Exception as e:  # surface pipeline errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    # -- public iterators ------------------------------------------------------
    def train_batches(
        self, epoch: int = 0, skip: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Epoch batch stream; `skip` fast-forwards past the first `skip`
        per-host batches (mid-epoch checkpoint resume) without loading them."""
        assert self._is_setup, "call setup() first"
        return self._iter_specs(
            self._train_specs,
            epoch,
            shuffle=self.shuffle,
            lean=not self.dense_transfer,
            skip=skip,
        )

    def val_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        assert self._is_setup, "call setup() first"
        return self._iter_specs(self._val_specs, 0, shuffle=False)

    def test_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        assert self._is_setup, "call setup() first"
        return self._iter_specs(self._test_specs, 0, shuffle=False)

    def predict_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """External inference AnnData (vocab gene filtering, datamodule.py:116-128)
        if set, else the test set."""
        if self._adata_inference is not None:
            specs = self._file_row_specs([self._adata_inference], self.test_batch_size)
            return self._iter_specs(specs, 0, shuffle=False)
        return self.test_batches()

    @property
    def steps_per_epoch(self) -> int:
        return len(self._train_specs) // self.num_hosts

    @property
    def n_val_batches(self) -> int:
        return len(self._val_specs) // self.num_hosts
