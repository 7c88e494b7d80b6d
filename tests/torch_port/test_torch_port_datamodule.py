"""The port's DataModule against the JAX package's over the same h5ad files:
every batch bit for bit (values, dtypes, shapes, key order) for a single CSR
file and a dense one, a sharded directory with metadata.json, a tissue
tree, lean uint16 and dense batches, two epochs, the mid-epoch `skip`,
prefetch off, the prefetch thread and the thread pool, the predict stream
with `adata_inference` gene filtering and a missing label column, and the
split bookkeeping (`n_cells`, `steps_per_epoch`, `n_val_batches`). Then the
native CSR packer bit for bit against the numpy path and JAX's packer, and an
abandoned iterator whose producer thread must end. numpy on both sides:
results are held equal, not close."""

import json
import sys
import threading
import time

import numpy as np
import pytest
from scipy import sparse

from scldm_tpu.data import fastpath as jax_fastpath
from scldm_tpu.data.datamodule import DataModule as JaxDataModule
from scldm_tpu.data.datamodule import train_val_split_list as jax_split
from scldm_tpu.data.encoder import VocabularyEncoder as JaxEncoder
from scldm_tpu.data.h5ad import write_h5ad
from scldm_torch.data import fastpath
from scldm_torch.data.datamodule import DataModule, train_val_split_list
from scldm_torch.data.encoder import VocabularyEncoder

G, SEQ = 40, 40
LABELS = {"clusters": 5, "batch": 3}


def cells(rng, n, dense_share=0.7):
    """n cells of G genes, about dense_share zeros, integer counts."""
    X = rng.poisson(2.0, size=(n, G)).astype(np.float32)
    X[rng.random((n, G)) < dense_share] = 0.0
    return X


def write(path, rng, n, csr=True, var_names=None, labels=LABELS):
    X = cells(rng, n)
    obs = {k: rng.choice([f"{k}{i}" for i in range(v)], size=n) for k, v in labels.items()}
    write_h5ad(path, sparse.csr_matrix(X) if csr else X, obs=obs,
               var_names=var_names or [f"g{i}" for i in range(G)],
               sparse_threshold=1.0 if not csr else 0.5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dm")
    rng = np.random.default_rng(0)
    write(tmp / "train.h5ad", rng, 203)
    write(tmp / "dense.h5ad", rng, 150, csr=False)
    write(tmp / "test.h5ad", rng, 70)
    shards = tmp / "shards"
    for i, n in enumerate((40, 40, 40, 40, 40, 40, 40, 40, 40, 23)):
        write(shards / f"adata_{i}.h5ad", rng, n)
    (shards / "metadata.json").write_text(json.dumps(
        {"n_cells": 383, "shard_size": 40, "last_shard_size": 23}))
    for tissue in ("lung", "liver"):
        for i in range(3):
            write(tmp / "tree" / tissue / "train" / f"adata_{i}.h5ad", rng, 32 if i < 2 else 11)
        (tmp / "tree" / tissue / "train" / "metadata.json").write_text(json.dumps(
            {"n_cells": 75, "shard_size": 32, "last_shard_size": 11}))
    # an external AnnData: a shuffled, partly unknown gene list, one label missing
    names = [f"g{i}" for i in rng.permutation(G)[:30]] + [f"unknown{i}" for i in range(6)]
    X = cells(rng, 50)[:, :36]
    write_h5ad(tmp / "external.h5ad", sparse.csr_matrix(X),
               obs={"clusters": rng.choice([f"clusters{i}" for i in range(5)], size=50)},
               var_names=names)
    meta = {"genes": [f"g{i}" for i in range(G)],
            "labels": {k: [f"{k}{i}" for i in range(v)] for k, v in LABELS.items()}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    return tmp


def pair(files, **kw):
    """A JAX DataModule and the port's, set up with the same arguments."""
    args = dict(batch_size=16, test_batch_size=12, genes_seq_len=SEQ, seed=7, prefetch=0)
    args.update(kw)
    enc = dict(class_vocab_sizes=LABELS, metadata_json=str(files / "meta.json"))
    jdm = JaxDataModule(vocabulary_encoder=JaxEncoder(**enc), **args)
    tdm = DataModule(vocabulary_encoder=VocabularyEncoder(**enc), **args)
    stage = "predict" if args.get("allow_missing_train") else "fit"
    jdm.setup(stage)
    tdm.setup(stage)
    return jdm, tdm


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def assert_bookkeeping(tdm, jdm):
    assert (tdm.n_cells, tdm.steps_per_epoch, tdm.n_val_batches) == (
        jdm.n_cells, jdm.steps_per_epoch, jdm.n_val_batches)


@pytest.mark.parametrize("source", ["train.h5ad", "dense.h5ad", "shards", "tree"])
@pytest.mark.parametrize("dense_transfer", [False, True])
def test_train_and_val_batches_match_jax(files, source, dense_transfer):
    jdm, tdm = pair(files, train_adata_path=str(files / source), dense_transfer=dense_transfer,
                    test_adata_path=str(files / "test.h5ad"))
    assert_bookkeeping(tdm, jdm)
    assert tdm.n_cells > 0 and tdm.n_val_batches > 0
    for epoch in (0, 1):
        assert_batches_equal(tdm.train_batches(epoch), jdm.train_batches(epoch))
    assert_batches_equal(tdm.train_batches(1, skip=3), jdm.train_batches(1, skip=3))
    assert_batches_equal(tdm.val_batches(), jdm.val_batches())
    assert_batches_equal(tdm.test_batches(), jdm.test_batches())


@pytest.mark.parametrize("prefetch,workers", [(0, 1), (2, 1), (3, 2)])
def test_prefetch_modes_match_jax(files, prefetch, workers):
    jdm, tdm = pair(files, train_adata_path=str(files / "shards"), dense_transfer=False,
                    prefetch=prefetch, workers=workers)
    assert_batches_equal(tdm.train_batches(1), jdm.train_batches(1))
    assert_batches_equal(tdm.train_batches(0, skip=5), jdm.train_batches(0, skip=5))
    # the same batches as without prefetching
    _, plain = pair(files, train_adata_path=str(files / "shards"), dense_transfer=False)
    assert_batches_equal(tdm.train_batches(1), plain.train_batches(1))


def test_lean_wire_format(files):
    _, tdm = pair(files, train_adata_path=str(files / "train.h5ad"), dense_transfer=False)
    b = next(iter(tdm.train_batches(0)))
    assert "counts" not in b and "genes" not in b
    assert b["genes_subset"].dtype == np.uint16 and b["counts_subset"].dtype == np.uint16
    assert b["library_size"].dtype == np.float32 and b["clusters"].dtype == np.int64


@pytest.mark.parametrize("kw", [
    dict(val_as_test=True), dict(drop_incomplete_batch=False), dict(shuffle=False),
    dict(val_fraction=0.25), dict(num_hosts=2, host_index=1),
])
def test_split_options_match_jax(files, kw):
    jdm, tdm = pair(files, train_adata_path=str(files / "train.h5ad"),
                    test_adata_path=str(files / "test.h5ad"), **kw)
    assert_bookkeeping(tdm, jdm)
    assert_batches_equal(tdm.train_batches(0), jdm.train_batches(0))
    if jdm.n_val_batches:
        assert_batches_equal(tdm.val_batches(), jdm.val_batches())


def test_n_cells_is_the_train_split(files):
    _, tdm = pair(files, train_adata_path=str(files / "train.h5ad"))
    n_val = int(0.1 * 203)
    assert tdm.n_cells == (203 - n_val) // 16 * 16
    _, sharded = pair(files, train_adata_path=str(files / "shards"))
    assert sharded.n_cells < 383  # the shard-level split holds out whole shards
    assert train_val_split_list(list("abcdefghij"), 3) == jax_split(list("abcdefghij"), 3)


def test_predict_stream_with_inference_adata_matches_jax(files):
    jdm, tdm = pair(files, allow_missing_train=True, test_adata_path=str(files / "test.h5ad"))
    for dm in (jdm, tdm):
        dm.adata_inference = str(files / "external.h5ad")
    batches = list(tdm.predict_batches())
    assert_batches_equal(batches, jdm.predict_batches())
    # 30 known genes kept of 36; the missing "batch" label is tolerated here
    assert batches[0]["counts"].shape == (12, 30)
    assert "clusters" in batches[0] and "batch" not in batches[0]
    # the test set when no external AnnData is set
    jdm2, tdm2 = pair(files, allow_missing_train=True, test_adata_path=str(files / "test.h5ad"))
    assert_batches_equal(tdm2.predict_batches(), jdm2.predict_batches())


def test_training_files_require_their_labels(files, tmp_path):
    write(tmp_path / "nolabel.h5ad", np.random.default_rng(1), 40, labels={"clusters": 5})
    _, tdm = pair(files, train_adata_path=str(tmp_path / "nolabel.h5ad"))
    with pytest.raises(KeyError):
        next(iter(tdm.train_batches(0)))


# -- the native packer -------------------------------------------------------------------------

def csr_block(rng, n=64, g=300, max_nnz=120, integer=True):
    nnz = rng.integers(0, max_nnz, n)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(g, k, replace=False)) for k in nnz]).astype(
        np.int32)
    data = (rng.poisson(3.0, int(indptr[-1])) + 1.0 if integer
            else rng.uniform(0.0, 7.0, int(indptr[-1]))).astype(np.float32)
    return data, indices, indptr, rng.permutation(g) + 1


@pytest.mark.parametrize("build_dense", [True, False])
@pytest.mark.parametrize("integer", [True, False])
def test_native_packer_matches_numpy_path(build_dense, integer):
    data, indices, indptr, gene_row = csr_block(np.random.default_rng(3), integer=integer)
    assert fastpath._native() is not None, "g++ could not build the packer"
    fastpath.NATIVE_PACKS.reset()
    got = fastpath.expressed_batch_from_csr(data, indices, indptr, gene_row, 130, build_dense)
    assert fastpath.NATIVE_PACKS.count == 1
    counts, genes_sub, counts_sub, library = fastpath._numpy_pack(
        data, indices, indptr, gene_row, 130, build_dense)
    np.testing.assert_array_equal(got["genes_subset"], genes_sub.astype(np.int64))
    np.testing.assert_array_equal(got["counts_subset"], counts_sub)
    np.testing.assert_array_equal(got["library_size"][:, 0], library)
    if build_dense:
        np.testing.assert_array_equal(got["counts"], counts)
    else:
        assert "counts" not in got and "genes" not in got


@pytest.mark.parametrize("build_dense", [True, False])
def test_native_packer_matches_jax(build_dense):
    data, indices, indptr, gene_row = csr_block(np.random.default_rng(4))
    got = fastpath.expressed_batch_from_csr(data, indices, indptr, gene_row, 130, build_dense)
    want = jax_fastpath.expressed_batch_from_csr(data, indices, indptr, gene_row, 130,
                                                 build_dense)
    assert_batches_equal([got], [want])
    with pytest.raises(ValueError):
        fastpath.expressed_batch_from_csr(data, indices, indptr, gene_row, 50, build_dense)


def test_datamodule_packs_through_the_native_packer(files):
    _, tdm = pair(files, train_adata_path=str(files / "train.h5ad"), dense_transfer=False)
    fastpath.NATIVE_PACKS.reset()
    fastpath.NUMPY_PACKS.reset()
    n = sum(1 for _ in tdm.train_batches(0))
    assert fastpath.NATIVE_PACKS.count == n and fastpath.NUMPY_PACKS.count == 0


def test_abandoned_iterator_does_not_wedge_the_producer(files):
    _, tdm = pair(files, train_adata_path=str(files / "shards"), prefetch=1)
    before = set(threading.enumerate())
    it = tdm.train_batches(0)
    next(it)
    time.sleep(0.1)  # the producer fills the queue and blocks on its put
    (producer,) = set(threading.enumerate()) - before
    assert producer.is_alive()
    it.close()
    producer.join(timeout=5.0)
    assert not producer.is_alive()


def test_pack_counter_loses_no_update_under_contention():
    counter = fastpath.PackCounter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.add() for _ in range(2_000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counter.count == 16 * 2_000
