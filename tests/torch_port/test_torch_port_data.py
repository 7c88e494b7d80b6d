"""The port's host data layer against the JAX package's, on the same inputs
made from a numpy seed: the vocabulary encoder (from both joint datasets'
metadata, with dict, JSON and pickle statistics, from an h5ad and from a
parquet file), `tokenize_cells` (every strategy, bit for bit under one
seed, and its errors), `expressed_batch_from_csr` (dense and lean, bit for
bit), the h5ad reader and writer (each reads what the other wrote), the
metadata extraction and the generation / inference output files.

Everything here is numpy on both sides: results are held equal, not close."""

import json
import pickle
import subprocess
import sys

import h5py
import numpy as np
import pytest
from scipy import sparse

from scldm_tpu.cli.extract_metadata import extract as jax_extract
from scldm_tpu.data import fastpath as jax_fastpath
from scldm_tpu.data.encoder import VocabularyEncoder as JaxEncoder
from scldm_tpu.data.h5ad import H5ADFile as JaxH5AD
from scldm_tpu.data.h5ad import read_shard_metadata as jax_read_shard_metadata
from scldm_tpu.data.h5ad import write_h5ad as jax_write_h5ad
from scldm_tpu.data.tokenize import tokenize_cells as jax_tokenize
from scldm_tpu.utils.output import create_anndata_from_inference_output as jax_inference_out
from scldm_tpu.utils.output import process_generation_output as jax_generation_out
from scldm_torch.cli.extract_metadata import extract, main as extract_main
from scldm_torch.data.encoder import VocabularyEncoder, VocabularyEncoderSimplified
from scldm_torch.data.fastpath import expressed_batch_from_csr
from scldm_torch.data.h5ad import H5ADFile, read_shard_metadata, write_h5ad
from scldm_torch.data.tokenize import tokenize_cells
from scldm_torch.utils.output import (
    create_anndata_from_inference_output,
    process_generation_output,
)

# the two datasets with condition_strategy: joint (configs/datamodule/default.yaml:87-121)
DATASETS = {
    "parse1m": ("metadata/parse1m_train.json", {"cell_type": 18, "cytokine": 91}),
    "replogle": ("metadata/replogle_train.json", {"cell_line": 4, "gene": 2024}),
}
STRATEGIES = ("none", "random", "weighted", "expressed", "expressed_zero", "random_expressed")


def assert_same(got, want, path=""):
    """Equal values, dtypes and shapes, recursively through dicts and lists."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def joint_stats(rng, labels, c1, c2, share=0.8, sd=0.05):
    """Joint statistics in the reference's format ({"c1_c2": {"<cat1>_<cat2>":
    value}}) for about `share` of the pairs, mu spread over [6, 9]."""
    mu, sds = {}, {}
    for a in labels[c1]:
        for b in labels[c2]:
            if rng.random() < share:
                mu[f"{a}_{b}"] = float(rng.uniform(6.0, 9.0))
                sds[f"{a}_{b}"] = float(sd)
    key = f"{c1}_{c2}"
    return {key: mu}, {key: sds}


def per_label_stats(rng, labels, numpy_scalars=False):
    cast = np.float32 if numpy_scalars else float
    mu = {k: {c: cast(rng.uniform(5, 9)) for c in cats if rng.random() < 0.9}
          for k, cats in labels.items()}
    sd = {k: {c: cast(rng.uniform(0.05, 0.5)) for c in v} for k, v in mu.items()}
    return mu, sd


def write_stats(tmp_path, mu, sd, fmt):
    """The statistics as the encoder takes them: a dict, JSON or pickle files."""
    if fmt == "dict":
        return mu, sd
    paths = []
    for name, payload in (("mu", mu), ("sd", sd)):
        p = tmp_path / f"{name}.{'json' if fmt == 'json' else 'pkl'}"
        if fmt == "json":
            p.write_text(json.dumps(payload))
        else:
            p.write_bytes(pickle.dumps(payload))
        paths.append(str(p))
    return paths


def encoder_state(enc):
    """The encoder's tables; "absent" where it has none (no labels)."""
    return {k: getattr(enc, k, "absent") for k in (
        "n_genes", "labels", "classes2idx", "idx2classes", "mu_size_factor", "sd_size_factor",
        "joint_key", "joint_components", "joint_idx_2_classes", "gene_tokens_idx")}


# -- the vocabulary encoder ---------------------------------------------------------

@pytest.mark.parametrize("fmt", ["dict", "json", "pickle"])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_joint_encoder_matches_jax(tmp_path, dataset, fmt):
    meta, vocab = DATASETS[dataset]
    labels = json.loads(open(meta).read())["labels"]
    c1, c2 = vocab
    mu, sd = write_stats(tmp_path, *joint_stats(np.random.default_rng(0), labels, c1, c2), fmt)
    kw = dict(metadata_json=meta, class_vocab_sizes=vocab, condition_strategy="joint",
              mu_size_factor=mu, sd_size_factor=sd)
    got, want = VocabularyEncoder(**kw), JaxEncoder(**kw)
    assert_same(encoder_state(got), encoder_state(want))
    np.testing.assert_array_equal(got.genes, want.genes)
    assert got.joint_key == f"{c1}_{c2}" and got.joint_components == [c1, c2]
    assert len(got.classes2idx[c1]) == vocab[c1] and len(got.classes2idx[c2]) == vocab[c2]
    # every "i1_i2" names the pair of categories at those indices
    for key, token in got.joint_idx_2_classes.items():
        i1, i2 = (int(v) for v in key.split("_"))
        assert token == f"{got.idx2classes[c1][i1]}_{got.idx2classes[c2][i2]}"


@pytest.mark.parametrize("fmt", ["dict", "json", "pickle"])
def test_per_label_encoder_matches_jax(tmp_path, fmt):
    """Per-label statistics re-keyed to class indices; pickles may hold
    numpy scalars."""
    meta, vocab = DATASETS["parse1m"]
    labels = json.loads(open(meta).read())["labels"]
    mu, sd = write_stats(tmp_path, *per_label_stats(np.random.default_rng(1), labels,
                                                     numpy_scalars=fmt == "pickle"), fmt)
    kw = dict(metadata_json=meta, class_vocab_sizes=vocab, mu_size_factor=mu,
              sd_size_factor=sd)
    got, want = VocabularyEncoder(**kw), JaxEncoder(**kw)
    assert_same(encoder_state(got), encoder_state(want))
    assert got.joint_key is None and got.joint_idx_2_classes is None


def test_encoder_integer_categories_and_missing_files(tmp_path):
    """JSON turns integer categories into strings: statistics keyed by ints
    (a pickle) and by their strings (JSON) give the same tables; a statistics
    path that does not exist gives None."""
    (tmp_path / "meta.json").write_text(json.dumps(
        {"genes": ["g0", "g1", "g2"], "labels": {"clusters": [0, 1, 2]}}))
    mu = {"clusters": {0: 7.0, 2: 8.0}}
    sd = {"clusters": {0: 0.1, 2: 0.2}}
    (tmp_path / "mu.json").write_text(json.dumps(mu))
    (tmp_path / "sd.json").write_text(json.dumps(sd))
    base = dict(metadata_json=str(tmp_path / "meta.json"), class_vocab_sizes={"clusters": 3})
    from_dict = VocabularyEncoder(**base, mu_size_factor=mu, sd_size_factor=sd)
    from_json = VocabularyEncoder(**base, mu_size_factor=str(tmp_path / "mu.json"),
                                  sd_size_factor=str(tmp_path / "sd.json"))
    want = JaxEncoder(**base, mu_size_factor=str(tmp_path / "mu.json"),
                      sd_size_factor=str(tmp_path / "sd.json"))
    assert from_dict.mu_size_factor == from_json.mu_size_factor == {"clusters": {0: 7.0, 2: 8.0}}
    assert_same(encoder_state(from_json), encoder_state(want))
    missing = dict(base, mu_size_factor=str(tmp_path / "no.pkl"), sd_size_factor=None)
    assert_same(encoder_state(VocabularyEncoder(**missing)), encoder_state(JaxEncoder(**missing)))
    assert VocabularyEncoder(**missing).mu_size_factor is None


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_encode_decode_match_jax(dataset):
    meta, vocab = DATASETS[dataset]
    got, want = (cls(metadata_json=meta, class_vocab_sizes=vocab, condition_strategy="joint")
                 for cls in (VocabularyEncoder, JaxEncoder))
    rng = np.random.default_rng(2)
    tokens = list(rng.choice(got.genes, 50)) + ["NOT_A_GENE", "<MASK>"]
    assert_same(got.encode_genes(tokens), want.encode_genes(tokens))
    idx = rng.integers(0, got.n_genes + 1, (4, 6))
    assert_same(got.decode_genes(idx), want.decode_genes(idx))
    for label, n in vocab.items():
        cats = [got.labels[label][i] for i in rng.integers(0, n, 40)]
        enc = got.encode_metadata(cats, label)
        assert_same(enc, want.encode_metadata(cats, label))
        assert_same(got.decode_metadata(enc, label), want.decode_metadata(enc, label))
        assert list(got.decode_metadata(enc, label)) == cats
        unknown = cats[:3] + ["no such category"]
        with pytest.raises(KeyError, match="no such category") as err:
            got.encode_metadata(unknown, label)
        with pytest.raises(KeyError) as jerr:
            want.encode_metadata(unknown, label)
        assert str(err.value) == str(jerr.value)


def test_encoder_errors_and_alias():
    with pytest.raises(ValueError, match="metadata_json / metadata_genes / adata_path"):
        VocabularyEncoder()
    with pytest.raises(ValueError, match="missing label categories for 'tissue'"):
        VocabularyEncoder(metadata_json=DATASETS["parse1m"][0], class_vocab_sizes={"tissue": 3})
    assert VocabularyEncoderSimplified is VocabularyEncoder


def test_encoder_from_h5ad_and_parquet(tmp_path):
    """Genes and categories from an h5ad written by the JAX package; genes,
    symbols and means from a parquet file."""
    import pandas as pd

    rng = np.random.default_rng(3)
    X = rng.poisson(1.0, (12, 5)).astype(np.float32)
    jax_write_h5ad(tmp_path / "d.h5ad", X, obs={"ct": rng.choice(["y", "x", "z"], 12),
                                                "batch": np.arange(12)},
                   var_names=["a", "b", "c", "d", "e"])
    kw = dict(adata_path=str(tmp_path / "d.h5ad"), class_vocab_sizes={"ct": 3, "batch": 12})
    got, want = VocabularyEncoder(**kw), JaxEncoder(**kw)
    assert_same(encoder_state(got), encoder_state(want))
    np.testing.assert_array_equal(got.genes, want.genes)
    assert got.labels["ct"] == ["x", "y", "z"]

    df = pd.DataFrame({"feature_id": [f"ENSG{i}" for i in range(6)],
                       "feature_name": [f"G{i}" for i in range(6)],
                       "means": rng.uniform(0.1, 3.0, 6)})
    df.to_parquet(tmp_path / "genes.parquet")
    kw = dict(metadata_genes=str(tmp_path / "genes.parquet"))
    got, want = VocabularyEncoder(**kw), JaxEncoder(**kw)
    np.testing.assert_array_equal(got.genes, want.genes)
    np.testing.assert_array_equal(got.gene_means, want.gene_means)
    assert got.gene_symbol_to_ensembl == want.gene_symbol_to_ensembl
    assert_same(encoder_state(got), encoder_state(want))


# -- tokenize_cells -------------------------------------------------------------------

@pytest.fixture(scope="module")
def gene_encoders(tmp_path_factory):
    """Both packages' encoders over 40 genes with means (a parquet file)."""
    import pandas as pd

    path = tmp_path_factory.mktemp("genes") / "genes.parquet"
    rng = np.random.default_rng(4)
    pd.DataFrame({"feature_id": [f"g{i}" for i in range(40)],
                  "feature_name": [f"G{i}" for i in range(40)],
                  "means": rng.uniform(0.05, 4.0, 40)}).to_parquet(path)
    return VocabularyEncoder(metadata_genes=str(path)), JaxEncoder(metadata_genes=str(path))


def counts_block(seed, n=9, g=30):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(0.6, (n, g)).astype(np.float32)
    counts[2] = 0  # an empty cell
    return counts


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tokenize_matches_jax_bitwise(gene_encoders, strategy, seed):
    """The same draws in the same order: equal outputs, bit for bit. The
    file's genes are a shuffled subset of the vocabulary plus one unknown."""
    got_enc, want_enc = gene_encoders
    rng = np.random.default_rng(seed + 100)
    var_names = list(rng.permutation([f"g{i}" for i in range(40)])[:29]) + ["unknown"]
    counts = counts_block(seed)
    kw = dict(var_names=var_names, genes_seq_len=24, sample_genes=strategy, seed=seed)
    got = tokenize_cells(counts, encoder=got_enc, **kw)
    want = jax_tokenize(counts, encoder=want_enc, **kw)
    assert_same(got, want)
    # custom output keys
    kw.update(gene_tokens_key="g", counts_key="c")
    assert_same(tokenize_cells(counts, encoder=got_enc, **kw),
                jax_tokenize(counts, encoder=want_enc, **kw))


def test_tokenize_errors_match_jax(gene_encoders):
    got_enc, want_enc = gene_encoders
    no_means = VocabularyEncoder(metadata_json=DATASETS["parse1m"][0])
    jax_no_means = JaxEncoder(metadata_json=DATASETS["parse1m"][0])
    counts = counts_block(1)
    names = [f"g{i}" for i in range(30)]
    cases = [
        (dict(sample_genes="bogus", genes_seq_len=24), (got_enc, want_enc)),
        (dict(sample_genes="expressed", genes_seq_len=2), (got_enc, want_enc)),
        (dict(sample_genes="weighted", genes_seq_len=24), (no_means, jax_no_means)),
    ]
    for kw, (enc, jenc) in cases:
        with pytest.raises(ValueError) as err:
            tokenize_cells(counts, names, enc, seed=0, **kw)
        with pytest.raises(ValueError) as jerr:
            jax_tokenize(counts, names, jenc, seed=0, **kw)
        assert str(err.value) == str(jerr.value)


# -- expressed_batch_from_csr -------------------------------------------------------------

def csr_cells(seed, n=33, g=200):
    """Integer counts as a CSR block with sorted column indices, 0 to 60
    expressed genes a cell (one empty cell)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        nnz = 0 if i == 5 else int(rng.integers(1, min(g, 60) + 1))
        cols = np.sort(rng.choice(g, nnz, replace=False))
        rows.append((cols, (rng.poisson(2.0, nnz) + 1).astype(np.float32)))
    indptr = np.concatenate([[0], np.cumsum([len(c) for c, _ in rows])]).astype(np.int64)
    indices = np.concatenate([c for c, _ in rows]).astype(np.int32)
    data = np.concatenate([d for _, d in rows]).astype(np.float32)
    return data, indices, indptr


@pytest.mark.parametrize("build_dense", [True, False])
def test_expressed_batch_matches_jax_bitwise(build_dense, monkeypatch):
    """Against JAX's numpy path and against its default (the native packer
    where it builds): integer counts sum exactly in any order."""
    data, indices, indptr = csr_cells(0)
    gene_row = np.random.default_rng(1).permutation(np.arange(1, 201)).astype(np.int64)
    got = expressed_batch_from_csr(data, indices, indptr, gene_row, 64, build_dense=build_dense)
    default = jax_fastpath.expressed_batch_from_csr(data, indices, indptr, gene_row, 64,
                                                    build_dense=build_dense)
    monkeypatch.setattr(jax_fastpath, "_native", lambda: None)
    numpy_path = jax_fastpath.expressed_batch_from_csr(data, indices, indptr, gene_row, 64,
                                                       build_dense=build_dense)
    assert_same(got, numpy_path)
    assert_same(got, default)
    assert ("counts" in got) == build_dense and got["genes_subset"].dtype == np.int64


def test_expressed_batch_equals_tokenize_expressed():
    """The CSR path and tokenize_cells("expressed") on the same cells."""
    data, indices, indptr = csr_cells(2, n=10, g=30)
    dense = sparse.csr_matrix((data, indices, indptr), shape=(10, 30)).toarray()
    enc = VocabularyEncoder(metadata_json=DATASETS["parse1m"][0])
    names = list(enc.genes[:30])
    want = tokenize_cells(dense, names, enc, 64, "expressed", seed=0)
    got = expressed_batch_from_csr(data, indices, indptr, enc.encode_genes(names), 64)
    for k in ("genes_subset", "counts_subset", "counts", "genes"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["library_size"], want["library_size"])


def test_expressed_batch_window_error_matches_jax():
    data, indices, indptr = csr_cells(3)
    gene_row = np.arange(1, 201)
    for fn in (expressed_batch_from_csr, jax_fastpath.expressed_batch_from_csr):
        with pytest.raises(ValueError, match="genes_seq_len is smaller"):
            fn(data, indices, indptr, gene_row, 10)


# -- h5ad ---------------------------------------------------------------------------------

def h5_contents(path) -> dict:
    """Every dataset's values and every attribute of an HDF5 file, strings
    decoded: what two writers must agree on (the files' bytes also hold
    creation times)."""
    out = {}

    def norm(v):
        v = np.asarray(v)
        if v.dtype.kind in ("S", "O"):
            return np.asarray([x.decode() if isinstance(x, bytes) else str(x) for x in v.ravel()])
        return v

    def visit(name, node):
        out[f"{name}@attrs"] = {k: norm(v).tolist() for k, v in sorted(node.attrs.items())}
        if isinstance(node, h5py.Dataset):
            out[name] = norm(node[()])

    with h5py.File(path, "r") as f:
        out["@attrs"] = {k: norm(v).tolist() for k, v in sorted(f.attrs.items())}
        f.visititems(visit)
    return out


def assert_same_h5(got_path, want_path):
    got, want = h5_contents(got_path), h5_contents(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            assert got[k] == want[k], k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def sample_anndata(seed):
    rng = np.random.default_rng(seed)
    X = rng.poisson(0.4, (15, 8)).astype(np.float32)  # mostly zeros: stored as CSR
    dense_layer = rng.normal(size=(15, 8)).astype(np.float32)  # stored dense
    obs = {"cell_type": rng.choice(["b", "a", "c"], 15), "score": rng.normal(size=15),
           "n": np.arange(15, dtype=np.int64)}
    return dict(X=X, obs=obs, var_names=[f"gene{i}" for i in range(8)],
                obs_names=[f"cell{i}" for i in range(15)],
                obsm={"z": rng.normal(size=(15, 3))},
                layers={"dense": dense_layer, "csr": sparse.csr_matrix(X * 2)})


def read_all(cls, path):
    with cls(path) as f:
        out = {"shape": f.shape(), "n": (f.n_obs, f.n_vars), "var": f.var_names,
               "obs_names": f.obs_names, "columns": f.obs_columns(),
               "X": f.rows(slice(None)), "X_rows": f.rows(np.array([7, 2, 2, 11])),
               "csr": [f.is_csr(), f.is_csr("layers", "dense"), f.is_csr("layers", "csr")],
               "layer_dense": f.rows(np.array([3, 0]), "layers", "dense"),
               "layer_csr": f.rows(slice(2, 9), "layers", "csr"),
               "block": list(f.csr_block(3, 10)),
               "layer_block": list(f.csr_block(0, 4, "layers", "csr"))}
        for c in out["columns"]:
            out[f"obs/{c}"] = f.obs_column(c)
            out[f"obs/{c}/rows"] = f.obs_column(c, np.array([4, 1]))
            out[f"codes/{c}"] = f.obs_codes(c)
            out[f"cats/{c}"] = f.obs_categories(c)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_h5ad_round_trip_both_ways(tmp_path, writer):
    """A file written by one package reads the same through either reader,
    and the two writers write the same contents."""
    ad = sample_anndata(0)
    write = write_h5ad if writer == "port" else jax_write_h5ad
    write(tmp_path / "a.h5ad", **ad)
    got, want = read_all(H5ADFile, tmp_path / "a.h5ad"), read_all(JaxH5AD, tmp_path / "a.h5ad")
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray) and want[k].dtype == object:
            assert list(got[k]) == list(want[k]), k
        elif k.startswith("codes/") and want[k] is not None:
            np.testing.assert_array_equal(got[k][0], want[k][0])
            assert got[k][1] == want[k][1]
        else:
            assert_same(got[k], want[k], k)
    np.testing.assert_array_equal(got["X"], ad["X"])
    np.testing.assert_array_equal(got["layer_dense"], ad["layers"]["dense"][[3, 0]])
    assert got["csr"] == [True, False, True]
    assert list(got["obs/cell_type"]) == list(ad["obs"]["cell_type"])
    assert got["cats/cell_type"] == ["a", "b", "c"] and got["cats/score"] is None
    other = tmp_path / "b.h5ad"
    (jax_write_h5ad if writer == "port" else write_h5ad)(other, **ad)
    assert_same_h5(tmp_path / "a.h5ad", other)


def test_h5ad_dense_x_and_defaults(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.uniform(1.0, 2.0, (4, 3)).astype(np.float32)  # no zeros: stored dense
    write_h5ad(tmp_path / "p.h5ad", X)
    jax_write_h5ad(tmp_path / "j.h5ad", X)
    assert_same_h5(tmp_path / "p.h5ad", tmp_path / "j.h5ad")
    with H5ADFile(tmp_path / "j.h5ad") as f, JaxH5AD(tmp_path / "p.h5ad") as jf:
        assert not f.is_csr() and not jf.is_csr()
        np.testing.assert_array_equal(f.rows(np.array([2, 0, 2])), jf.rows(np.array([2, 0, 2])))
        assert list(f.var_names) == ["g0", "g1", "g2"] and list(f.obs_names) == list("0123")


@pytest.mark.parametrize("n_vars", [5, 6])
def test_h5ad_csc_matrix(tmp_path, n_vars):
    """A CSC matrix (written by anndata, not by either writer) reads as rows.
    A square one passes the CSR test on indptr's length; the port's `rows`
    trusts the declared encoding first, as `is_csr` does in both packages
    (JAX's `rows` reads a square CSC matrix as CSR)."""
    rng = np.random.default_rng(6)
    X = rng.poisson(0.5, (6, n_vars)).astype(np.float32)
    jax_write_h5ad(tmp_path / "c.h5ad", X)
    csc = sparse.csc_matrix(X)
    with h5py.File(tmp_path / "c.h5ad", "a") as f:
        del f["X"]
        g = f.create_group("X")
        g.attrs["encoding-type"] = "csc_matrix"
        g.attrs["shape"] = np.asarray(X.shape)
        for k in ("data", "indices", "indptr"):
            g.create_dataset(k, data=getattr(csc, k))
    for cls in (H5ADFile, JaxH5AD) if n_vars != 6 else (H5ADFile,):
        with cls(tmp_path / "c.h5ad") as f:
            assert not f.is_csr()
            np.testing.assert_array_equal(f.rows(np.array([5, 1])), X[[5, 1]])


def test_read_shard_metadata(tmp_path):
    assert read_shard_metadata(tmp_path) is None and jax_read_shard_metadata(tmp_path) is None
    meta = {"n_cells": 10_000, "shard_size": 4096, "last_shard_size": 1808}
    (tmp_path / "metadata.json").write_text(json.dumps(meta))
    assert read_shard_metadata(tmp_path) == jax_read_shard_metadata(tmp_path) == meta


# -- metadata extraction and output files ---------------------------------------------------

@pytest.fixture()
def labelled_h5ad(tmp_path):
    rng = np.random.default_rng(8)
    X = rng.poisson(3.0, (40, 12)).astype(np.float32)
    X[X < 2] = 0
    obs = {"cell_type": rng.choice(["T", "B", "NK"], 40),
           "cytokine": rng.choice(["IL2", "IFNG"], 40), "plain": np.arange(40) % 3}
    jax_write_h5ad(tmp_path / "cells.h5ad", X, obs=obs, var_names=[f"G{i}" for i in range(12)],
                   layers={"counts": X * 3})
    return tmp_path / "cells.h5ad"


@pytest.mark.parametrize("attr,key", [("X", None), ("layers", "counts")])
def test_extract_matches_jax(tmp_path, labelled_h5ad, attr, key):
    outs = {}
    for name, fn in (("port", extract), ("jax", jax_extract)):
        out = tmp_path / name / "meta.json"
        payload = fn(str(labelled_h5ad), ["cell_type", "cytokine", "plain"], str(out),
                     size_factors_out=str(tmp_path / name / "sf" / "cells"), adata_attr=attr,
                     adata_key=key)
        files = {p.name: p.read_text() for p in [out, *sorted((tmp_path / name / "sf").iterdir())]}
        outs[name] = (payload, files)
    assert outs["port"] == outs["jax"]
    payload, files = outs["port"]
    assert payload["labels"]["cell_type"] == ["B", "NK", "T"]
    assert payload["labels"]["plain"] == ["0", "1", "2"]
    assert sorted(files) == ["cells_log_size_factor_mu.json", "cells_log_size_factor_sd.json",
                             "meta.json"]


def test_extract_cli(tmp_path, labelled_h5ad):
    out = tmp_path / "m.json"
    assert extract_main([str(labelled_h5ad), "--labels", "cell_type", "--out", str(out),
                         "--dataset", "demo"]) == 0
    payload = json.loads(out.read_text())
    assert payload["dataset"] == "demo" and len(payload["genes"]) == 12
    # the metadata feeds the encoder
    enc = VocabularyEncoder(metadata_json=str(out), class_vocab_sizes={"cell_type": 3})
    assert enc.classes2idx["cell_type"] == {"B": 0, "NK": 1, "T": 2}
    proc = subprocess.run([sys.executable, "-m", "scldm_torch.cli.extract_metadata", "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--size-factors-out" in proc.stdout


def output_encoders(tmp_path):
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"genes": [f"G{i}" for i in range(6)],
                                "labels": {"cell_type": ["B", "NK", "T"],
                                           "cytokine": ["IFNG", "IL2"]}}))
    kw = dict(metadata_json=str(meta), class_vocab_sizes={"cell_type": 3, "cytokine": 2},
              condition_strategy="joint")
    return VocabularyEncoder(**kw), JaxEncoder(**kw)


def test_generation_output_matches_jax(tmp_path):
    enc, jenc = output_encoders(tmp_path)
    rng = np.random.default_rng(9)
    batches = [{"counts_generated_unconditional": rng.poisson(2.0, (n, 6)).astype(np.float32),
                "counts_generated_conditional": rng.poisson(2.0, (n, 6)).astype(np.float32),
                "z_generated_unconditional": rng.normal(size=(n, 2, 3)).astype(np.float32),
                "z_generated_conditional": rng.normal(size=(n, 2, 3)).astype(np.float32),
                "cell_type": rng.integers(0, 3, n), "cytokine": rng.integers(0, 2, n),
                "library_size": np.ones((n, 1), np.float32)}
               for n in (4, 3)]
    got = process_generation_output(batches, enc, tmp_path / "port", dataset="parse", index=2)
    want = jax_generation_out(batches, jenc, tmp_path / "jax", dataset="parse", index=2)
    assert got.name == want.name == "parse_generated_2.h5ad"
    assert_same_h5(got, want)
    with H5ADFile(got) as f:
        assert f.n_obs == 14 and list(f.var_names) == [f"G{i}" for i in range(6)]
        ct = np.concatenate([b["cell_type"] for b in batches])
        assert list(f.obs_column("cell_type")) == [enc.labels["cell_type"][i] for i in ct] * 2
        assert list(f.obs_column("generation_type")) == ["unconditional"] * 7 + ["conditional"] * 7


def test_inference_output_matches_jax(tmp_path):
    enc, jenc = output_encoders(tmp_path)
    rng = np.random.default_rng(10)
    outputs = {"reconstructed_counts": rng.poisson(2.0, (5, 6)).astype(np.float32),
               "z": rng.normal(size=(5, 2, 3)).astype(np.float32),
               "z_mean_flat": rng.normal(size=(5, 6)).astype(np.float32),
               "cell_type": rng.integers(0, 3, 5), "score": rng.normal(size=5),
               "library_size": np.ones(5, np.float32), "not_per_cell": np.arange(3)}
    got = create_anndata_from_inference_output(outputs, enc, tmp_path / "port")
    want = jax_inference_out(outputs, jenc, tmp_path / "jax")
    assert got.name == want.name == "inference_inference_0.h5ad"
    assert_same_h5(got, want)
    with H5ADFile(got) as f:
        assert f.obs_columns() == ["cell_type", "score"]
