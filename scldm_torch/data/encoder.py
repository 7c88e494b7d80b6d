"""Gene / label vocabulary encoder (counterpart of scldm_tpu/data/encoder.py).

The gene token table with <MASK> at index 0, the label category <-> index
maps, and the per-class (or joint "c1_c2"-keyed) log-library-size statistics
that `sampling.size_factors.SizeFactorSampler` turns into tables. Genes come
from a metadata JSON ({genes, labels}), a parquet file (feature_id,
feature_name, optional means; read with pandas) or an h5ad file (read with
`data.h5ad`); statistics from a dict, a JSON file or a pickle (the reference
format). pandas and h5py are imported only where those files are read.
"""

from __future__ import annotations

import json
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


@dataclass
class VocabularyEncoder:
    """Encode a vocabulary of genes and labels into indices."""

    adata_path: Optional[str] = None
    class_vocab_sizes: Dict[str, int] = field(default_factory=dict)
    mask_token: str = "<MASK>"
    mask_token_idx: int = 0
    n_genes: Optional[int] = None
    guidance_weight: Optional[Dict[str, float]] = None
    mu_size_factor: Optional[str | dict] = None
    sd_size_factor: Optional[str | dict] = None
    condition_strategy: str = "mutually_exclusive"
    metadata_genes: Optional[str] = None  # parquet with feature_id/feature_name
    metadata_json: Optional[str] = None

    def __post_init__(self):
        metadata_payload = None
        if self.metadata_json is not None:
            metadata_payload = json.loads(Path(self.metadata_json).read_text())

        adata = None
        if self.adata_path is not None and metadata_payload is None:
            from scldm_torch.data.h5ad import H5ADFile

            adata = H5ADFile(self.adata_path)

        self.gene_means = None
        if self.metadata_genes is not None:
            import pandas as pd

            df = pd.read_parquet(self.metadata_genes)
            self.genes = df["feature_id"].values
            self.gene_symbol_to_ensembl = dict(
                zip(df["feature_name"].values, df["feature_id"].values)
            )
            if "means" in df.columns:
                self.gene_means = df["means"].values
        elif metadata_payload is not None:
            self.genes = np.asarray(metadata_payload["genes"])
        elif adata is not None:
            self.genes = adata.var_names
        else:
            raise ValueError("one of metadata_json / metadata_genes / adata_path required")

        detected = len(self.genes)
        if self.n_genes is None or self.n_genes != detected:
            self.n_genes = detected

        # label categories
        if adata is not None:
            self.labels = {
                label: adata.obs_categories(label) or sorted(set(adata.obs_column(label)))
                for label in self.class_vocab_sizes
            }
            adata.close()
        elif metadata_payload is not None and self.class_vocab_sizes:
            label_payload = metadata_payload.get("labels", {})
            self.labels = {}
            for label in self.class_vocab_sizes:
                if label not in label_payload:
                    raise ValueError(f"metadata_json missing label categories for '{label}'")
                self.labels[label] = label_payload[label]
        else:
            self.labels = None

        tokens = [self.mask_token, *list(self.genes)]
        self._gene_token2idx = {str(t): i for i, t in enumerate(tokens)}
        self._gene_idx2token = dict(enumerate(tokens))
        self.gene_tokens_idx = list(range(1, len(tokens)))
        if self.mask_token_idx != self._gene_token2idx[self.mask_token]:
            raise ValueError(f"mask_token_idx {self.mask_token_idx} is not the mask token's "
                             f"index {self._gene_token2idx[self.mask_token]}")

        if self.labels is not None:
            self.classes2idx = {
                label: {str(t): i for i, t in enumerate(self.labels[label])}
                for label in self.class_vocab_sizes
            }
            self.idx2classes = {
                label: {i: t for t, i in self.classes2idx[label].items()}
                for label in self.class_vocab_sizes
            }

        self._load_size_factor_stats()

    # -- size factors ----------------------------------------------------------
    def _load_stats(self, src) -> Optional[dict]:
        """A dict as given, a JSON file, or a pickle (the reference's
        format: trusted files only, as unpickling can run code); None for a
        path that does not exist."""
        if src is None or isinstance(src, dict):
            return src
        p = Path(src)
        if not p.exists():
            return None
        if p.suffix == ".json":
            return json.loads(p.read_text())
        with open(p, "rb") as f:
            return pickle.load(f)

    def _load_size_factor_stats(self):
        """Per label, the statistics re-keyed from category to class index
        (JSON turns integer categories into strings, so categories are looked
        up as strings); under the joint strategy the "c1_c2" table as given,
        with `joint_idx_2_classes` mapping "i1_i2" to its "<cat1>_<cat2>" key
        (split at the last underscore)."""
        mu_raw = self._load_stats(self.mu_size_factor)
        sd_raw = self._load_stats(self.sd_size_factor)
        self.joint_key = None
        self.joint_components = None
        self.joint_idx_2_classes = None

        if self.condition_strategy != "joint":
            if mu_raw is not None:
                self.mu_size_factor = {
                    label: {self.classes2idx[label][str(k)]: v for k, v in mu_raw[label].items()}
                    for label in self.class_vocab_sizes
                    if label in mu_raw
                }
            else:
                self.mu_size_factor = None
            if sd_raw is not None:
                self.sd_size_factor = {
                    label: {self.classes2idx[label][str(k)]: v for k, v in sd_raw[label].items()}
                    for label in self.class_vocab_sizes
                    if label in sd_raw
                }
            else:
                self.sd_size_factor = None
        else:
            joint_class = "_".join(self.class_vocab_sizes.keys())
            self.joint_key = joint_class
            self.joint_components = list(self.class_vocab_sizes.keys())
            if mu_raw is not None:
                self.mu_size_factor = {joint_class: mu_raw[joint_class]}
                self.joint_idx_2_classes = {}
                class1, class2 = self.class_vocab_sizes.keys()
                for token in mu_raw[joint_class]:
                    instance1, instance2 = str(token).rsplit("_", 1)
                    c1 = self.classes2idx[class1][instance1]
                    c2 = self.classes2idx[class2][instance2]
                    self.joint_idx_2_classes[f"{c1}_{c2}"] = token
            else:
                self.mu_size_factor = None
            if sd_raw is not None:
                self.sd_size_factor = {joint_class: sd_raw[joint_class]}
            else:
                self.sd_size_factor = None

    # -- encode / decode ---------------------------------------------------------
    def encode_genes(self, tokens: Sequence[str]) -> np.ndarray:
        """Tokens -> indices; unknown tokens map to the mask index."""
        mask = self.mask_token_idx
        return np.asarray(
            [self._gene_token2idx.get(str(t), mask) for t in tokens], dtype=np.int64
        )

    def decode_genes(self, indices: Sequence[int]) -> np.ndarray:
        return np.asarray([self._gene_idx2token.get(int(i)) for i in np.ravel(indices)]).reshape(
            np.shape(indices)
        )

    def encode_metadata(self, metadata: Sequence[str], label: str) -> np.ndarray:
        """Categories -> indices. An unknown category raises a KeyError that
        names it, here rather than as a failed integer cast later."""
        table = self.classes2idx[label]
        out = [table.get(str(m)) for m in metadata]
        if any(v is None for v in out):
            unknown = sorted({str(m) for m, v in zip(metadata, out) if v is None})
            raise KeyError(
                f"unknown {label!r} categories (not in the training vocabulary): "
                f"{unknown[:10]}{'...' if len(unknown) > 10 else ''}"
            )
        return np.asarray(out)

    def decode_metadata(self, indices: Sequence[int], label: str) -> np.ndarray:
        return np.asarray([self.idx2classes[label].get(int(i)) for i in indices])


# the reference's class name
VocabularyEncoderSimplified = VocabularyEncoder
