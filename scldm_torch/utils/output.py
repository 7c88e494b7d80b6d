"""Generation and inference outputs -> AnnData files on disk (counterpart of
scldm_tpu/utils/output.py), written through `data.h5ad`. Inputs are numpy
arrays: move tensors to the host before calling."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from scldm_torch.data.h5ad import write_h5ad
from scldm_torch.ops.transforms import COUNTS, NON_CONDITION_KEYS


def _var_names(vocab_encoder) -> list:
    return [vocab_encoder._gene_idx2token[i] for i in vocab_encoder.gene_tokens_idx]


def process_generation_output(
    batches: List[Dict[str, np.ndarray]],
    vocab_encoder,
    out_path: str | Path,
    dataset: str = "generated",
    index: int = 0,
) -> Path:
    """Stack generation batches into one h5ad, the unconditional cells first:
    each batch carries counts_generated_unconditional / _conditional,
    optionally z_generated_*, and the condition label columns (class
    indices, decoded to categories in obs)."""
    uncond = np.concatenate([b[f"{COUNTS}_generated_unconditional"] for b in batches])
    cond = np.concatenate([b[f"{COUNTS}_generated_conditional"] for b in batches])
    X = np.concatenate([uncond, cond])
    n_half = len(uncond)

    obs: Dict[str, np.ndarray] = {
        "generation_type": np.asarray(
            ["unconditional"] * n_half + ["conditional"] * n_half
        )
    }
    label_keys = [
        k
        for k in batches[0]
        if k not in NON_CONDITION_KEYS and not k.startswith(("z_generated", f"{COUNTS}_generated"))
    ]
    for k in label_keys:
        idx = np.concatenate([np.asarray(b[k]) for b in batches])
        decoded = vocab_encoder.decode_metadata(idx, k)
        obs[k] = np.concatenate([decoded, decoded])

    obsm = {}
    if "z_generated_unconditional" in batches[0]:
        z_u = np.concatenate([b["z_generated_unconditional"] for b in batches])
        z_c = np.concatenate([b["z_generated_conditional"] for b in batches])
        obsm["z"] = np.concatenate([z_u, z_c]).reshape(len(X), -1)

    path = Path(out_path) / f"{dataset}_generated_{index}.h5ad"
    write_h5ad(path, X, obs=obs, var_names=_var_names(vocab_encoder), obsm=obsm)
    return path


def create_anndata_from_inference_output(
    outputs: Dict[str, np.ndarray],
    vocab_encoder,
    out_path: str | Path,
    dataset: str = "inference",
    index: int = 0,
) -> Path:
    """Reconstructed counts and the latent z -> h5ad; 1-D per-cell columns
    go to obs, label columns decoded to categories."""
    X = np.asarray(outputs["reconstructed_counts"])
    obs: Dict[str, np.ndarray] = {}
    for k, v in outputs.items():
        v = np.asarray(v)
        if k in ("reconstructed_counts", "z", "z_mean_flat") or k in NON_CONDITION_KEYS:
            continue
        if v.ndim == 1 and len(v) == len(X):
            if k in getattr(vocab_encoder, "classes2idx", {}):
                obs[k] = vocab_encoder.decode_metadata(v.astype(int), k)
            else:
                obs[k] = v
    obsm = {}
    if "z" in outputs:
        obsm["z"] = np.asarray(outputs["z"]).reshape(len(X), -1)
    path = Path(out_path) / f"{dataset}_inference_{index}.h5ad"
    write_h5ad(path, X, obs=obs, var_names=_var_names(vocab_encoder), obsm=obsm)
    return path
