"""Extract a dataset's metadata JSON from an h5ad file (counterpart of
scldm_tpu/cli/extract_metadata.py).

Writes {genes, labels, dataset, source_h5ad}, which `data.encoder.
VocabularyEncoder(metadata_json=...)` reads, and optionally the per-class
mean and standard deviation of the log library size
(`<name>_log_size_factor_mu.json` / `_sd.json`), the statistics that
generation samples size factors from.

Usage:
    python -m scldm_torch.cli.extract_metadata data/train.h5ad \
        --labels clusters --out metadata/mydataset_train.json \
        --size-factors-out artifacts/mydataset
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np

from scldm_torch.data.h5ad import H5ADFile

logger = logging.getLogger(__name__)


def extract(
    h5ad_path: str,
    labels: list[str],
    out: str,
    dataset: str | None = None,
    size_factors_out: str | None = None,
    adata_attr: str = "X",
    adata_key: str | None = None,
) -> dict:
    """Write the metadata JSON to `out` (and the statistics beside
    `size_factors_out`) and return the metadata."""
    with H5ADFile(h5ad_path) as f:
        payload = {
            "genes": [str(g) for g in f.var_names],
            "labels": {},
            "dataset": dataset or Path(h5ad_path).stem,
            "source_h5ad": str(h5ad_path),
        }
        for label in labels:
            cats = f.obs_categories(label)
            if cats is None:
                cats = sorted(set(str(v) for v in f.obs_column(label)))
            payload["labels"][label] = [str(c) for c in cats]

        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(payload, indent=2))
        logger.info("wrote %s: %d genes, labels=%s", out, len(payload["genes"]),
                    list(payload["labels"]))

        if size_factors_out and labels:
            # per-class mean / sd of the log library size, 2,048 rows a read
            n = f.n_obs
            lib = np.zeros(n, np.float64)
            for lo in range(0, n, 2048):
                hi = min(lo + 2048, n)
                lib[lo:hi] = f.rows(slice(lo, hi), adata_attr, adata_key).sum(1)
            log_lib = np.log(np.maximum(lib, 1.0))
            mu_all: dict = {}
            sd_all: dict = {}
            for label in labels:
                col = f.obs_column(label)
                mu_all[label] = {}
                sd_all[label] = {}
                for cat in payload["labels"][label]:
                    mask = col == cat
                    if mask.sum() > 0:
                        mu_all[label][cat] = float(log_lib[mask].mean())
                        sd_all[label][cat] = float(log_lib[mask].std() or 1e-3)
            base = Path(size_factors_out)
            base.parent.mkdir(parents=True, exist_ok=True)
            (base.parent / f"{base.name}_log_size_factor_mu.json").write_text(json.dumps(mu_all))
            (base.parent / f"{base.name}_log_size_factor_sd.json").write_text(json.dumps(sd_all))
            logger.info("wrote size-factor stats to %s", base.parent)
    return payload


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("h5ad")
    p.add_argument("--labels", nargs="*", default=[])
    p.add_argument("--out", required=True)
    p.add_argument("--dataset", default=None)
    p.add_argument("--size-factors-out", default=None)
    p.add_argument("--adata-attr", default="X")
    p.add_argument("--adata-key", default=None)
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    extract(a.h5ad, a.labels, a.out, a.dataset, a.size_factors_out, a.adata_attr, a.adata_key)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
