"""scVI-baseline training entry point (counterpart of
scldm_tpu/cli/train_scvi.py; the reference's models.VAEScvi through
train.py).

Usage:
    python -m scldm_torch.cli.train_scvi --config configs/vae_scvi_training.yaml \
        datamodule.datamodule.train_adata_path=data/dentate_gyrus_train.h5ad

One process on one card (`device`, default cuda; `device=cpu` for the CPU):
config -> vocabulary -> DataModule -> max_steps -> scVI VAE and task ->
state -> checkpoint manager with the config snapshot -> preemption guard ->
fit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scldm_torch.cli._common import parse_config, run_fit, setup_device
from scldm_torch.config.build import (
    build_datamodule,
    build_scvi_task,
    build_vocabulary_encoder,
    compute_max_steps,
)
from scldm_torch.utils.logger import logger

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "vae_scvi_training.yaml"


def main(argv=None) -> int:
    cfg = parse_config(argv, DEFAULT_CONFIG, __doc__)
    seed = int(cfg.get("seed", 42))
    np.random.seed(seed)
    device = setup_device(cfg)
    logger.info(f"device: {device}")

    vocab = build_vocabulary_encoder(cfg)
    datamodule = build_datamodule(cfg, vocab)
    datamodule.setup("fit")
    max_steps = compute_max_steps(cfg, datamodule.n_cells)
    logger.info(f"n_cells={datamodule.n_cells} max_steps={max_steps}")

    task = build_scvi_task(cfg, max_steps)
    state = task.init_state(torch.Generator(device).manual_seed(seed))
    n_params = sum(p.numel() for p in task.vae.parameters())
    logger.info(f"scVI params: {n_params:,}")

    ckpt_dir = cfg.get("checkpoint_dir", "outputs/checkpoints/scvi")
    run_fit(cfg, task, datamodule, state, max_steps, ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
