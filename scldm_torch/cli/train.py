"""VAE training entry point (counterpart of scldm_tpu/cli/train.py; the
reference's experiments/scripts/train.py).

Usage:
    python -m scldm_torch.cli.train --config configs/vae_training.yaml \
        datamodule.datamodule.train_adata_path=data/dentate_gyrus_train.h5ad

One process on one card (`device`, default cuda; `device=cpu` for the CPU):
config -> vocabulary -> DataModule -> max_steps -> VAE and task -> state ->
checkpoint manager with the config snapshot -> preemption guard -> fit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scldm_torch.cli._common import (
    make_checkpoint_manager,
    make_preemption_guard,
    make_wandb_logger,
    parse_config,
    setup_device,
)
from scldm_torch.config.build import (
    build_datamodule,
    build_vae,
    build_vae_task,
    build_vocabulary_encoder,
    compute_max_steps,
)
from scldm_torch.training.loop import CSVLogger, fit
from scldm_torch.utils.logger import logger

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "vae_training.yaml"


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

    vae = build_vae(cfg)
    task = build_vae_task(cfg, vae, max_steps)
    state = task.init_state(torch.Generator(device).manual_seed(seed))
    n_params = sum(p.numel() for p in vae.parameters())
    logger.info(f"VAE params: {n_params:,}")

    ckpt_dir = cfg.get("checkpoint_dir", "outputs/checkpoints/vae")
    mgr = make_checkpoint_manager(cfg, ckpt_dir)
    # one process: the per-host learning rate is the run's
    mgr.save_config(cfg)
    wandb_logger = make_wandb_logger(cfg)
    preemption = make_preemption_guard(cfg)

    try:
        state = fit(
            task,
            datamodule,
            state,
            max_steps=max_steps,
            epochs=int(cfg.get("epochs", 100)),
            ckpt_manager=mgr,
            csv_logger=CSVLogger(Path(ckpt_dir) / "metrics.csv"),
            log_every_steps=int(cfg["training"].get("log_every_steps", 50)),
            val_every_epochs=int(cfg["training"].get("val_every_epochs", 1)),
            save_every_epochs=int(cfg["training"]["checkpoint"].get("save_every_epochs", 1)),
            eval_rng_seed=seed,
            steps_per_dispatch=int(cfg["training"].get("steps_per_dispatch", 1)),
            profile_dir=cfg["training"].get("profile_dir") or None,
            profile_steps=int(cfg["training"].get("profile_steps", 3)),
            wandb_logger=wandb_logger,
            preemption=preemption,
        )
    finally:
        if preemption is not None:
            preemption.uninstall()
        mgr.close()  # drain the writes in flight before exit
    if wandb_logger is not None:
        wandb_logger.finish()
    logger.info(f"done at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
