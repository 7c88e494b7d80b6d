"""VAE training entry point (counterpart of scldm_tpu/cli/train.py; the
reference's experiments/scripts/train.py).

Usage:
    python -m scldm_torch.cli.train --config configs/vae_training.yaml \
        datamodule.datamodule.train_adata_path=data/dentate_gyrus_train.h5ad

One process a card (`device`, default cuda; `device=cpu` for the CPU), one
or several (`torchrun --nproc_per_node=N -m scldm_torch.cli.train ...`,
data-parallel; `cli._common`): config -> process group and mesh ->
vocabulary -> this rank's DataModule -> max_steps -> VAE and task -> state ->
checkpoint manager with the config snapshot -> preemption guard -> fit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scldm_torch.cli._common import parse_config, run_fit, scale_lr, setup_parallel
from scldm_torch.config.build import (
    build_datamodule,
    build_vae,
    build_vae_task,
    build_vocabulary_encoder,
    compute_max_steps,
)
from scldm_torch.parallel import rank, world_size
from scldm_torch.utils.logger import logger

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "vae_training.yaml"


def main(argv=None) -> int:
    cfg = parse_config(argv, DEFAULT_CONFIG, __doc__)
    seed = int(cfg.get("seed", 42))
    np.random.seed(seed)
    device, mesh = setup_parallel(cfg)

    vocab = build_vocabulary_encoder(cfg)
    datamodule = build_datamodule(cfg, vocab, num_hosts=world_size(), host_index=rank())
    datamodule.setup("fit")
    max_steps = compute_max_steps(cfg, datamodule.n_cells, world_size=world_size())
    logger.info(f"n_cells={datamodule.n_cells} max_steps={max_steps}")
    base_lr = scale_lr(cfg)

    vae = build_vae(cfg)
    task = build_vae_task(cfg, vae, max_steps, mesh=mesh)
    # each rank its own draws (JAX draws one array over the global batch)
    state = task.init_state(torch.Generator(device).manual_seed(seed + rank()))
    n_params = sum(p.numel() for p in vae.parameters())
    logger.info(f"VAE params: {n_params:,}")

    ckpt_dir = cfg.get("checkpoint_dir", "outputs/checkpoints/vae")
    run_fit(cfg, task, datamodule, state, max_steps, ckpt_dir, mesh=mesh, base_lr=base_lr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
