"""LDM training entry point (counterpart of scldm_tpu/cli/train_ldm.py; the
reference's experiments/scripts/train_ldm.py).

Loads the trained VAE from its checkpoint directory, grafts the VAE
architecture from the checkpoint's config snapshot into this run's config
(the reference's _utils.py:336-370 checkpoint surgery), freezes it as the
tokenizer, and trains the DiT with the SiT flow-matching loss.

Usage:
    python -m scldm_torch.cli.train_ldm --config configs/ldm_training.yaml \
        datamodule.datamodule.train_adata_path=...
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
    build_dit,
    build_ldm_task,
    build_vae,
    build_vocabulary_encoder,
    compute_max_steps,
)
from scldm_torch.training.checkpoint import CheckpointManager, read_payload
from scldm_torch.training.loop import CSVLogger, fit
from scldm_torch.utils.logger import logger

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "ldm_training.yaml"


@torch.no_grad()
def load_vae_from_checkpoint(cfg: dict):
    """The frozen VAE of `cfg["vae_checkpoint_dir"]`'s latest step, with
    its architecture grafted into `cfg["model"]["vae"]` (and the DiT's
    n_embed_input / seq_len following the latent dims, as the reference's
    _utils.py:363-369 does). Every parameter's shape is checked against the
    grafted architecture; a mismatch raises a ValueError naming it."""
    vae_dir = cfg["vae_checkpoint_dir"]
    vae_mgr = CheckpointManager(vae_dir)
    vae_cfg = vae_mgr.load_config()
    if vae_cfg is not None:
        cfg["model"]["vae"] = vae_cfg["model"]["vae"]
        cfg["model"]["decoder_name"] = vae_cfg["model"].get(
            "decoder_name", "negative_binomial_shared_theta"
        )
        # the DiT's latent dims follow the grafted VAE
        cfg["model"]["diffusion_model"]["n_embed_input"] = cfg["model"]["vae"]["n_embed_latent"]
        cfg["model"]["diffusion_model"]["seq_len"] = cfg["model"]["vae"]["n_inducing_points"]
    vae = build_vae(cfg)
    step = vae_mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no VAE checkpoint in {vae_dir}")
    weights = read_payload(vae_mgr.directory / str(step))["module"]
    vae_mgr.close()
    own = vae.state_dict()
    for name, want in own.items():
        if name not in weights:
            raise ValueError(f"VAE checkpoint lacks parameter {name!r} of the grafted "
                             "architecture — wrong checkpoint or config drift")
        if tuple(weights[name].shape) != tuple(want.shape):
            raise ValueError(
                f"VAE checkpoint parameter {name!r} has shape {tuple(weights[name].shape)}, "
                f"the grafted architecture's is {tuple(want.shape)} — wrong checkpoint or "
                "config drift"
            )
    extra = sorted(set(weights) - set(own))
    if extra:
        raise ValueError(f"VAE checkpoint holds parameters the grafted architecture lacks: "
                         f"{extra[:5]}")
    vae.load_state_dict(weights)
    logger.info(f"loaded frozen VAE from {vae_dir} @ step {step}")
    return vae.requires_grad_(False).eval()


def main(argv=None) -> int:
    cfg = parse_config(argv, DEFAULT_CONFIG, __doc__)
    seed = int(cfg.get("seed", 42))
    np.random.seed(seed)
    device = setup_device(cfg)

    vocab = build_vocabulary_encoder(cfg)
    datamodule = build_datamodule(cfg, vocab)
    datamodule.setup("fit")
    max_steps = compute_max_steps(cfg, datamodule.n_cells)

    vae = load_vae_from_checkpoint(cfg)
    dit = build_dit(cfg)
    task = build_ldm_task(cfg, vae, dit, max_steps)
    state = task.init_state(torch.Generator(device).manual_seed(seed))
    n_params = sum(p.numel() for p in dit.parameters())
    logger.info(f"DiT params: {n_params:,}; max_steps={max_steps}")

    ckpt_dir = cfg.get("checkpoint_dir", "outputs/checkpoints/ldm")
    mgr = make_checkpoint_manager(cfg, ckpt_dir)
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
        mgr.close()
    if wandb_logger is not None:
        wandb_logger.finish()
    logger.info(f"done at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
