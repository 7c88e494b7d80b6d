"""LDM training entry point (counterpart of scldm_tpu/cli/train_ldm.py; the
reference's experiments/scripts/train_ldm.py).

Loads the trained VAE from its checkpoint directory, grafts the VAE
architecture from the checkpoint's config snapshot into this run's config
(the reference's _utils.py:336-370 checkpoint surgery), freezes it as the
tokenizer, and trains the DiT with the SiT flow-matching loss; under
`model.vae_as_tokenizer.train=true` the VAE is finetuned with the DiT and
the LDM checkpoints carry it (`LDMTask(train_vae=True)`).

Usage:
    python -m scldm_torch.cli.train_ldm --config configs/ldm_training.yaml \
        datamodule.datamodule.train_adata_path=...
    torchrun --nproc_per_node=N -m scldm_torch.cli.train_ldm ...  # data-parallel

With several processes each rank reads the VAE checkpoint, trains on its
own rows, and the ranks meet in the steps' collectives (`cli._common`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scldm_torch.cli._common import parse_config, run_fit, scale_lr, setup_parallel
from scldm_torch.config.build import (
    build_datamodule,
    build_dit,
    build_ldm_task,
    build_vae,
    build_vocabulary_encoder,
    compute_max_steps,
)
from scldm_torch.training.checkpoint import CheckpointManager, read_payload
from scldm_torch.training.loop import CSVLogger
from scldm_torch.parallel import rank, world_size
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


def generation_eval_hook(cfg: dict, task, vocab, datamodule, ckpt_dir, seed: int):
    """`model.eval_generation` as JAX's train_ldm wires it (the reference's
    models.py:849-939): where enabled, a hook for `fit`'s
    `on_validation_end` that, on the epochs `should_run` picks, generates
    from the EMA weights without guidance and writes the metrics of
    `evals.generation_eval.run_generation_eval` to `generation_eval.csv`
    beside `metrics.csv`. None where disabled. On several ranks each rank
    evaluates against its own validation rows, as each JAX process does
    against its host's; the file holds rank 0's figures, which cover 1/N of
    the validation set (MMD and Sinkhorn are not means, so they are not
    averaged over the ranks)."""
    gen_cfg = cfg["model"].get("eval_generation") or {}
    if not gen_cfg.get("enabled"):
        return None
    from scldm_torch.evals.generation_eval import run_generation_eval, should_run
    from scldm_torch.sampling.size_factors import SizeFactorSampler

    sample_fn = task.make_sample_fn(
        SizeFactorSampler(vocab),
        guidance_weight=None,
        sampling_method=gen_cfg.get("sampling_method", "dopri5"),
        num_steps=int(gen_cfg.get("timesteps", 50)),
        use_ema=True,
    )
    csv_logger = CSVLogger(Path(ckpt_dir) / "generation_eval.csv") if rank() == 0 else None

    def on_validation_end(epoch, val_metrics, state):
        if not should_run(epoch, gen_cfg):
            return
        # every rank generates from its own validation rows; rank 0 writes its own
        mets = run_generation_eval(sample_fn, state, datamodule.val_batches(),
                                   sample_size=int(gen_cfg.get("sample_size", 1024)),
                                   rng_seed=seed + epoch)
        if csv_logger is not None:
            csv_logger.log({"epoch": epoch, **mets})

    return on_validation_end


def main(argv=None) -> int:
    cfg = parse_config(argv, DEFAULT_CONFIG, __doc__)
    seed = int(cfg.get("seed", 42))
    np.random.seed(seed)
    device, mesh = setup_parallel(cfg)

    vocab = build_vocabulary_encoder(cfg)
    datamodule = build_datamodule(cfg, vocab, num_hosts=world_size(), host_index=rank())
    datamodule.setup("fit")
    max_steps = compute_max_steps(cfg, datamodule.n_cells, world_size=world_size())
    base_lr = scale_lr(cfg)

    vae = load_vae_from_checkpoint(cfg)
    dit = build_dit(cfg)
    task = build_ldm_task(cfg, vae, dit, max_steps, mesh=mesh)
    state = task.init_state(torch.Generator(device).manual_seed(seed + rank()))
    n_params = sum(p.numel() for p in dit.parameters())
    logger.info(f"DiT params: {n_params:,}; max_steps={max_steps}")

    ckpt_dir = cfg.get("checkpoint_dir", "outputs/checkpoints/ldm")
    on_validation_end = generation_eval_hook(cfg, task, vocab, datamodule, ckpt_dir, seed)
    run_fit(cfg, task, datamodule, state, max_steps, ckpt_dir, on_validation_end, mesh=mesh,
            base_lr=base_lr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
