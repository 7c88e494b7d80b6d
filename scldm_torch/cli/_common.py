"""Shared CLI wiring (counterpart of scldm_tpu/cli/_common.py): the device
and the process group, the checkpoint manager, the preemption guard and the
wandb logger from the `training:` config group (the reference's
training/default.yaml:26-52, a rank-0 WandbLogger and ModelCheckpoint
monitor / save_top_k / save_last), and the fit that the training CLIs share.

A launch over several cards is torchrun's, one process a card:
`torchrun --nproc_per_node=N -m scldm_torch.cli.train ...`. Each rank loads
its own `batch_size` cells (the DataModule's host split), so the global
batch is `batch_size x world`, `max_steps` divides by it, and the learning
rate is scaled by the world size: JAX's multi-host semantics and the
reference's DDP's. The config snapshot records the per-rank learning rate."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from scldm_torch.config.build import resolve_device
from scldm_torch.config.loader import load_config, merge_overrides, resolve
from scldm_torch.parallel import make_mesh, maybe_initialize_distributed, rank, world_size
from scldm_torch.training.checkpoint import CheckpointManager
from scldm_torch.training.loop import CSVLogger, fit
from scldm_torch.training.preemption import PreemptionGuard
from scldm_torch.utils.logger import logger
from scldm_torch.utils.wandb_logger import WandbLogger


def parse_config(argv, default_config, description: str) -> Dict:
    """`--config FILE` and dotted `key=value` overrides -> the resolved config."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=str(default_config))
    p.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    return resolve(merge_overrides(load_config(args.config), args.overrides))


def setup_device(cfg: Dict) -> torch.device:
    """The config's device (`config.build.resolve_device`). On the card,
    cuBLAS is kept from reducing the split-K partial sums of bf16 products
    in bf16, for the rest of the process: JAX's bf16 products sum in f32."""
    device = resolve_device(cfg)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


def setup_parallel(cfg: Dict):
    """The process group where the launcher started several processes
    (`parallel.maybe_initialize_distributed`: NCCL on the card, gloo on the
    CPU), the device (`setup_device`; each rank's own card), and the mesh:
    every rank on "data" when there is more than one, else None, as JAX's
    CLIs build no mesh on one device. Returns (device, mesh)."""
    maybe_initialize_distributed(cfg.get("device") or "cuda")
    device = setup_device(cfg)
    if device.type == "cuda" and world_size() > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh() if world_size() > 1 else None
    logger.info(f"device: {device}; ranks: {world_size()}; mesh: {mesh}")
    return device, mesh


def scale_lr(cfg: Dict) -> float:
    """Scale `model.optimizer.lr` by the world size, in place (the
    reference's linear scaling, train.py:32-35); returns the per-rank rate."""
    base = float(cfg["model"]["optimizer"]["lr"])
    cfg["model"]["optimizer"]["lr"] = base * world_size()
    return base


def make_checkpoint_manager(cfg: Dict, ckpt_dir) -> CheckpointManager:
    ck = cfg["training"]["checkpoint"]
    return CheckpointManager(
        ckpt_dir,
        max_to_keep=int(ck.get("max_to_keep", 3)),
        monitor=ck.get("monitor"),
        save_top_k=int(ck.get("save_top_k", 1) or 0),
        mode=ck.get("mode", "min"),
        async_save=bool(ck.get("async_save", False)),
    )


def make_preemption_guard(cfg: Dict) -> Optional[PreemptionGuard]:
    """Install the SIGTERM checkpoint-and-exit guard unless the config opts
    out (`training.handle_preemption: false`). Returns the installed guard
    (the caller passes it to fit and uninstalls it after) or None."""
    if not bool(cfg["training"].get("handle_preemption", True)):
        return None
    return PreemptionGuard().install()


def make_wandb_logger(cfg: Dict) -> Optional[WandbLogger]:
    wb = cfg["training"].get("wandb") or {}
    if not wb.get("enabled"):
        return None
    return WandbLogger(
        project=wb.get("project") or "scldm-torch",
        name=wb.get("name") or cfg.get("experiment_name"),
        config=cfg,
    )


def run_fit(cfg: Dict, task, datamodule, state, max_steps: int, ckpt_dir,
            on_validation_end: Optional[Callable] = None, mesh=None,
            base_lr: Optional[float] = None):
    """The training CLIs' common tail: the checkpoint manager with the config
    snapshot (its learning rate the per-rank `base_lr` where given: a
    relaunch scales it again), the wandb logger and the preemption guard,
    then `fit` with `metrics.csv` beside the checkpoints. Under a process
    group every rank trains and saves; rank 0 alone logs, writes the
    metrics and traces. Returns the final state."""
    tr = cfg["training"]
    first = rank() == 0
    mgr = make_checkpoint_manager(cfg, ckpt_dir)
    scaled = cfg["model"]["optimizer"]["lr"]
    if base_lr is not None:
        cfg["model"]["optimizer"]["lr"] = base_lr
    mgr.save_config(cfg)
    cfg["model"]["optimizer"]["lr"] = scaled
    wandb_logger = make_wandb_logger(cfg) if first else None
    preemption = make_preemption_guard(cfg)
    try:
        state = fit(
            task,
            datamodule,
            state,
            max_steps=max_steps,
            epochs=int(cfg.get("epochs", 100)),
            ckpt_manager=mgr,
            csv_logger=CSVLogger(Path(ckpt_dir) / "metrics.csv") if first else None,
            log_every_steps=int(tr.get("log_every_steps", 50)),
            val_every_epochs=int(tr.get("val_every_epochs", 1)),
            save_every_epochs=int(tr["checkpoint"].get("save_every_epochs", 1)),
            eval_rng_seed=int(cfg.get("seed", 42)),
            steps_per_dispatch=int(tr.get("steps_per_dispatch", 1)),
            profile_dir=(tr.get("profile_dir") or None) if first else None,
            profile_steps=int(tr.get("profile_steps", 3)),
            on_validation_end=on_validation_end,
            wandb_logger=wandb_logger,
            preemption=preemption,
            mesh=mesh,
        )
    finally:
        if preemption is not None:
            preemption.uninstall()
        mgr.close()  # drain the writes in flight before exit
    if wandb_logger is not None:
        wandb_logger.finish()
    logger.info(f"done at step {int(state.step)}")
    return state
