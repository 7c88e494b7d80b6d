"""Train state (counterpart of scldm_tpu/training/state.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from scldm_torch.training.ema import EMAState


@dataclass
class TrainState:
    """The module (which holds the parameters), its optimizer, the number of
    optimizer steps taken, the generator for the step's random draws,
    optionally the EMA of the parameters, and under FSDP the parameters'
    slices (`parallel.data_parallel.FlatShards`), which the optimizer
    updates; between steps the module's sharded tensors are then empty.
    `sync_group` is the group of ranks that share rows and so draw alike (a
    data row's model ranks), or None."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    ema: Optional[EMAState] = None
    shards: Optional[Any] = None
    sync_group: Optional[Any] = None


def create_train_state(
    module: torch.nn.Module, optimizer: torch.optim.Optimizer, generator: torch.Generator,
    ema: Optional[EMAState] = None, shards: Optional[Any] = None,
) -> TrainState:
    return TrainState(module=module, optimizer=optimizer, step=0, generator=generator, ema=ema,
                      shards=shards)
