"""Train state (counterpart of scldm_tpu/training/state.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from scldm_torch.training.ema import EMAState


@dataclass
class TrainState:
    """The module (which holds the parameters), its optimizer, the number of
    optimizer steps taken, the generator for the step's random draws, and
    optionally the EMA of the parameters."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    ema: Optional[EMAState] = None


def create_train_state(
    module: torch.nn.Module, optimizer: torch.optim.Optimizer, generator: torch.Generator,
    ema: Optional[EMAState] = None,
) -> TrainState:
    return TrainState(module=module, optimizer=optimizer, step=0, generator=generator, ema=ema)
