"""Train state (counterpart of scldm_tpu/training/state.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    """The module (which holds the parameters), its optimizer, the number of
    optimizer steps taken, and the generator for the step's random draws."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def create_train_state(
    module: torch.nn.Module, optimizer: torch.optim.Optimizer, generator: torch.Generator
) -> TrainState:
    return TrainState(module=module, optimizer=optimizer, step=0, generator=generator)
