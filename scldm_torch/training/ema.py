"""Exponential moving average of a module's parameters (counterpart of
scldm_tpu/training/ema.py, the semantics of ema-pytorch).

- The state counts the calls of `ema_update`, one per optimizer step.
- A blend happens only on every `update_every`-th call.
- The decay is 0 until `update_after_step`, so until then each blend copies
  the online parameters; afterwards it ramps as
  1 - (1 + epoch / inv_gamma)^(-power), clamped to [min_value, beta], with
  epoch = step - update_after_step - 1.

The blend runs as a few multi-tensor ops over every parameter of the module,
in place on the state's copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import torch


@dataclass
class EMAState:
    """The averaged parameters by name, and the number of updates so far."""

    params: Dict[str, torch.Tensor]
    step: int = 0


def ema_init(named_params: Iterable[Tuple[str, torch.Tensor]]) -> EMAState:
    """Fresh copies of the parameters (e.g. `module.named_parameters()`)."""
    return EMAState({n: p.detach().clone() for n, p in named_params})


def current_decay(
    step: int,
    beta: float = 0.9999,
    update_after_step: int = 100,
    inv_gamma: float = 1.0,
    power: float = 2.0 / 3.0,
    min_value: float = 0.0,
) -> float:
    epoch = max(step - update_after_step - 1, 0)
    if epoch <= 0:
        return 0.0
    value = 1.0 - (1.0 + epoch / inv_gamma) ** (-power)
    return min(max(value, min_value), beta)


@torch.no_grad()
def ema_update(
    state: EMAState,
    named_params: Iterable[Tuple[str, torch.Tensor]],
    *,
    beta: float = 0.9999,
    update_every: int = 10,
    update_after_step: int = 100,
    inv_gamma: float = 1.0,
    power: float = 2.0 / 3.0,
    min_value: float = 0.0,
) -> EMAState:
    """One EMA tick: ema = ema * decay + online * (1 - decay) on every
    `update_every`-th call. Updates `state` in place and returns it."""
    state.step += 1
    if state.step % update_every == 0:
        decay = current_decay(state.step, beta, update_after_step, inv_gamma, power, min_value)
        online = dict(named_params)
        ema = list(state.params.values())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [online[n].detach() for n in state.params], alpha=1.0 - decay)
    return state
