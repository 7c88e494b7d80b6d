"""Optimizer and learning-rate schedule (counterpart of
scldm_tpu/training/optim.py).

- `wsd_schedule`: the warmup-stable-decay multiplier of the reference.
- `AdamWLegacy` (the JAX package's `adamw_legacy`): timm-style AdamW with decoupled
  weight decay applied before the update, optional AMSGrad, and optional
  cautious masking (updates whose sign disagrees with the gradient are
  zeroed, arXiv 2411.16085), for the VAE.
- `AdamW`: the stock `optax.adamw` of the LDM task.

In both, the learning rate of step t (counted from 0) is
`learning_rate * schedule(t)`.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch


def wsd_schedule(
    num_training_steps: int,
    final_lr_factor: float = 0.1,
    num_warmup_steps: int = 1000,
    init_div_factor: float = 100,
    fract_decay: float = 0.1,
    decay_type: str = "cosine",
) -> Callable[[int], float]:
    """multiplier(step): linear warmup from 1/init_div_factor, hold at 1.0,
    then cosine or sqrt decay to final_lr_factor. Warmup takes precedence
    over hold and decay, as in the reference's if-chain."""
    if decay_type not in ("cosine", "sqrt"):
        raise ValueError(f"decay type {decay_type} is not in ['cosine','sqrt']")
    n_anneal_steps = int(fract_decay * num_training_steps)
    n_hold = num_training_steps - n_anneal_steps

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            return step / num_warmup_steps + (1 - step / num_warmup_steps) / init_div_factor
        if step < n_hold:
            return 1.0
        if step >= num_training_steps:
            return final_lr_factor
        if decay_type == "cosine":
            progress = (step - num_warmup_steps) / max(num_training_steps - num_warmup_steps, 1)
            return final_lr_factor + (1 - final_lr_factor) * 0.5 * (1 + math.cos(math.pi * progress))
        return final_lr_factor + (1 - final_lr_factor) * (
            1 - math.sqrt(max(step - n_hold, 0) / max(n_anneal_steps, 1))
        )

    return schedule


class _StepCount:
    """Keeps `step_count`, the schedule's position and the bias-correction
    count, in the optimizer's state dict, so a restored optimizer resumes
    where it stopped."""

    def state_dict(self):
        out = super().state_dict()
        out["step_count"] = self.step_count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.step_count = int(state_dict.pop("step_count", 0))
        super().load_state_dict(state_dict)


class AdamWLegacy(_StepCount, torch.optim.Optimizer):
    """The reference AdamWLegacy. Per parameter p with gradient g, at step t
    (from 0) with lr = learning_rate * schedule(t):

        p *= 1 - lr * wd                                   (decay first)
        m = b1 m + (1-b1) g ;  v = b2 v + (1-b2) g^2
        denom = sqrt(v_hat / bc2) + eps   (v_hat = running max of v with AMSGrad)
        caution: m *= mask / max(mean(mask), 1e-3), mask = (m * g > 0)
        p -= lr / bc1 * m / denom

    Parameters whose `grad` is None are skipped. Where a parameter is a
    slice (`set_slices`: FSDP over the data ranks, Megatron over the model
    ranks, or both), the cautious mask's mean is taken over the whole
    tensor: the slices' mask sums are all-reduced over their groups."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float = 1e-3,
        schedule: Optional[Callable[[int], float]] = None,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 1e-2,
        amsgrad: bool = False,
        caution: bool = False,
    ):
        defaults = dict(lr=learning_rate, betas=betas, eps=eps, weight_decay=weight_decay,
                        amsgrad=amsgrad, caution=caution)
        super().__init__(params, defaults)
        self.schedule = schedule or (lambda step: 1.0)
        self.step_count = 0
        self._slices: dict = {}  # id(slice) -> (the full tensor's numel, its groups)

    def set_slices(self, numels: dict, *groups) -> None:
        """Mark parameters as slices: {id(slice): the full tensor's numel},
        the slices spread over the ranks of each of `groups`."""
        self._slices.update({i: (n, groups) for i, n in numels.items()})

    def _mask_means(self, params, masks):
        means = [k.mean() for k in masks]
        by_groups: dict = {}
        for i, p in enumerate(params):
            if id(p) in self._slices:
                by_groups.setdefault(self._slices[id(p)][1], []).append(i)
        for groups, sliced in by_groups.items():
            import torch.distributed as dist

            sums = torch.stack([masks[i].sum() for i in sliced])
            for group in groups:
                dist.all_reduce(sums, group=group)
            for j, i in enumerate(sliced):
                means[i] = sums[j] / self._slices[id(params[i])][0]
        return means

    @torch.no_grad()
    def step(self, closure=None):  # noqa: ARG002 (torch.optim signature)
        """One update of every parameter with a gradient, as a few
        multi-tensor ops per group (one launch each on a GPU, not one per
        parameter tensor)."""
        self.step_count += 1
        count = self.step_count
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr = group["lr"] * self.schedule(count - 1)
            bc1, bc2 = 1 - b1**count, 1 - b2**count
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        self.state[p]["max_exp_avg_sq"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            ms = [self.state[p]["exp_avg"] for p in params]
            vs = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
            if group["amsgrad"]:
                maxs = [self.state[p]["max_exp_avg_sq"] for p in params]
                torch._foreach_maximum_(maxs, vs)
                vs = maxs
            denom = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            if group["caution"]:
                masks = [(m * g > 0).to(g.dtype) for m, g in zip(ms, grads)]
                ms = [m * (k / mean.clamp_min(1e-3))
                      for m, k, mean in zip(ms, masks, self._mask_means(params, masks))]
            update = torch._foreach_div(ms, denom)
            torch._foreach_mul_(params, 1 - lr * group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-lr / bc1)


class AdamW(_StepCount, torch.optim.AdamW):
    """`optax.adamw`, the LDM task's optimizer, as `torch.optim.AdamW` with
    the multi-tensor update: per parameter p with gradient g at step t (from
    0), with lr = learning_rate * schedule(t) set before the step as optax
    reads its schedule at the update count,

        m = b1 m + (1-b1) g ;  v = b2 v + (1-b2) g^2
        p -= lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)

    (torch applies the decay as p *= 1 - lr * wd before the Adam term, the
    same update). Every parameter is decayed, as optax does without a mask."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float = 1e-3,
        schedule: Optional[Callable[[int], float]] = None,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
    ):
        super().__init__(params, lr=learning_rate, betas=betas, eps=eps,
                         weight_decay=weight_decay, foreach=True)
        self.learning_rate = learning_rate
        self.schedule = schedule or (lambda step: 1.0)
        self.step_count = 0

    def step(self, closure=None):
        lr = self.learning_rate * self.schedule(self.step_count)
        for group in self.param_groups:
            group["lr"] = lr
        self.step_count += 1
        return super().step(closure)
