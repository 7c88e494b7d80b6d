"""Regression metrics and gradient norms (counterpart of
scldm_tpu/training/metrics.py; torchmetrics semantics)."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch


def mse(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (preds - target).square().mean()


def pearson_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-column Pearson correlation of 2-D inputs, (N, d) -> (d,); a column
    with zero variance gives nan."""
    pc = preds.float() - preds.float().mean(0)
    tc = target.float() - target.float().mean(0)
    cov = (pc * tc).mean(0)
    return cov / torch.sqrt(pc.square().mean(0) * tc.square().mean(0))


def r2_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Scalar R^2 of the flattened predictions (the generation eval's
    per-gene mean and variance vectors; the reference's models.py:52-55)."""
    preds = preds.reshape(-1).float()
    target = target.reshape(-1).float()
    ss_res = torch.sum(torch.square(target - preds))
    ss_tot = torch.sum(torch.square(target - target.mean()))
    return 1.0 - ss_res / ss_tot


def zeros_accuracy(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Fraction of entries that agree on zero / non-zero."""
    return ((preds == 0) == (target == 0)).float().mean()


def nanmean(x: torch.Tensor) -> torch.Tensor:
    return torch.nanmean(x)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm of all the tensors together."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


def grad_norms_by_module(
    named_grads: Iterable[Tuple[str, torch.Tensor]], depth: int = 2, prefix: str = "grad_norm",
    norm: Callable = None,
) -> Dict[str, torch.Tensor]:
    """L2 norms of the gradients under each module path, down to `depth`
    levels of the parameter names: {"grad_norm/encoder": ...,
    "grad_norm/encoder/ca_layer": ...}. The parameter itself is not a group.
    `norm` (default `global_norm`) takes each group's gradients: FSDP passes
    one that all-reduces its slices' squares."""
    norm = norm or global_norm
    groups: Dict[str, list] = {}
    for name, grad in named_grads:
        path = name.split(".")
        for d in range(1, min(depth, len(path) - 1) + 1):
            groups.setdefault("/".join(path[:d]), []).append(grad)
    return {f"{prefix}/{name}": norm(gs) for name, gs in groups.items()}
