"""Entropic-regularised Wasserstein distance by the log-domain Sinkhorn
(counterpart of scldm_tpu/evals/wasserstein.py; the reference's POT
`ot.sinkhorn2` / `ot.emd2` calls, evaluations.py:85-108): uniform
marginals, the Euclidean cost to the given power, the square root taken
for power 2.

JAX's `lax.while_loop` stops at the first iteration whose row-marginal
error is at most `tol`, or at `max_iters`. The port stops at the same
iteration without a host sync per iteration: the iterations run on the
device with a done flag that freezes (f, g) once the loop would have
stopped, and the host reads the flag every `_CHECK_EVERY` iterations.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_CHECK_EVERY = 64  # iterations between the host's reads of the done flag


def _cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(x * x, 1, keepdim=True)
    y2 = torch.sum(y * y, 1, keepdim=True)
    return torch.sqrt(torch.clamp_min(x2 - 2.0 * x @ y.T + y2.T, 0.0))


def sinkhorn(
    x0: torch.Tensor,
    x1: torch.Tensor,
    reg: float = 0.05,
    power: int = 2,
    max_iters: int = 10_000,
    tol: float = 1e-9,
) -> Tuple[torch.Tensor, int]:
    """(<P, M> under entropic OT with uniform marginals, the number of
    iterations JAX's loop runs)."""
    n, m = x0.shape[0], x1.shape[0]
    M = _cdist(x0.float(), x1.float())
    if power == 2:
        M = M * M
    dev = M.device
    log_a = torch.full((n,), -math.log(n), device=dev)
    log_b = torch.full((m,), -math.log(m), device=dev)
    a = torch.exp(log_a)
    f = torch.zeros(n, device=dev)
    g = torch.zeros(m, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for start in range(0, max_iters, _CHECK_EVERY):
        for _ in range(min(_CHECK_EVERY, max_iters - start)):
            f_new = reg * (log_a - torch.logsumexp((g[None, :] - M) / reg, dim=1))
            g_new = reg * (log_b - torch.logsumexp((f_new[:, None] - M) / reg, dim=0))
            # the violation of the row marginals
            log_p_row = torch.logsumexp((f_new[:, None] + g_new[None, :] - M) / reg, dim=1)
            err = torch.max(torch.abs(torch.exp(log_p_row) - a))
            f = torch.where(done, f, f_new)
            g = torch.where(done, g, g_new)
            it = it + (~done).long()
            done = done | (err <= tol)
        if bool(done):
            break
    log_p = (f[:, None] + g[None, :] - M) / reg
    return torch.sum(torch.exp(log_p) * M), int(it)


def sinkhorn_divergence(x0, x1, reg: float = 0.05, power: int = 2, max_iters: int = 10_000,
                        tol: float = 1e-9) -> torch.Tensor:
    """<P, M> under entropic OT with uniform marginals (ot.sinkhorn2 parity)."""
    return sinkhorn(x0, x1, reg, power, max_iters, tol)[0]


def wasserstein(x0, x1, method: str = "sinkhorn", reg: float = 0.05, power: int = 2) -> float:
    """W_p estimate. `emd` takes the exact assignment
    (`scipy.optimize.linear_sum_assignment`) when the two samples have equal
    size (uniform-marginal EMD is the optimal matching); otherwise, and for
    `sinkhorn`, the Sinkhorn cost. The square root for power 2."""
    if power not in (1, 2):
        raise ValueError(f"power must be 1 or 2, not {power}")
    x0, x1 = torch.as_tensor(x0), torch.as_tensor(x1)
    if method == "emd" and x0.shape[0] == x1.shape[0]:
        from scipy.optimize import linear_sum_assignment

        M = _cdist(x0.float(), x1.float()).cpu().numpy()
        if power == 2:
            M = M**2
        r, c = linear_sum_assignment(M)
        ret = float(np.asarray(M[r, c]).mean())
    else:
        ret = float(sinkhorn_divergence(x0, x1, reg=reg, power=power))
    if power == 2:
        ret = ret**0.5
    return ret
