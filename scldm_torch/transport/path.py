"""Interpolant path of SiT flow matching (counterpart of
scldm_tpu/transport/path.py). Only the Linear plan is ported so far.

    x_t = alpha_t * x1 + sigma_t * x0     (x1 = data, x0 = noise)
    u_t = d_alpha_t * x1 + d_sigma_t * x0 (target velocity)
"""

from __future__ import annotations

import torch


def expand_t_like_x(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape time (B,) to broadcast against x (B, ...)."""
    return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))


class ICPlan:
    """Linear coupling plan: alpha_t = t, sigma_t = 1 - t."""

    def compute_alpha_t(self, t):
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t):
        return 1.0 - t, -torch.ones_like(t)

    def plan(self, t, x0, x1):
        """(t, x_t, u_t) for noise x0 and data x1 at times t (B,)."""
        te = expand_t_like_x(t, x1)
        alpha_t, d_alpha_t = self.compute_alpha_t(te)
        sigma_t, d_sigma_t = self.compute_sigma_t(te)
        return t, alpha_t * x1 + sigma_t * x0, d_alpha_t * x1 + d_sigma_t * x0
