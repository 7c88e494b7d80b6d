"""Interpolant paths of SiT flow matching (counterpart of
scldm_tpu/transport/path.py): the Linear plan, the variance-preserving (VP)
plan and the trigonometric (GVP) plan, with the SDE pieces and the
conversions between velocity, score and noise predictions.

    x_t = alpha_t * x1 + sigma_t * x0     (x1 = data, x0 = noise)
    u_t = d_alpha_t * x1 + d_sigma_t * x0 (target velocity)

The formulas are JAX's as written, in the same order of operations: a more
accurate form (`expm1` in the VP sigma, say) would be a different result.
"""

from __future__ import annotations

import math

import torch


def expand_t_like_x(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape time (B,) to broadcast against x (B, ...)."""
    return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))


class ICPlan:
    """Linear coupling plan: alpha_t = t, sigma_t = 1 - t."""

    def __init__(self, sigma: float = 0.0):
        self.sigma = sigma

    # -- coefficients ------------------------------------------------------
    def compute_alpha_t(self, t):
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t):
        return 1.0 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t):
        return 1.0 / t

    # -- SDE pieces --------------------------------------------------------
    def compute_drift(self, x, t):
        """The score-parameterised SDE drift: (-drift, diffusion)."""
        t = expand_t_like_x(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        drift = alpha_ratio * x
        diffusion = alpha_ratio * (sigma_t**2) - sigma_t * d_sigma_t
        return -drift, diffusion

    def compute_diffusion(self, x, t, form: str = "constant", norm: float = 1.0):
        """The diffusion coefficient by form; "inccreasing-decreasing" keeps
        the reference's spelling."""
        t = expand_t_like_x(t, x)
        if form == "constant":
            return torch.tensor(norm, dtype=x.dtype, device=x.device)
        if form == "SBDM":
            return norm * self.compute_drift(x, t)[1]
        if form == "sigma":
            return norm * self.compute_sigma_t(t)[0]
        if form == "linear":
            return norm * (1.0 - t)
        if form == "decreasing":
            return 0.25 * (norm * torch.cos(math.pi * t) + 1.0) ** 2
        if form == "inccreasing-decreasing":
            return norm * torch.sin(math.pi * t) ** 2
        raise NotImplementedError(f"Diffusion form {form} not implemented")

    # -- parameterisation conversions --------------------------------------
    def get_score_from_velocity(self, velocity, x, t):
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t**2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_noise_from_velocity(self, velocity, x, t):
        t = expand_t_like_x(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = reverse_alpha_ratio * d_sigma_t - sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_velocity_from_score(self, score, x, t):
        t = expand_t_like_x(t, x)
        drift, var = self.compute_drift(x, t)
        return var * score - drift

    # -- interpolation -----------------------------------------------------
    def compute_mu_t(self, t, x0, x1):
        t = expand_t_like_x(t, x1)
        alpha_t, _ = self.compute_alpha_t(t)
        sigma_t, _ = self.compute_sigma_t(t)
        return alpha_t * x1 + sigma_t * x0

    def compute_xt(self, t, x0, x1):
        return self.compute_mu_t(t, x0, x1)

    def compute_ut(self, t, x0, x1, xt):
        del xt
        t = expand_t_like_x(t, x1)
        _, d_alpha_t = self.compute_alpha_t(t)
        _, d_sigma_t = self.compute_sigma_t(t)
        return d_alpha_t * x1 + d_sigma_t * x0

    def plan(self, t, x0, x1):
        """(t, x_t, u_t) for noise x0 and data x1 at times t (B,)."""
        xt = self.compute_xt(t, x0, x1)
        ut = self.compute_ut(t, x0, x1, xt)
        return t, xt, ut


class VPCPlan(ICPlan):
    """Variance-preserving path."""

    def __init__(self, sigma_min: float = 0.1, sigma_max: float = 20.0):
        super().__init__()
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max

    def _log_mean_coeff(self, t):
        return -0.25 * ((1.0 - t) ** 2) * (self.sigma_max - self.sigma_min) - 0.5 * (
            1.0 - t
        ) * self.sigma_min

    def _d_log_mean_coeff(self, t):
        return 0.5 * (1.0 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def compute_alpha_t(self, t):
        alpha_t = torch.exp(self._log_mean_coeff(t))
        return alpha_t, alpha_t * self._d_log_mean_coeff(t)

    def compute_sigma_t(self, t):
        p_sigma_t = 2.0 * self._log_mean_coeff(t)
        sigma_t = torch.sqrt(1.0 - torch.exp(p_sigma_t))
        d_sigma_t = torch.exp(p_sigma_t) * (2.0 * self._d_log_mean_coeff(t)) / (-2.0 * sigma_t)
        return sigma_t, d_sigma_t

    def compute_d_alpha_alpha_ratio_t(self, t):
        return self._d_log_mean_coeff(t)

    def compute_drift(self, x, t):
        t = expand_t_like_x(t, x)
        beta_t = self.sigma_min + (1.0 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2.0


class GVPCPlan(ICPlan):
    """Trigonometric (GVP) path."""

    def compute_alpha_t(self, t):
        return torch.sin(t * math.pi / 2.0), math.pi / 2.0 * torch.cos(t * math.pi / 2.0)

    def compute_sigma_t(self, t):
        return torch.cos(t * math.pi / 2.0), -math.pi / 2.0 * torch.sin(t * math.pi / 2.0)

    def compute_d_alpha_alpha_ratio_t(self, t):
        return math.pi / (2.0 * torch.tan(t * math.pi / 2.0))
