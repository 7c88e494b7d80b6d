"""Negative-binomial log-pmf and sampling, and the Gaussian terms of the
scVI baseline (counterpart of scldm_tpu/ops/distributions.py).

Every draw comes from an explicit `torch.Generator` on the tensors' device.
`torch._standard_gamma` takes no generator, so the gamma draws are written
out (Marsaglia and Tsang, 2000) over generator-driven normals and uniforms.
"""

from __future__ import annotations

import math

import torch

_MAX_GAMMA_ROUNDS = 100


def standard_gamma(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws, elementwise, by Marsaglia-Tsang rejection.

    Each round draws a normal and a uniform for every element and keeps the
    first accepted proposal; shapes below 1 use the boost
    Gamma(a) = Gamma(a + 1) * U^(1/a). Acceptance is above 95% per round for
    a >= 1, so a handful of rounds covers millions of elements."""
    alpha = alpha.float()
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.zeros_like(a)
    done = torch.zeros_like(a, dtype=torch.bool)
    for _ in range(_MAX_GAMMA_ROUNDS):
        z = torch.randn(a.shape, generator=generator, device=a.device)
        u = torch.rand(a.shape, generator=generator, device=a.device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (
            torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp_min(1e-30))
        )
        take = ok & ~done
        out = torch.where(take, d * v, out)
        done = done | ok
        if bool(done.all()):
            break
    else:
        raise RuntimeError(f"gamma rejection sampler did not finish in {_MAX_GAMMA_ROUNDS} rounds")
    u = torch.rand(a.shape, generator=generator, device=a.device)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def nb_sample(
    mu: torch.Tensor, theta: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """Counts from NB(mu, theta) by the gamma-Poisson mixture:
    lam ~ Gamma(shape=theta, scale=mu/theta), x ~ Poisson(lam). f32 out."""
    mu = mu.float()
    theta = torch.broadcast_to(theta.float(), mu.shape)
    safe_theta = theta.clamp_min(1e-8)
    lam = standard_gamma(safe_theta, generator) * (mu / safe_theta)
    lam = lam.clamp(0.0, 1e12)
    return torch.poisson(lam, generator=generator)


def nb_mean(mu: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:  # noqa: ARG001
    """Mean of NB(mu, theta): the mu parameter itself."""
    return mu


def log_nb_positive(
    x: torch.Tensor, mu: torch.Tensor, theta: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """Elementwise log-pmf of NB(mu, theta) (scvi convention), in f32."""
    x, mu, theta = x.float(), mu.float(), theta.float()
    log_theta_mu_eps = torch.log(theta + mu + eps)
    return (
        theta * (torch.log(theta + eps) - log_theta_mu_eps)
        + x * (torch.log(mu + eps) - log_theta_mu_eps)
        + torch.lgamma(x + theta)
        - torch.lgamma(theta)
        - torch.lgamma(x + 1.0)
    )


def log_gaussian(
    x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor | None = None, eps: float = 1e-8
) -> torch.Tensor:
    """Gaussian reconstruction term: with `sigma=None` the elementwise L2
    loss (x - mu)^2, otherwise a Gaussian NLL up to an additive constant."""
    if sigma is None:
        return (x - mu) ** 2
    sigma = sigma + eps
    return 0.5 * torch.square((x - mu) / sigma) + torch.log(sigma)


def normal_log_prob(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Elementwise Normal log-density (the scVI baseline's ELBO)."""
    var = scale * scale
    return -0.5 * (torch.log(2.0 * math.pi * var) + torch.square(x - loc) / var)
