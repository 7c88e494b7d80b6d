"""SiT flow-matching transport: the training losses, the drift and score
closures, and the ODE, SDE and likelihood samplers (counterpart of
scldm_tpu/transport/transport.py).

Three paths (Linear, GVP, VP), three predictions (velocity, score, noise)
and three loss weights (none, velocity, likelihood), as JAX has them, with
JAX's time intervals. Every random draw comes from an explicit
`torch.Generator`, or is given: `losses_at` takes t and x0, `sample_sde`
the Brownian normals and `sample_ode_likelihood` the Rademacher vector, so
tests can inject JAX's draws.
"""

from __future__ import annotations

import enum
import math
from typing import Any, Callable, Dict, Optional, Union

import torch

from scldm_torch.transport import path as path_mod
from scldm_torch.transport.integrators import (
    Draws,
    _odeint_fixed_tree,
    odeint_dopri5,
    odeint_euler,
    odeint_heun,
    sdeint,
)

ModelFn = Callable[..., torch.Tensor]  # model(x, t, **kwargs) -> prediction


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


class WeightType(enum.Enum):
    NONE = enum.auto()
    VELOCITY = enum.auto()
    LIKELIHOOD = enum.auto()


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


class Transport:
    """The flow-matching loss and the conversions between predictions."""

    def __init__(self, *, model_type: ModelType, path_type: PathType, loss_type: WeightType,
                 train_eps: float, sample_eps: float):
        path_options = {
            PathType.LINEAR: path_mod.ICPlan,
            PathType.GVP: path_mod.GVPCPlan,
            PathType.VP: path_mod.VPCPlan,
        }
        self.loss_type = loss_type
        self.model_type = model_type
        self.path_type = path_type
        self.path_sampler = path_options[path_type]()
        self.train_eps = train_eps
        self.sample_eps = sample_eps

    # -- intervals -----------------------------------------------------------
    def check_interval(self, train_eps: Optional[float] = None,
                       sample_eps: Optional[float] = None, *, diffusion_form: str = "SBDM",
                       sde: bool = False, reverse: bool = False, eval: bool = False,
                       last_step_size: float = 0.0):
        """The time interval (t0, t1) of training, or with `eval` of sampling
        (the epsilons default to the transport's own). Velocity on the Linear
        and GVP paths is stable on all of [0, 1]; the VP path stops short of
        1, and the score and noise predictions (or an SDE) of the others keep
        off both ends."""
        train_eps = self.train_eps if train_eps is None else train_eps
        sample_eps = self.sample_eps if sample_eps is None else sample_eps
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if isinstance(self.path_sampler, path_mod.VPCPlan):
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        elif self.model_type != ModelType.VELOCITY or sde:
            t0 = (
                eps
                if (diffusion_form == "SBDM" and sde) or self.model_type != ModelType.VELOCITY
                else 0.0
            )
            t1 = 1.0 - eps if (not sde or last_step_size == 0) else 1.0 - last_step_size
        if reverse:
            t0, t1 = 1.0 - t0, 1.0 - t1
        return t0, t1

    # -- prior ---------------------------------------------------------------
    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """log N(z; 0, I) per sample."""
        n = math.prod(z.shape[1:])
        flat = z.reshape(z.shape[0], -1)
        return -n / 2.0 * math.log(2.0 * math.pi) - torch.sum(flat**2, dim=1) / 2.0

    # -- sampling t, x0 ------------------------------------------------------
    def sample(self, generator: torch.Generator, x1: torch.Tensor):
        """(t, x0, x1): noise x0 ~ N(0, 1) like x1 and times t (B,) uniform on
        the training interval, drawn from `generator`."""
        x0 = torch.randn(x1.shape, generator=generator, device=generator.device,
                         dtype=x1.dtype).to(x1.device)
        t0, t1 = self.check_interval()
        t = torch.rand(x1.shape[0], generator=generator, device=generator.device)
        return t.to(x1.device) * (t1 - t0) + t0, x0, x1

    # -- training loss -------------------------------------------------------
    def training_losses(self, model: ModelFn, generator: torch.Generator, x1: torch.Tensor,
                        model_kwargs: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
        """Per-sample flow-matching loss, {"pred", "loss" (B,)}, with t and x0
        drawn from `generator`; `model(xt, t, **model_kwargs)` predicts what
        the transport's model type names."""
        t, x0, x1 = self.sample(generator, x1)
        return self.losses_at(model, t, x0, x1, model_kwargs)

    def losses_at(self, model: ModelFn, t: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                  model_kwargs: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """`training_losses` at given times t and noise x0. Velocity is held
        to the path's target velocity; noise to x0 and score to -x0 / sigma_t,
        each under the loss weight (none, velocity: (diffusion / sigma_t)^2,
        likelihood: diffusion / sigma_t^2)."""
        t, xt, ut = self.path_sampler.plan(t, x0, x1)
        pred = model(xt, t, **(model_kwargs or {}))
        if pred.shape != xt.shape:
            raise ValueError(f"model output {tuple(pred.shape)} != x_t {tuple(xt.shape)}")
        terms = {"pred": pred}
        if self.model_type == ModelType.VELOCITY:
            terms["loss"] = mean_flat((pred - ut) ** 2)
            return terms
        _, drift_var = self.path_sampler.compute_drift(xt, t)
        sigma_t, _ = self.path_sampler.compute_sigma_t(path_mod.expand_t_like_x(t, xt))
        if self.loss_type == WeightType.VELOCITY:
            weight = (drift_var / sigma_t) ** 2
        elif self.loss_type == WeightType.LIKELIHOOD:
            weight = drift_var / (sigma_t**2)
        elif self.loss_type == WeightType.NONE:
            weight = 1.0
        else:
            raise NotImplementedError(self.loss_type)
        if self.model_type == ModelType.NOISE:
            terms["loss"] = mean_flat(weight * (pred - x0) ** 2)
        else:
            terms["loss"] = mean_flat(weight * (pred * sigma_t + x0) ** 2)
        return terms

    # -- drift / score closures ----------------------------------------------
    def get_drift(self):
        """fn(x, t, model, **kwargs): the probability-flow ODE's drift from
        the model's prediction."""
        path = self.path_sampler

        def score_ode(x, t, model, **kwargs):
            drift_mean, drift_var = path.compute_drift(x, t)
            return -drift_mean + drift_var * model(x, t, **kwargs)

        def noise_ode(x, t, model, **kwargs):
            drift_mean, drift_var = path.compute_drift(x, t)
            sigma_t, _ = path.compute_sigma_t(path_mod.expand_t_like_x(t, x))
            score = model(x, t, **kwargs) / -sigma_t
            return -drift_mean + drift_var * score

        def velocity_ode(x, t, model, **kwargs):
            return model(x, t, **kwargs)

        drift_fn = {
            ModelType.NOISE: noise_ode,
            ModelType.SCORE: score_ode,
            ModelType.VELOCITY: velocity_ode,
        }[self.model_type]

        def body_fn(x, t, model, **kwargs):
            out = drift_fn(x, t, model, **kwargs)
            if out.shape != x.shape:
                raise ValueError(f"drift {tuple(out.shape)} != x {tuple(x.shape)}")
            return out

        return body_fn

    def get_score(self):
        """fn(x, t, model, **kwargs): the score from the model's prediction."""
        path = self.path_sampler
        if self.model_type == ModelType.NOISE:
            return lambda x, t, model, **kw: model(x, t, **kw) / -path.compute_sigma_t(
                path_mod.expand_t_like_x(t, x))[0]
        if self.model_type == ModelType.SCORE:
            return lambda x, t, model, **kw: model(x, t, **kw)
        if self.model_type == ModelType.VELOCITY:
            return lambda x, t, model, **kw: path.get_score_from_velocity(
                model(x, t, **kw), x, t)
        raise NotImplementedError(self.model_type)


class Sampler:
    """ODE, SDE and likelihood sampling closures over a Transport."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

    def _sde_pieces(self, diffusion_form="SBDM", diffusion_norm=1.0):
        def diffusion_fn(x, t):
            return self.transport.path_sampler.compute_diffusion(
                x, t, form=diffusion_form, norm=diffusion_norm)

        def sde_drift(x, t, model, **kwargs):
            return self.drift(x, t, model, **kwargs) + diffusion_fn(x, t) * self.score(
                x, t, model, **kwargs)

        return sde_drift, diffusion_fn

    def _last_step_fn(self, sde_drift, *, last_step, last_step_size):
        """The deterministic final step of the SDE sampler: none, Mean (a
        drift step), Tweedie (the posterior mean, at the first batch
        element's alpha and sigma, as JAX takes them) or Euler (an ODE
        step)."""
        if last_step is None:
            return lambda x, t, model, **kw: x
        if last_step == "Mean":
            return lambda x, t, model, **kw: x + sde_drift(x, t, model, **kw) * last_step_size
        if last_step == "Tweedie":
            alpha = self.transport.path_sampler.compute_alpha_t
            sigma = self.transport.path_sampler.compute_sigma_t

            def tweedie(x, t, model, **kw):
                a = alpha(t)[0][0]
                s = sigma(t)[0][0]
                return x / a + (s**2) / a * self.score(x, t, model, **kw)

            return tweedie
        if last_step == "Euler":
            return lambda x, t, model, **kw: x + self.drift(x, t, model, **kw) * last_step_size
        raise NotImplementedError(last_step)

    def sample_sde(self, *, sampling_method="Euler", diffusion_form="SBDM", diffusion_norm=1.0,
                   last_step="Mean", last_step_size=0.04, num_steps=250,
                   return_trajectory=False):
        """Returns fn(draws, init, model, **model_kwargs): the SDE from noise
        (t0) to data, Euler-Maruyama or stochastic Heun, then the last step.
        `draws` is a generator or the (num_steps - 1, *init.shape) standard
        normals of the Brownian increments. With `return_trajectory`, the
        saved states with the last step's result appended."""
        if last_step is None:
            last_step_size = 0.0
        sde_drift, sde_diffusion = self._sde_pieces(diffusion_form, diffusion_norm)
        t0, t1 = self.transport.check_interval(
            diffusion_form=diffusion_form, sde=True, eval=True, reverse=False,
            last_step_size=last_step_size)
        last_step_fn = self._last_step_fn(sde_drift, last_step=last_step,
                                          last_step_size=last_step_size)

        def _sample(draws: Draws, init: torch.Tensor, model, **model_kwargs):
            x = sdeint(lambda x, t: sde_drift(x, t, model, **model_kwargs), sde_diffusion,
                       draws, init, t0, t1, num_steps, method=sampling_method,
                       return_trajectory=return_trajectory)
            ts = torch.full((init.shape[0],), t1, dtype=init.dtype, device=init.device)
            if return_trajectory:
                last = last_step_fn(x[-1], ts, model, **model_kwargs)
                return torch.cat([x, last[None]])
            return last_step_fn(x, ts, model, **model_kwargs)

        return _sample

    def sample_ode(self, *, sampling_method="dopri5", num_steps=50, atol=1e-5, rtol=1e-5,
                   reverse=False, return_trajectory=False, error_mean=None):
        """Returns fn(init, model, **model_kwargs): the probability-flow ODE
        from noise (t0) to data (t1) by euler, heun or dopri5, the final
        state or, with `return_trajectory`, the (num_steps, ...) states at
        linspace(t0, t1, num_steps) (dopri5 adaptive on each stretch).
        `reverse` runs data to noise: over (1 - t1, 1 - t0) with drift
        -f(x, 1 - s). `error_mean` replaces the mean of dopri5's error norm
        (a batch split over ranks takes it over every rank's rows)."""
        if sampling_method not in ("euler", "heun", "dopri5"):
            raise NotImplementedError(sampling_method)
        t0, t1 = self.transport.check_interval(sde=False, eval=True, reverse=False,
                                               last_step_size=0.0)
        if reverse:
            def base_drift(x, t, model, **kw):
                return -self.drift(x, torch.ones_like(t) * (1.0 - t), model, **kw)

            t0, t1 = 1.0 - t1, 1.0 - t0
        else:
            base_drift = self.drift

        def _sample(init: torch.Tensor, model, **model_kwargs) -> torch.Tensor:
            def drift(x, t):
                return base_drift(x, t, model, **model_kwargs)

            if sampling_method == "euler":
                return odeint_euler(drift, init, t0, t1, num_steps,
                                    return_trajectory=return_trajectory)
            if sampling_method == "heun":
                return odeint_heun(drift, init, t0, t1, num_steps,
                                   return_trajectory=return_trajectory)
            save_ts = torch.linspace(t0, t1, num_steps) if return_trajectory else None
            return odeint_dopri5(drift, init, t0, t1, rtol=rtol, atol=atol, save_ts=save_ts,
                                 mean=error_mean or torch.mean)

        return _sample

    def sample_ode_likelihood(self, *, sampling_method="euler", num_steps=50, atol=1e-5,
                              rtol=1e-5):
        """Returns fn(draws, x, model, **model_kwargs) -> (logp, z0): the
        log-likelihood of data x by the reverse-time probability-flow ODE
        over the augmented state (x, logp), with the divergence of the drift
        estimated by Hutchinson's trace estimator, by euler, heun or dopri5.
        `draws` is a generator or the Rademacher vector (+-1, like x).

        The estimate eps^T J eps is taken as (J^T eps) . eps: one
        vector-Jacobian product of the drift (`torch.autograd.grad`), exact
        like JAX's jvp, through any module with a backward. The model must
        therefore be differentiable: a module, not the DiT block kernels,
        which have no forward-mode or double derivative."""
        if sampling_method not in ("euler", "heun", "dopri5"):
            raise NotImplementedError(sampling_method)
        t0, t1 = self.transport.check_interval(sde=False, eval=True, reverse=False,
                                               last_step_size=0.0)

        def _sample(draws: Union[torch.Generator, torch.Tensor], x: torch.Tensor, model,
                    **model_kwargs):
            eps = rademacher(draws, x)

            def aug_drift(state, t_vec):
                xc, _logp = state
                rev_t = torch.ones_like(t_vec) * (1.0 - t_vec)
                with torch.enable_grad():
                    y = xc.detach().requires_grad_(True)
                    f = self.drift(y, rev_t, model, **model_kwargs)
                    (vjp,) = torch.autograd.grad(f, y, eps)
                div_est = torch.sum((vjp * eps).reshape(xc.shape[0], -1), dim=1)
                return (-f.detach(), div_est)

            init = (x, torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device))
            if sampling_method == "dopri5":
                z0, delta_logp = odeint_dopri5(aug_drift, init, t0, t1, rtol=rtol, atol=atol)
            else:
                z0, delta_logp = _odeint_fixed_tree(aug_drift, init, t0, t1, num_steps,
                                                    heun=sampling_method == "heun")
            return self.transport.prior_logp(z0) - delta_logp, z0

        return _sample


def rademacher(draws: Union[torch.Generator, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """A vector of +-1 like x: drawn from a generator, or given."""
    if isinstance(draws, torch.Tensor):
        if draws.shape != x.shape:
            raise ValueError(f"Rademacher vector {tuple(draws.shape)} != x {tuple(x.shape)}")
        return draws.to(device=x.device, dtype=x.dtype)
    bits = torch.randint(0, 2, x.shape, generator=draws, device=draws.device)
    return (bits.to(x.dtype) * 2.0 - 1.0).to(x.device)
