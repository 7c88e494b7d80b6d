"""SiT flow-matching transport and its ODE sampler (counterpart of
scldm_tpu/transport/transport.py).

Ported so far: the Linear path with velocity prediction, the configuration
of `configs/model/ldm_base.yaml`, with its training loss. The model's output
is then the ODE's drift and the integration runs over [0, 1]. The noise and
score parameterisations, the GVP and VP paths, SDE sampling and the
likelihood ODE are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from scldm_torch.transport.integrators import odeint_dopri5, odeint_euler, odeint_heun
from scldm_torch.transport.path import ICPlan


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


class Transport:
    """Linear path, velocity prediction. `loss_weight` is kept for the
    factory's keys: the velocity loss does not read it, as in the JAX
    package."""

    def __init__(self, *, loss_weight: Optional[str] = None, train_eps: float = 0.0,
                 sample_eps: float = 0.0):
        self.path_sampler = ICPlan()
        self.loss_weight = loss_weight
        self.train_eps = train_eps
        self.sample_eps = sample_eps

    def check_interval(self, eval: bool = False):
        """The time interval (t0, t1) of training, or with `eval` of sampling.
        Velocity on the Linear path is stable on all of [0, 1], so both are
        [0, 1]: `train_eps` and `sample_eps` shrink it only under SDE
        sampling, which is not ported."""
        return 0.0, 1.0

    def sample(self, generator: torch.Generator, x1: torch.Tensor):
        """(t, x0, x1): noise x0 ~ N(0, 1) like x1 and times t (B,) uniform on
        the training interval, drawn from `generator`."""
        x0 = torch.randn(x1.shape, generator=generator, device=generator.device,
                         dtype=x1.dtype).to(x1.device)
        t0, t1 = self.check_interval()
        t = torch.rand(x1.shape[0], generator=generator, device=generator.device)
        return t.to(x1.device) * (t1 - t0) + t0, x0, x1

    def training_losses(self, model: Callable[..., torch.Tensor], generator: torch.Generator,
                        x1: torch.Tensor, model_kwargs: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
        """Per-sample flow-matching loss, {"pred", "loss" (B,)}, with t and x0
        drawn from `generator`; `model(xt, t, **model_kwargs)` predicts the
        velocity."""
        t, x0, x1 = self.sample(generator, x1)
        return self.losses_at(model, t, x0, x1, model_kwargs)

    def losses_at(self, model: Callable[..., torch.Tensor], t: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor, model_kwargs: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, torch.Tensor]:
        """`training_losses` at given times t and noise x0."""
        t, xt, ut = self.path_sampler.plan(t, x0, x1)
        pred = model(xt, t, **(model_kwargs or {}))
        if pred.shape != xt.shape:
            raise ValueError(f"model output {tuple(pred.shape)} != x_t {tuple(xt.shape)}")
        return {"pred": pred, "loss": mean_flat((pred - ut) ** 2)}


class Sampler:
    """ODE sampling closures over a Transport."""

    def __init__(self, transport: Transport):
        self.transport = transport

    def sample_ode(self, *, sampling_method="dopri5", num_steps=50):
        """Returns fn(init, model, **model_kwargs) -> final state, integrating
        noise (t0) to data (t1) with euler, heun or dopri5 (rtol = atol =
        1e-5, the reference's defaults); `model(x, t, **model_kwargs)` is the
        velocity."""
        if sampling_method not in ("euler", "heun", "dopri5"):
            raise NotImplementedError(sampling_method)
        t0, t1 = self.transport.check_interval(eval=True)

        def _sample(init: torch.Tensor, model, **model_kwargs) -> torch.Tensor:
            def drift(x, t):
                return model(x, t, **model_kwargs)

            if sampling_method == "euler":
                return odeint_euler(drift, init, t0, t1, num_steps)
            if sampling_method == "heun":
                return odeint_heun(drift, init, t0, t1, num_steps)
            return odeint_dopri5(drift, init, t0, t1)

        return _sample
