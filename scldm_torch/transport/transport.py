"""SiT flow-matching transport and its ODE sampler (counterpart of
scldm_tpu/transport/transport.py).

Ported so far: the Linear path with velocity prediction, the configuration
of `configs/model/ldm_base.yaml`. The model's output is then the ODE's
drift and the integration runs over [0, 1]. Training losses, the noise and
score parameterisations, SDE sampling and the likelihood ODE are not
ported yet.
"""

from __future__ import annotations

import torch

from scldm_torch.transport.integrators import odeint_dopri5, odeint_euler, odeint_heun
from scldm_torch.transport.path import ICPlan


class Transport:
    """Linear path, velocity prediction."""

    def __init__(self):
        self.path_sampler = ICPlan()

    def check_interval(self):
        """ODE integration interval: velocity on the Linear path is stable on
        all of [0, 1], so the reference's epsilons do not shrink it."""
        return 0.0, 1.0


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
        t0, t1 = self.transport.check_interval()

        def _sample(init: torch.Tensor, model, **model_kwargs) -> torch.Tensor:
            def drift(x, t):
                return model(x, t, **model_kwargs)

            if sampling_method == "euler":
                return odeint_euler(drift, init, t0, t1, num_steps)
            if sampling_method == "heun":
                return odeint_heun(drift, init, t0, t1, num_steps)
            return odeint_dopri5(drift, init, t0, t1)

        return _sample
