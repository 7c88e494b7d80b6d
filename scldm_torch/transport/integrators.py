"""ODE integrators (counterpart of scldm_tpu/transport/integrators.py).

Drift functions take (x, t_vec) with t_vec of shape (batch,). Time runs in
f32 like the JAX package. Fixed-step solvers are Python loops; dopri5 keeps
its accept/reject decision on the device (`torch.where`) and reads one
scalar back per step, for the loop test.
"""

from __future__ import annotations

from typing import Callable

import torch

DriftFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _t_vec(x: torch.Tensor, t) -> torch.Tensor:
    return torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)


def _grid(t0: float, t1: float, num_steps: int):
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    return ts, ts[1] - ts[0]


def odeint_euler(
    drift: DriftFn, x: torch.Tensor, t0: float, t1: float, num_steps: int
) -> torch.Tensor:
    """Explicit Euler over the num_steps - 1 strides of linspace(t0, t1, num_steps)."""
    ts, dt = _grid(t0, t1, num_steps)
    for t in ts[:-1]:
        x = x + float(dt) * drift(x, _t_vec(x, t))
    return x


def odeint_heun(
    drift: DriftFn, x: torch.Tensor, t0: float, t1: float, num_steps: int
) -> torch.Tensor:
    """Explicit trapezoidal (Heun) fixed-step solver."""
    ts, dt = _grid(t0, t1, num_steps)
    for t in ts[:-1]:
        k1 = drift(x, _t_vec(x, t))
        k2 = drift(x + float(dt) * k1, _t_vec(x, t + dt))
        x = x + 0.5 * float(dt) * (k1 + k2)
    return x


# Dormand-Prince 5(4) tableau (torchdiffeq / scipy RK45 coefficients).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def odeint_dopri5(
    drift: DriftFn,
    x: torch.Tensor,
    t0: float,
    t1: float,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 1000,
    safety: float = 0.9,
    min_factor: float = 0.2,
    max_factor: float = 10.0,
) -> torch.Tensor:
    """Adaptive RK45 from t0 to t1.

    Error control is torchdiffeq's mixed rms norm over the whole state,
        err = sqrt(mean((e / (atol + rtol * max(|y0|, |y1|)))**2)),
    steps with err > 1 are rejected and retried with a smaller dt, and the
    step is clipped to land on t1. Every step makes 7 drift evaluations.
    `max_steps` bounds the loop (reaching it returns the current state)."""
    f32 = dict(dtype=torch.float32, device=x.device)
    t = torch.tensor(t0, **f32)
    t_b = torch.tensor(t1, **f32)
    t_stop = float(t_b - 1e-12)
    dt = (t_b - t) / 100.0

    def stage_time(c):
        return (t + c * dt).expand(x.shape[0])

    for _ in range(max_steps):
        if not float(t) < t_stop:
            break
        dt = torch.minimum(dt, t_b - t)
        ks = []
        for i in range(7):
            xi = x
            if i > 0:
                acc = torch.zeros_like(x)
                for j, a in enumerate(_DP_A[i]):
                    acc = acc + a * ks[j]
                xi = x + dt * acc
            ks.append(drift(xi, stage_time(_DP_C[i])))
        x5 = x + dt * sum(b * k for b, k in zip(_DP_B5, ks))
        x4 = x + dt * sum(b * k for b, k in zip(_DP_B4, ks))
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        err = torch.sqrt(torch.mean(torch.square((x5 - x4) / scale)))
        accept = err <= 1.0
        factor = torch.clamp(safety * err.clamp_min(1e-10) ** -0.2, min_factor, max_factor)
        t = torch.where(accept, t + dt, t)
        x = torch.where(accept, x5, x)
        dt = dt * factor
    return x
