"""ODE and SDE integrators (counterpart of scldm_tpu/transport/integrators.py).

Drift functions take (x, t_vec) with t_vec of shape (batch,). Time runs in
f32 like the JAX package. The fixed-step solvers (Euler, Heun, and their
stochastic versions) are Python loops; dopri5 keeps its accept/reject
decision on the device (`torch.where`) and reads one scalar back per step,
for the loop test.

A state is a tensor or, for `_odeint_fixed_tree` and `odeint_dopri5`, a
tuple of tensors with a common leading batch axis (the likelihood ODE's
`(x, logp)`); dopri5 ravels a tuple into one vector, leaves in order, as
JAX ravels its pytree, so its error norm runs over every leaf.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

DriftFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Draws = Union[torch.Generator, torch.Tensor]


def _t_vec(x: torch.Tensor, t) -> torch.Tensor:
    return torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)


def _grid(t0: float, t1: float, num_steps: int):
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    return ts, ts[1] - ts[0]


def _stack(x: torch.Tensor, states: list, return_trajectory: bool) -> torch.Tensor:
    return torch.stack(states) if return_trajectory else x


# ---------------------------------------------------------------------------
# Fixed-step ODE solvers
# ---------------------------------------------------------------------------


def odeint_euler(
    drift: DriftFn, x: torch.Tensor, t0: float, t1: float, num_steps: int,
    return_trajectory: bool = False,
) -> torch.Tensor:
    """Explicit Euler over the num_steps - 1 strides of linspace(t0, t1,
    num_steps). With `return_trajectory`, the (num_steps, ...) states at the
    grid's points, the initial one first."""
    ts, dt = _grid(t0, t1, num_steps)
    states = [x]
    for t in ts[:-1]:
        x = x + float(dt) * drift(x, _t_vec(x, t))
        states.append(x)
    return _stack(x, states, return_trajectory)


def odeint_heun(
    drift: DriftFn, x: torch.Tensor, t0: float, t1: float, num_steps: int,
    return_trajectory: bool = False,
) -> torch.Tensor:
    """Explicit trapezoidal (Heun) fixed-step solver; `return_trajectory` as
    in `odeint_euler`."""
    ts, dt = _grid(t0, t1, num_steps)
    states = [x]
    for t in ts[:-1]:
        k1 = drift(x, _t_vec(x, t))
        k2 = drift(x + float(dt) * k1, _t_vec(x, t + dt))
        x = x + 0.5 * float(dt) * (k1 + k2)
        states.append(x)
    return _stack(x, states, return_trajectory)


def _odeint_fixed_tree(drift, x: Sequence[torch.Tensor], t0: float, t1: float, num_steps: int,
                       heun: bool):
    """Fixed-step Euler or Heun over a tuple state (the likelihood ODE's
    `(x, logp)`); `drift(state, t_vec)` returns a tuple like the state."""
    ts, dt = _grid(t0, t1, num_steps)
    dt = float(dt)
    x = tuple(x)
    lead = x[0]
    for t in ts[:-1]:
        k1 = drift(x, _t_vec(lead, t))
        if not heun:
            x = tuple(a + dt * b for a, b in zip(x, k1))
            continue
        xp = tuple(a + dt * b for a, b in zip(x, k1))
        k2 = drift(xp, _t_vec(lead, t + dt))
        x = tuple(a + 0.5 * dt * (b + c) for a, b, c in zip(x, k1, k2))
    return x


# ---------------------------------------------------------------------------
# Adaptive Dormand-Prince 5(4)
# ---------------------------------------------------------------------------

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


def _ravel(state):
    """(flat vector, unravel) of a tensor or a tuple of tensors, the leaves
    flattened and concatenated in order."""
    if isinstance(state, torch.Tensor):
        return state.reshape(-1), lambda v: v.reshape(state.shape)
    shapes = [s.shape for s in state]
    sizes = [s.numel() for s in state]

    def unravel(v):
        return tuple(p.reshape(sh) for p, sh in zip(torch.split(v, sizes), shapes))

    return torch.cat([s.reshape(-1) for s in state]), unravel


def odeint_dopri5(
    drift,
    x,
    t0: float,
    t1: float,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    max_steps: int = 1000,
    safety: float = 0.9,
    min_factor: float = 0.2,
    max_factor: float = 10.0,
    save_ts: Optional[Sequence[float]] = None,
    mean=torch.mean,
):
    """Adaptive RK45 from t0 to t1, over a tensor or a tuple state.

    Error control is torchdiffeq's mixed rms norm over the whole ravelled
    state, err = sqrt(mean((e / (atol + rtol * max(|y0|, |y1|)))**2)); steps
    with err > 1 are rejected and retried with a smaller dt, and the step is
    clipped to land on t1. Every step makes 7 drift evaluations. `max_steps`
    bounds each integration (reaching it returns the current state).

    With `save_ts` (ascending points spanning [t0, t1]) each stretch between
    consecutive points is integrated adaptively on its own, from a fresh
    first step, and the states at every point come back stacked on a new
    leading axis (per leaf for a tuple), the initial one first. `mean` is
    the error norm's mean (a batch split over ranks passes one over every
    rank's rows, so that all ranks take the same steps)."""
    flat, unravel = _ravel(x)
    lead = x if isinstance(x, torch.Tensor) else x[0]
    batch = lead.shape[0]
    f32 = dict(dtype=torch.float32, device=flat.device)

    def flat_drift(v, t_vec):
        return _ravel(drift(unravel(v), t_vec))[0]

    def integrate(v, t_a, t_b):
        t = torch.tensor(t_a, **f32)
        t_b = torch.tensor(t_b, **f32)
        t_stop = float(t_b - 1e-12)
        dt = (t_b - t) / 100.0
        for _ in range(max_steps):
            if not float(t) < t_stop:
                break
            dt = torch.minimum(dt, t_b - t)
            ks = []
            for i in range(7):
                vi = v
                if i > 0:
                    acc = torch.zeros_like(v)
                    for j, a in enumerate(_DP_A[i]):
                        acc = acc + a * ks[j]
                    vi = v + dt * acc
                ks.append(flat_drift(vi, (t + _DP_C[i] * dt).expand(batch)))
            v5 = v + dt * sum(b * k for b, k in zip(_DP_B5, ks))
            v4 = v + dt * sum(b * k for b, k in zip(_DP_B4, ks))
            scale = atol + rtol * torch.maximum(v.abs(), v5.abs())
            err = torch.sqrt(mean(torch.square((v5 - v4) / scale)))
            accept = err <= 1.0
            factor = torch.clamp(safety * err.clamp_min(1e-10) ** -0.2, min_factor, max_factor)
            t = torch.where(accept, t + dt, t)
            v = torch.where(accept, v5, v)
            dt = dt * factor
        return v

    if save_ts is None:
        return unravel(integrate(flat, t0, t1))
    pts = [float(s) for s in torch.as_tensor(save_ts, dtype=torch.float32)]
    traj = [flat]
    for a, b in zip(pts[:-1], pts[1:]):
        traj.append(integrate(traj[-1], a, b))
    states = [unravel(v) for v in traj]
    if isinstance(x, torch.Tensor):
        return torch.stack(states)
    return tuple(torch.stack(leaf) for leaf in zip(*states))


# ---------------------------------------------------------------------------
# Fixed-step SDE solvers
# ---------------------------------------------------------------------------


def brownian_normals(draws: Draws, x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The (num_steps - 1, *x.shape) standard normals of an SDE run: drawn
    from a generator, or given (tests inject JAX's)."""
    if isinstance(draws, torch.Tensor):
        want = (num_steps - 1, *x.shape)
        if tuple(draws.shape) != want:
            raise ValueError(f"injected increments {tuple(draws.shape)}, expected {want}")
        return draws.to(device=x.device, dtype=x.dtype)
    return torch.randn((num_steps - 1, *x.shape), generator=draws, device=draws.device,
                       dtype=x.dtype).to(x.device)


def sdeint(
    drift: DriftFn,
    diffusion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    draws: Draws,
    x: torch.Tensor,
    t0: float,
    t1: float,
    num_steps: int,
    method: str = "Euler",
    return_trajectory: bool = False,
) -> torch.Tensor:
    """Euler-Maruyama or stochastic Heun over linspace(t0, t1, num_steps)[:-1].

    `draws` is a generator or the (num_steps - 1, *x.shape) standard normals
    (`brownian_normals`); step i's increment is normals[i] * sqrt(dt).
    Returns the state after the last step (before a sampler's deterministic
    last step), or with `return_trajectory` the (num_steps, ...) states, the
    initial one first."""
    if method not in ("Euler", "Heun"):
        raise NotImplementedError(f"SDE method {method}")
    ts, dt = _grid(t0, t1, num_steps)
    sqrt_dt = float(torch.sqrt(dt))
    normals = brownian_normals(draws, x, num_steps)
    states = [x]
    for i, t in enumerate(ts[:-1]):
        dw = normals[i] * sqrt_dt
        tv = _t_vec(x, t)
        if method == "Euler":
            d = drift(x, tv)
            g = diffusion(x, tv)
            x = x + d * float(dt) + torch.sqrt(2.0 * g) * dw
        else:
            g = diffusion(x, tv)
            xhat = x + torch.sqrt(2.0 * g) * dw
            k1 = drift(xhat, tv)
            xp = xhat + float(dt) * k1
            k2 = drift(xp, _t_vec(x, t + dt))
            x = xhat + 0.5 * float(dt) * (k1 + k2)
        states.append(x)
    return _stack(x, states, return_trajectory)
