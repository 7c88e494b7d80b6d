"""The port's ODE integrators against the JAX integrators on the same drift
and the same numpy start state.

euler and heun at 1e-5 (same f32 arithmetic, same grid). dopri5 at 1e-3:
both take the same accept/reject path except where an error norm lands
within rounding of 1, and the results agree to the solver's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.transport import Sampler as JaxSampler
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.transport.integrators import odeint_dopri5 as jax_dopri5
from scldm_tpu.transport.integrators import odeint_euler as jax_euler
from scldm_tpu.transport.integrators import odeint_heun as jax_heun
from scldm_tpu.transport.path import ICPlan as JaxICPlan
from scldm_torch.transport import Sampler, create_transport
from scldm_torch.transport.integrators import odeint_dopri5, odeint_euler, odeint_heun
from scldm_torch.transport.path import ICPlan


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _x0():
    return np.random.default_rng(0).normal(size=(4, 6, 3)).astype(np.float32)


def jax_drift(x, t):
    return -x * (1.0 + t[:, None, None]) + 0.5 * jnp.sin(3.0 * x) + t[:, None, None] ** 2


def torch_drift(x, t):
    return -x * (1.0 + t[:, None, None]) + 0.5 * torch.sin(3.0 * x) + t[:, None, None] ** 2


CASES = {
    "euler": (lambda: jax_euler(jax_drift, jnp.asarray(_x0()), 0.0, 1.0, 12),
              lambda: odeint_euler(torch_drift, torch.from_numpy(_x0()), 0.0, 1.0, 12), 1e-5),
    "heun": (lambda: jax_heun(jax_drift, jnp.asarray(_x0()), 0.0, 1.0, 12),
             lambda: odeint_heun(torch_drift, torch.from_numpy(_x0()), 0.0, 1.0, 12), 1e-5),
    "dopri5": (lambda: jax_dopri5(jax_drift, jnp.asarray(_x0()), 0.0, 1.0),
               lambda: odeint_dopri5(torch_drift, torch.from_numpy(_x0()), 0.0, 1.0), 1e-3),
}


@pytest.mark.parametrize("method", sorted(CASES))
def test_integrator_matches_jax(method):
    jax_fn, torch_fn, tol = CASES[method]
    np.testing.assert_allclose(torch_fn().numpy(), np.asarray(jax_fn()), rtol=tol, atol=tol)


def test_dopri5_is_accurate_on_a_linear_ode():
    """dx/dt = -2x: the adaptive solver lands on exp(-2) to its tolerance."""
    x0 = torch.from_numpy(_x0())
    got = odeint_dopri5(lambda x, t: -2.0 * x, x0, 0.0, 1.0)
    np.testing.assert_allclose(got.numpy(), (x0 * np.exp(-2.0)).numpy(), rtol=1e-4, atol=1e-4)


def test_dopri5_counts_seven_evaluations_per_step():
    evals = []

    def drift(x, t):
        evals.append(float(t[0]))
        return torch_drift(x, t)

    odeint_dopri5(drift, torch.from_numpy(_x0()), 0.0, 1.0)
    assert len(evals) % 7 == 0 and len(evals) > 0
    assert max(evals) == pytest.approx(1.0)


@pytest.mark.parametrize("method", ["euler", "heun", "dopri5"])
def test_sample_ode_matches_jax(method):
    """Sampler.sample_ode on the Linear/velocity transport: same interval,
    the model's output as the drift."""
    jfn = JaxSampler(jax_create_transport()).sample_ode(sampling_method=method, num_steps=10)
    tfn = Sampler(create_transport()).sample_ode(sampling_method=method, num_steps=10)
    want = jfn(jnp.asarray(_x0()), lambda x, t: jnp.tanh(x) * (0.5 + t[:, None, None]))
    got = tfn(torch.from_numpy(_x0()), lambda x, t: torch.tanh(x) * (0.5 + t[:, None, None]))
    tol = 1e-3 if method == "dopri5" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_linear_plan_matches_jax():
    rng = np.random.default_rng(2)
    t = rng.uniform(size=(4,)).astype(np.float32)
    x0, x1 = _x0(), rng.normal(size=(4, 6, 3)).astype(np.float32)
    _, xt, ut = JaxICPlan().plan(jnp.asarray(t), jnp.asarray(x0), jnp.asarray(x1))
    _, xt_t, ut_t = ICPlan().plan(*map(torch.from_numpy, (t, x0, x1)))
    np.testing.assert_allclose(xt_t.numpy(), np.asarray(xt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ut_t.numpy(), np.asarray(ut), rtol=1e-6, atol=1e-6)


def test_unported_paths_raise():
    """What JAX refuses, the port refuses: an unknown solver, an unknown
    diffusion form, an unknown path."""
    with pytest.raises(NotImplementedError):
        Sampler(create_transport()).sample_ode(sampling_method="rk4")
    with pytest.raises(NotImplementedError):
        jax_create_transport().path_sampler.compute_diffusion(
            jnp.ones((2, 3)), jnp.full((2,), 0.5), form="quadratic")
    with pytest.raises(NotImplementedError):
        create_transport().path_sampler.compute_diffusion(
            torch.ones(2, 3), torch.full((2,), 0.5), form="quadratic")
    with pytest.raises(KeyError):
        jax_create_transport(path_type="Cosine")
    with pytest.raises(KeyError):
        create_transport(path_type="Cosine")
