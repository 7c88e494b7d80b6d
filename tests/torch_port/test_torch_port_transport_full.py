"""The whole transport family of the port against the JAX package: every
path (Linear, GVP, VP) under every prediction (velocity, score, noise) and
loss weight (none, velocity, likelihood), the SDE pieces, the conversions,
the SDE sampler with every last step, the ODE sampler reversed and with
trajectories, and the likelihood ODE, on the same numpy inputs.

JAX's random draws are recomputed from its keys and injected: the
Brownian normals of `sdeint` (one split of the carried key a step) and the
Rademacher vector of the likelihood ODE.

Tolerances: f32 on both sides. Elementwise functions and single losses at
1e-5 relative, fixed-step samplers at 1e-4 (the same grid and arithmetic;
sums of a step's terms in another order), dopri5 at 1e-3 (the same
accept/reject path but where an error norm lands within rounding of 1).
Near the ends of the interval the score and noise predictions divide by
sigma_t; the times there are the interval's own ends (`check_interval`),
and the same 1e-5 holds, checked at both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.transport import Sampler as JaxSampler
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.transport.integrators import _odeint_fixed_tree as jax_fixed_tree
from scldm_tpu.transport.integrators import odeint_dopri5 as jax_dopri5
from scldm_tpu.transport.integrators import odeint_euler as jax_euler
from scldm_tpu.transport.integrators import odeint_heun as jax_heun
from scldm_tpu.transport.integrators import sdeint as jax_sdeint
from scldm_torch.transport import Sampler, create_transport
from scldm_torch.transport.integrators import (
    _odeint_fixed_tree,
    odeint_dopri5,
    odeint_euler,
    odeint_heun,
    sdeint,
)
from scldm_torch.transport.transport import rademacher

PATHS = ["Linear", "GVP", "VP"]
PREDICTIONS = ["velocity", "score", "noise"]
WEIGHTS = [None, "velocity", "likelihood"]
FORMS = ["constant", "SBDM", "sigma", "linear", "decreasing", "inccreasing-decreasing"]
SHAPE = (4, 6, 3)
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _normal(seed, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(path, prediction, loss_weight=None, **kw):
    return (jax_create_transport(path, prediction, loss_weight, **kw),
            create_transport(path, prediction, loss_weight, **kw))


def _times(jt, eval=False):
    """Times across the interval, its two ends included."""
    t0, t1 = jt.check_interval(jt.train_eps, jt.sample_eps, eval=eval)
    return np.array([t0, t0 + 0.37 * (t1 - t0), t0 + 0.81 * (t1 - t0), t1], np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), **(tol or F32))


def jax_model(x, t, scale=1.0):
    return scale * (jnp.tanh(x) * (0.5 + t[:, None, None]) + 0.1 * x)


def torch_model(x, t, scale=1.0):
    return scale * (torch.tanh(x) * (0.5 + t[:, None, None]) + 0.1 * x)


# -- the factory and the intervals ---------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("eps", [{}, dict(train_eps=2e-3, sample_eps=3e-2)])
def test_check_interval_every_flag_matches_jax(path, prediction, eps):
    jt, tt = _pair(path, prediction, **eps)
    assert (tt.train_eps, tt.sample_eps) == (jt.train_eps, jt.sample_eps)
    for form in ("SBDM", "sigma"):
        for sde in (False, True):
            for reverse in (False, True):
                for ev in (False, True):
                    for last in (0.0, 0.04):
                        flags = dict(diffusion_form=form, sde=sde, reverse=reverse, eval=ev,
                                     last_step_size=last)
                        want = jt.check_interval(jt.train_eps, jt.sample_eps, **flags)
                        assert tt.check_interval(**flags) == pytest.approx(want), flags
                        assert tt.check_interval(jt.train_eps, jt.sample_eps, **flags) == \
                            pytest.approx(want)


# -- the paths ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_path_pieces_match_jax(path):
    """plan, compute_drift, every diffusion form, the three conversions and
    the coefficients, at times across the sampling interval of the score
    prediction (both its ends included)."""
    jt, tt = _pair(path, "score")
    jp, tp = jt.path_sampler, tt.path_sampler
    t = _times(jt, eval=True)
    x0, x1, v = _normal(0), _normal(1), _normal(2)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    for want, got in zip(jp.plan(J(t), J(x0), J(x1)), tp.plan(T(t), T(x0), T(x1))):
        _close(got, want)
    for want, got in zip(jp.compute_drift(J(x1), J(t)), tp.compute_drift(T(x1), T(t))):
        _close(got, want)
    for form in FORMS:
        for norm in (1.0, 0.5):
            want = jp.compute_diffusion(J(x1), J(t), form=form, norm=norm)
            got = tp.compute_diffusion(T(x1), T(t), form=form, norm=norm)
            _close(got, np.broadcast_to(np.asarray(want), np.shape(got)))
    te_j, te_t = J(t)[:, None, None], T(t)[:, None, None]
    for name in ("compute_alpha_t", "compute_sigma_t"):
        for want, got in zip(getattr(jp, name)(te_j), getattr(tp, name)(te_t)):
            _close(got, want)
    _close(tp.compute_d_alpha_alpha_ratio_t(te_t), jp.compute_d_alpha_alpha_ratio_t(te_j))
    for name in ("get_score_from_velocity", "get_noise_from_velocity", "get_velocity_from_score"):
        _close(getattr(tp, name)(T(v), T(x1), T(t)), getattr(jp, name)(J(v), J(x1), J(t)))
    with pytest.raises(NotImplementedError):
        tp.compute_diffusion(T(x1), T(t), form="cubic")


# -- the losses ----------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("loss_weight", WEIGHTS)
def test_training_losses_match_jax(path, prediction, loss_weight):
    """JAX's draws (t, x0) from its key, injected into `losses_at`; then the
    same at the training interval's two ends."""
    jt, tt = _pair(path, prediction, loss_weight)
    x1 = _normal(3)
    key = jax.random.PRNGKey(7)
    want = jt.training_losses(jax_model, key, jnp.asarray(x1))
    t, x0, _ = jt.sample(key, jnp.asarray(x1))
    got = tt.losses_at(torch_model, torch.from_numpy(np.array(t)),
                       torch.from_numpy(np.array(x0)), torch.from_numpy(x1))
    for k in ("loss", "pred"):
        _close(got[k], want[k])
    ends = _times(jt)
    ends = np.array([ends[0], ends[-1], ends[0], ends[-1]], np.float32)
    _, xt, ut = jt.path_sampler.plan(jnp.asarray(ends), jnp.asarray(_normal(4)), jnp.asarray(x1))
    want_end = _jax_loss(jt, jnp.asarray(ends), xt, ut)
    got_end = tt.losses_at(torch_model, torch.from_numpy(ends), torch.from_numpy(_normal(4)),
                           torch.from_numpy(x1))["loss"]
    _close(got_end, want_end)
    # the port's own draws: t on the training interval, the loss per sample
    t0, t1 = tt.check_interval()
    seen = []
    terms = tt.training_losses(lambda x, t: seen.append(t) or torch_model(x, t),
                               torch.Generator().manual_seed(0), torch.from_numpy(x1))
    assert terms["loss"].shape == (4,) and torch.isfinite(terms["loss"]).all()
    assert ((seen[0] >= t0) & (seen[0] <= t1)).all()


def _jax_loss(jt, t, xt, ut):
    """The loss terms of JAX's `training_losses` at given t, x_t, u_t (its
    body after the draws, with x0 from the same numpy seed)."""
    from scldm_tpu.transport import path as jpath
    from scldm_tpu.transport.transport import ModelType, WeightType, mean_flat

    x0 = jnp.asarray(_normal(4))
    out = jax_model(xt, t)
    if jt.model_type == ModelType.VELOCITY:
        return mean_flat((out - ut) ** 2)
    _, drift_var = jt.path_sampler.compute_drift(xt, t)
    sigma_t, _ = jt.path_sampler.compute_sigma_t(jpath.expand_t_like_x(t, xt))
    weight = {WeightType.VELOCITY: lambda: (drift_var / sigma_t) ** 2,
              WeightType.LIKELIHOOD: lambda: drift_var / (sigma_t**2),
              WeightType.NONE: lambda: 1.0}[jt.loss_type]()
    if jt.model_type == ModelType.NOISE:
        return mean_flat(weight * (out - x0) ** 2)
    return mean_flat(weight * (out * sigma_t + x0) ** 2)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_drift_score_and_prior_match_jax(path, prediction):
    jt, tt = _pair(path, prediction)
    x = _normal(5)
    t = _times(jt, eval=True)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(tt.get_drift()(tx, torch.from_numpy(t), torch_model),
           jt.get_drift()(jx, jnp.asarray(t), jax_model))
    _close(tt.get_score()(tx, torch.from_numpy(t), torch_model),
           jt.get_score()(jx, jnp.asarray(t), jax_model))
    _close(tt.prior_logp(tx), jt.prior_logp(jx))


# -- the integrators ------------------------------------------------------------------------

def jax_drift(x, t):
    return -x * (1.0 + t[:, None, None]) + 0.5 * jnp.sin(3.0 * x) + t[:, None, None] ** 2


def torch_drift(x, t):
    return -x * (1.0 + t[:, None, None]) + 0.5 * torch.sin(3.0 * x) + t[:, None, None] ** 2


def jax_tree_drift(state, t):
    x, logp = state
    return jax_drift(x, t), jnp.sum(jnp.cos(x), axis=(1, 2)) * t


def torch_tree_drift(state, t):
    x, logp = state
    return torch_drift(x, t), torch.sum(torch.cos(x), dim=(1, 2)) * t


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_fixed_step_trajectories_match_jax(method):
    jfn, tfn = {"euler": (jax_euler, odeint_euler), "heun": (jax_heun, odeint_heun)}[method]
    want = jfn(jax_drift, jnp.asarray(_normal(0)), 0.1, 0.9, 7, return_trajectory=True)
    got = tfn(torch_drift, torch.from_numpy(_normal(0)), 0.1, 0.9, 7, return_trajectory=True)
    assert got.shape == (7, *SHAPE)
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(got[-1], tfn(torch_drift, torch.from_numpy(_normal(0)), 0.1, 0.9, 7), rtol=0, atol=0)


@pytest.mark.parametrize("heun", [False, True])
def test_fixed_step_tree_matches_jax(heun):
    init = (_normal(0), np.zeros(4, np.float32))
    want = jax_fixed_tree(jax_tree_drift, tuple(map(jnp.asarray, init)), 0.0, 1.0, 9, heun=heun)
    got = _odeint_fixed_tree(torch_tree_drift, tuple(map(torch.from_numpy, init)), 0.0, 1.0, 9,
                             heun=heun)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("save", [False, True])
def test_dopri5_over_a_tuple_state_matches_jax(save):
    """The state (x, logp) ravelled as JAX ravels its pytree: the same
    steps, so the same results at dopri5's 1e-3; with `save_ts`, every
    saved state."""
    init = (_normal(0), np.full(4, 3.0, np.float32))
    save_ts = np.linspace(0.0, 1.0, 5).astype(np.float32) if save else None
    want = jax_dopri5(jax_tree_drift, tuple(map(jnp.asarray, init)), 0.0, 1.0,
                      save_ts=None if save_ts is None else jnp.asarray(save_ts))
    got = odeint_dopri5(torch_tree_drift, tuple(map(torch.from_numpy, init)), 0.0, 1.0,
                        save_ts=save_ts)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, rtol=1e-3, atol=1e-3)


def test_dopri5_evaluations_follow_the_whole_state():
    """The controller sees logp too: a stiff logp leaf alone forces more
    steps than x alone would take."""
    counts = {}

    def drift(scale):
        def f(state, t):
            counts[scale] = counts.get(scale, 0) + 1
            x, logp = state
            return torch_drift(x, t), -scale * logp
        return f

    for scale in (0.0, 40.0):
        odeint_dopri5(drift(scale), (torch.from_numpy(_normal(0)), torch.ones(4)), 0.0, 1.0)
    assert counts[40.0] > counts[0.0]


def _jax_normals(key, shape, n):
    """The normals JAX's sdeint draws: one split of the carried key a step."""
    out = []
    for _ in range(n - 1):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("method", ["Euler", "Heun"])
def test_sdeint_matches_jax_at_its_draws(method):
    key = jax.random.PRNGKey(11)

    def jdiff(x, t):
        return 0.3 * (1.0 - t)[:, None, None] * jnp.ones_like(x)

    def tdiff(x, t):
        return 0.3 * (1.0 - t)[:, None, None] * torch.ones_like(x)

    want = jax_sdeint(jax_drift, jdiff, key, jnp.asarray(_normal(0)), 0.0, 0.9, 8,
                      method=method, return_trajectory=True)
    got = sdeint(torch_drift, tdiff, _jax_normals(key, SHAPE, 8), torch.from_numpy(_normal(0)),
                 0.0, 0.9, 8, method=method, return_trajectory=True)
    _close(got, want, rtol=1e-4, atol=1e-5)
    drawn = sdeint(torch_drift, tdiff, torch.Generator().manual_seed(0),
                   torch.from_numpy(_normal(0)), 0.0, 0.9, 8, method=method)
    assert drawn.shape == SHAPE and torch.isfinite(drawn).all()
    with pytest.raises(ValueError, match="increments"):
        sdeint(torch_drift, tdiff, torch.zeros(3, *SHAPE), torch.from_numpy(_normal(0)),
               0.0, 0.9, 8)


# -- the samplers ---------------------------------------------------------------------------

# every method and last step under every prediction, the three paths in turn
SDE_CASES = [(PATHS[(i + j) % 3], prediction, method, last_step)
             for i, prediction in enumerate(PREDICTIONS)
             for j, (method, last_step) in enumerate(
                 (m, s) for m in ("Euler", "Heun") for s in (None, "Mean", "Tweedie", "Euler"))]


@pytest.mark.parametrize("path,prediction,method,last_step", SDE_CASES)
def test_sample_sde_matches_jax(path, prediction, method, last_step):
    # epsilons of 1e-3 keep every SDE off t = 0, where velocity's default 0
    # would divide by zero on both sides
    jt, tt = _pair(path, prediction, train_eps=1e-3, sample_eps=1e-3)
    kw = dict(sampling_method=method, last_step=last_step, num_steps=6,
              diffusion_form="sigma" if path == "GVP" else "SBDM")
    key = jax.random.PRNGKey(5)
    model = dict(scale=0.5)
    want = JaxSampler(jt).sample_sde(**kw)(key, jnp.asarray(_normal(0)), jax_model, **model)
    got = Sampler(tt).sample_sde(**kw)(_jax_normals(key, SHAPE, 6), torch.from_numpy(_normal(0)),
                                       torch_model, **model)
    assert np.isfinite(np.asarray(want)).all()
    mag = float(np.abs(np.asarray(want)).max())
    _close(got, want, rtol=1e-4, atol=1e-5 * max(mag, 1.0))


def test_sample_sde_trajectory_matches_jax():
    jt, tt = _pair("VP", "noise")
    kw = dict(num_steps=5, return_trajectory=True, last_step="Tweedie")
    key = jax.random.PRNGKey(9)
    want = JaxSampler(jt).sample_sde(**kw)(key, jnp.asarray(_normal(0)), jax_model)
    got = Sampler(tt).sample_sde(**kw)(_jax_normals(key, SHAPE, 5), torch.from_numpy(_normal(0)),
                                       torch_model)
    assert got.shape == (6, *SHAPE) and np.isfinite(np.asarray(want)).all()
    mag = float(np.abs(np.asarray(want)).max())
    _close(got, want, rtol=1e-4, atol=1e-5 * max(mag, 1.0))


@pytest.mark.parametrize("path,prediction", [("Linear", "velocity"), ("GVP", "score"),
                                             ("VP", "noise"), ("Linear", "noise")])
@pytest.mark.parametrize("method", ["euler", "heun", "dopri5"])
@pytest.mark.parametrize("reverse", [False, True])
def test_sample_ode_reverse_and_trajectory_match_jax(path, prediction, method, reverse):
    jt, tt = _pair(path, prediction)
    kw = dict(sampling_method=method, num_steps=5, reverse=reverse, return_trajectory=True)
    want = JaxSampler(jt).sample_ode(**kw)(jnp.asarray(_normal(0)), jax_model, scale=0.5)
    got = Sampler(tt).sample_ode(**kw)(torch.from_numpy(_normal(0)), torch_model, scale=0.5)
    assert got.shape == (5, *SHAPE) and np.isfinite(np.asarray(want)).all()
    tol = 1e-3 if method == "dopri5" else 1e-4
    _close(got, want, rtol=tol, atol=tol)
    final = Sampler(tt).sample_ode(**{**kw, "return_trajectory": False})(
        torch.from_numpy(_normal(0)), torch_model, scale=0.5)
    if method != "dopri5":  # dopri5's trajectory restarts its step at every saved point
        _close(final, got[-1], rtol=0, atol=0)


@pytest.mark.parametrize("path,prediction", [("Linear", "velocity"), ("VP", "velocity"),
                                             ("GVP", "score"), ("Linear", "noise")])
@pytest.mark.parametrize("method", ["euler", "heun", "dopri5"])
def test_sample_ode_likelihood_matches_jax(path, prediction, method):
    """JAX's Rademacher vector, recomputed from its key and injected; logp
    and z0 at 1e-4 (fixed steps) or dopri5's 1e-3. (VP under noise
    prediction is left out: its reverse interval starts at t = 1, where
    sigma_t is 0, and both packages divide by it.)"""
    jt, tt = _pair(path, prediction)
    kw = dict(sampling_method=method, num_steps=6)
    key = jax.random.PRNGKey(2)
    x = _normal(1)
    want_logp, want_z = JaxSampler(jt).sample_ode_likelihood(**kw)(key, jnp.asarray(x), jax_model)
    eps = np.asarray(jax.random.randint(key, x.shape, 0, 2, dtype=jnp.int32)).astype(
        np.float32) * 2.0 - 1.0
    logp, z = Sampler(tt).sample_ode_likelihood(**kw)(torch.from_numpy(eps), torch.from_numpy(x),
                                                      torch_model)
    assert np.isfinite(np.asarray(want_logp)).all() and np.isfinite(np.asarray(want_z)).all()
    tol = 1e-3 if method == "dopri5" else 1e-4
    _close(z, want_z, rtol=tol, atol=tol)
    _close(logp, want_logp, rtol=tol, atol=tol * float(np.abs(np.asarray(want_logp)).max()))
    drawn = rademacher(torch.Generator().manual_seed(0), torch.from_numpy(x))
    assert set(drawn.unique().tolist()) == {-1.0, 1.0}
