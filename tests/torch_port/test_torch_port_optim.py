"""The port's wsd schedule and AdamWLegacy against the JAX package's, over
several steps, on the same numpy parameters and gradients. Tolerance 1e-6
relative: the port's schedule runs in f64 on the host, JAX's in f32."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scldm_tpu.training.optim import adamw_legacy as jax_adamw
from scldm_tpu.training.optim import wsd_schedule as jax_wsd
from scldm_torch.training.optim import AdamWLegacy, wsd_schedule


@pytest.mark.parametrize("decay_type", ["sqrt", "cosine"])
@pytest.mark.parametrize("fract_decay,warmup", [(0.1, 10), (1.0, 10), (0.3, 0)])
def test_wsd_schedule_matches_jax(decay_type, fract_decay, warmup):
    kw = dict(num_training_steps=100, final_lr_factor=0.1, num_warmup_steps=max(warmup, 1),
              init_div_factor=100, fract_decay=fract_decay, decay_type=decay_type)
    want, got = jax_wsd(**kw), wsd_schedule(**kw)
    for step in range(0, 120):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-7)
    if fract_decay == 1.0:  # warmup wins over decay from step 0 (the LDM default)
        assert got(0) == pytest.approx(0.01)


def test_wsd_schedule_rejects_unknown_decay():
    with pytest.raises(ValueError, match="decay type"):
        wsd_schedule(10, decay_type="linear")


@pytest.mark.parametrize("variant", ["plain", "caution", "amsgrad"])
def test_adamw_legacy_matches_jax(variant):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "e": (11, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05,
              amsgrad=variant == "amsgrad", caution=variant == "caution")
    sched = wsd_schedule(20, num_warmup_steps=3, fract_decay=0.5, decay_type="sqrt")
    jsched = jax_wsd(20, num_warmup_steps=3, fract_decay=0.5, decay_type="sqrt")
    tx = jax_adamw(learning_rate=lambda c: 1e-2 * jsched(c), **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamWLegacy(tp.values(), learning_rate=1e-2, schedule=sched, **kw)
    for _ in range(8):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    # the parameters moved: the comparison was not of two idle optimizers
    assert not np.allclose(tp["w"].detach().numpy(), params["w"], atol=1e-3)
