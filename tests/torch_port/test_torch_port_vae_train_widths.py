"""The VAE training step against the JAX package at the kernel path's other
shapes, split from `test_torch_port_vae_train.py` (its helpers, sizes and
tolerances): one kernel-path step at E = 64, and one at parse1m-like
proportions, where the dense encoder pool takes the encoder's input. JAX
runs its Pallas kernels in interpret mode; the port's kernel path on CPU
tensors runs the kernels' plain versions."""

import jax
import numpy as np
import pytest
import torch

from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training.vae_task import VAETask as JaxVAETask
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_decoder, fused_encoder
from scldm_torch.training.vae_task import VAETask, _fused_path_ok
from scldm_torch.utils.weights import load_reference_state_dict
from tests.torch_port.test_torch_port_vae_train import (
    DENSE_S,
    TASK,
    B,
    G,
    _jax_kernel_path_step,
    assert_grads_close,
    dense_setup,  # noqa: F401 (a fixture)
    lean_batch,
    port_task,
    to_jax,
    to_torch,
)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


# vae_base.yaml with model.vae.n_embed=64, n_head_cross=4, n_inducing_points=32:
# head width 16, hidden 172, the width chip_smoke.py's phase 13 trains at
WIDE = dict(n_embed=64, n_head_cross=4, n_inducing_points=32)


@pytest.fixture(scope="module")
def wide_setup():
    with jax.default_matmul_precision("highest"):
        jvae = jax_build_vae(n_genes=G, **WIDE)
        jtask = JaxVAETask(jvae, **TASK)
        state = jtask.init_state(jax.random.PRNGKey(2), to_jax(lean_batch()))
    return jvae, jtask, state


def test_train_step_matches_jax_at_e64(wide_setup):
    """One kernel-path train step at E = 64 (4 cross heads of 16 over 32
    latent tokens, hidden 172) against JAX's with its Pallas tail in
    interpret mode: loss, grad norm and theta within 1e-3, the clipped
    gradients within 2e-2 of each tensor's largest, as at E = 32."""
    jvae, jtask, state = wide_setup
    # compiled: the interpret-mode tail's gradients take seconds instead of tens of seconds
    step = jax.jit(lambda st, b: _jax_kernel_path_step(jvae, jtask, st, b))
    _, jgrad, want = step(state, to_jax(lean_batch()))
    tvae = build_transformer_vae(n_genes=G, device="cpu", **WIDE)
    load_reference_state_dict(tvae, export_torch_state_dict(state.params))
    task = VAETask(tvae, **TASK, fused_decoder=True)
    assert _fused_path_ok(tvae) and fused_decoder.kernel_takes(64, 4, 32, 172)
    tstate = task.init_state(torch.Generator().manual_seed(0))
    launches = fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count
    tstate, mets = task.train_step(tstate, to_torch(lean_batch(dtype=np.uint16)))
    assert fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count == launches  # CPU: the plain version
    for k in ("train_loss", "grad_norm", "train_theta"):
        np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-3)
    assert_grads_close(tstate.module, jgrad, 2e-2, skip=("decoder_head.params.bias",))


def test_dense_pool_train_step_matches_jax(dense_setup):
    """At parse1m-like proportions (G=60 genes, a window of S=50 tokens)
    `fused_nb_apply` pools the encoder's input over the dense gene axis, as
    JAX's does: one call of the dense pool per step (its plain version here,
    no kernel launch). One train step's loss, grad norm and clipped gradients
    match JAX's (its dense pool and tail in Pallas interpret mode) at the
    kernel path's bounds."""
    jvae, jtask, state = dense_setup
    _, jgrad, want = _jax_kernel_path_step(jvae, jtask, state, to_jax(lean_batch(window=DENSE_S)))
    task, tstate = port_task(state, fused_decoder=True)
    calls = []
    real = fused_encoder._EncoderPool.apply
    launches = fused_encoder.ENCODER_POOL_FWD_LAUNCHES.count
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_encoder._EncoderPool, "apply",
                   lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
        tstate, mets = task.train_step(tstate, to_torch(lean_batch(window=DENSE_S, dtype=np.uint16)))
        task.loss(to_torch(lean_batch()))  # a window of S=20: the gate is off
    assert calls == [(B, G)]
    assert fused_encoder.ENCODER_POOL_FWD_LAUNCHES.count == launches  # CPU: the plain version
    for k in ("train_loss", "grad_norm", "train_theta"):
        np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-3)
    assert_grads_close(tstate.module, jgrad, 2e-2, skip=("decoder_head.params.bias",))
