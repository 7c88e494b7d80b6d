"""The long-latent slice against the JAX package at small width: a VAE over
1,024 latent tokens (its MCAB pools 1,024 queries over the gene window, and
every encoder and decoder block attends over 1,024 tokens) under a DiT over
the same 1,024 tokens, where `sdpa` takes the flash attention kernel on
both sides. `VAETask.encode` and two euler steps of generation from
injected noise (`generate_from_noise(fused_blocks=False)`, the deterministic
part of `make_sample_fn(fused_blocks=False)`: the module DiT, the module
decode) on the same weights (`export_torch_state_dict` ->
`load_reference_state_dict`) and numpy inputs.

JAX takes its kernel only on a TPU, so the test forces it here, and only
here: `scldm_tpu.ops.attention._use_flash` becomes the length test and
`scldm_tpu.ops.flash_attention.flash_attention` an interpret-mode call that
counts itself. The count must be above zero: JAX's `sdpa` catches any
exception of its kernel and computes plain attention instead, so without it
the test could compare plain attention with plain attention. On CPU tensors
the port's `sdpa` is the plain path, the kernel's plain version.

Size: E = 32, 2 layers, 2 + 2 heads, 1,024 inducing points, an 8-wide
latent, a 1,100-token window over 1,200 genes, B = 2; the DiT at E = 32, 2
layers, 2 heads, T = 1,024. Tolerance: the latents, the samples and the NB
means within 1e-4 of their largest magnitude (f32 both sides; streaming
against materialized softmax, sums in other orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.ops import attention as jattn
from scldm_tpu.ops import flash_attention as jfa
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.training.vae_task import VAETask as JaxVAETask
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.nnets import DiT
from scldm_torch.ops import flash_attention as fa
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.training.vae_task import VAETask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import load_reference_state_dict
from tests.torch_port.test_torch_port_dit import randomized_dit_params
from tests.torch_port.test_torch_port_window_pool_wide import jax_vae_and_params, lean

G, S, B, T, LATENT = 1_200, 1_100, 2, 1_024, 8
VAE_ARCH = dict(n_genes=G, n_embed=32, n_embed_latent=LATENT, n_layer=2, n_inducing_points=T,
                n_head=2, n_head_cross=2)
DIT_ARCH = dict(n_embed=32, n_embed_input=LATENT, n_layer=2, n_head=2, seq_len=T,
                class_vocab_sizes={"clusters": 3}, cfg_dropout_prob=0.8)
GUIDANCE = {"clusters": 1.0}


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def jax_flash(monkeypatch):
    """JAX's gate forced open at the length test, its kernel in interpret
    mode; returns the list that each call which returns appends q's shape
    to (a call that raises appends nothing)."""
    calls = []
    kernel = functools.partial(jfa.flash_attention, interpret=True)

    def counted(q, k, v):
        out = kernel(q, k, v)
        calls.append(q.shape)
        return out

    monkeypatch.setattr(jattn, "_use_flash", lambda q, k: k.shape[1] >= jattn._FLASH_MIN_SEQ
                        and q.shape[1] >= jattn._FLASH_MIN_SEQ)
    monkeypatch.setattr(jfa, "flash_attention", counted)
    return calls


@pytest.fixture(scope="module")
def vae_pair():
    batch = lean(B, G, S, seed=11)
    batch["genes_subset"][:, -1] = 0  # the window ends in padding on both cells
    with jax.default_matmul_precision("highest"):
        jvae, params, tvae = jax_vae_and_params(VAE_ARCH, batch, seed=11, noise=0.1)
    return jvae, params, tvae.eval(), batch


def _near(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert scale > 0 and err <= 1e-4 * scale, (what, err, scale)


def test_encode_matches_jax_kernel(vae_pair, jax_flash):
    """The MCAB (1,024 queries over the 1,100-token window) and both encoder
    blocks (1,024 x 1,024) through JAX's kernel; the port's encode on CPU
    tensors through the plain path."""
    jvae, params, tvae, batch = vae_pair
    want = JaxVAETask(jvae).encode(params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert jax_flash, "JAX's kernel did not run"
    assert (B, T, VAE_ARCH["n_head_cross"], 16) in jax_flash  # the MCAB's queries
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    with torch.no_grad():
        got = VAETask(tvae).encode({k: torch.from_numpy(v) for k, v in batch.items()})
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before
    assert got.shape == (B, T, LATENT)
    _near(got.numpy(), want, "latents")


def test_generation_matches_jax_kernel(vae_pair, jax_flash):
    """Two euler steps (num_steps = 3) of the module DiT under batched CFG,
    then the module decode (its trunk over 1,024 tokens; E = 32 keeps the
    algebraic decode off on both sides), from the same noise and size
    factors."""
    jvae, vae_params, tvae, _ = vae_pair
    rng = np.random.default_rng(12)
    z0 = rng.normal(size=(B, T, LATENT)).astype(np.float32)
    log_sf = rng.normal(6.0, 0.1, size=(B,)).astype(np.float32)
    cond = {"clusters": np.array([0, 2], np.int32)}
    genes = np.arange(1, G + 1, dtype=np.int32)
    jdit = JaxDiT(**DIT_ARCH)
    dit_params = randomized_dit_params(jdit, jnp.asarray(z0), jnp.linspace(0.1, 0.9, B),
                                       {k: jnp.asarray(v) for k, v in cond.items()}, seed=13)
    jtask = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport())
    assert not jtask.algebraic_decode
    sample_ode = jtask.transport_sampler.sample_ode(sampling_method="euler", num_steps=3)

    def model_fn(x, t, condition=None):
        return jdit.apply(dit_params, x, t, condition, cfg_scale=GUIDANCE,
                          method="forward_with_cfg_batched")

    jz0 = jnp.asarray(z0)
    want_z = sample_ode(jnp.concatenate([jz0, jz0]), model_fn,
                        condition={k: jnp.asarray(np.concatenate([v, v])) for k, v in cond.items()})
    n_dit = len(jax_flash)
    sf = jnp.exp(jnp.asarray(log_sf)).reshape(-1, 1)
    want = jvae.apply(vae_params, want_z, jnp.asarray(genes), jnp.concatenate([sf, sf]),
                      method="decode")
    assert n_dit > 0 and len(jax_flash) > n_dit, "JAX's kernel did not run in the DiT and decoder"

    tdit = DiT(**DIT_ARCH)
    load_reference_state_dict(tdit, export_torch_state_dict(dit_params))
    task = LDMTask(tvae, tdit, create_transport())
    assert not task.algebraic_decode
    before = fa.FLASH_ATTENTION_LAUNCHES.count
    z, out, evals = task.generate_from_noise(
        torch.from_numpy(z0), torch.from_numpy(log_sf), torch.from_numpy(genes).long(),
        {k: torch.from_numpy(v).long() for k, v in cond.items()}, guidance_weight=GUIDANCE,
        sampling_method="euler", num_steps=3, fused_blocks=False)
    assert fa.FLASH_ATTENTION_LAUNCHES.count == before and evals == 2
    assert z.shape == (2 * B, T, LATENT) and out["mu"].shape == (2 * B, G)
    _near(z.numpy(), want_z, "samples")
    _near(out["mu"].numpy(), want["mu"], "mu")
