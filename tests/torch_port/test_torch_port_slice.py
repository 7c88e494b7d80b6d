"""The generation slice as a whole: the JAX LDMTask's sampler and decode
against the port's LDMTask, from the same injected prior noise and log size
factors (the random draws cannot match across two RNGs). Then the port's
own sampling pieces: NB draws, size factors, the whole sample function, and
that `scldm_torch` imports without jax."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_dit
from scldm_torch.ops.distributions import nb_mean, nb_sample
from scldm_torch.ops.transforms import canonical_gene_ids
from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import init_reference_, load_reference_state_dict
from tests.torch_port.test_torch_port_dit import randomized_dit_params

G, E, E_LAT, M, B = 50, 16, 8, 4, 3
VAE_ARCH = dict(n_genes=G, n_embed=E, n_embed_latent=E_LAT, n_layer=2, n_inducing_points=M,
                n_head=4, n_head_cross=2)
DIT_ARCH = dict(n_embed=64, n_embed_input=E_LAT, n_layer=2, n_head=4, seq_len=M,
                class_vocab_sizes={"clusters": 5}, cfg_dropout_prob=0.8)
GUIDANCE = {"clusters": 1.0}


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def tasks():
    rng = np.random.default_rng(0)
    counts = rng.poisson(2.0, size=(B, G)).astype(np.float32)
    genes = np.tile(np.arange(1, G + 1), (B, 1)).astype(np.int32)
    jvae = jax_build_vae(**VAE_ARCH)
    with jax.default_matmul_precision("highest"):
        vae_params = jvae.init(jax.random.PRNGKey(0), jnp.asarray(counts), jnp.asarray(genes),
                               jnp.asarray(counts.sum(1, keepdims=True)),
                               jnp.asarray(counts[:, :20]), jnp.asarray(genes[:, :20]))
        jdit = JaxDiT(**DIT_ARCH)
        x = jnp.zeros((B, M, E_LAT))
        dit_params = randomized_dit_params(
            jdit, x, jnp.linspace(0.1, 0.9, B), {"clusters": jnp.arange(B) % 5})
    jtask = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), num_training_steps=10)

    tvae = build_transformer_vae(**VAE_ARCH).eval()
    load_reference_state_dict(tvae, export_torch_state_dict(vae_params))
    tdit = DiT(**DIT_ARCH).eval()
    load_reference_state_dict(tdit, export_torch_state_dict(dit_params))
    ttask = LDMTask(tvae, tdit, create_transport())
    return jtask, dit_params, vae_params, ttask


def _jax_generate(jtask, dit_params, vae_params, z0, log_sf, genes, cond, method, steps):
    """make_sample_fn's program off the TPU (module DiT path), with the
    draws injected."""
    sample_ode = jtask.transport_sampler.sample_ode(sampling_method=method, num_steps=steps)
    z_cfg = jnp.concatenate([z0, z0])
    cond_cfg = {k: jnp.concatenate([v, v]) for k, v in cond.items()}

    def model_fn(x, t, condition=None):
        return jtask.dit.apply(dit_params, x, t, condition, cfg_scale=GUIDANCE,
                               method="forward_with_cfg_batched")

    samples = sample_ode(z_cfg, model_fn, condition=cond_cfg)
    sf = jnp.exp(log_sf).reshape(-1, 1)
    out = jtask.vae.apply(vae_params, samples, genes, jnp.concatenate([sf, sf]), method="decode")
    return samples, out


@pytest.mark.parametrize("method,steps,tol", [("euler", 8, 1e-4), ("heun", 5, 1e-4),
                                              ("dopri5", 50, 1e-3)])
def test_generation_matches_jax(tasks, method, steps, tol):
    jtask, dit_params, vae_params, ttask = tasks
    rng = np.random.default_rng(1)
    z0 = rng.normal(size=(B, M, E_LAT)).astype(np.float32)
    log_sf = rng.normal(6.0, 0.1, size=(B,)).astype(np.float32)
    cond = {"clusters": np.array([0, 3, 4], np.int32)}
    genes = np.arange(1, G + 1, dtype=np.int32)
    want_z, want = _jax_generate(jtask, dit_params, vae_params, jnp.asarray(z0),
                                 jnp.asarray(log_sf), jnp.asarray(genes),
                                 {k: jnp.asarray(v) for k, v in cond.items()}, method, steps)
    z, out, evals = ttask.generate_from_noise(
        torch.from_numpy(z0), torch.from_numpy(log_sf), canonical_gene_ids(G),
        {"clusters": torch.from_numpy(cond["clusters"]).long()},
        guidance_weight=GUIDANCE, sampling_method=method, num_steps=steps)
    assert evals == {"euler": steps - 1, "heun": 2 * (steps - 1)}.get(method, evals)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=tol, atol=tol)
    for k in ("mu", "theta"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=tol, atol=tol)


def test_sample_fn_end_to_end_on_cpu(tasks):
    """The whole sample function on CPU tensors: shapes, finiteness, integer
    counts, determinism under one seed, and no kernel launch."""
    *_, ttask = tasks
    fn = ttask.make_sample_fn(SizeFactorSampler(constant_stats({"clusters": 5})),
                              guidance_weight=GUIDANCE, sampling_method="euler", num_steps=6)
    cond = {"clusters": torch.tensor([0, 1, 4])}
    before = fused_dit.DIT_BLOCK_LAUNCHES.count
    counts, z = fn(torch.Generator().manual_seed(5), canonical_gene_ids(G), cond)
    assert fused_dit.DIT_BLOCK_LAUNCHES.count == before
    assert fn.drift_evals == 5
    assert counts.shape == (2 * B, G) and z.shape == (2 * B, M, E_LAT)
    assert torch.isfinite(z).all() and torch.isfinite(counts).all()
    assert (counts >= 0).all() and (counts == counts.round()).all()
    again, z2 = fn(torch.Generator().manual_seed(5), canonical_gene_ids(G), cond)
    assert torch.equal(counts, again) and torch.equal(z, z2)


def test_nb_sample_moments_and_determinism():
    mu = torch.tensor([[0.5, 3.0, 40.0]]).expand(40_000, 3)
    theta = torch.tensor([0.3, 2.0, 10.0])
    x = nb_sample(mu, theta, torch.Generator().manual_seed(0))
    assert x.dtype == torch.float32 and (x >= 0).all() and (x == x.round()).all()
    mean, var = x.mean(0), x.var(0)
    want_var = mu[0] + mu[0] ** 2 / theta
    torch.testing.assert_close(mean, nb_mean(mu[0], theta), rtol=0.03, atol=0.02)
    torch.testing.assert_close(var, want_var, rtol=0.08, atol=0.05)
    y = nb_sample(mu, theta, torch.Generator().manual_seed(0))
    assert torch.equal(x, y)
    assert not torch.equal(x, nb_sample(mu, theta, torch.Generator().manual_seed(1)))


def test_size_factor_sampler():
    sfs = SizeFactorSampler(constant_stats({"clusters": 4}, mu=8.6, sd=0.3))
    cond = {"clusters": torch.tensor([0, 1, 2, 3] * 5000)}
    draws = sfs.sample(torch.Generator().manual_seed(0), cond, 20_000)
    assert abs(draws.mean().item() - 8.6) < 0.02 and abs(draws.std().item() - 0.3) < 0.02
    assert torch.equal(sfs.sample(torch.Generator(), None, 3), torch.zeros(3))


def test_random_dit_is_not_identity():
    dit = init_reference_(DiT(**DIT_ARCH), torch.Generator().manual_seed(0), zero_init=False)
    with torch.no_grad():
        out = dit(torch.zeros(2, M, E_LAT), torch.tensor([0.2, 0.7]))
    assert out.abs().max() > 1e-3


def test_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import scldm_torch.training.ldm_task, scldm_torch.utils.weights, scldm_torch.kernels.build\n"
        "import scldm_torch.training.vae_task, scldm_torch.training.optim, scldm_torch.training.state\n"
        "import scldm_torch.training.metrics, scldm_torch.ops.fused_decoder\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
