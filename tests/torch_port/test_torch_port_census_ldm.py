"""The census LDM slice against the JAX package: `LDMTask`'s generation
options (the algebraic decode, its output-projection fold and fused gate),
one training step of a DiT over T = 64 latent tokens, and generation through
the algebraic decode, with the DiT on the kernel path (on CPU tensors, the
kernels' plain versions) and on the module path (`fused_blocks=False`).

Size: a census-like pair cut to run on the CPU in seconds: the VAE at E = 256
(so that the algebraic decode resolves on, as at the census E = 512), 8 self
and 8 cross heads, 64 inducing points, a 64-wide latent, one layer, G = 300
genes; the DiT at T = 64 (the inducing points), E = 64, 4 heads, 2 layers,
its adaLN and final layers drawn non-zero. Weights go across with
`export_torch_state_dict`; inputs and injected draws come from numpy or from
JAX's keys, as in test_torch_port_ldm_train.py.

Tolerances: f32 on both sides, sums in other orders. The train step's loss
and gradient norm at 1e-4 relative; generation's latents and mu at rtol =
1e-4 (mu's atol 1e-4 of its largest), dopri5 at 1e-3 (its adaptive steps
amplify rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.training.ema import ema_init as jax_ema_init
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_dit
from scldm_torch.ops.transforms import canonical_gene_ids
from scldm_torch.training import ldm_task as tlt
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import load_reference_state_dict
from tests.test_training import make_batch
from tests.torch_port.test_torch_port_dit import randomized_dit_params
from tests.torch_port.test_torch_port_ldm_train import jax_draws, to_torch

G, B = 300, 3
VAE_ARCH = dict(n_genes=G, n_embed=256, n_embed_latent=64, n_layer=1, n_inducing_points=64,
                n_head=8, n_head_cross=8, multiple_of=64)
DIT_ARCH = dict(n_embed=64, n_embed_input=64, n_layer=2, n_head=4, seq_len=64,
                class_vocab_sizes={"clusters": 3}, cfg_dropout_prob=0.8)
TASK = dict(num_training_steps=10, ema_update_every=1, ema_update_after_step=0)
GUIDANCE = {"clusters": 1.0}


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def setup():
    """JAX's census-like LDMTask and a DiT state with its zero-init layers
    redrawn (adaLN-zero would make every block the identity)."""
    with jax.default_matmul_precision("highest"):
        batch = make_batch(jax.random.PRNGKey(0), n_genes=G, batch=B)
        jvae = jax_build_vae(**VAE_ARCH)
        vae_params = jvae.init(jax.random.PRNGKey(0), batch["counts"], batch["genes"],
                               batch["library_size"], batch["counts_subset"],
                               batch["genes_subset"])
        jdit = JaxDiT(**DIT_ARCH)
        jtask = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), **TASK)
        state = jtask.init_state(jax.random.PRNGKey(3), batch)
        z = jtask._encode(batch)
        params = randomized_dit_params(jdit, jnp.zeros(z.shape), jnp.linspace(0.1, 0.9, B),
                                       {"clusters": batch["clusters"]}, seed=1)
        state = state.replace(params=params, opt_state=jtask.tx.init(params),
                              ema=jax_ema_init(params["params"]))
    return jtask, vae_params, state, batch


def port_task(vae_params, dit_params, **kw):
    tvae = build_transformer_vae(**VAE_ARCH, device="cpu").eval()
    load_reference_state_dict(tvae, export_torch_state_dict(vae_params))
    tdit = DiT(**DIT_ARCH)
    load_reference_state_dict(tdit, export_torch_state_dict(dit_params))
    return LDMTask(tvae, tdit, create_transport(), **TASK, **kw)


# -- options ------------------------------------------------------------------------

@pytest.mark.parametrize("E,kw", [
    (256, {}),
    (256, {"algebraic_fused_gate": True}),
    (256, {"algebraic_vw_fold": False}),
    (256, {"algebraic_decode": False, "algebraic_fused_gate": True}),
    (48, {}),
    (48, {"algebraic_fused_gate": True}),
    (48, {"algebraic_decode": True}),
    (48, {"algebraic_decode": True, "algebraic_vw_fold": False, "algebraic_fused_gate": True}),
])
def test_options_resolve_as_jax(E, kw):
    """algebraic_decode on at E > 128 unless refused, the fold with it, the
    fused gate only when asked and only with the decode (JAX
    `LDMTask.__init__`)."""
    arch = {**VAE_ARCH, "n_embed": E}
    jtask = JaxLDMTask(jax_build_vae(**arch), None, JaxDiT(**DIT_ARCH), jax_create_transport(),
                       **kw)
    task = LDMTask(build_transformer_vae(**arch, device="meta"), DiT(**DIT_ARCH),
                   create_transport(), **kw)
    flags = ("algebraic_decode", "algebraic_vw_fold", "algebraic_fused_gate")
    assert [getattr(task, f) for f in flags] == [bool(getattr(jtask, f)) for f in flags]


def test_census_options_default_on():
    """At the census widths (E = 512) the decode and the fold resolve on and
    the gate stays off, on the meta device (no memory)."""
    vae = build_transformer_vae(n_genes=36_601, n_embed=512, n_embed_latent=64, n_layer=16,
                                n_inducing_points=64, n_head=8, n_head_cross=8, multiple_of=64,
                                device="meta")
    task = LDMTask(vae, DiT(**{**DIT_ARCH, "n_embed": 256, "n_head": 8, "n_layer": 8}),
                   create_transport())
    assert task.algebraic_decode and task.algebraic_vw_fold and not task.algebraic_fused_gate


# -- training ------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["kernel", "module"])
def test_train_step_matches_jax(setup, path):
    """One step from the same parameters, batch and draws: the loss and the
    gradient norm at 1e-4 relative."""
    jtask, vae_params, state, batch = setup
    noise = jax_draws(jtask, state, batch)
    _, want = jax.jit(jtask._train_step_impl)(state, batch, vae_params)
    task = port_task(vae_params, state.params, fused_training=path == "kernel")
    tstate = task.init_state(torch.Generator().manual_seed(0))
    before = fused_dit.DIT_BLOCK_BWD_LAUNCHES.count
    tstate, mets = task.train_step(tstate, to_torch(batch), noise)
    assert fused_dit.DIT_BLOCK_BWD_LAUNCHES.count == before  # CPU: the plain version
    for k in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-4)


# -- generation ------------------------------------------------------------------------

def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    z0 = rng.normal(size=(B, 64, 64)).astype(np.float32)
    log_sf = rng.normal(6.0, 0.1, size=(B,)).astype(np.float32)
    return z0, log_sf, {"clusters": np.array([0, 2, 1], np.int32)}


def _jax_generate(jtask, dit_params, vae_params, z0, log_sf, genes, cond, method, steps,
                  algebraic):
    """make_sample_fn's program off the TPU (the module DiT path), with the
    draws injected; the decode as its `alg_decode` routes it, the Pallas
    swiglu_vec in interpret mode."""
    sample_ode = jtask.transport_sampler.sample_ode(sampling_method=method, num_steps=steps)
    cond_cfg = {k: jnp.concatenate([v, v]) for k, v in cond.items()}

    def model_fn(x, t, condition=None):
        return jtask.dit.apply(dit_params, x, t, condition, cfg_scale=GUIDANCE,
                               method="forward_with_cfg_batched")

    samples = sample_ode(jnp.concatenate([z0, z0]), model_fn, condition=cond_cfg)
    sf = jnp.exp(log_sf).reshape(-1, 1)
    sf_cfg = jnp.concatenate([sf, sf])
    if algebraic:
        out = jvt.algebraic_decode(jtask.vae, vae_params, samples, sf_cfg,
                                   vw_fold=jtask.algebraic_vw_fold,
                                   fused_gate=jtask.algebraic_fused_gate, interpret=True)
    else:
        out = jtask.vae.apply(vae_params, samples, genes, sf_cfg, method="decode")
    return samples, out


def _assert_generation(z, out, want_z, want, tol):
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=tol, atol=tol)
    mu = np.asarray(want["mu"])
    np.testing.assert_allclose(out["mu"].numpy(), mu, rtol=tol, atol=tol * np.abs(mu).max())
    np.testing.assert_allclose(out["theta"].numpy(), np.asarray(want["theta"]), rtol=1e-6)


@pytest.mark.parametrize("method,steps,tol", [("euler", 6, 1e-4), ("dopri5", 50, 1e-3)])
@pytest.mark.parametrize("kw", [{}, {"algebraic_fused_gate": True},
                                {"algebraic_vw_fold": False}])
def test_generation_through_the_algebraic_decode_matches_jax(setup, kw, method, steps, tol):
    """The canonical gene row: the decode is `algebraic_decode` on both
    sides, with the task's fold and gate; the denoiser the kernel path and
    the module path (`fused_blocks=False`), the same numbers."""
    jtask, vae_params, state, _ = setup
    jtask_kw = JaxLDMTask(jtask.vae, vae_params, jtask.dit, jax_create_transport(), **TASK, **kw)
    assert jtask_kw.algebraic_decode
    z0, log_sf, cond = _inputs()
    genes = np.arange(1, G + 1, dtype=np.int32)
    want_z, want = _jax_generate(jtask_kw, state.params, vae_params, jnp.asarray(z0),
                                 jnp.asarray(log_sf), jnp.asarray(genes),
                                 {k: jnp.asarray(v) for k, v in cond.items()}, method, steps,
                                 algebraic=True)
    task = port_task(vae_params, state.params, **kw)
    calls = []
    real = tlt.algebraic_decode
    for fused in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tlt, "algebraic_decode", lambda *a, **k: calls.append(k) or real(*a, **k))
            z, out, _ = task.generate_from_noise(
                torch.from_numpy(z0), torch.from_numpy(log_sf), canonical_gene_ids(G, device="cpu"),
                {"clusters": torch.from_numpy(cond["clusters"]).long()}, guidance_weight=GUIDANCE,
                sampling_method=method, num_steps=steps, fused_blocks=fused)
        _assert_generation(z, out, want_z, want, tol)
    flags = {"fused_gate": jtask_kw.algebraic_fused_gate, "vw_fold": jtask_kw.algebraic_vw_fold}
    assert calls == [flags, flags]


@pytest.mark.parametrize("which", ["reversed", "per_cell"])
def test_other_genes_take_the_module_decode(setup, which):
    """Genes other than the canonical row 1..G (JAX checks on the host, once
    per call) decode through the module, on both sides."""
    jtask, vae_params, state, _ = setup
    z0, log_sf, cond = _inputs(seed=2)
    genes = np.arange(G, 0, -1, dtype=np.int32)
    if which == "per_cell":
        genes = np.tile(np.arange(1, G + 1, dtype=np.int32), (B, 1))
    jgenes = jnp.asarray(genes) if genes.ndim == 1 else jnp.asarray(np.concatenate([genes, genes]))
    want_z, want = _jax_generate(jtask, state.params, vae_params, jnp.asarray(z0),
                                 jnp.asarray(log_sf), jgenes,
                                 {k: jnp.asarray(v) for k, v in cond.items()}, "euler", 4,
                                 algebraic=False)
    task = port_task(vae_params, state.params)
    assert task.algebraic_decode
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlt, "algebraic_decode", lambda *a, **k: calls.append(k))
        z, out, _ = task.generate_from_noise(
            torch.from_numpy(z0), torch.from_numpy(log_sf), torch.from_numpy(genes).long(),
            {"clusters": torch.from_numpy(cond["clusters"]).long()}, guidance_weight=GUIDANCE,
            sampling_method="euler", num_steps=4)
    assert calls == []
    _assert_generation(z, out, want_z, want, 1e-4)


def test_sample_fn_takes_the_options(setup):
    """`make_sample_fn(fused_blocks=False)` runs the module denoiser (no
    block through `dit_block`) and gives what the kernel path gives."""
    jtask, vae_params, state, _ = setup
    task = port_task(vae_params, state.params)
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats

    sfs = SizeFactorSampler(constant_stats({"clusters": 3}))
    cond = {"clusters": torch.tensor([0, 1])}
    outs, counted = [], []
    for fused in (True, False):
        fn = task.make_sample_fn(sfs, guidance_weight=GUIDANCE, sampling_method="euler",
                                 num_steps=3, fused_blocks=fused)
        calls = []
        real = fused_dit.dit_block
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fused_dit, "dit_block", lambda *a: calls.append(1) or real(*a))
            outs.append(fn(torch.Generator().manual_seed(4), canonical_gene_ids(G, device="cpu"),
                           cond))
        counted.append((len(calls), fn.drift_evals))
    assert counted == [(2 * 2, 2), (0, 2)]
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-4)
    assert outs[0][0].shape == (4, G)
