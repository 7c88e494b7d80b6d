"""The joint-conditioning slice (parse1m / replogle: two label classes, one
(n1, n2) size-factor table keyed by the pair) against the JAX package.

- `SizeFactorSampler`: the joint and per-label tables equal JAX's, built
  from both packages' `VocabularyEncoder` at both datasets' real label
  vocabularies (18 x 91 and 4 x 2,024, not square, so a swapped axis order
  shows); draws at sd = 0 equal JAX's (missing pairs give 0, indices are
  clamped as JAX's gather clamps them); the draws' moments; the per-label
  fallback and the zeros of JAX's constructor.
- The joint LDM path at a small size: one train step (the kernel path's
  plain versions and the module path) against JAX's at 1e-4, and
  `generate_from_noise` with joint CFG against JAX's at the tolerances of
  test_torch_port_slice.py, from injected noise and log size factors; then
  the port's whole sample function, whose conditional libraries track the
  joint table (JAX's criterion, tests/test_joint_conditioning.py)."""

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.data.encoder import VocabularyEncoder as JaxEncoder
from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.sampling.size_factors import SizeFactorSampler as JaxSampler
from scldm_tpu.sampling.size_factors import constant_stats as jax_constant_stats
from scldm_tpu.training.ema import ema_init as jax_ema_init
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.data.encoder import VocabularyEncoder
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_dit
from scldm_torch.ops.transforms import canonical_gene_ids
from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import load_reference_ema_, load_reference_state_dict
from tests.torch_port.test_torch_port_data import DATASETS, joint_stats, per_label_stats
from tests.torch_port.test_torch_port_dit import randomized_dit_params
from tests.torch_port.test_torch_port_ldm_train import jax_draws


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def encoders(dataset, sd=0.05, share=0.8, strategy="joint", reverse=False):
    """Both packages' encoders of `dataset` with joint statistics for about
    `share` of the pairs; `reverse` lists the two classes the other way round."""
    meta, vocab = DATASETS[dataset]
    if reverse:
        vocab = dict(reversed(list(vocab.items())))
    labels = json.loads(open(meta).read())["labels"]
    mu, sds = joint_stats(np.random.default_rng(0), labels, *vocab, share=share, sd=sd)
    kw = dict(metadata_json=meta, class_vocab_sizes=vocab, condition_strategy=strategy,
              mu_size_factor=mu, sd_size_factor=sds)
    return VocabularyEncoder(**kw), JaxEncoder(**kw)


def _np(t):
    return np.asarray(t)


# -- the sampler ------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_joint_table_matches_jax(dataset, reverse):
    enc, jenc = encoders(dataset, reverse=reverse)
    got, want = SizeFactorSampler(enc, "joint"), JaxSampler(jenc, "joint")
    c1, c2 = enc.class_vocab_sizes
    assert got.joint_components == want.joint_components == [c1, c2]
    shape = (enc.class_vocab_sizes[c1], enc.class_vocab_sizes[c2])
    for a, b in zip(got.joint_table, want.joint_table):
        assert a.dtype == torch.float32 and tuple(a.shape) == shape
        np.testing.assert_array_equal(a.numpy(), _np(b))
    mu = got.joint_table[0].numpy()
    assert 0.5 < (mu > 0).mean() < 1.0  # most pairs have statistics, not all
    assert got.tables == {}


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_joint_encoder_gives_the_joint_table_by_default(dataset):
    """Without a strategy the sampler takes the encoder's: a joint encoder
    gets the table JAX builds under an explicit "joint" (JAX's default is
    per-label, which raises a TypeError on the pair-keyed statistics)."""
    enc, jenc = encoders(dataset)
    got, want = SizeFactorSampler(enc), JaxSampler(jenc, "joint")
    assert got.strategy == "joint" and got.tables == {}
    for a, b in zip(got.joint_table, want.joint_table):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    with pytest.raises(TypeError):
        JaxSampler(jenc)
    # asked for per-label tables, a joint encoder has none: zeros
    per_label = SizeFactorSampler(enc, "mutually_exclusive")
    assert per_label.joint_table is None and per_label.tables == {}
    c1, c2 = enc.class_vocab_sizes
    cond = {c1: torch.tensor([0, 1]), c2: torch.tensor([2, 3])}
    assert torch.equal(per_label.sample(torch.Generator(), cond, 2, "cpu"), torch.zeros(2))


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_joint_samples_at_sd0_match_jax(dataset):
    """sd = 0: each draw is its pair's mu; pairs without statistics give 0;
    out-of-range indices (the null id n, n + 5, -1) are clamped as JAX's
    gather clamps them."""
    enc, jenc = encoders(dataset, sd=0.0)
    got, want = SizeFactorSampler(enc, "joint"), JaxSampler(jenc, "joint")
    c1, c2 = enc.class_vocab_sizes
    n1, n2 = enc.class_vocab_sizes[c1], enc.class_vocab_sizes[c2]
    rng = np.random.default_rng(1)
    i1 = np.concatenate([rng.integers(0, n1, 300), [n1, n1 + 5, -1, 0, n1 - 1]])
    i2 = np.concatenate([rng.integers(0, n2, 300), [0, n2 + 5, -1, n2, n2 - 1]])
    b = len(i1)
    draws = got.sample(torch.Generator().manual_seed(0),
                       {c2: torch.from_numpy(i2), c1: torch.from_numpy(i1)}, b, "cpu")
    jdraws = want.sample(jax.random.PRNGKey(0), {c2: jnp.asarray(i2), c1: jnp.asarray(i1)}, b)
    np.testing.assert_array_equal(draws.numpy(), _np(jdraws))
    mu = got.joint_table[0].numpy()
    np.testing.assert_array_equal(draws.numpy()[:300], mu[i1[:300], i2[:300]])
    assert (draws.numpy() == 0).any() and draws.dtype == torch.float32


def test_joint_sampler_moments():
    """JAX's moment test (tests/test_joint_conditioning.py), on the port."""

    class _E:
        class_vocab_sizes = {"a": 2, "b": 2}
        mu_size_factor = {"a_b": {"x0_y0": 5.0, "x1_y1": 9.0}}
        sd_size_factor = {"a_b": {"x0_y0": 0.5, "x1_y1": 0.5}}
        joint_key = "a_b"
        joint_components = ["a", "b"]
        joint_idx_2_classes = {"0_0": "x0_y0", "1_1": "x1_y1"}

    sfs = SizeFactorSampler(_E(), condition_strategy="joint")
    cond = {"a": torch.zeros(2000, dtype=torch.int32), "b": torch.zeros(2000, dtype=torch.int32)}
    out = sfs.sample(torch.Generator().manual_seed(0), cond, 2000, "cpu")
    assert out.mean().item() == pytest.approx(5.0, abs=0.1)
    assert out.std().item() == pytest.approx(0.5, rel=0.15)
    ones = {"a": torch.ones(2000, dtype=torch.int64), "b": torch.ones(2000, dtype=torch.int64)}
    assert sfs.sample(torch.Generator().manual_seed(1), ones, 2000, "cpu").mean().item() == \
        pytest.approx(9.0, abs=0.1)
    # a pair without statistics: mu = sd = 0, exactly 0
    mixed = {"a": torch.zeros(50, dtype=torch.int64), "b": torch.ones(50, dtype=torch.int64)}
    assert torch.equal(sfs.sample(torch.Generator(), mixed, 50, "cpu"), torch.zeros(50))


def test_per_label_fallback_when_joint_key_is_none():
    """JAX's constructor takes the per-label tables when the encoder has no
    joint key, under "joint" too; indices there are clipped."""
    vocab = {"cell_type": 4, "cytokine": 6}
    for strategy in ("joint", "mutually_exclusive"):
        got = SizeFactorSampler(constant_stats(vocab, mu=7.5, sd=0.0), strategy)
        want = JaxSampler(jax_constant_stats(vocab, mu=7.5, sd=0.0), strategy)
        assert got.joint_table is None and want.joint_table is None
        assert sorted(got.tables) == sorted(want.tables) == sorted(vocab)
        for k in vocab:
            for a, b in zip(got.tables[k], want.tables[k]):
                np.testing.assert_array_equal(a.numpy(), _np(b))
        idx = np.array([0, 3, 9, -2])
        cond = {"cytokine": idx}
        draws = got.sample(torch.Generator(), {k: torch.from_numpy(v) for k, v in cond.items()},
                           4, "cpu")
        jdraws = want.sample(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in cond.items()}, 4)
        np.testing.assert_array_equal(draws.numpy(), _np(jdraws))
        np.testing.assert_array_equal(draws.numpy(), np.full(4, 7.5, np.float32))


def test_per_label_tables_from_the_encoder_match_jax():
    meta, vocab = DATASETS["parse1m"]
    labels = json.loads(open(meta).read())["labels"]
    mu, sd = per_label_stats(np.random.default_rng(2), labels)
    kw = dict(metadata_json=meta, class_vocab_sizes=vocab, mu_size_factor=mu, sd_size_factor=sd)
    got, want = SizeFactorSampler(VocabularyEncoder(**kw)), JaxSampler(JaxEncoder(**kw))
    assert sorted(got.tables) == sorted(want.tables) == sorted(vocab)
    for k in vocab:
        for a, b in zip(got.tables[k], want.tables[k]):
            np.testing.assert_array_equal(a.numpy(), _np(b))
    # sd = 0 draws through the first label in sorted order, clipped
    zero = {k: {c: 0.0 for c in v} for k, v in sd.items()}
    kw.update(sd_size_factor=zero)
    got, want = SizeFactorSampler(VocabularyEncoder(**kw)), JaxSampler(JaxEncoder(**kw))
    idx = {"cytokine": np.array([0, 5, 90, 200]), "cell_type": np.array([17, 3, 0, -4])}
    draws = got.sample(torch.Generator(), {k: torch.from_numpy(v) for k, v in idx.items()}, 4,
                       "cpu")
    jdraws = want.sample(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in idx.items()}, 4)
    np.testing.assert_array_equal(draws.numpy(), _np(jdraws))


def test_zeros_without_statistics_or_condition():
    """A joint encoder without statistics, a missing condition, and a
    condition with one of the two joint labels: zeros, as in JAX."""
    meta, vocab = DATASETS["replogle"]
    kw = dict(metadata_json=meta, class_vocab_sizes=vocab, condition_strategy="joint")
    got, want = SizeFactorSampler(VocabularyEncoder(**kw), "joint"), \
        JaxSampler(JaxEncoder(**kw), "joint")
    assert got.joint_table is None and got.tables == {} and want.joint_table is None
    cond = {"cell_line": np.array([0, 3]), "gene": np.array([5, 2000])}
    for c in (cond, None, {"gene": cond["gene"]}):
        tc = None if c is None else {k: torch.from_numpy(v) for k, v in c.items()}
        jc = None if c is None else {k: jnp.asarray(v) for k, v in c.items()}
        np.testing.assert_array_equal(got.sample(torch.Generator(), tc, 2, "cpu").numpy(),
                                      _np(want.sample(jax.random.PRNGKey(0), jc, 2)))
    enc, jenc = encoders("replogle")
    full = SizeFactorSampler(enc, "joint")
    one = {"gene": torch.from_numpy(cond["gene"])}
    assert torch.equal(full.sample(torch.Generator(), one, 2, "cpu"), torch.zeros(2))
    np.testing.assert_array_equal(
        _np(JaxSampler(jenc, "joint").sample(jax.random.PRNGKey(0),
                                             {"gene": jnp.asarray(cond["gene"])}, 2)),
        np.zeros(2, np.float32))


# -- the joint LDM path ------------------------------------------------------------------

N_GENES, B = 30, 8
# not square, and listed against the sorted order the DiT sums its embeddings in
VOCAB = {"cytokine": 5, "cell_type": 3}
VAE_ARCH = dict(n_genes=N_GENES, n_embed=16, n_embed_latent=8, n_layer=1, n_inducing_points=4,
                n_head=2, n_head_cross=2)
DIT_ARCH = dict(n_embed=32, n_embed_input=8, n_layer=2, n_head=2, seq_len=4,
                class_vocab_sizes=VOCAB, cfg_dropout_prob=0.5, condition_strategy="joint")
TASK = dict(num_training_steps=10, ema_update_every=1, ema_update_after_step=0)
GUIDANCE = {"cytokine": 1.0, "cell_type": 1.0}
LR = 5e-4


def joint_batch(seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(2.0, (B, N_GENES)).astype(np.float32)
    genes = np.tile(np.arange(1, N_GENES + 1), (B, 1)).astype(np.int32)
    return {"counts": counts, "genes": genes, "library_size": counts.sum(1, keepdims=True),
            "counts_subset": counts[:, :10], "genes_subset": genes[:, :10],
            "cytokine": rng.integers(0, 5, B).astype(np.int32),
            "cell_type": rng.integers(0, 3, B).astype(np.int32)}


@pytest.fixture(scope="module")
def joint_setup():
    """JAX's LDMTask with a joint DiT whose zero-init layers are redrawn."""
    with jax.default_matmul_precision("highest"):
        batch = {k: jnp.asarray(v) for k, v in joint_batch().items()}
        jvae = jax_build_vae(**VAE_ARCH)
        vae_params = jvae.init(jax.random.PRNGKey(1), batch["counts"], batch["genes"],
                               batch["library_size"], batch["counts_subset"],
                               batch["genes_subset"])
        jdit = JaxDiT(**DIT_ARCH)
        jtask = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), learning_rate=LR,
                           **TASK)
        # a state key whose step draws a CFG drop mask that keeps some rows
        # and drops others (with key 2 every row drops)
        state = jtask.init_state(jax.random.PRNGKey(3), batch)
        z = jtask._encode(batch)
        cond = {k: batch[k] for k in VOCAB}
        params = randomized_dit_params(jdit, jnp.zeros(z.shape),
                                       jnp.linspace(0.1, 0.9, z.shape[0]), cond, seed=3)
        state = state.replace(params=params, opt_state=jtask.tx.init(params),
                              ema=jax_ema_init(params["params"]))
    return jtask, vae_params, state, batch


def port_task(vae_params, state, **kw):
    tvae = build_transformer_vae(**VAE_ARCH, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(vae_params))
    tdit = DiT(**DIT_ARCH)
    load_reference_state_dict(tdit, export_torch_state_dict(state.params))
    task = LDMTask(tvae, tdit, create_transport(), learning_rate=LR, **TASK, **kw)
    tstate = task.init_state(torch.Generator().manual_seed(0))
    load_reference_ema_(tstate.ema, export_torch_state_dict(state.ema.params))
    return task, tstate


@pytest.mark.parametrize("path", ["kernel", "module"])
def test_joint_train_step_matches_jax(joint_setup, path):
    """One step from the same parameters, batch and draws (JAX's t, x0 and
    CFG drop mask): loss and gradient norm to 1e-4 relative, the parameters
    after it to a tenth of the step AdamW takes."""
    jtask, vae_params, state, batch = joint_setup
    task, tstate = port_task(vae_params, state, fused_training=path == "kernel")
    noise = jax_draws(jtask, state, batch)
    assert noise["drop_mask"].any() and not noise["drop_mask"].all()
    new_state, want = jax.jit(jtask._train_step_impl)(state, batch, vae_params)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    bwd = fused_dit.DIT_BLOCK_BWD_LAUNCHES.count
    tstate, mets = task.train_step(tstate, tbatch, noise)
    assert fused_dit.DIT_BLOCK_BWD_LAUNCHES.count == bwd  # CPU: the plain version
    for k in ("train_loss", "grad_norm", "lr_mult"):
        np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-4)
    step = LR * float(want["lr_mult"])
    want_p = export_torch_state_dict(new_state.params)
    for name, p in tstate.module.named_parameters():
        g = p.grad.abs().numpy()
        sure = g > 1e-4 * (g.max() + 1e-30)
        assert np.abs(p.detach().numpy() - want_p[name])[sure].max(initial=0.0) <= 0.1 * step, name
    # both class tables moved: the joint embedding sums them
    for name in ("class_embeddings.cytokine.weight", "class_embeddings.cell_type.weight"):
        assert float(tstate.module.get_parameter(name).grad.abs().max()) > 0, name


def _jax_generate(jtask, dit_params, vae_params, z0, log_sf, genes, cond, method, steps):
    """JAX's sampler program off the TPU (module DiT path, joint CFG), with
    the draws injected."""
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


@pytest.mark.parametrize("fused_blocks", [True, False])
@pytest.mark.parametrize("method,steps,tol", [("euler", 8, 1e-4), ("heun", 5, 1e-4),
                                              ("dopri5", 50, 1e-3)])
def test_joint_generation_matches_jax(joint_setup, method, steps, tol, fused_blocks):
    """Injected prior noise and the joint table's log size factors (sd = 0:
    both samplers give each pair's mu, missing pairs 0)."""
    jtask, vae_params, state, batch = joint_setup
    task, _ = port_task(vae_params, state)
    rng = np.random.default_rng(4)
    z0 = rng.normal(size=(B, 4, 8)).astype(np.float32)
    cond = {k: np.array(batch[k]) for k in VOCAB}
    enc, jenc = synthetic_encoders(sd=0.0)
    log_sf = SizeFactorSampler(enc, "joint").sample(
        torch.Generator(), {k: torch.from_numpy(v) for k, v in cond.items()}, B, "cpu")
    jlog_sf = JaxSampler(jenc, "joint").sample(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in cond.items()}, B)
    np.testing.assert_array_equal(log_sf.numpy(), _np(jlog_sf))
    genes = np.arange(1, N_GENES + 1, dtype=np.int32)
    want_z, want = _jax_generate(jtask, state.params, vae_params, jnp.asarray(z0), jlog_sf,
                                 jnp.asarray(genes), {k: jnp.asarray(v) for k, v in cond.items()},
                                 method, steps)
    before = fused_dit.DIT_BLOCK_LAUNCHES.count
    z, out, evals = task.generate_from_noise(
        torch.from_numpy(z0), log_sf, canonical_gene_ids(N_GENES, device="cpu"),
        {k: torch.from_numpy(v).long() for k, v in cond.items()}, guidance_weight=GUIDANCE,
        sampling_method=method, num_steps=steps, fused_blocks=fused_blocks)
    assert fused_dit.DIT_BLOCK_LAUNCHES.count == before
    np.testing.assert_allclose(z.numpy(), _np(want_z), rtol=tol, atol=tol)
    for k in ("mu", "theta"):
        np.testing.assert_allclose(out[k].numpy(), _np(want[k]), rtol=tol, atol=tol)


def synthetic_encoders(sd=0.1):
    """Both packages' joint encoders over the batch's vocabulary: mu = 3 +
    i + j for pair (cytokine i, cell type j) (JAX's test_joint_cfg_generation
    layout), one pair left without statistics."""
    labels = {"cytokine": [f"k{i}" for i in range(5)], "cell_type": [f"t{j}" for j in range(3)]}
    meta = {"genes": [f"g{i}" for i in range(N_GENES)], "labels": labels}
    pairs = [(i, j) for i in range(5) for j in range(3) if (i, j) != (4, 2)]
    mu = {"cytokine_cell_type": {f"k{i}_t{j}": 3.0 + i + j for i, j in pairs}}
    sds = {"cytokine_cell_type": {f"k{i}_t{j}": sd for i, j in pairs}}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/meta.json"
        with open(path, "w") as f:
            json.dump(meta, f)
        kw = dict(metadata_json=path, class_vocab_sizes=VOCAB, condition_strategy="joint",
                  mu_size_factor=mu, sd_size_factor=sds)
        return VocabularyEncoder(**kw), JaxEncoder(**kw)


@pytest.mark.parametrize("fused_blocks", [True, False])
def test_joint_sample_fn_tracks_the_table(joint_setup, fused_blocks):
    """The port's whole sample function with the joint sampler: the log of
    each conditional cell's library correlates with its pair's mu at 0.7 or
    more (JAX's criterion); deterministic under one seed; labels decode back
    to the requested categories."""
    _, vae_params, state, _ = joint_setup
    task, _ = port_task(vae_params, state)
    enc, _ = synthetic_encoders()
    sfs = SizeFactorSampler(enc, "joint")
    rng = np.random.default_rng(5)
    n = 48
    pairs = [(i, j) for i in range(5) for j in range(3) if (i, j) != (4, 2)]
    chosen = [pairs[k] for k in rng.integers(0, len(pairs), n)]
    cats = {"cytokine": [f"k{i}" for i, _ in chosen], "cell_type": [f"t{j}" for _, j in chosen]}
    cond = {k: torch.from_numpy(enc.encode_metadata(v, k)) for k, v in cats.items()}
    fn = task.make_sample_fn(sfs, guidance_weight=GUIDANCE, sampling_method="euler", num_steps=4,
                             fused_blocks=fused_blocks)
    counts, z = fn(torch.Generator().manual_seed(6), canonical_gene_ids(N_GENES, device="cpu"),
                   cond)
    assert counts.shape == (2 * n, N_GENES) and torch.isfinite(counts).all()
    lib = np.log(counts[n:].sum(1).numpy() + 1e-6)
    want = np.array([3.0 + i + j for i, j in chosen])
    assert np.corrcoef(lib, want)[0, 1] > 0.7
    again, _ = fn(torch.Generator().manual_seed(6), canonical_gene_ids(N_GENES, device="cpu"),
                  cond)
    assert torch.equal(counts, again)
    for k, v in cats.items():
        assert list(enc.decode_metadata(cond[k].numpy(), k)) == v
