"""The port's TransformerVAE against the flax module, weights moved by the
bridge. Tolerance 1e-4 (f32 on both sides, sums in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops.transforms import canonical_gene_ids
from scldm_torch.utils.weights import init_reference_, load_reference_state_dict

G, E, E_LAT, M, N_LAYER, N_HEAD, N_HEAD_X, B, S = 50, 16, 8, 4, 2, 4, 2, 3, 20
ARCH = dict(n_genes=G, n_embed=E, n_embed_latent=E_LAT, n_layer=N_LAYER, n_inducing_points=M,
            n_head=N_HEAD, n_head_cross=N_HEAD_X)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    counts = rng.poisson(2.0, size=(B, G)).astype(np.float32)
    genes = np.tile(np.arange(1, G + 1), (B, 1)).astype(np.int32)
    lib = counts.sum(1, keepdims=True)
    c_sub, g_sub = counts[:, :S], genes[:, :S]
    jvae = jax_build_vae(**ARCH)
    with jax.default_matmul_precision("highest"):
        params = jvae.init(jax.random.PRNGKey(0), *map(jnp.asarray, (counts, genes, lib, c_sub, g_sub)))
    tvae = build_transformer_vae(**ARCH, device="cpu").eval()
    load_reference_state_dict(tvae, export_torch_state_dict(params), strict=True)
    return jvae, params, tvae, (counts, genes, lib, c_sub, g_sub)


def test_encode_matches_flax(pair):
    jvae, params, tvae, (counts, genes, _, c_sub, g_sub) = pair
    want = jvae.apply(params, jnp.asarray(counts), jnp.asarray(genes),
                      jnp.asarray(c_sub), jnp.asarray(g_sub), method="encode")
    with torch.no_grad():
        got = tvae.encode(torch.from_numpy(counts), torch.from_numpy(genes).long(),
                          torch.from_numpy(c_sub), torch.from_numpy(g_sub).long())
    assert got.shape == (B, M, E_LAT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gene_layout", ["shared_1d", "per_cell_2d"])
def test_decode_matches_flax(pair, gene_layout):
    jvae, params, tvae, _ = pair
    rng = np.random.default_rng(1)
    z = rng.normal(size=(B, M, E_LAT)).astype(np.float32)
    lib = rng.uniform(500, 2000, size=(B, 1)).astype(np.float32)
    if gene_layout == "shared_1d":
        genes = np.arange(1, G + 1, dtype=np.int32)
        np.testing.assert_array_equal(canonical_gene_ids(G, device="cpu").numpy(), genes)
    else:
        genes = np.stack([rng.permutation(G)[:30] + 1 for _ in range(B)]).astype(np.int32)
    want = jvae.apply(params, jnp.asarray(z), jnp.asarray(genes), jnp.asarray(lib), method="decode")
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z), torch.from_numpy(genes).long(), torch.from_numpy(lib))
    np.testing.assert_allclose(got["mu"].numpy(), np.asarray(want["mu"]), **TOL)
    np.testing.assert_allclose(got["theta"].numpy(), np.asarray(want["theta"]), **TOL)
    # the NB mean sums to the library size over the decoded genes
    np.testing.assert_allclose(got["mu"].sum(1, keepdim=True).numpy(), lib, rtol=1e-4)


def test_init_reference_is_seeded_and_follows_reference_inits():
    a = init_reference_(build_transformer_vae(**ARCH, device="cpu"), torch.Generator().manual_seed(3))
    b = init_reference_(build_transformer_vae(**ARCH, device="cpu"), torch.Generator().manual_seed(3))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    sd = a.state_dict()
    assert torch.all(sd["decoder_head.theta.weight"] == 1.0)
    assert torch.all(sd["encoder.pos_embed"] == 0.0)
    assert torch.all(sd["encoder.encoder_layers.0.ln_1.weight"] == 1.0)
    assert 0.8 < sd["input_layer.gene_embedding.weight"].std() < 1.2
