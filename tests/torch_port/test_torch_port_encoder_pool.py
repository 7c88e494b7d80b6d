"""The port's encoder pools (scldm_torch.ops.fused_encoder, through
`training/vae_task.fused_encoder_pooling` and `fused_window_pooling`) against
the JAX Pallas kernels run in interpret mode, on the same weights and numpy
inputs, and the dispatch gates against JAX's.

Shapes: the dense pool at G=60 genes over an S=50 window (the port and JAX
both take G - S = 10 zero rows out) and at G=1100 over S=1000 (JAX pads the
gene axis to 2048 and takes 1048 out, the port 100); the window pool at
S=50 and at a ragged S=1030 (JAX pads to 2048 and takes 1018 out, the port
pads nothing). The two sides compare at the pooled (B, M, E) tokens and at
the module parameters' gradients, so the kernels' layouts do not matter.

Both sides round the same operands to bf16 and accumulate in f32 (the port's
plain version on CPU tensors). Tolerances: the pooled tokens within 1e-3 of
their largest magnitude (largest gap seen 4.8e-04, where JAX streams two
1024-token tiles and rounds each tile's exponentials against its running
max; 7e-07 in one tile); each gradient within 1e-2 of its own largest
(largest gap seen 6.4e-03: JAX also rounds its reduced gradients to bf16 per
tile, the port after the whole sum). The CUDA kernels
themselves are held to the plain version on the card in
test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_encoder as fe
from scldm_torch.training import vae_task as tvt
from scldm_torch.utils.weights import load_reference_state_dict

E, H, Q = 32, 4, 16  # the reference encoder: the widths the kernels are built for


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def make_case(B, G, S, seed=0):
    """A JAX VAE with randomised weights (non-zero LayerNorm biases, so the
    zero-row correction is not trivial), the port's copy of it, a lean batch
    of B cells over an S-token window and its dense counts."""
    rng = np.random.default_rng(seed)
    gs = np.zeros((B, S), np.int32)
    cs = np.zeros((B, S), np.float32)
    for i in range(B):
        nnz = int(rng.integers(min(5, S - 1), S))
        gs[i, :nnz] = np.sort(rng.choice(G, nnz, replace=False)) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    dense = np.zeros((B, G), np.float32)
    for i in range(B):
        nz = gs[i] > 0
        dense[i, gs[i, nz] - 1] = cs[i, nz]
    jvae = jax_build_vae(n_genes=G, n_layer=1)
    params = jvae.init(jax.random.PRNGKey(seed), jnp.asarray(dense),
                       jnp.tile(jnp.arange(1, G + 1), (B, 1)),
                       jnp.asarray(dense.sum(1, keepdims=True)), jnp.asarray(cs), jnp.asarray(gs))
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.3 * rng.normal(size=p.shape).astype(np.float32)), params)
    tvae = build_transformer_vae(n_genes=G, n_layer=1)
    load_reference_state_dict(tvae, export_torch_state_dict(params))
    w = rng.normal(size=(B, Q, E)).astype(np.float32)  # a non-uniform cotangent
    return jvae, params, tvae, dict(genes_subset=gs, counts_subset=cs, counts=dense), w


def jax_pooled(variant, jvae, params, x):
    if variant == "dense":
        return jvt.fused_encoder_pooling(jvae, params, jnp.asarray(x["counts"]),
                                         x["genes_subset"].shape[1], interpret=True)
    emb = jvae.apply(params, jnp.asarray(x["counts_subset"]), jnp.asarray(x["genes_subset"]),
                     method=lambda m, c, g: m.input_layer(c, g))
    return jvt.fused_window_pooling(jvae, params, emb, interpret=True)


def port_pooled(variant, tvae, x):
    if variant == "dense":
        return tvt.fused_encoder_pooling(tvae, torch.from_numpy(x["counts"]),
                                         x["genes_subset"].shape[1])
    emb = tvae.input_layer(torch.from_numpy(x["counts_subset"]),
                           torch.from_numpy(x["genes_subset"]).long())
    return tvt.fused_window_pooling(tvae, emb)


CASES = [("dense", 8, 60, 50), ("dense", 2, 1100, 1000), ("window", 8, 60, 50),
         ("window", 2, 1100, 1030)]


@pytest.mark.parametrize("part", ["forward", "gradients"])
@pytest.mark.parametrize("variant,B,G,S", CASES)
def test_pool_matches_pallas_interpret(variant, B, G, S, part):
    jvae, params, tvae, x, w = make_case(B, G, S)
    counters = (fe.ENCODER_POOL_FWD_LAUNCHES, fe.ENCODER_POOL_BWD_LAUNCHES,
                fe.WINDOW_POOL_FWD_LAUNCHES, fe.WINDOW_POOL_BWD_LAUNCHES)
    before = [c.count for c in counters]
    if part == "forward":
        want = np.asarray(jax_pooled(variant, jvae, params, x))
        with torch.no_grad():
            got = port_pooled(variant, tvae, x).numpy()
        assert got.shape == want.shape == (B, Q, E)
        assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()
    else:
        jgrads = export_torch_state_dict(jax.grad(
            lambda p: jnp.sum(jax_pooled(variant, jvae, p, x) * w))(params))
        (port_pooled(variant, tvae, x) * torch.from_numpy(w)).sum().backward()
        n = 0
        for name, p in tvae.named_parameters():
            if p.grad is None:
                continue
            want = jgrads[name]
            scale = np.abs(want).max()
            assert scale > 0, name
            assert np.abs(p.grad.numpy() - want).max() < 1e-2 * scale, name
            n += 1
        # the MCAB's 13 parameters and the gene embedding
        assert n == 14
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("variant", ["dense", "window"])
def test_function_matches_reference_autograd(variant):
    """On CPU tensors the autograd Functions (recompute VJP given the saved
    m) and the plain versions' own autograd agree to rounding."""
    rng = np.random.default_rng(3)
    B, N = 3, 40

    def f(*s, scale=0.5):
        return torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32))

    x = dict(src=f(N, E) if variant == "dense" else f(B, N, E), q=f(Q, E), ln1g=f(1, E) + 1.0,
             ln1b=f(1, E), wk=f(E, E, scale=0.2), wv=f(E, E, scale=0.2))
    counts = torch.from_numpy(rng.poisson(1.0, (B, N)).astype(np.float32))
    cot = (f(B, Q, E), f(B, Q * H))
    grads = []
    for fn in ((fe.encoder_pool_reference, fe.encoder_pool) if variant == "dense"
               else (fe.window_pool_reference, fe.window_pool)):
        leaves = {k: t.clone().requires_grad_() for k, t in x.items()}
        qfull = fe.build_query_operand(leaves["q"], H)
        weights = [leaves[k] for k in fe.WEIGHT_NAMES]
        args = (counts, leaves["src"]) if variant == "dense" else (leaves["src"],)
        num, den, m = fn(*args, qfull, weights, H, 1e-8)
        assert not m.requires_grad
        torch.autograd.backward((num, den), cot)
        grads.append({k: t.grad for k, t in leaves.items()})
    for k in x:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-6)


def test_gate_shapes_match_jax():
    """The port keeps JAX's dispatch ratio: dentate shapes take the module
    encoder, parse1m / replogle shapes the dense pool."""
    assert not tvt._dense_pool_worth_it(17_002, 6_147)
    assert tvt._dense_pool_worth_it(2_000, 2_000)
    for g, s in ((17_002, 6_147), (2_000, 2_000), (60, 50), (60, 20), (1_100, 1_000),
                 (2_049, 1_600), (2_049, 2_000)):
        assert tvt._dense_pool_worth_it(g, s) == jvt._dense_pool_worth_it(g, s), (g, s)


def test_eligibility_matches_jax():
    """`_fused_encoder_ok` and `_fused_window_ok` against JAX's on the same
    architectures; JAX's other input transforms, which its dense gate
    refuses, do not exist in the port."""
    for kw in (dict(), dict(bias=True), dict(n_embed=256, n_head=8),
               dict(n_embed=192, n_head=4)):
        jvae = jax_build_vae(n_genes=60, n_layer=1, **kw)
        tvae = build_transformer_vae(n_genes=60, n_layer=1, **kw)
        assert tvt._fused_encoder_ok(tvae) == jvt._fused_encoder_ok(jvae), kw
        assert tvt._fused_window_ok(tvae) == jvt._fused_window_ok(jvae), kw
    assert tvt._fused_encoder_ok(build_transformer_vae(n_genes=60, n_layer=1))
    assert not jvt._fused_encoder_ok(jax_build_vae(n_genes=60, agg_func="scaled_log1p"))


def test_shape_checks_and_devices():
    emb = torch.zeros(2, 5, E)
    qfull = fe.build_query_operand(torch.zeros(Q, E), H)
    weights = (torch.zeros(1, E), torch.zeros(1, E), torch.zeros(E, E), torch.zeros(E, E))
    assert fe._check("window", emb, qfull, weights, H) == (2, 5, E, Q)
    assert fe._check("dense", emb[0], qfull, weights, H, torch.zeros(3, 5)) == (3, 5, E, Q)
    with pytest.raises(ValueError, match="counts must be"):
        fe._check("dense", emb[0], qfull, weights, H, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="built for"):
        fe._check("window", emb, qfull, weights, 2)  # another head count
    narrow = (torch.zeros(1, 16), torch.zeros(1, 16), torch.zeros(16, 16), torch.zeros(16, 16))
    with pytest.raises(ValueError, match="built for"):
        fe._check("window", emb[..., :16], fe.build_query_operand(torch.zeros(Q, 16), 2), narrow, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fe.window_pool_fwd(emb.to("meta"), qfull.to("meta"), [w.to("meta") for w in weights],
                           H, 1e-8)
