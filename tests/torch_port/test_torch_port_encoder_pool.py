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
test_torch_port_cuda.py. The same holds at the other widths the JAX gates
send the narrow kernels (`WIDTHS`: E = 16, 64 and 128, head widths 8 and 16,
a ragged query count)."""

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


def make_case(B, G, S, seed=0, e=E, h=H, q=Q, jit=False):
    """A JAX VAE with randomised weights (non-zero LayerNorm biases, so the
    zero-row correction is not trivial), the port's copy of it, a lean batch
    of B cells over an S-token window and its dense counts; the MCAB at
    width e with h heads over q inducing points (`jit`: JAX's init compiled,
    seconds instead of tens of seconds)."""
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
    kw = dict(n_embed=e, n_head_cross=h, n_inducing_points=q, n_head=max(1, e // 16))
    jvae = jax_build_vae(n_genes=G, n_layer=1, **kw)
    params = (jax.jit(jvae.init) if jit else jvae.init)(
        jax.random.PRNGKey(seed), jnp.asarray(dense), jnp.tile(jnp.arange(1, G + 1), (B, 1)),
        jnp.asarray(dense.sum(1, keepdims=True)), jnp.asarray(cs), jnp.asarray(gs))
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.3 * rng.normal(size=p.shape).astype(np.float32)), params)
    tvae = build_transformer_vae(n_genes=G, n_layer=1, device="cpu", **kw)
    load_reference_state_dict(tvae, export_torch_state_dict(params))
    w = rng.normal(size=(B, q, e)).astype(np.float32)  # a non-uniform cotangent
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


# (variant, e, h, q, B, G, S) at the other widths the JAX gates send the
# narrow kernels: E = 16 (head width 8), 64 (16) and 128 (16, both variants:
# the two share `_pool` but for the embedding) and a ragged query count
# the last eight: more inducing points than one 64-query tile of the kernels
WIDTHS = [("window", 16, 2, 8, 3, 60, 50), ("window", 64, 4, 32, 2, 60, 50),
          ("dense", 128, 8, 64, 2, 40, 30), ("window", 128, 8, 64, 2, 40, 30),
          ("window", 48, 3, 20, 2, 60, 50),
          ("window", 64, 4, 65, 2, 40, 30), ("dense", 64, 4, 65, 2, 40, 30),
          ("window", 128, 8, 65, 2, 40, 30), ("dense", 128, 8, 65, 2, 40, 30),
          ("window", 64, 4, 128, 2, 40, 30), ("dense", 64, 4, 128, 2, 40, 30),
          ("window", 128, 8, 128, 2, 40, 30), ("dense", 128, 8, 128, 2, 40, 30)]


@pytest.mark.parametrize("variant,e,h,q,B,G,S", WIDTHS)
def test_pool_matches_pallas_interpret_at_other_widths(variant, e, h, q, B, G, S):
    """The plain pools' pooled tokens and the MCAB's gradients against JAX's
    Pallas pools in interpret mode, at the tolerances of the dentate width."""
    jvae, params, tvae, x, w = make_case(B, G, S, 7, e, h, q, jit=True)
    want = np.asarray(jax.jit(lambda p: jax_pooled(variant, jvae, p, x))(params))
    out = port_pooled(variant, tvae, x)
    assert out.shape == want.shape == (B, q, e)
    assert np.abs(out.detach().numpy() - want).max() < 1e-3 * np.abs(want).max()
    jgrads = export_torch_state_dict(jax.jit(jax.grad(
        lambda p: jnp.sum(jax_pooled(variant, jvae, p, x) * w)))(params))
    (out * torch.from_numpy(w)).sum().backward()
    n = 0
    for name, p in tvae.named_parameters():
        if p.grad is None:
            continue
        want_g = jgrads[name]
        scale = np.abs(want_g).max()
        assert scale > 0, name
        assert np.abs(p.grad.numpy() - want_g).max() < 1e-2 * scale, name
        n += 1
    assert n == 14


def test_narrow_kernels_take_every_width_the_gate_sends():
    """Every E from 16 to 128 in steps of 16 with head widths 8, 16, 32 and
    64 and any number of inducing points (1 up to past several 64-query
    tiles) takes the narrow kernels; so do E off the multiples of 16 and head
    widths 1, 4 and 128. E past 128, a head count not dividing E, and no
    inducing point do not."""
    for e in range(16, 129, 16):
        for hd in (8, 16, 32, 64):
            if e % hd == 0:
                for q in (1, 20, 64, 65, 128, 129, 256, 1_000):
                    assert fe.narrow_kernel_takes(e, e // hd, q), (e, hd, q)
    for e, h, q in ((24, 3, 10), (40, 10, 17), (16, 4, 64), (128, 1, 5), (32, 4, 65),
                    (64, 4, 128), (128, 128, 300), (1, 1, 2_000)):
        assert fe.narrow_kernel_takes(e, h, q)
    for e, h, q in ((160, 4, 16), (256, 4, 16), (48, 5, 16), (32, 4, 0), (129, 1, 8)):
        assert not fe.narrow_kernel_takes(e, h, q), (e, h, q)
    assert fe.SPECIALISED == (E, H, Q) and fe.narrow_kernel_takes(*fe.SPECIALISED)


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
        tvae = build_transformer_vae(n_genes=60, n_layer=1, device="cpu", **kw)
        assert tvt._fused_encoder_ok(tvae) == jvt._fused_encoder_ok(jvae), kw
        assert tvt._fused_window_ok(tvae) == jvt._fused_window_ok(jvae), kw
    assert tvt._fused_encoder_ok(build_transformer_vae(n_genes=60, n_layer=1, device="cpu"))
    assert not jvt._fused_encoder_ok(jax_build_vae(n_genes=60, agg_func="scaled_log1p"))


def test_shape_checks_and_devices():
    emb = torch.zeros(2, 5, E)
    qfull = fe.build_query_operand(torch.zeros(Q, E), H)
    weights = (torch.zeros(1, E), torch.zeros(1, E), torch.zeros(E, E), torch.zeros(E, E))
    assert fe._check("window", emb, qfull, weights, H) == (2, 5, E, Q)
    assert fe._check("dense", emb[0], qfull, weights, H, torch.zeros(3, 5)) == (3, 5, E, Q)
    with pytest.raises(ValueError, match="counts must be"):
        fe._check("dense", emb[0], qfull, weights, H, torch.zeros(3, 4))
    # another head count (32 queries of 2 heads) and E = 16: the any-width design's
    assert fe._check("window", emb, qfull, weights, 2) == (2, 5, E, 2 * Q)
    narrow = (torch.zeros(1, 16), torch.zeros(1, 16), torch.zeros(16, 16), torch.zeros(16, 16))
    assert fe._check("window", emb[..., :16].contiguous(),
                     fe.build_query_operand(torch.zeros(Q, 16), 2), narrow, 2) == (2, 5, 16, Q)
    # 65 inducing points: two 64-query tiles of the any-width design
    assert fe._check("window", emb, fe.build_query_operand(torch.zeros(65, E), H), weights,
                     H) == (2, 5, E, 65)
    with pytest.raises(ValueError, match="built for"):  # 65 rows are not 4 heads' blocks
        fe._check("window", emb, torch.zeros(65, E), weights, H)
    wide = (torch.zeros(1, 160), torch.zeros(1, 160), torch.zeros(160, 160), torch.zeros(160, 160))
    with pytest.raises(ValueError, match="built for"):  # between the narrow and wide designs
        fe._check("window", torch.zeros(2, 5, 160), fe.build_query_operand(torch.zeros(Q, 160), 4),
                  wide, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fe.window_pool_fwd(emb.to("meta"), qfull.to("meta"), [w.to("meta") for w in weights],
                           H, 1e-8)


@pytest.mark.parametrize("variant", ["dense", "window"])
def test_backward_reference_in_f64_matches_pallas_interpret(variant):
    """The f64 yardstick of the narrow backwards is JAX's function:
    `encoder_pool_backward_reference` and `window_pool_backward_reference`
    on f64 inputs (they keep f64 and round to bf16 where the kernels do)
    against JAX's custom-VJP backward of the Pallas pool (`_fused_bwd`,
    `_wfused_bwd`) in interpret mode, at a ragged B = 5 cells over N = 130
    tokens (one Pallas tile, so no padded rows), given the same saved m (JAX's
    forward) and cotangents (dnum in the head-diagonal blocks JAX's num
    has). Both round the same operands to bf16; JAX sums in f32, so a bf16
    rounding flips now and then: each gradient within 1e-2 of its largest
    magnitude everywhere and within 1e-4 of it on all but 5% of its entries
    (chip_smoke.held_bf16's bounds)."""
    from scldm_tpu.ops import fused_encoder as jfe

    rng = np.random.default_rng(7)
    B, N, hd, eps, scale = 5, 130, E // H, 1e-8, (E // H) ** -0.5

    def f(*s, scale=1.0, shift=0.0):
        return (rng.normal(size=s) * scale + shift).astype(np.float32)

    src = f(N, E) if variant == "dense" else f(B, N, E)
    q, ln1g, ln1b = f(Q, E), f(1, E, scale=0.3, shift=1.0), f(1, E, scale=0.3)
    wk, wv = f(E, E, scale=E**-0.5), f(E, E, scale=E**-0.5)
    counts = (rng.poisson(3.0, (B, N)) * (rng.random((B, N)) < 0.6)).astype(np.float32)
    dnum, dden = f(B, Q, E), f(B, Q * H)

    qfull = jfe.build_query_operand(jnp.asarray(q), H)
    weights = tuple(jnp.asarray(a) for a in (ln1g, ln1b, wk, wv))
    dnum_full = np.zeros((B, Q * H, E), np.float32)  # JAX's num: (B, Q*H, E)
    for h in range(H):
        dnum_full[:, h * Q:(h + 1) * Q, h * hd:(h + 1) * hd] = dnum[:, :, h * hd:(h + 1) * hd]
    cts = (jnp.asarray(dnum_full), jnp.asarray(dden), None)
    if variant == "dense":
        m = jfe.fused_encoder_pool(jnp.asarray(counts), jnp.asarray(src), qfull, weights, scale,
                                   eps, interpret=True)[2]
        res = (jnp.asarray(counts), jnp.asarray(src), qfull, weights, m)
        _, dsrc, dq, dws = jfe._fused_bwd(scale, eps, 1024, 8, True, res, cts)
    else:
        m = jfe.fused_window_pool(jnp.asarray(src), qfull, weights, scale, eps, interpret=True)[2]
        res = (jnp.asarray(src), qfull, weights, m)
        dsrc, dq, dws = jfe._wfused_bwd(scale, eps, 1024, 8, 0, True, res, cts)
    want = [np.asarray(g) for g in (dsrc, dq, *dws)]

    t = [torch.from_numpy(a).double() for a in (src, q, ln1g, ln1b, wk, wv, dnum, dden)]
    stats = (torch.from_numpy(np.array(m)).double(), t[6], t[7])
    qfull64 = fe.build_query_operand(t[1], H)
    if variant == "dense":
        got = fe.encoder_pool_backward_reference(torch.from_numpy(counts), t[0], qfull64, t[2:6],
                                                 *stats, H, eps)
    else:
        got = fe.window_pool_backward_reference(t[0], qfull64, t[2:6], *stats, H, eps)
    got = [got[0], got[1], *got[2]]
    for name, g, w in zip(("dsrc", "dqfull", "dln1g", "dln1b", "dwk", "dwv"), got, want):
        assert g.dtype == torch.float64, name
        d = np.abs(g.numpy() - w)
        top = np.abs(w).max()
        assert top > 0 and d.max() <= 1e-2 * top, (name, d.max() / top)
        assert (d > 1e-4 * top).mean() <= 0.05, (name, (d > 1e-4 * top).mean())


# encoder_pool.cu's narrow forward: a CTA of 16 warps a cell, warp w taking the
# cell's 16-token tiles w, w + 16, ...
KERNEL_WARPS, KERNEL_TILE = 16, 16


def kernel_order_pool(emb, qfull, weights, n_head=H, eps=1e-8):
    """The narrow forward over (B, N, E) tokens in the kernel's order, plain
    PyTorch: pass 1 each (query, head) row's max over every token; pass 2,
    per warp, its tiles last to first, each tile's den and num (bf(e) against
    that max, times bf(v)) summed from zero and added in f32; then the
    warps' sums added in warp order. -> (num (B, Q, E), den, m)."""
    B, N, E_ = emb.shape
    s, v = fe._ln_kv_scores(emb, qfull, weights, eps, (E_ // n_head) ** -0.5)
    m = s.amax(dim=1)
    e = torch.exp(s - m[:, None, :])
    eb, vb = fe._bf_keep(e).transpose(1, 2), fe._bf_keep(v)
    ntiles = -(-N // KERNEL_TILE)
    full = torch.zeros(B, s.shape[2], E_)
    den = torch.zeros(B, s.shape[2])
    for w in range(KERNEL_WARPS):
        wn, wd = torch.zeros_like(full), torch.zeros_like(den)
        for i in reversed(range(w, ntiles, KERNEL_WARPS)):
            t = slice(KERNEL_TILE * i, KERNEL_TILE * (i + 1))
            wn += eb[:, :, t] @ vb[:, t]
            wd += e[:, t].sum(dim=1)
        full += wn
        den += wd
    hd = E_ // n_head
    num = torch.diagonal(full.reshape(B, n_head, -1, n_head, hd), dim1=1, dim2=3)
    return num.permute(0, 1, 3, 2).reshape(B, -1, E_), den, m


def kernel_order_encoder_pool(counts, table, qfull, weights, n_head=H, eps=1e-8):
    return kernel_order_pool(fe._dense_emb(counts.float(), table), qfull, weights, n_head, eps)


@pytest.mark.parametrize("variant,N", [("dense", 2_000), ("window", 6_147)])
def test_kernel_order_forward_matches_plain_at_kernel_shapes(variant, N):
    """The forward's splits, at the shapes the kernel takes on the training
    path (the parse1m genes, the dentate window), keep the plain version's
    numbers: (num, den, m) and the pooled values num / den within 1e-3 of
    their largest magnitudes, the file's bound on the pooled tokens, and
    within the share bounds chip_smoke.py's phase 1d holds the kernel to (at
    most 5% of the entries beyond 3e-4 of the largest for num, 1e-4 for den
    and m). The kernel's sums differ from the plain version's only in their
    f32 order: every exponential is rounded to bf16 against the final max,
    as the plain version rounds it."""
    rng = np.random.default_rng(11)
    B, hd = 2, E // H

    def f(*s, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + shift).astype(np.float32))

    src = f(N, E) if variant == "dense" else f(B, N, E)
    qfull = fe.build_query_operand(f(Q, E), H)
    weights = (f(1, E, scale=0.3, shift=1.0), f(1, E, scale=0.3), f(E, E, scale=E**-0.5),
               f(E, E, scale=E**-0.5))
    counts = torch.from_numpy((rng.poisson(3.0, (B, N)) * (rng.random((B, N)) < 0.6))
                              .astype(np.float32))
    with torch.no_grad():
        if variant == "dense":
            got = kernel_order_encoder_pool(counts, src, qfull, weights)
            want = fe.encoder_pool_reference(counts, src, qfull, weights, H)
        else:
            got = kernel_order_pool(src, qfull, weights)
            want = fe.window_pool_reference(src, qfull, weights, H)
    pooled = [o[0] / fe.head_rows(o[1], H, hd) for o in (got, want)]
    for name, g, w in (*zip(("num", "den", "m"), got, want), ("pooled", *pooled)):
        assert g.shape == w.shape, name
        d, top = (g - w).abs(), w.abs().max()
        assert d.max() <= 1e-3 * top, name
        assert (d > (3e-4 if name == "num" else 1e-4) * top).float().mean() <= 0.05, name


@pytest.mark.parametrize("variant,B,G,S", CASES)
def test_kernel_order_forward_matches_pallas_interpret(variant, B, G, S, monkeypatch):
    """The pooled tokens through the forward in the kernel's order (in place
    of the pools `fused_encoder_pooling` and `fused_window_pooling` call)
    against JAX's Pallas forward in interpret mode, within 1e-3 of their
    largest magnitude, the bound `test_pool_matches_pallas_interpret` holds
    the plain version to."""
    jvae, params, tvae, x, _ = make_case(B, G, S)
    want = np.asarray(jax_pooled(variant, jvae, params, x))
    monkeypatch.setattr(tvt, "encoder_pool", kernel_order_encoder_pool)
    monkeypatch.setattr(tvt, "window_pool", kernel_order_pool)
    with torch.no_grad():
        got = port_pooled(variant, tvae, x).numpy()
    assert got.shape == want.shape == (B, Q, E)
    assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()
