"""The census window pool (the wide design of scldm_torch.ops.fused_encoder's
window pool) against the JAX package: the pooled tokens and their gradients
at census width, one `VAETask(fused_pool=True, algebraic_tail=False)` step,
and one `LDMTask(fused_encode=True)` frozen encode, on the same weights
(`export_torch_state_dict` -> `load_reference_state_dict`) and numpy inputs.

Shapes: the pool at E=512, 8 cross heads, 64 inducing points over a window
of S=600 tokens, B=4 (tests/test_fused_encoder.py:163-225: JAX streams it in
two 512-token tiles forward and three 256-token tiles backward, padding the
window to 1,024 and taking 424 zero rows out in closed form; the port pads
nothing). The train step at E=256, 4 cross heads, 16 inducing points, S=280,
B=4 (tests/test_fused_encoder.py:227-254, with `algebraic_tail=False` on both
sides: JAX leaves it on auto there, which at E=256 takes the algebraic path
and never reaches the pool). The encode at E=512, S=600, B=4.

Both sides round the same operands to bf16 and accumulate in f32 (the port's
plain version on CPU tensors; JAX's Pallas kernels in interpret mode).
Tolerances are the encoder pools' (test_torch_port_encoder_pool.py): the
pooled tokens within 1e-3 of their largest magnitude, each gradient within
1e-2 of its own largest. The step and the encode are held at JAX's own
bounds between its window pool and its module path (loss 5e-3 relative and
gradient norm 2%; 0.02 of the largest latent). The CUDA kernels themselves
are held to the plain version on the card in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.training.vae_task import VAETask as JaxVAETask
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_encoder as fe
from scldm_torch.training import vae_task as tvt
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.training.vae_task import VAETask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import load_reference_state_dict

# the census encoder's MCAB (configs/model/vae_census.yaml), one layer
CENSUS_ARCH = dict(n_genes=700, n_embed=512, n_embed_latent=64, n_layer=1, n_inducing_points=64,
                   n_head=8, n_head_cross=8)
# the E = 256 encoder of tests/test_fused_encoder.py:227-254 (4 cross heads by default)
E256_ARCH = dict(n_genes=300, n_embed=256, n_embed_latent=32, n_layer=1, n_inducing_points=16,
                 n_head=8)
DIT_ARCH = dict(n_embed=32, n_embed_input=64, n_layer=1, n_head=4, seq_len=64,
                class_vocab_sizes={}, cfg_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def lean(B, G, S, seed, dtype=np.int32):
    """A lean wire batch: B cells of 5 to S - 1 expressed genes of G, counts
    Poisson(3) + 1, zero-padded to the S-token window."""
    rng = np.random.default_rng(seed)
    gs = np.zeros((B, S), dtype)
    cs = np.zeros((B, S), np.float32 if dtype == np.int32 else dtype)
    for i in range(B):
        nnz = int(rng.integers(5, S))
        gs[i, :nnz] = np.sort(rng.choice(G, nnz, replace=False)) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    return {"genes_subset": gs, "counts_subset": cs,
            "library_size": cs.astype(np.float32).sum(1, keepdims=True)}


def jax_vae_and_params(arch, batch, seed, noise):
    """A JAX VAE, its parameters with `noise` times a standard normal added
    (non-zero LayerNorm biases, non-trivial attention), and the port's copy."""
    rng = np.random.default_rng(seed)
    jvae = jax_build_vae(**arch)
    gs, cs = jnp.asarray(batch["genes_subset"]), jnp.asarray(batch["counts_subset"])
    params = jvae.init(jax.random.PRNGKey(seed), cs, gs, jnp.asarray(batch["library_size"]), cs, gs)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(noise * rng.normal(size=p.shape).astype(np.float32)), params)
    tvae = build_transformer_vae(**arch, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(params))
    return jvae, params, tvae


@pytest.fixture(scope="module")
def census_case():
    batch = lean(4, CENSUS_ARCH["n_genes"], 600, seed=7)
    with jax.default_matmul_precision("highest"):
        jvae, params, tvae = jax_vae_and_params(CENSUS_ARCH, batch, seed=7, noise=0.05)
    # a non-uniform cotangent of the pooled (B, M, E) tokens
    w = np.random.default_rng(3).normal(size=(4, 64, 512)).astype(np.float32)
    return jvae, params, tvae, batch, w


def jax_pooled(jvae, params, batch):
    emb = jvae.apply(params, jnp.asarray(batch["counts_subset"]),
                     jnp.asarray(batch["genes_subset"]), method=lambda m, c, g: m.input_layer(c, g))
    return jvt.fused_window_pooling(jvae, params, emb, interpret=True)


def port_pooled(tvae, batch):
    emb = tvae.input_layer(torch.from_numpy(batch["counts_subset"]),
                           torch.from_numpy(batch["genes_subset"]).long())
    return tvt.fused_window_pooling(tvae, emb)


def test_census_width_takes_the_wide_design():
    """The census MCAB's (E, heads, queries) is a wide kernel shape; the
    dense pool keeps the narrow designs only, which take E <= 128."""
    assert fe.wide_kernel_takes(512, 8, 64) and fe.wide_kernel_takes(256, 4, 16)
    assert fe.SPECIALISED == (32, 4, 16) and not fe.wide_kernel_takes(32, 4, 16)
    assert fe.narrow_kernel_takes(32, 4, 16) and not fe.narrow_kernel_takes(256, 4, 16)
    assert fe._wide(512) and fe._wide(256) and not fe._wide(32)


# (E, n_head, Q) and whether the wide kernels take it: the census encoder,
# E = 256, 768 and 1,024 with heads of 64, 1, 40 and 1,024 inducing points
# (the long-latent encoder's); refused: heads of 32 or 128, E off the
# multiples of 64 or outside [256, 1,024], more than 1,024 queries
@pytest.mark.parametrize("E,H,Q,takes", [
    (512, 8, 64, True), (256, 4, 64, True), (768, 12, 64, True), (1024, 16, 64, True),
    (512, 8, 1, True), (512, 8, 40, True), (512, 8, 1024, True), (256, 4, 1024, True),
    (512, 16, 64, False), (256, 8, 16, False), (512, 4, 64, False), (512, 8, 1025, False),
    (512, 8, 0, False), (320, 5, 64, True), (288, 4, 64, False), (192, 3, 64, False),
    (1088, 17, 64, False),
])
def test_wide_kernel_takes(E, H, Q, takes):
    assert fe.wide_kernel_takes(E, H, Q) is takes


@pytest.mark.parametrize("backward", [False, True])
def test_plain_window_pool_in_f64(backward):
    """The plain window pool keeps f64 inputs in f64 (the wide kernels'
    yardstick on the card) and is unchanged on f32
    ones (`_bf_keep` is `_bf` there); the two agree within `held_bf16`'s
    largest-error bound, 1e-2 of each tensor's largest magnitude."""
    from scldm_torch.ops.fused_decoder import _bf

    B, S, E, H, Q = 2, 50, 256, 4, 8
    g = torch.Generator().manual_seed(3)
    x = [torch.randn(B, S, E, generator=g), fe.build_query_operand(torch.randn(Q, E, generator=g), H),
         torch.randn(1, E, generator=g) * 0.3 + 1.0, torch.randn(1, E, generator=g) * 0.3,
         torch.randn(E, E, generator=g) * E**-0.5, torch.randn(E, E, generator=g) * E**-0.5]
    assert torch.equal(fe._bf_keep(x[0]), _bf(x[0]))

    def run(ts):
        out = fe.window_pool_reference(ts[0], ts[1], ts[2:], H)
        if not backward:
            return list(out)
        cot = [torch.randn(B, Q, E, generator=torch.Generator().manual_seed(4)).to(ts[0].dtype),
               torch.randn(B, Q * H, generator=torch.Generator().manual_seed(5)).to(ts[0].dtype)]
        demb, dq, dw = fe.window_pool_backward_reference(ts[0], ts[1], ts[2:], out[2], *cot, H)
        return [demb, dq, *dw]

    for a, b in zip(run(x), run([t.double() for t in x])):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        assert (a.double() - b).abs().max() <= 1e-2 * b.abs().max()


def _jax_window_pool_blocks(emb, q, weights, H, scale):
    """JAX's Pallas window pool (interpret mode) on the raw queries, with num
    cut to the head-diagonal blocks the port returns: (num (B, Q, E), den,
    m)."""
    from scldm_tpu.ops import fused_encoder as jfe

    Q, E = q.shape
    # positional: block_s 1,024, block_b 8, bwd_block_s 0 (JAX's defaults), interpret
    num, den, m = jfe.fused_window_pool(emb, jfe.build_query_operand(q, H), weights, scale,
                                        1e-8, 1024, 8, 0, True)
    B = num.shape[0]
    blocks = num.reshape(B, H, Q, H, E // H)
    diag = jnp.stack([blocks[:, h, :, h, :] for h in range(H)], axis=2)  # (B, Q, H, hd)
    return diag.reshape(B, Q, E), den, m


# E = 256 (4 heads of 64) at the long-latent encoder's 1,024 inducing points
# and at a ragged 40, over a window of S <= 130 tokens (one JAX token tile);
# whether the gradients are held to the share bound too (see the docstring)
@pytest.mark.parametrize("B,S,Q,grad_share", [(2, 130, 1024, False), (2, 97, 40, True)])
def test_wide_pool_plain_matches_pallas_interpret(B, S, Q, grad_share):
    """The port's plain window pool (what the wide kernels are held to on the
    card) against JAX's Pallas `fused_window_pool` in interpret mode on the
    same numpy inputs, forward and gradients (through `build_query_operand`
    on both sides, of a random projection of num and den). Both round the
    same operands and cotangents to bf16 and sum in f32 in other orders, so
    now and then a rounding of x2 or k flips, which moves a score by up to
    about 2e-3 and the outputs of its query with it. The bounds of
    chip_smoke.py's `held_bf16`: num, den and m within 1e-2 of the tensor's
    largest magnitude with at most 5% of the entries beyond 3e-4 of it for
    num, 1e-4 for den and m; every gradient within 1e-2 of its own largest,
    and at 40 queries with at most 5% of its entries beyond 1e-4 of it (1e-3
    for ln1g). At 1,024 queries such flips reach enough row maxima, and a
    moved m scales its row's gradients, that the shares beyond 1e-4 of two
    f32 summation orders exceed 5% (measured here, beyond 1e-4: emb 17.5%,
    ln1b 20.3%, wk 10.1%, wv 7.5%, q 2.0%; ln1g 2.3% beyond 1e-3): there the
    gradients are held to the 1e-2 bound only (the kernels on the card are
    held to the plain version evaluated in f64: chip_smoke.py's phase 1d)."""
    E, H = 256, 4
    rng = np.random.default_rng(Q)
    f = lambda *s, scale=1.0, shift=0.0: (rng.normal(size=s) * scale + shift).astype(np.float32)  # noqa: E731
    x = dict(emb=f(B, S, E), q=f(Q, E), ln1g=f(1, E, scale=0.3, shift=1.0), ln1b=f(1, E, scale=0.3),
             wk=f(E, E, scale=E**-0.5), wv=f(E, E, scale=E**-0.5))
    w_num, w_den = f(B, Q, E), f(B, Q * H)
    names = list(x)
    scale = (E // H) ** -0.5

    def jax_loss(*args):
        a = dict(zip(names, args))
        num, den, _ = _jax_window_pool_blocks(a["emb"], a["q"], tuple(a[k] for k in fe.WEIGHT_NAMES),
                                              H, scale)
        return jnp.sum(num * w_num) + jnp.sum(den * w_den), (num, den)

    jargs = [jnp.asarray(x[k]) for k in names]
    jgrads, (jnum, jden) = jax.grad(jax_loss, argnums=tuple(range(len(names))), has_aux=True)(*jargs)
    jm = _jax_window_pool_blocks(jargs[0], jargs[1], tuple(jargs[2:]), H, scale)[2]

    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
    num, den, m = fe.window_pool(leaves["emb"], fe.build_query_operand(leaves["q"], H),
                                 [leaves[k] for k in fe.WEIGHT_NAMES], H)
    assert num.shape == (B, Q, E) and den.shape == m.shape == (B, Q * H)
    ((num * torch.from_numpy(w_num)).sum() + (den * torch.from_numpy(w_den)).sum()).backward()

    for name, got, ref, near in (("num", num, jnum, 3e-4), ("den", den, jden, 1e-4),
                                 ("m", m, jm, 1e-4)):
        ref = np.asarray(ref)
        d, scale_r = np.abs(got.detach().numpy() - ref), np.abs(ref).max()
        assert d.max() <= 1e-2 * scale_r and (d > near * scale_r).mean() <= 5e-2, name
    for k, g in zip(names, jgrads):
        g = np.asarray(g)
        d, scale_g = np.abs(leaves[k].grad.numpy() - g), np.abs(g).max()
        assert scale_g > 0 and d.max() <= 1e-2 * scale_g, k
        if grad_share:
            assert (d > (1e-3 if k == "ln1g" else 1e-4) * scale_g).mean() <= 5e-2, k


@pytest.mark.parametrize("part", ["forward", "gradients"])
def test_census_pool_matches_pallas_interpret(census_case, part):
    jvae, params, tvae, batch, w = census_case
    counters = (fe.WINDOW_POOL_WIDE_FWD_LAUNCHES, fe.WINDOW_POOL_WIDE_BWD_LAUNCHES)
    before = [c.count for c in counters]
    if part == "forward":
        want = np.asarray(jax_pooled(jvae, params, batch))
        with torch.no_grad():
            got = port_pooled(tvae, batch).numpy()
        assert got.shape == want.shape == (4, 64, 512)
        assert np.abs(got - want).max() < 1e-3 * np.abs(want).max()
    else:
        jgrads = export_torch_state_dict(jax.grad(
            lambda p: jnp.sum(jax_pooled(jvae, p, batch) * w))(params))
        tvae.zero_grad(set_to_none=True)
        (port_pooled(tvae, batch) * torch.from_numpy(w)).sum().backward()
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


def test_fused_pool_step_matches_jax():
    """One `VAETask(fused_pool=True, algebraic_tail=False)` step at E=256
    against JAX's with the same flags (its window pool in interpret mode):
    the step's MCAB pooling goes through the port's window pool once, and
    the loss and gradient norm agree at JAX's bounds."""
    G, S, B = E256_ARCH["n_genes"], 280, 4
    jbatch = lean(B, G, S, seed=11)
    jvae = jax_build_vae(**E256_ARCH)
    jtask = JaxVAETask(jvae, num_training_steps=10, fused_pool=True, algebraic_tail=False)
    assert jtask.fused_pool and not jtask.algebraic_tail
    jtask._pool_interpret = True  # the CPU backend
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    with jax.default_matmul_precision("highest"):
        state = jtask.init_state(jax.random.PRNGKey(0), jb)
        # the jitted step donates its state: run the same program undonated
        _, want = jax.jit(jtask._train_step_impl)(state, jb)

    tvae = build_transformer_vae(**E256_ARCH, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(state.params))
    task = VAETask(tvae, num_training_steps=10, fused_pool=True, algebraic_tail=False)
    assert task.fused_pool and not task.algebraic_tail
    tbatch = {k: torch.from_numpy(v) for k, v in lean(B, G, S, seed=11, dtype=np.uint16).items()}
    assert not task._use_fused(tbatch) and not task._use_algebraic(tbatch)
    calls = []
    real = fe._WindowPool.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fe._WindowPool, "apply", lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
        _, mets = task.train_step(task.init_state(torch.Generator().manual_seed(0)), tbatch)
    assert calls == [(B, S, 256)]
    lp, lj = float(mets["train_loss"]), float(want["train_loss"])
    gp, gj = float(mets["grad_norm"]), float(want["grad_norm"])
    assert np.isfinite(lp) and abs(lp - lj) < 5e-3 * abs(lj), (lp, lj)
    assert abs(gp - gj) < 0.02 * abs(gj), (gp, gj)


def test_fused_encode_matches_jax_module_encode(census_case):
    """`LDMTask(fused_encode=True)._encode` at census width (the wide window
    pool's plain version here) against JAX's module encode of the same frozen
    VAE and batch."""
    jvae, params, tvae, batch, _ = census_case
    jtask = JaxLDMTask(jvae, params, JaxDiT(**DIT_ARCH), jax_create_transport(),
                       num_training_steps=10)
    want = np.asarray(jtask._encode({k: jnp.asarray(v) for k, v in batch.items()}))
    task = LDMTask(tvae.eval(), DiT(**DIT_ARCH), create_transport(), fused_encode=True)
    calls = []
    real = fe._WindowPool.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fe._WindowPool, "apply", lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
        got = task._encode({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert calls == [(4, 600, 512)]
    assert got.shape == want.shape == (4, 64, 64)
    assert np.abs(got - want).max() < 0.02 * np.abs(want).max()
