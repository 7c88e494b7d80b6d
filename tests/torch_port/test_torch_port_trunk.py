"""The port's whole-trunk path (scldm_torch.ops.fused_trunk, and
`training/vae_task.fused_nb_apply(use_trunk=True)` / `VAETask(fused_trunk=True)`)
against the JAX package, its Pallas trunk kernels run in interpret mode, on
the same weights and numpy inputs; and the dispatch against JAX's gate.

Shapes: the trunk alone at JAX's test shape (R=12 rows of T=16 tokens, E=32,
8 heads, L=3) and at a ragged R=5 (JAX pads it to its 8-row blocks); the VAE
paths at the sizes of test_torch_port_vae_train.py (G=60 genes, B=8 cells,
a window of S=20 tokens for the window branch and of S=50 for the dense
pool's), with all eight layers in each trunk.

Tolerances: the trunk is f32 on both sides with sums in other orders: its
output within 1e-4 of the output's largest magnitude, dx and each weight
gradient within 1e-4 of their own largest. The VAE paths add the decoder
tail, which rounds six operands to bf16 on both sides (see
test_torch_port_vae_train.py): mu and the loss within 1e-3, h_z within 1e-4,
gradients within 2e-2 of each tensor's largest. The CUDA kernels themselves
are held to the plain version on the card in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.ops import fused_trunk as jft
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_trunk as ft
from scldm_torch.training import vae_task as tvt
from scldm_torch.utils.weights import load_reference_state_dict
from tests.torch_port.test_torch_port_vae_train import (
    DENSE_S,
    TASK,
    G,
    S as S_WINDOW,
    assert_grads_close,
    dense_setup,  # noqa: F401 (a fixture)
    lean_batch,
    port_task,
    setup,  # noqa: F401 (a fixture)
    to_jax,
    to_torch,
)

R, T, E, H, L = 12, 16, 32, 8, 3  # tests/test_fused_trunk.py's trunk
HIDDEN = 88  # the SwiGLU hidden width at E = 32
EPS = 1e-8


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def stacked_params(seed=0):
    """JAX's stacked (L, ...) trunk weights, (in, out), non-trivial LayerNorms."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "g1": 1.0 + rnd(L, 1, E, scale=0.1), "b1": rnd(L, 1, E, scale=0.1),
        "wqkv": rnd(L, E, 3 * E, scale=E**-0.5), "wproj": rnd(L, E, E, scale=E**-0.5),
        "g2": 1.0 + rnd(L, 1, E, scale=0.1), "b2": rnd(L, 1, E, scale=0.1),
        "w1": rnd(L, E, HIDDEN, scale=E**-0.5), "w2": rnd(L, E, HIDDEN, scale=E**-0.5),
        "wmlp": rnd(L, HIDDEN, E, scale=HIDDEN**-0.5),
    }


def port_weights(stacked):
    """The port's per-layer weights from JAX's stacked ones: LayerNorm
    vectors (E,), matrices in nn.Linear's (out, in) layout."""
    return {k: [torch.from_numpy(np.ascontiguousarray(a[i].reshape(E) if a.shape[1] == 1
                                                      else a[i].T)) for i in range(L)]
            for k, a in stacked.items()}


def assert_rel(got, want, rel, what=""):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(np.asarray(got) - want).max() <= rel * scale, what


@pytest.mark.parametrize("variant", ["blocks", "saving"])
@pytest.mark.parametrize("rows,block_rows", [(R, 64), (5, 8)])  # one block; ragged, padded
def test_trunk_forward_matches_jax(rows, block_rows, variant):
    """`fused_trunk_blocks` (row 9) and `fused_trunk_fwd_saving` (row 10,
    with each layer's input) against JAX's Pallas forward in interpret mode."""
    stacked = stacked_params()
    x = np.random.default_rng(1).normal(size=(rows, T, E)).astype(np.float32)
    weights = port_weights(stacked)
    kp = {k: jnp.asarray(v) for k, v in stacked.items()}
    if variant == "blocks":
        want = jft.fused_trunk_blocks(jnp.asarray(x), kp, n_head=H, block_rows=block_rows,
                                      interpret=True)
        got = ft.fused_trunk_blocks(torch.from_numpy(x), weights, H, EPS)
    else:
        want, want_xs = jft._fwd_saving(jnp.asarray(x), kp, H, EPS, block_rows, True)
        got, xs = ft.fused_trunk_fwd_saving(torch.from_numpy(x), weights, H, EPS)
        assert xs.shape == (L, rows, T, E)
        assert_rel(xs.numpy(), want_xs, 1e-4, "xs")
    assert got.shape == (rows, T, E) and got.dtype == torch.float32
    assert_rel(got.numpy(), want, 1e-4)
    assert np.abs(got.numpy() - x).max() > 1e-2  # the trunk is not the identity


def trunk_vae(seed=0):
    """A JAX VAE with L trunk layers and randomised weights (non-trivial
    LayerNorm affines), and the port's copy of it."""
    rng = np.random.default_rng(seed)
    jvae = jax_build_vae(n_genes=G, n_layer=L)
    batch = lean_batch()
    dense = np.zeros((batch["genes_subset"].shape[0], G), np.float32)
    params = jvae.init(jax.random.PRNGKey(seed), jnp.asarray(dense),
                       jnp.tile(jnp.arange(1, G + 1), (dense.shape[0], 1)),
                       jnp.asarray(batch["library_size"]), jnp.asarray(batch["counts_subset"]),
                       jnp.asarray(batch["genes_subset"]))
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.2 * rng.normal(size=p.shape).astype(np.float32)), params)
    tvae = build_transformer_vae(n_genes=G, n_layer=L, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(params))
    return params, tvae


@pytest.mark.parametrize("rows", [R, 5])
def test_trainable_gradients_match_jax(rows):
    """dx and every encoder block's parameter gradients through
    `extract_trunk_params` and `fused_trunk_blocks_trainable` (rows 10 and
    11; their plain versions here) against jax.grad through JAX's custom VJP
    (Pallas in interpret mode, its backward in 8-row blocks)."""
    params, tvae = trunk_vae()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(rows, T, E)).astype(np.float32)
    w = rng.normal(size=(rows, T, E)).astype(np.float32)

    def jloss(x, enc):
        kp = jft.extract_trunk_params(enc, L)
        return (jft.fused_trunk_blocks_trainable(x, kp, H, EPS, 64, 8, True) * w).sum()

    enc = params["params"]["encoder"]
    jgx, jgenc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), enc)
    jgrads = jax.tree_util.tree_map(jnp.zeros_like, params)
    jgrads["params"]["encoder"] = jgenc
    want = export_torch_state_dict(jgrads)

    tx = torch.from_numpy(x).requires_grad_()
    blocks = tvae.encoder.encoder_layers
    out = ft.fused_trunk_blocks_trainable(tx, ft.extract_trunk_params(blocks), H, EPS)
    (out * torch.from_numpy(w)).sum().backward()
    assert_rel(tx.grad.numpy(), jgx, 1e-4, "dx")
    n = 0
    for name, p in blocks.named_parameters():
        assert_rel(p.grad.numpy(), want[f"encoder.encoder_layers.{name}"], 1e-4, name)
        n += 1
    assert n == 9 * L


@pytest.mark.parametrize("branch", ["window", "dense"])
def test_fused_nb_apply_trunk_matches_jax(request, branch):
    """`fused_nb_apply(use_trunk=True)` against JAX's (Pallas trunk, pool and
    tail in interpret mode) on both branches of the encoder: the window
    (the module MCAB, then the trunk kernel: JAX `pool_only=True`) and the
    dense pool. Outputs, h_z, the loss and the gradients."""
    window = S_WINDOW if branch == "window" else DENSE_S
    jvae, jtask, state = request.getfixturevalue("setup" if branch == "window" else "dense_setup")
    task, _ = port_task(state)
    jb = jtask._materialize(to_jax(lean_batch(window=window)))
    tb = task._materialize(to_torch(lean_batch(window=window)))

    def jloss(params):
        out, z = jvt.fused_nb_apply(jvae, params, jb, train=True, interpret=True, use_trunk=True)
        return jvt.vae_loss(jb["counts"], out, False), (out, z)

    (want_loss, (want, want_z)), jgrads = jax.value_and_grad(jloss, has_aux=True)(state.params)
    calls = []
    real = ft._FusedTrunk.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ft._FusedTrunk, "apply", lambda *a: calls.append(a[0].shape) or real(*a))
        got, got_z = tvt.fused_nb_apply(task.vae, tb, use_trunk=True)
    assert len(calls) == 2  # the encoder's trunk and the decoder's
    loss = tvt.vae_loss(tb["counts"], got)
    loss.backward()
    assert_rel(got_z.detach().numpy(), want_z, 1e-4, "h_z")
    assert_rel(got["mu"].detach().numpy(), want["mu"], 1e-3, "mu")
    np.testing.assert_allclose(got["theta"].detach().numpy(), np.asarray(want["theta"]), rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-3)
    assert_grads_close(task.vae, jgrads, 2e-2, skip=("decoder_head.params.bias",))


def _jax_trunk_step(jvae, jtask, state, batch):
    """`VAETask._train_step_impl` of a `VAETask(fused_trunk=True)` on the
    kernel path (JAX vae_task.py:1088-1119), every Pallas kernel in
    interpret mode: the loss, the metrics and the clipped gradients."""
    batch = jtask._materialize(batch)

    def loss_fn(params):
        out, _ = jvt.fused_nb_apply(jvae, params, batch, train=True, interpret=True,
                                    use_trunk=True)
        loss = jvt.vae_loss(batch["counts"], out, False)
        return loss, out["theta"].mean()

    (loss, theta), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    gnorm = jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads)))
    scale = jnp.minimum(1.0, jtask.grad_clip / (gnorm + 1e-12))
    grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
    return grads, {"train_loss": loss, "grad_norm": gnorm, "train_theta": theta}


def test_fused_trunk_train_step_matches_jax(setup):  # noqa: F811 (the imported fixture)
    """One `VAETask(fused_trunk=True).train_step` on a lean wire batch: both
    trunks through `fused_trunk_blocks_trainable` (once each per step), its
    loss, grad norm and clipped gradients against JAX's fused step."""
    jvae, jtask, state = setup
    jgrad, want = _jax_trunk_step(jvae, jtask, state, to_jax(lean_batch()))
    task, tstate = port_task(state, fused_decoder=True, fused_trunk=True)
    assert task.fused_trunk
    calls = []
    real = ft._FusedTrunk.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ft._FusedTrunk, "apply", lambda *a: calls.append(a[0].shape) or real(*a))
        tstate, mets = task.train_step(tstate, to_torch(lean_batch(dtype=np.uint16)))
    assert len(calls) == 2
    for k in ("train_loss", "grad_norm", "train_theta"):
        np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-3)
    assert_grads_close(tstate.module, jgrad, 2e-2, skip=("decoder_head.params.bias",))


@pytest.mark.parametrize("flag,arch,on", [
    (None, {}, False),  # opt-in, as in JAX
    (False, {}, False),
    (True, {}, True),
    (True, {"n_embed": 16, "n_head": 4, "n_head_cross": 2}, True),  # any E <= 128
    (True, {"n_embed": 256, "n_layer": 1}, False),  # E > 128
    (True, {"bias": True, "n_layer": 1}, False),
])
def test_fused_trunk_dispatch(flag, arch, on):
    """`VAETask(fused_trunk=...)` is on exactly where JAX's is: asked for,
    and `_fused_trunk_ok` (JAX's gate, read off the modules)."""
    tvae = build_transformer_vae(n_genes=G, device="cpu", **arch)
    jvae = jax_build_vae(n_genes=G, **arch)
    assert tvt._fused_trunk_ok(tvae) == jvt._fused_trunk_ok(jvae)
    assert tvt.VAETask(tvae, fused_trunk=flag, **TASK).fused_trunk is on
    assert jvt.VAETask(jvae, fused_trunk=flag, **TASK).fused_trunk is on


def test_trunk_kernel_gate_matches_jax():
    cases = [(32, False, 0.0, False), (32, True, 0.0, False), (32, False, 0.1, False),
             (32, False, 0.0, True), (128, False, 0.0, False), (512, False, 0.0, False)]
    for args in cases:
        assert ft.trunk_kernel_ok(*args) == jft.trunk_kernel_ok(*args), args


def test_trainable_takes_the_saving_forward_only_under_autograd():
    """Row 10 (the Function) where autograd records, row 9 elsewhere, as
    JAX's primal call outside jax.grad; `extract_trunk_params` hands over the
    parameters themselves, so their gradients land in the module."""
    tvae = build_transformer_vae(n_genes=G, n_layer=2, device="cpu")
    blocks = tvae.encoder.encoder_layers
    weights = ft.extract_trunk_params(blocks)
    assert weights["wqkv"][1] is blocks[1].attn.c_attn.weight
    x = torch.randn(3, T, E)
    calls = []
    real = ft._FusedTrunk.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ft._FusedTrunk, "apply", lambda *a: calls.append(1) or real(*a))
        with torch.no_grad():
            plain = ft.fused_trunk_blocks_trainable(x, weights, H, EPS)
        assert calls == []
        out = ft.fused_trunk_blocks_trainable(x, weights, H, EPS)
        assert calls == [1]
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    out.sum().backward()
    assert all(p.grad is not None for p in blocks.parameters())


def test_trunk_backward_from_saved_inputs_matches_autograd():
    """`fused_trunk_bwd` from the saving forward's xs (its plain version on
    CPU tensors) equals autograd through the plain trunk."""
    weights = port_weights(stacked_params(3))
    rng = np.random.default_rng(4)
    x, dy = (torch.from_numpy(rng.normal(size=(5, T, E)).astype(np.float32)) for _ in range(2))
    _, xs = ft.fused_trunk_fwd_saving(x, weights, H, EPS)
    dx, grads = ft.fused_trunk_bwd(xs, weights, dy, H, EPS)
    rdx, rgrads = ft.fused_trunk_backward_reference(x, weights, dy, H, EPS)
    torch.testing.assert_close(dx, rdx)
    for k in ft.TRUNK_WEIGHT_NAMES:
        for got, want, w in zip(grads[k], rgrads[k], weights[k]):
            assert got.shape == w.shape
            torch.testing.assert_close(got, want)


# -- the kernels' layout (no card needed) -----------------------------------------

# (E, n_head, hidden) of the trunks the kernels run: the shipped VAE's
# (configs/model/vae_base.yaml: E = 32, 8 heads, hidden 88, over its 16 latent
# tokens; parse1m and replogle train the same VAE) and the other widths of the
# GPU tests (test_torch_port_cuda.py)
TRUNK_WIDTHS = [(32, 8, 88), (64, 4, 172), (128, 8, 344)]
MAX_SMEM = 227 * 1024  # one CTA's dynamic shared memory on an H100


def parent_smem_bytes(T, E, n_head, hidden, backward):
    """The shared memory of the scalar trunk kernels this layout replaced
    (scores of every head in shared memory): the widths they took."""
    scores = n_head * T * (T + 1)
    if backward:
        return 4 * (4 * T * E + T * (3 * E + 1) + T * max(2 * hidden, 3 * E) + 2 * scores
                    + 4 * T)
    return 4 * (2 * T * E + T * max(3 * E + 1, hidden) + scores)


@pytest.mark.parametrize(
    "T,E,n_head,hidden",
    [(T, *w) for T in (16, 10) for w in TRUNK_WIDTHS] + [(40, *w) for w in TRUNK_WIDTHS[:2]])
def test_trunk_layout_fits_a_cta(T, E, n_head, hidden):
    """At the shipped and tested widths and token counts (T = 16, and T = 10
    and 40, which do not fill whole m16 tiles; at E = 128 a row of 40 takes
    more shared memory than a CTA has, as it did before), both kernels'
    shared memory fits one CTA, the wrapper takes the shape, and the
    backward's workspace is the per-token pairs, the LayerNorm group
    partials and the weight gradients' chunk partials of up to eight
    layers."""
    for backward in (False, True):
        assert 0 < ft.trunk_smem_bytes(T, E, n_head, hidden, backward) <= MAX_SMEM
    assert ft._shape_error(T, E, n_head, hidden) is None
    R = 128
    per_layer = R * T * (8 * E + 3 * hidden) + 32 * R * E
    partials = 8 * (4 * E * E + 3 * E * hidden + 9 * E + 2 * hidden)
    assert ft.trunk_workspace_floats(R, T, E, hidden, 10) == 8 * (per_layer + partials)
    assert ft.trunk_workspace_floats(R, T, E, hidden, 3) == 3 * (per_layer + partials)


@pytest.mark.parametrize("E,n_head,hidden", TRUNK_WIDTHS)
def test_trunk_takes_every_row_length_the_scalar_kernels_took(E, n_head, hidden):
    """No shape the replaced kernels took now raises at these widths: every
    T whose scalar layout fitted a CTA fits (and longer rows too)."""
    took = [T for T in range(1, 257)
            if max(parent_smem_bytes(T, E, n_head, hidden, b) for b in (False, True)) <= MAX_SMEM]
    assert took and all(ft._shape_error(T, E, n_head, hidden) is None for T in took)
    assert ft._shape_error(max(took) + 1, E, n_head, hidden) is None


def test_trunk_accepted_set_is_divisibility_and_shared_memory():
    """The kernels refuse a shape only for E % 4, hidden % 4, E % n_head or
    shared memory, and at the VAE's T = 16 every E <= 128 (JAX's gate) with
    hidden up to 1,024 fits: there the accepted set is the divisibility rule."""
    for E in range(2, 132, 2):
        for n_head in (1, 2, 3, 4, 6, 8, 16):
            for hidden in (4, 6, 88, 172, 344, 1024):
                divides = E % 4 == 0 and hidden % 4 == 0 and E % n_head == 0
                takes = ft._shape_error(16, E, n_head, hidden) is None
                assert takes == divides, (E, n_head, hidden)
    assert ft._shape_error(400, 32, 8, 88) is not None  # shared memory


def test_trunk_refuses_only_a_thin_band_the_scalar_kernels_took():
    """Where the new layout is larger than the scalar one (short rows: the
    LayerNorm affines of two layers and the pitches padded to 8 outweigh the
    scores the scalar kernels kept), the shapes it refuses and they took
    are the widest hidden layers only: for every E <= 128 (JAX's gate), n_head
    dividing it and T <= 64, the largest hidden taken falls short of the
    scalar kernels' largest by at most 3.3%, never below 328, and not at all
    past T = 36 (ROADMAP.md queue 3 lists the band)."""

    def largest_hidden(smem, T, E, n_head):
        def fits(hidden):
            return max(smem(T, E, n_head, hidden, b) for b in (False, True)) <= MAX_SMEM

        lo, hi = 0, 1 << 17  # fits(lo) or lo == 0; not fits(hi); multiples of 4
        while hi - lo > 4:
            mid = (lo + hi) // 8 * 4
            lo, hi = (mid, hi) if fits(mid) else (lo, mid)
        return lo

    for E in range(4, 132, 4):
        for n_head in (h for h in range(1, E + 1) if E % h == 0):
            for T in range(1, 65):
                took = largest_hidden(parent_smem_bytes, T, E, n_head)
                takes = largest_hidden(ft.trunk_smem_bytes, T, E, n_head)
                if takes < took:
                    assert T <= 36 and takes >= 328 and took - takes <= 0.033 * took, (
                        T, E, n_head, took, takes)
