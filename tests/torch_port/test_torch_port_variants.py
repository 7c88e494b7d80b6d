"""The transformer-VAE and DiT variants JAX's builders take, in the port,
against the JAX package on the same weights (the bridge) and the same numpy
inputs: the seven input layers (`agg_func`), the encoder without its
positional table, the decoder with its own gene embedding, the NB head with
per-token theta or a temperature, the Gaussian head, the adaLN MCAB, the
decoder's `cross_chunks` and `remat_cross`, dropout through JAX's own masks
(recovered from its modules' intermediates and injected), one
`VAETask.train_step` on three variants, the five VAE kernel gates and the
LDM's over a grid of variants, one bf16 variant step, the builders and
`cli.train` on the CPU.

Tolerances: 1e-4 in f32 (relative to each tensor's largest magnitude where
a gradient is held); the decoder tail's plain version against JAX's
interpret-mode kernel at the bounds `test_torch_port_vae_train.py` holds it
to (loss 1e-3, gradients 2e-2); `remat_cross` bit for bit; the bf16 step at
`test_torch_port_bf16.py`'s K bound."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.config import build as jax_build
from scldm_tpu.nn import layers as jlayers
from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training import ldm_task as jldm
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.config import build
from scldm_torch.nn import layers
from scldm_torch.nn.layers import Drops
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_decoder
from scldm_torch.training import vae_task as tvt
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import init_reference_, load_reference_state_dict
from tests.torch_port.test_torch_port_bf16 import BF, assert_bf16_near
from tests.torch_port.test_torch_port_config import SMALL_DIT, jax_shapes, port_shapes, small_cfg
from tests.torch_port.test_torch_port_dit import randomized_dit_params

G, E, E_LAT, M, N_LAYER, N_HEAD, N_HEAD_X, B, S = 40, 16, 8, 4, 2, 4, 2, 3, 20
ARCH = dict(n_genes=G, n_embed=E, n_embed_latent=E_LAT, n_layer=N_LAYER, n_inducing_points=M,
            n_head=N_HEAD, n_head_cross=N_HEAD_X)
AGG_FUNCS = ("log1p", "log1pzero", "anscombe", "sqrt", "proj", "projconcat", "softbin")
TASK = dict(num_training_steps=100)
# the head's bias cancels in the softmax: its true gradient is 0, both sides noise
SOFTMAX_INVARIANT = ("decoder_head.params.bias",)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def np32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def assert_close(got, want, what, rel=1e-4):
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rel * max(1.0, np.abs(want).max(initial=0.0)), f"{what}: {err:.3e}"


def assert_grads_close(module, want, rel=1e-4, skip=SOFTMAX_INVARIANT):
    """Each gradient of `module`'s parameters within `rel` of its JAX
    counterpart's largest magnitude (`want`: reference-named arrays)."""
    n = 0
    for name, p in module.named_parameters():
        if not p.requires_grad or name in skip:
            continue
        w = np.asarray(want[name])
        if p.grad is None:  # outside the graph: JAX's gradient is zero
            assert not w.any(), name
            continue
        err = np.abs(np32(p.grad) - w).max()
        assert err <= rel * (np.abs(w).max() + 1e-6), f"{name}: {err:.3e}"
        n += 1
    assert n > 0


def cells(seed=0, n_cells=B):
    """Dense counts with zeros (where log1pzero, proj and softbin part from
    log1p), the full gene rows, the library sizes and a window of S tokens."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(1.5, size=(n_cells, G)).astype(np.float32)
    counts[:, :5] = 0.0  # zero-count tokens in every window
    genes = np.tile(np.arange(1, G + 1, dtype=np.int32), (n_cells, 1))
    return counts, genes, counts.sum(1, keepdims=True), counts[:, :S].copy(), genes[:, :S].copy()


def lean_batch(seed=0, dtype=np.int32):
    rng = np.random.default_rng(seed)
    gs = np.zeros((B, S), dtype)
    cs = np.zeros((B, S), dtype)
    for i in range(B):
        nnz = int(rng.integers(S // 2, S))
        gs[i, :nnz] = np.sort(rng.choice(G, nnz, replace=False)) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    return {"genes_subset": gs, "counts_subset": cs,
            "library_size": cs.astype(np.float32).sum(1, keepdims=True)}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


_PAIRS = {}


def pair(**variant):
    """JAX's VAE of ARCH with `variant`, its weights drawn once per variant,
    and the port's on those weights (strict load)."""
    key = tuple(sorted(variant.items()))
    if key not in _PAIRS:
        jvae = jax_build_vae(**ARCH, **variant)
        params = jvae.init(jax.random.PRNGKey(0), *map(jnp.asarray, cells()))
        _PAIRS[key] = (jvae, params, port_vae(params, **variant))
    return _PAIRS[key]


def port_vae(params, dtype=torch.float32, **variant):
    tvae = build_transformer_vae(**ARCH, **variant, dtype=dtype, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(params), strict=True)
    return tvae


# -- the input layer ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg_func", AGG_FUNCS)
def test_input_layer_matches_jax(agg_func):
    """`InputTransformerVAE(agg_func)`: the embedded window and the
    gradients of every parameter, zero-count tokens included."""
    counts, genes = cells(1)[3:]
    jmod = jlayers.InputTransformerVAE(n_genes=G, n_embed=E, agg_func=agg_func)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(counts), jnp.asarray(genes))
    cot = np.random.default_rng(2).normal(size=(B, S, E)).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jmod.apply(p, jnp.asarray(counts), jnp.asarray(genes)), params)
    (jgrad,) = vjp(jnp.asarray(cot))
    tmod = layers.InputTransformerVAE(G, E, agg_func)
    load_reference_state_dict(tmod, export_torch_state_dict(params), strict=True)
    got = tmod(torch.from_numpy(counts), torch.from_numpy(genes).long())
    got.backward(torch.from_numpy(cot))
    assert_close(got, want, agg_func)
    assert_grads_close(tmod, export_torch_state_dict(jgrad))
    zero_rows = np.abs(np32(got)[:, :5]).max(-1)  # the zero-count tokens
    assert (zero_rows == 0).all() if agg_func == "log1p" else (zero_rows > 0).all()


def test_unknown_agg_func_and_head_raise():
    with pytest.raises(ValueError, match="Unknown agg_func"):
        layers.InputTransformerVAE(G, E, "none")
    with pytest.raises(ValueError, match="Unknown decoder_head"):
        build_transformer_vae(**ARCH, decoder_head="poisson", device="cpu")


# -- module variants ----------------------------------------------------------------------------

MODULE_VARIANTS = {
    "no_positional_encoding": dict(positional_encoding=False),
    "unshared_embedding": dict(shared_embedding=False),
    "unshared_theta": dict(decoder_head="negative_binomial_unshared_theta"),
    "gaussian": dict(decoder_head="gaussian"),
    "head_temperature": dict(head_temperature=0.7),
    "softbin_unshared_everything": dict(agg_func="softbin", shared_embedding=False,
                                        decoder_head="negative_binomial_unshared_theta"),
}


def _jax_loss_and_grads(jvae, params, args, gaussian):
    def loss(p):
        out, h_z = jvae.apply(p, *args)
        return jvt.vae_loss(args[0], out, gaussian), (out, h_z)

    (lv, (out, h_z)), g = jax.value_and_grad(loss, has_aux=True)(params)
    return float(lv), out, h_z, export_torch_state_dict(g)


@pytest.mark.parametrize("name", sorted(MODULE_VARIANTS))
def test_module_variant_matches_jax(name):
    """The whole VAE (encode the window, decode every gene), the head's
    parameters, the loss and every gradient; then the decode of the
    canonical 1-D gene row and of per-cell rows."""
    variant = MODULE_VARIANTS[name]
    jvae, params, tvae = pair(**variant)
    gaussian = variant.get("decoder_head") == "gaussian"
    args = tuple(map(jnp.asarray, cells(2)))
    lv, want, want_z, jgrads = _jax_loss_and_grads(jvae, params, args, gaussian)
    tvae.zero_grad()
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs[1], targs[4] = targs[1].long(), targs[4].long()
    got, got_z = tvae(*targs)
    loss = tvt.vae_loss(targs[0], got, gaussian)
    loss.backward()
    assert set(got) == ({"mu"} if gaussian else {"mu", "theta"}) == set(want)
    for k in got:
        assert_close(got[k], want[k], k)
    assert_close(got_z, want_z, "h_z")
    assert float(loss) == pytest.approx(lv, rel=1e-5)
    assert_grads_close(tvae, jgrads)
    if not variant.get("positional_encoding", True):
        assert tvae.encoder.pos_embed is None and "encoder.pos_embed" not in jgrads

    rng = np.random.default_rng(3)
    z = rng.normal(size=(B, M, E_LAT)).astype(np.float32)
    lib = rng.uniform(100, 900, size=(B, 1)).astype(np.float32)
    for genes in (np.arange(1, G + 1, dtype=np.int32),
                  np.stack([rng.permutation(G)[:25] + 1 for _ in range(B)]).astype(np.int32)):
        want = jvae.apply(params, jnp.asarray(z), jnp.asarray(genes), jnp.asarray(lib),
                          method="decode")
        with torch.no_grad():
            got = tvae.decode(torch.from_numpy(z), torch.from_numpy(genes).long(),
                              torch.from_numpy(lib))
        for k in want:
            assert_close(got[k], want[k], f"decode {k} {genes.shape}")


def test_cross_attention_block_adaln_matches_jax():
    """`CrossAttentionBlock(use_adaln=True)`: adaLN-zero over both inputs,
    the queries' own modulation, JAX's swapped modulate chunks; per-cell and
    batch-shared queries, the output and every gradient, on weights whose
    zero-initialised modulations are redrawn."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 6, E)).astype(np.float32)
    cond = rng.normal(size=(B, 1, E)).astype(np.float32)
    for q in (rng.normal(size=(B, 5, E)), rng.normal(size=(5, E))):
        q = q.astype(np.float32)
        jmod = jlayers.CrossAttentionBlock(n_embed=E, n_inducing_points=0, n_head=N_HEAD_X,
                                           use_adaln=True)
        params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(q),
                           jnp.asarray(cond))
        flat = flax.traverse_util.flatten_dict(params)
        params = flax.traverse_util.unflatten_dict({
            k: jnp.asarray(rng.normal(size=v.shape) * 0.3, jnp.float32)
            if any("adaln" in p for p in k) else v for k, v in flat.items()})
        cot = rng.normal(size=(B, 5, E)).astype(np.float32)
        want, vjp = jax.vjp(lambda p, c: jmod.apply(p, jnp.asarray(x), jnp.asarray(q), c),
                            params, jnp.asarray(cond))
        jgrad, jgc = vjp(jnp.asarray(cot))
        tmod = layers.CrossAttentionBlock(E, 0, N_HEAD_X, use_adaln=True)
        load_reference_state_dict(tmod, export_torch_state_dict(params), strict=True)
        tc = torch.from_numpy(cond).requires_grad_()
        got = tmod(torch.from_numpy(x), torch.from_numpy(q), tc)
        got.backward(torch.from_numpy(cot))
        assert_close(got, want, f"adaLN MCAB {q.shape}")
        assert_close(tc.grad, jgc, "condition gradient")
        assert_grads_close(tmod, export_torch_state_dict(jgrad), skip=())


# -- cross_chunks and remat_cross --------------------------------------------------------------

@pytest.mark.parametrize("chunks", [3, 7])  # G = 40 divides by neither: the padded last slice
def test_cross_chunks_match_jax(chunks):
    """The decoder's cross block over `chunks` slices of the gene axis,
    against JAX's chunked module (with `remat_cross`, as the census config
    pairs them): the head's parameters and every gradient."""
    variant = dict(cross_chunks=chunks, remat_cross=True)
    jvae, params, tvae = pair(**variant)
    args = tuple(map(jnp.asarray, cells(5)))
    lv, want, _, jgrads = _jax_loss_and_grads(jvae, params, args, False)
    tvae.zero_grad()
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs[1], targs[4] = targs[1].long(), targs[4].long()
    got, _ = tvae(*targs)
    loss = tvt.vae_loss(targs[0], got)
    loss.backward()
    for k in ("mu", "theta"):
        assert_close(got[k], want[k], k)
    assert float(loss) == pytest.approx(lv, rel=1e-5)
    assert_grads_close(tvae, jgrads)


@pytest.mark.parametrize("chunks", [1, 3])
def test_remat_cross_gradients_are_bitwise(chunks):
    """`remat_cross` recomputes the cross block in the backward: the same
    loss and gradients bit for bit as the same module without it."""
    _, params, _ = pair()
    grads = {}
    for remat in (False, True):
        tvae = port_vae(params, cross_chunks=chunks, remat_cross=remat)
        task = tvt.VAETask(tvae, fused_decoder=False, **TASK)
        loss, _ = task.loss(to_torch(lean_batch(1)))
        loss.backward()
        grads[remat] = (loss.detach(), {n: p.grad.clone() for n, p in tvae.named_parameters()
                                        if p.grad is not None})
    assert torch.equal(grads[True][0], grads[False][0])
    assert grads[True][1].keys() == grads[False][1].keys()
    for name, g in grads[False][1].items():
        assert torch.equal(grads[True][1][name], g), name


# -- dropout -----------------------------------------------------------------------------------

def _is_dropout(module, _):
    return type(module).__name__ == "Dropout"


def jax_keep_masks(intermediates, port_names):
    """JAX's keep masks (a Dropout's output is zero exactly where it dropped)
    by the port's site names: {site: [mask a call]}."""
    flat = flax.traverse_util.flatten_dict(intermediates)
    out = {}
    for path, calls in flat.items():
        site = list(path[:-3])  # ..., "attn", "Dropout_0", "__call__"
        site.append(path[-3])
        name = ".".join(port_names(site))
        out[name] = [torch.from_numpy(np.asarray(c) != 0) for c in calls]
    return out


def _vae_site(path):
    top, *rest = path
    if rest[0].startswith("block_"):
        layers_ = "encoder_layers" if top == "encoder" else "decoder_layers"
        return [top, layers_, rest[0].split("_")[1], *rest[1:]]
    return path


@pytest.mark.parametrize("chunks", [1, 2])
def test_vae_dropout_matches_jax_with_its_masks(chunks):
    """A training forward of the VAE at dropout 0.1 under a known dropout
    rng: JAX's masks of each attention (the cross block's one a chunk)
    injected into the port give JAX's loss and gradients."""
    variant = dict(dropout=0.1, cross_chunks=chunks)
    jvae, params, tvae = pair(**variant)
    args = tuple(map(jnp.asarray, cells(6)))
    rngs = {"dropout": jax.random.PRNGKey(9)}

    def loss(p):
        (out, _), st = jvae.apply(p, *args, train=True, rngs=rngs, mutable=["intermediates"],
                                  capture_intermediates=_is_dropout)
        return jvt.vae_loss(args[0], out, False), (out, st["intermediates"])

    (lv, (want, inter)), g = jax.value_and_grad(loss, has_aux=True)(params)
    keep = jax_keep_masks(inter, _vae_site)
    assert len(keep) == 2 + 2 * N_LAYER and len(keep["decoder.decoder_cross_attention.attn"]) \
        == chunks
    assert sum(int((~k).sum()) for ks in keep.values() for k in ks) > 0  # some entries dropped
    tvae.zero_grad()
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs[1], targs[4] = targs[1].long(), targs[4].long()
    got, _ = tvae(*targs, drops=Drops(tvae, keep=keep))
    tl = tvt.vae_loss(targs[0], got)
    tl.backward()
    assert_close(got["mu"], want["mu"], "mu")
    assert float(tl) == pytest.approx(float(lv), rel=1e-5)
    assert_grads_close(tvae, export_torch_state_dict(g))


def test_dropout_off_in_evaluation_and_repeated_under_remat():
    """Without draws (evaluation, `eval_step`) a VAE with dropout is bit for
    bit the dropout-free VAE on the same weights; a training step drops
    (another loss), and its draws, seeded per site, repeat when the blocks
    and the cross block are recomputed in the backward (`remat`,
    `remat_cross`): the same gradients bit for bit."""
    _, params, _ = pair()
    plain = port_vae(params)
    dropping = port_vae(params, dropout=0.1)
    batch = tvt.VAETask(plain, **TASK)._materialize(to_torch(lean_batch(2)))
    with torch.no_grad():
        for k, v in plain(batch["counts"], batch["genes"], batch["library_size"],
                          batch["counts_subset"], batch["genes_subset"])[0].items():
            got = dropping(batch["counts"], batch["genes"], batch["library_size"],
                           batch["counts_subset"], batch["genes_subset"])[0][k]
            assert torch.equal(got, v), k
    mets = {k: tvt.VAETask(m, fused_decoder=False, **TASK).eval_step(
        None, to_torch(lean_batch(2)), torch.Generator().manual_seed(1))
        for k, m in (("plain", plain), ("dropping", dropping))}
    assert all(torch.equal(mets["plain"][k], mets["dropping"][k]) for k in mets["plain"])
    grads = {}
    for remat in (False, True):
        tvae = port_vae(params, dropout=0.1, remat=remat, remat_cross=remat, cross_chunks=2)
        task = tvt.VAETask(tvae, **TASK)
        state = task.init_state(torch.Generator().manual_seed(3))
        _, m = task.train_step(state, to_torch(lean_batch(2)))
        grads[remat] = (m["train_loss"], {n: p.grad for n, p in tvae.named_parameters()
                                          if p.grad is not None})
    assert torch.equal(grads[True][0], grads[False][0])
    assert all(torch.equal(grads[True][1][n], v) for n, v in grads[False][1].items())
    no_drop = tvt.VAETask(port_vae(params, cross_chunks=2), **TASK)
    assert float(no_drop.loss(to_torch(lean_batch(2)))[0]) != float(grads[False][0])


def test_dit_dropout_matches_jax_with_its_masks():
    """The DiT's blocks at dropout 0.1 under a known dropout rng (adaLN
    layers redrawn, so the attention reaches the output): JAX's masks
    injected into the port's trunk give JAX's output and gradients; without
    draws the trunk is the dropout-free one's bit for bit."""
    arch = dict(n_embed=32, n_embed_input=E_LAT, n_layer=2, n_head=2, seq_len=M)
    jdit = JaxDiT(**arch, dropout=0.1)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, M, E_LAT)).astype(np.float32)
    t = rng.uniform(size=(B,)).astype(np.float32)
    params = randomized_dit_params(jdit, jnp.asarray(x), jnp.asarray(t), {}, seed=2)
    c = rng.normal(size=(B, 32)).astype(np.float32)
    cot = rng.normal(size=(B, M, E_LAT)).astype(np.float32)

    def trunk(p):
        out, st = jdit.apply(p, jnp.asarray(x), jnp.asarray(c)[:, None], True,
                             method=lambda m, x_, c_, tr: m._trunk(x_, c_, tr),
                             rngs={"dropout": jax.random.PRNGKey(4)},
                             mutable=["intermediates"], capture_intermediates=_is_dropout)
        return jnp.sum(out * cot), (out, st["intermediates"])

    (_, (want, inter)), g = jax.value_and_grad(trunk, has_aux=True)(params)
    keep = jax_keep_masks(inter, lambda p: ["blocks", p[0].split("_")[1], *p[1:]])
    assert sorted(keep) == ["blocks.0.attn", "blocks.1.attn"]
    tdit = DiT(**arch, dropout=0.1)
    load_reference_state_dict(tdit, export_torch_state_dict(params), strict=True)
    got = tdit.trunk(torch.from_numpy(x), torch.from_numpy(c), Drops(tdit, keep=keep))
    (got * torch.from_numpy(cot)).sum().backward()
    assert_close(got, want, "DiT trunk")
    assert_grads_close(tdit, export_torch_state_dict(g), skip=())
    plain = DiT(**arch)
    load_reference_state_dict(plain, export_torch_state_dict(params), strict=True)
    with torch.no_grad():
        assert torch.equal(tdit.trunk(torch.from_numpy(x), torch.from_numpy(c)),
                           plain.trunk(torch.from_numpy(x), torch.from_numpy(c)))


# -- VAETask.train_step on three variants ---------------------------------------------------------

STEP_VARIANTS = {
    "softbin_tail": dict(agg_func="softbin"),
    "unshared_modules": dict(decoder_head="negative_binomial_unshared_theta",
                             shared_embedding=False),
    "gaussian": dict(decoder_head="gaussian"),
}


@pytest.fixture(scope="module")
def step_references():
    """Per variant: JAX's task, its state, and its loss and gradients on the
    lean batch (the tail path's through JAX's interpret-mode kernel), each
    computed once."""
    out = {}
    with jax.default_matmul_precision("highest"):
        for name, variant in STEP_VARIANTS.items():
            jvae = jax_build_vae(**ARCH, **variant)
            jtask = jvt.VAETask(jvae, **TASK)
            state = jtask.init_state(jax.random.PRNGKey(1), to_jax(lean_batch()))
            jb = jtask._materialize(to_jax(lean_batch()))
            gaussian = jtask.gaussian_head

            def loss(p, jvae=jvae, jtask=jtask, jb=jb, gaussian=gaussian, name=name):
                if name == "softbin_tail":
                    o, _ = jvt.fused_nb_apply(jvae, p, jb, train=True, interpret=True)
                else:
                    o, _ = jtask._apply(p, jb, train=True)
                return jvt.vae_loss(jb["counts"], o, gaussian)

            lv, g = jax.value_and_grad(loss)(state.params)
            gnorm = float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g))))
            out[name] = (jtask, state, float(lv), gnorm, export_torch_state_dict(g))
    return out


@pytest.mark.parametrize("name", sorted(STEP_VARIANTS))
def test_vae_task_train_step_matches_jax(step_references, name):
    """One `VAETask.train_step` from JAX's state on a lean wire batch: the
    path (the decoder tail under softbin, the modules under the unshared
    embedding and theta or the Gaussian head), the loss, the gradient norm
    and each gradient; no theta metric under the Gaussian head; then the
    validation metrics' keys."""
    jtask, state, lv, gnorm, jgrads = step_references[name]
    variant = STEP_VARIANTS[name]
    tvae = port_vae(state.params, **variant)
    task = tvt.VAETask(tvae, fused_decoder=True, **TASK)
    batch = to_torch(lean_batch(dtype=np.uint16))
    assert task._use_fused(batch) == (name == "softbin_tail")
    assert task.gaussian_head == (name == "gaussian")
    before = fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count
    tstate = task.init_state(torch.Generator().manual_seed(0))
    tstate, mets = task.train_step(tstate, batch)
    assert fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count == before  # CPU: the plain version
    assert ("train_theta" in mets) == (name != "gaussian")
    loss_rel, grad_rel = (1e-3, 2e-2) if name == "softbin_tail" else (1e-5, 1e-4)
    assert float(mets["train_loss"]) == pytest.approx(lv, rel=loss_rel)
    assert float(mets["grad_norm"]) == pytest.approx(gnorm, rel=10 * loss_rel)
    want = port_vae(state.params, **variant)
    task2 = tvt.VAETask(want, fused_decoder=True, **TASK)
    loss, _ = task2.loss(batch)
    loss.backward()
    assert_grads_close(want, jgrads, grad_rel)
    val = task.eval_step(tstate, to_torch(lean_batch(4)), torch.Generator().manual_seed(0))
    assert ("val_theta" in val) == (name != "gaussian")
    assert all(torch.isfinite(v) for v in val.values())


def test_gaussian_eval_metrics_match_jax(step_references):
    """The Gaussian branch of `eval_step`: the mean is the prediction, on
    the log1p-CPM scale, no theta."""
    jtask, state, *_ = step_references["gaussian"]
    want = jtask._eval_step_impl(state.params, to_jax(lean_batch(4)), jax.random.PRNGKey(0))
    task = tvt.VAETask(port_vae(state.params, decoder_head="gaussian"), **TASK)
    got = task.eval_step(None, to_torch(lean_batch(4)), torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k


# -- the gates ---------------------------------------------------------------------------------

GATE_VARIANTS = [
    {}, dict(agg_func="sqrt"), dict(agg_func="softbin"), dict(agg_func="log1pzero"),
    dict(agg_func="proj", positional_encoding=False), dict(dropout=0.1),
    dict(shared_embedding=False), dict(decoder_head="negative_binomial_unshared_theta"),
    dict(decoder_head="gaussian"), dict(head_temperature=0.5), dict(remat=True),
    dict(bias=True), dict(n_embed=256), dict(n_embed=192, n_head=4),
    dict(n_embed=256, dropout=0.1), dict(cross_chunks=2, remat_cross=True),
]
GATES = ("_fused_path_ok", "_algebraic_path_ok", "_fused_encoder_ok", "_fused_window_ok",
         "_fused_trunk_ok")


@pytest.mark.parametrize("variant", GATE_VARIANTS,
                         ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_vae_gates_match_jax(variant):
    """The five kernel gates of the VAE task, each the JAX package's on the
    same architecture."""
    arch = dict(ARCH, n_layer=1, **variant)
    jvae = jax_build_vae(**arch)
    tvae = build_transformer_vae(**arch, device="cpu")
    for gate in GATES:
        assert getattr(tvt, gate)(tvae) == getattr(jvt, gate)(jvae), gate


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_ldm_gates_match_jax(dropout, monkeypatch):
    """The LDM's fused training (JAX: on a TPU with DiT dropout 0; the port:
    on CUDA tensors with dropout 0) and its fused sampler (the same rule),
    and an explicit fused_training=True on a DiT that drops raises."""
    arch = dict(n_embed=32, n_embed_input=E_LAT, n_layer=1, n_head=2, seq_len=M)
    monkeypatch.setattr(jldm.jax, "default_backend", lambda: "tpu")
    jtask = jldm.LDMTask(jax_build_vae(**ARCH), None, JaxDiT(**arch, dropout=dropout),
                         jax_create_transport())
    tvae = build_transformer_vae(**ARCH, device="cpu")
    task = LDMTask(tvae, DiT(**arch, dropout=dropout), create_transport())
    on_card = type("OnCard", (), {"is_cuda": True})()
    assert task._use_fused(on_card) == jtask.fused_training == (dropout == 0.0)
    assert task._fused_sampler(task.dit, True) == (dropout == 0.0)
    assert not task._fused_sampler(task.dit, False)
    if dropout:
        with pytest.raises(ValueError, match="no dropout"):
            LDMTask(tvae, DiT(**arch, dropout=dropout), create_transport(), fused_training=True)


def test_ldm_step_with_dit_dropout_and_gaussian_generation_raises():
    """A module-path LDM step over a DiT with dropout draws its masks from
    the step's generator, after the transport's draws: a repeat from the same
    generator state repeats the loss, and injected all-keep masks give the
    loss of the dropout-free DiT whose attention outputs are scaled by 1 /
    (1 - rate); generation from a Gaussian-head VAE raises for want of
    theta."""
    from scldm_torch.sampling.size_factors import SizeFactorSampler

    arch = dict(n_embed=32, n_embed_input=E_LAT, n_layer=2, n_head=2, seq_len=M)
    g = torch.Generator().manual_seed(0)
    tvae = init_reference_(build_transformer_vae(**ARCH, device="cpu"), g)
    dit = init_reference_(DiT(**arch, dropout=0.5), g, zero_init=False)
    task = LDMTask(tvae.eval(), dit, create_transport())
    batch = to_torch(lean_batch())
    losses = [float(task.loss(batch, torch.Generator().manual_seed(5))) for _ in range(2)]
    assert losses[0] == losses[1]
    keep = {f"blocks.{i}.attn": [torch.ones(B, M, 32, dtype=torch.bool)] for i in range(2)}
    kept = float(task.loss(batch, torch.Generator().manual_seed(5),
                           {"drops": Drops(dit, keep=keep)}))
    plain = DiT(**arch)
    plain.load_state_dict(dit.state_dict())
    with torch.no_grad():
        for block in plain.blocks:  # x / (1 - 0.5) where every entry is kept
            block.attn.c_proj.weight.mul_(2.0)
            block.attn.c_proj.bias.mul_(2.0)
    want = float(LDMTask(tvae, plain, create_transport()).loss(
        batch, torch.Generator().manual_seed(5)))
    assert kept == pytest.approx(want, rel=1e-6) and losses[0] != kept
    gvae = build_transformer_vae(**ARCH, decoder_head="gaussian", device="cpu")
    sampler = SizeFactorSampler.__new__(SizeFactorSampler)
    fn = LDMTask(gvae, plain, create_transport()).make_sample_fn(sampler, num_steps=2)
    with pytest.raises(ValueError, match="no theta"):
        fn(torch.Generator(), torch.arange(1, G + 1), batch_size=2)


# -- bf16 --------------------------------------------------------------------------------------

def test_bf16_variant_step_matches_jax():
    """One module-path loss and backward of a bf16 variant (softbin input,
    the unshared gene embedding and theta) against JAX's bf16 and f32 on the
    same weights, at `test_torch_port_bf16.py`'s bound; f32 weights and
    gradients, bf16 latents."""
    variant = dict(agg_func="softbin", shared_embedding=False,
                   decoder_head="negative_binomial_unshared_theta")
    jvaes = {k: jax_build_vae(**ARCH, **variant, dtype=jd) for k, (jd, _) in BF.items()}
    jt = jvt.VAETask(jvaes["bf16"], **TASK)
    state = jt.init_state(jax.random.PRNGKey(2), to_jax(lean_batch()))
    jb = jt._materialize(to_jax(lean_batch()))
    loss_v, grads, hz = {}, {}, {}
    for k, jvae in jvaes.items():
        task_k = jvt.VAETask(jvae, **TASK)

        def loss(p, task_k=task_k):
            out, h_z = task_k._apply(p, jb, train=False)
            return jvt.vae_loss(jb["counts"], out, False), h_z

        (lv, hz[k]), g = jax.value_and_grad(loss, has_aux=True)(state.params)
        loss_v[k], grads[k] = float(lv), export_torch_state_dict(g)
    tvae = port_vae(state.params, dtype=torch.bfloat16, **variant)
    task = tvt.VAETask(tvae, **TASK)
    tb = task._materialize(to_torch(lean_batch(dtype=np.uint16)))
    out, h_z = task._apply(tb)
    loss = tvt.vae_loss(tb["counts"], out)
    loss.backward()
    assert h_z.dtype == torch.bfloat16 and out["mu"].dtype == out["theta"].dtype == torch.float32
    assert_bf16_near(np32(h_z), np32(hz["bf16"]), np32(hz["f32"]), "h_z")
    assert_bf16_near(float(loss), loss_v["bf16"], loss_v["f32"], "loss")
    n = 0
    for name, p in tvae.named_parameters():
        if p.requires_grad and name not in SOFTMAX_INVARIANT:
            assert p.dtype == p.grad.dtype == torch.float32, name
            assert_bf16_near(p.grad.numpy(), grads["bf16"][name], grads["f32"][name], name)
            n += 1
    assert n > 30


# -- the builders and the CLI ------------------------------------------------------------------

VALUES = [
    ["model.vae.dropout=0.1"], ["model.vae.positional_encoding=false"],
    ["model.vae.shared_embedding=false"], ["model.remat_cross=true", "model.cross_chunks=3"],
    *[[f"model.vae.agg_func={a}"] for a in AGG_FUNCS],
    *[[f"model.decoder_name={d}"] for d in ("negative_binomial_shared_theta",
                                            "negative_binomial_unshared_theta", "gaussian")],
]


@pytest.mark.parametrize("overrides", VALUES, ids=lambda o: " ".join(o))
def test_build_vae_takes_the_value_as_jax(overrides):
    """`build_vae` takes each value, with the parameter names and shapes of
    JAX's `build_vae` on the same config (through the bridge's names)."""
    cfg = small_cfg("vae_training.yaml", SMALL_DIT + overrides)
    tvae = build.build_vae(cfg)
    jvae = jax_build.build_vae(cfg)
    n_genes = cfg["model"]["vae"]["n_genes"]
    counts = jnp.ones((2, n_genes), jnp.float32)
    genes = jnp.broadcast_to(jnp.arange(1, n_genes + 1), (2, n_genes))
    shapes = jax.eval_shape(lambda: jvae.init(jax.random.PRNGKey(0), counts, genes,
                                              jnp.ones((2, 1)), counts, genes))
    assert port_shapes(tvae) == jax_shapes(shapes)
    d, m = tvae.decoder, cfg["model"]
    assert (tvae.encoder.dropout, d.shared_embedding, d.remat_cross, d.cross_chunks,
            tvae.input_layer.agg_func) == (
        float(m["vae"].get("dropout", 0.0)), m["vae"].get("shared_embedding", True),
        m.get("remat_cross", False), m.get("cross_chunks", 1), m["vae"].get("agg_func", "log1p"))


@pytest.mark.parametrize("variant", [
    dict(agg_func="softbin", shared_embedding=False, decoder_head="gaussian"),
    dict(agg_func="proj", decoder_head="negative_binomial_unshared_theta"),
    dict(agg_func="projconcat", positional_encoding=False),
])
def test_init_reference_draws_the_new_parameters_as_jax(variant):
    """`init_reference_` on the variants' parameters, with JAX's
    initialisers: N(0, 1) tables and bins, xavier-uniform dense kernels
    within their bound, zero biases, unit LayerNorm scales; no positional
    table without `positional_encoding`."""
    vae = init_reference_(build_transformer_vae(**ARCH, **variant, device="cpu"),
                          torch.Generator().manual_seed(0))
    jvae = jax_build_vae(**ARCH, **variant)
    want = export_torch_state_dict(jvae.init(jax.random.PRNGKey(0), *map(jnp.asarray, cells())))
    got = {k: v.detach() for k, v in vae.named_parameters()}
    assert set(got) == set(want)
    for name, p in got.items():
        w = np.asarray(want[name])
        if name.endswith("bias") or name == "encoder.pos_embed":
            assert not p.any() and not w.any(), name
        elif p.ndim == 1 or name == "decoder_head.theta.weight":  # scales, the theta table
            assert torch.all(p == 1) and np.all(w == 1), name
        elif name.endswith(("gene_embedding.weight", "bin_embeddings", "inducing_points")):
            assert 0.7 < float(p.std()) < 1.3 and 0.7 < w.std() < 1.3, name
        else:  # a dense kernel: xavier-uniform, (out, in)
            bound = np.sqrt(6.0 / sum(p.shape))
            assert float(p.abs().max()) <= bound and np.abs(w).max() <= bound, name
            assert float(p.abs().max()) > 0.5 * bound, name


def test_build_dit_takes_dropout_and_unknown_values_raise():
    cfg = small_cfg("ldm_training.yaml", SMALL_DIT + ["model.diffusion_model.dropout=0.1"])
    dit = build.build_dit(cfg)
    assert dit.dropout == 0.1 and all(b.attn.dropout == 0.1 for b in dit.blocks)
    for bad, match in ((["model.vae.agg_func=none"], "Unknown agg_func"),
                       (["model.decoder_name=poisson"], "Unknown decoder_head")):
        with pytest.raises(ValueError, match=match):
            build.build_vae(small_cfg("vae_training.yaml", SMALL_DIT + bad))


def test_cli_train_takes_softbin_and_vae_only_reconstructs_gaussian_means(tmp_path):
    """`cli.train` on the CPU with `model.vae.agg_func=softbin` for one step
    writes a checkpoint and a finite loss; `inference vae_only=true` on a
    one-step Gaussian-head VAE writes its means as the reconstruction."""
    import csv
    import json

    from scldm_tpu.data.h5ad import write_h5ad
    from scldm_torch.cli import inference, train
    from scldm_torch.data.h5ad import H5ADFile
    from tests.torch_port.test_torch_port_cli import config, overrides

    rng = np.random.default_rng(0)
    n, g = 48, 24
    write_h5ad(tmp_path / "train.h5ad", rng.poisson(1.0, size=(n, g)).astype(np.float32),
               obs={"clusters": rng.choice(["c0", "c1"], size=n)},
               var_names=[f"g{i}" for i in range(g)])
    (tmp_path / "meta.json").write_text(json.dumps(
        {"genes": [f"g{i}" for i in range(g)], "labels": {"clusters": ["c0", "c1"]}}))
    stats = {"clusters": {"c0": 3.5, "c1": 3.5}}
    (tmp_path / "mu.json").write_text(json.dumps(stats))
    (tmp_path / "sd.json").write_text(json.dumps({"clusters": {"c0": 0.1, "c1": 0.1}}))
    for name, variant in (("softbin", ["model.vae.agg_func=softbin"]),
                          ("gaussian", ["model.decoder_name=gaussian"])):
        ov = overrides(tmp_path, name) + ["device=cpu", "training.max_steps=1",
                                          "training.steps_per_dispatch=1",
                                          "training.log_every_steps=1"] + variant
        assert train.main(config("vae_training.yaml") + ov) == 0
        ckpt = tmp_path / name / "checkpoints" / "vae_dentate_gyrus"
        snap = json.loads((ckpt / "config.json").read_text())
        assert snap["model"]["vae"].get("agg_func", "log1p") == (
            "softbin" if name == "softbin" else "log1p")
        rows = [r for r in csv.DictReader((ckpt / "metrics.csv").open()) if r["train_loss"]]
        assert rows and all(np.isfinite(float(r["train_loss"])) for r in rows)
    out = tmp_path / "gaussian" / "vae_inference"
    assert inference.main(config("inference.yaml") + overrides(tmp_path, "gaussian") + [
        "device=cpu", "vae_only=true", f"paths.inference_path={out}"]) == 0
    files = sorted(out.glob("*.h5ad"))
    assert files
    f = H5ADFile(files[0])
    recon = f.rows(slice(0, f.n_obs))
    assert np.isfinite(recon).all() and not np.allclose(recon, np.round(recon))
