"""The port at the configs' compute dtype, `model.compute_dtype: bfloat16`
(f32 weights, bf16 products), against the JAX package's modules and tasks
built with `dtype=jnp.bfloat16`, on the same weights (the bridge) and the
same numpy inputs: silu (bit for bit), the input layer, one block, the encoder with its MCAB,
the decoder and the NB head; the whole VAE forward and one
`VAETask.train_step`; the module DiT and one module-path `LDMTask` step;
euler steps of generation through the module denoiser; the algebraic tail
with and without the vw fold and the fused gate; the bf16 plain
`swiglu_vec` against JAX's interpret-mode kernel, forward and gradients.
Then the dtypes (f32 weights and gradients, bf16 block outputs where JAX's
are, f32 operands on the DiT kernel path under a bf16 config against JAX's
`fused_dit_train_apply` in interpret mode), remat (the same gradients bit
for bit), and an f32 config's step bit for bit against the plain
`nn.Linear` / `nn.Embedding` modules the port had before it had a compute
dtype.

Bound (`assert_bf16_near`): over each tensor, the port's largest distance
from JAX's bf16 result is at most K = 2.25 times JAX's own largest
bf16-versus-f32 distance (the same function built with `dtype=jnp.float32`
on the same weights and inputs) plus a floor of FLOOR = 4e-3 of the f32
result's largest magnitude. Both sides round to bf16 at the program's
points, and the port rounds where XLA on the CPU does after each
elementwise op, each of `jax.nn.silu`'s four sigmoid ops included
(`nn.layers.silu`). Where a LayerNorm reads a residual sum, XLA hands its
f32 upcast the sum's unrounded value and the port the rounded one, and the
two sum their cotangents in other orders; so the port's distance runs up to
2.2 times JAX's own among the VAE's gradients here, and the bound needs K =
1.90 (`python -m tests.torch_port.bf16_ratios` prints each tensor's). Since
an f32 port would pass that bound too, the dtypes are checked beside it.
The DiT kernel path, f32 on both sides, is held to 1e-4 as the f32 tests
hold it."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from scldm_tpu.nn.layers import Block as JaxBlock
from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.ops.fused_dit import fused_dit_train_apply as jax_fused_dit_train_apply
from scldm_tpu.ops.fused_swiglu import swiglu_vec as jax_swiglu_vec
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.training.ema import ema_init as jax_ema_init
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.training.ldm_task import split_condition as jax_split_condition
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn import layers
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_swiglu as fs
from scldm_torch.ops.fused_dit import fused_dit_train_apply
from scldm_torch.training import vae_task as tvt
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import load_reference_state_dict
from tests.test_training import make_batch
from tests.torch_port.test_torch_port_dit import randomized_dit_params

K, FLOOR = 2.25, 4e-3
BF = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
G, B, S = 40, 6, 20
VAE_ARCH = dict(n_genes=G, n_embed=16, n_embed_latent=8, n_layer=2, n_inducing_points=4,
                n_head=2, n_head_cross=2)
# the algebraic tail's: a wider decoder, hidden width 96
ALG_ARCH = dict(n_genes=G, n_embed=64, n_embed_latent=16, n_layer=1, n_inducing_points=4,
                n_head=2, n_head_cross=2, multiple_of=16)
DIT_ARCH = dict(n_embed=32, n_embed_input=8, n_layer=2, n_head=2, seq_len=4,
                class_vocab_sizes={"clusters": 3}, cfg_dropout_prob=0.8)
TASK = dict(num_training_steps=100)
LDM_TASK = dict(num_training_steps=10, ema_update_every=1, ema_update_after_step=0)
NOT_COMPARED = ("decoder_head.params.bias",)  # softmax-invariant: its gradient is noise


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def record_ratio(what, err, noise, scale):
    """With SCLDM_BF16_RATIOS set to a file, append one JSON line per tensor
    held: its test, its name, the ratio err / noise (the port's distance from
    JAX's bf16 result over JAX's own bf16-versus-f32 distance) and the K the
    bound needs beside its floor, max(0, err - FLOOR scale) / noise.
    `python -m tests.torch_port.bf16_ratios` runs this file so and tabulates
    the lines."""
    path = os.environ.get("SCLDM_BF16_RATIOS")
    if not path:
        return
    test = os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0].split("::")[-1]
    row = {"test": test, "what": what, "err": err, "noise": noise, "scale": scale,
           "ratio": err / noise if noise > 0 else None,
           "needed_k": max(0.0, err - FLOOR * scale) / noise if noise > 0 else None}
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


def assert_bf16_near(got, want, want_f32, what):
    """max |got - want| <= K max |want - want_f32| + FLOOR max |want_f32|."""
    got, want, ref = (np.asarray(np.asarray(a, np.float32), np.float64)
                      for a in (got, want, want_f32))
    assert got.shape == want.shape == ref.shape, what
    err, noise, scale = np.abs(got - want).max(), np.abs(want - ref).max(), np.abs(ref).max()
    record_ratio(what, float(err), float(noise), float(scale))
    assert err <= K * noise + FLOOR * scale, (
        f"{what}: {err:.3e} > {K} x {noise:.3e} + {FLOOR} x {scale:.3e}")


def np32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def lean_batch(seed=0, dtype=np.int32, n_genes=G):
    rng = np.random.default_rng(seed)
    gs = np.zeros((B, S), dtype)
    cs = np.zeros((B, S), dtype)
    for i in range(B):
        nnz = int(rng.integers(S // 2, S))
        gs[i, :nnz] = np.sort(rng.choice(n_genes, nnz, replace=False)) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    return {"genes_subset": gs, "counts_subset": cs,
            "library_size": cs.astype(np.float32).sum(1, keepdims=True)}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def port_vae(params, arch=VAE_ARCH, dtype=torch.bfloat16, **kw):
    tvae = build_transformer_vae(**arch, dtype=dtype, device="cpu", **kw)
    load_reference_state_dict(tvae, export_torch_state_dict(params), strict=True)
    return tvae


@pytest.fixture(scope="module")
def vae_setup():
    """JAX's VAE task at both dtypes on one state (the weights are f32
    whatever the dtype), and the port's bf16 VAE holding its weights."""
    jtasks = {k: jvt.VAETask(jax_build_vae(**VAE_ARCH, dtype=jd), **TASK)
              for k, (jd, _) in BF.items()}
    state = jtasks["bf16"].init_state(jax.random.PRNGKey(0), to_jax(lean_batch()))
    return jtasks, state


# -- the modules ----------------------------------------------------------------------

def _jax_part(jvae, params, part, inputs):
    if part == "input_layer":
        c, g = inputs
        return jvae.apply(params, c, g, method=lambda m, c, g: m.input_layer(c, g))
    if part == "block":
        block = JaxBlock(n_embed=16, n_head=2, dtype=jvae.encoder.dtype)
        return block.apply({"params": params["params"]["encoder"]["block_0"]}, inputs[0])
    if part == "encoder":
        c, g = inputs
        return jvae.apply(params, c, g, method="encode")
    if part == "decoder":
        z, g = inputs
        return jvae.apply(params, z, g, method=lambda m, z, g: m.decoder(
            z, m.input_layer.embed_genes(g)))
    z, g, lib = inputs
    out = jvae.apply(params, z, g, lib, method="decode")
    return out["mu"], out["theta"]


def _port_part(tvae, part, inputs):
    with torch.no_grad():
        if part == "input_layer":
            return tvae.input_layer(*inputs)
        if part == "block":
            return tvae.encoder.encoder_layers[0](inputs[0])
        if part == "encoder":
            return tvae.encode(*inputs)
        if part == "decoder":
            z, g = inputs
            return tvae.decoder(z, tvae.input_layer.embed_genes(g))
        out = tvae.decode(*inputs)
        return out["mu"], out["theta"]


@pytest.mark.parametrize("part,out_dtype", [
    ("input_layer", "bf16"), ("block", "bf16"), ("encoder", "bf16"), ("decoder", "bf16"),
    ("head", "f32"),
])
def test_vae_modules_match_jax_bf16(vae_setup, part, out_dtype):
    jtasks, state = vae_setup
    tvae = port_vae(state.params)
    rng = np.random.default_rng(1)
    batch = lean_batch(seed=2)
    if part in ("input_layer", "encoder"):
        arrays = (batch["counts_subset"].astype(np.float32), batch["genes_subset"])
    elif part == "block":
        x = rng.normal(size=(B, 4, 16)).astype(np.float32)
        arrays = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)),)
    else:
        z = rng.normal(size=(B, 4, 8)).astype(np.float32)
        genes = np.stack([rng.permutation(G)[:25] + 1 for _ in range(B)]).astype(np.int32)
        arrays = (z, genes) if part == "decoder" else (
            z, genes, rng.uniform(50, 200, size=(B, 1)).astype(np.float32))
    want = {}
    for k, (jd, _) in BF.items():
        ins = [jnp.asarray(a, jd) if (part == "block") else jnp.asarray(a) for a in arrays]
        want[k] = jax.jit(lambda p, *a, jvae=jtasks[k].vae: _jax_part(jvae, p, part, a))(
            state.params, *ins)
    ins = [torch.from_numpy(a).to(torch.bfloat16) if part == "block" else
           (torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a))
           for a in arrays]
    got = _port_part(tvae, part, ins)
    pairs = zip(got, want["bf16"], want["f32"]) if part == "head" else [
        (got, want["bf16"], want["f32"])]
    for i, (g, wb, wf) in enumerate(pairs):
        assert g.dtype == BF[out_dtype][1] and wb.dtype == BF[out_dtype][0], (part, g.dtype)
        assert_bf16_near(np32(g), np32(wb), np32(wf), f"{part}[{i}]")


def _global_norm(tree):
    return float(jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                              for x in jax.tree_util.tree_leaves(tree))))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_silu_matches_jax(dtype):
    """`layers.silu` against `jax.nn.silu`, forward and gradient, on the same
    inputs: in bf16 bit for bit (each op of the sigmoid rounded as XLA
    rounds it, where `F.silu` rounds once), in f32 `F.silu` itself."""
    jdt, tdt = BF[dtype]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((257, 67)) * 4).astype(np.float32)
    g = rng.standard_normal((257, 67)).astype(np.float32)
    y, vjp = jax.vjp(jax.nn.silu, jnp.asarray(x, jdt))
    (gx,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = layers.silu(xt)
    out.backward(torch.from_numpy(g).to(tdt))
    assert out.dtype == xt.grad.dtype == tdt
    if dtype == "bf16":
        np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(y, np.float32))
        np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(gx, np.float32))
    else:
        x32 = torch.from_numpy(x).requires_grad_()
        F.silu(x32).backward(torch.from_numpy(g))
        assert torch.equal(out, F.silu(torch.from_numpy(x))) and torch.equal(xt.grad, x32.grad)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


def test_vae_forward_and_train_step_match_jax_bf16(vae_setup):
    """The module path's forward, gradients and one optimizer step: the
    port's step's loss and gradient norm against the bf16 loss and gradient
    norm JAX's `_train_step_impl` reports (its module-path loss on the
    materialised batch), their f32 reference the f32 module's. The
    gradients reaching the f32 weights are f32, and so are the weights after
    the step."""
    jtasks, state = vae_setup
    jb = jtasks["bf16"]._materialize(to_jax(lean_batch()))
    fwd, grads, loss_norm = {}, {}, {}
    for k, jt in jtasks.items():
        def loss(p, jt=jt):
            out, h_z = jt._apply(p, jb, train=False)
            return jvt.vae_loss(jb["counts"], out, False), (out["mu"], h_z)
        (lv, fwd[k]), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(state.params)
        grads[k], loss_norm[k] = export_torch_state_dict(g), (float(lv), _global_norm(g))
    task = tvt.VAETask(port_vae(state.params), **TASK)
    tb = task._materialize(to_torch(lean_batch(dtype=np.uint16)))
    with torch.no_grad():
        out, h_z = task._apply(tb)
    assert h_z.dtype == torch.bfloat16 and out["mu"].dtype == torch.float32
    assert_bf16_near(np32(out["mu"]), fwd["bf16"][0], fwd["f32"][0], "mu")
    assert_bf16_near(np32(h_z), np32(fwd["bf16"][1]), fwd["f32"][1], "h_z")

    loss, _ = task.loss(to_torch(lean_batch(dtype=np.uint16)))
    loss.backward()
    n = 0
    for name, p in task.vae.named_parameters():
        if not p.requires_grad:
            continue  # the frozen all-zeros positional table
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        if name not in NOT_COMPARED:
            assert_bf16_near(p.grad.numpy(), grads["bf16"][name], grads["f32"][name], name)
            n += 1
    assert n > 40

    tstate = task.init_state(torch.Generator().manual_seed(0))
    tstate, mets = task.train_step(tstate, to_torch(lean_batch(dtype=np.uint16)))
    for i, k in enumerate(("train_loss", "grad_norm")):
        assert_bf16_near(float(mets[k]), loss_norm["bf16"][i], loss_norm["f32"][i], k)
    assert all(p.dtype == torch.float32 for p in tstate.module.parameters())


# -- the algebraic tail and swiglu_vec -------------------------------------------------------

@pytest.mark.parametrize("vw_fold,fused_gate", [(False, False), (True, True)])
def test_algebraic_tail_matches_jax_bf16(vw_fold, fused_gate):
    """`algebraic_nb_apply` (the census path's tail; its fused gate the bf16
    `swiglu_vec`, JAX's in interpret mode): mu and the gradients."""
    jvaes = {k: jax_build_vae(**ALG_ARCH, dtype=jd) for k, (jd, _) in BF.items()}
    jt = jvt.VAETask(jvaes["bf16"], **TASK)
    batch = lean_batch(seed=3)
    state = jt.init_state(jax.random.PRNGKey(1), to_jax(batch))
    jb = jt._materialize(to_jax(batch))
    mu, grads = {}, {}
    for k, jvae in jvaes.items():
        def loss(p, jvae=jvae):
            out, _ = jvt.algebraic_nb_apply(jvae, p, jb, fused_gate=fused_gate, interpret=True,
                                            vw_fold=vw_fold)
            return jvt.vae_loss(jb["counts"], out, False), out["mu"]
        (_, mu[k]), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(state.params)
        grads[k] = export_torch_state_dict(g)
    tvae = port_vae(state.params, ALG_ARCH)
    tb = tvt.VAETask(tvae, **TASK)._materialize(to_torch(batch))
    out, _ = tvt.algebraic_nb_apply(tvae, tb, fused_gate=fused_gate, vw_fold=vw_fold)
    tvt.vae_loss(tb["counts"], out).backward()
    assert_bf16_near(np32(out["mu"]), mu["bf16"], mu["f32"], "mu")
    for name, p in tvae.named_parameters():
        if name not in NOT_COMPARED and p.grad is not None:
            assert p.grad.dtype == torch.float32, name
            assert_bf16_near(p.grad.numpy(), grads["bf16"][name], grads["f32"][name], name)


@pytest.mark.parametrize("R", [333, 700])
def test_swiglu_vec_bf16_matches_jax(R):
    """The bf16 plain version (the CPU tensors' path of the bf16 kernels)
    against JAX's Pallas `swiglu_vec` in interpret mode on bf16 operands:
    s and (dx, dw12, dwv), each in its operand's dtype."""
    rng = np.random.default_rng(R)
    E, hd = 64, 96
    arrays = [rng.normal(size=(R, E)), rng.normal(size=(E, 2 * hd)) / np.sqrt(E),
              rng.normal(size=(hd, 1)) / np.sqrt(hd)]
    arrays = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    ds = rng.normal(size=(R, 1)).astype(np.float32)
    want = {}
    for k, (jd, _) in BF.items():
        out, vjp = jax.vjp(lambda *a: jax_swiglu_vec(*a, 512, True),
                           *(jnp.asarray(a, jd) for a in arrays))
        want[k] = (out, *vjp(jnp.asarray(ds)))
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrays]
    got = fs.swiglu_vec(*leaves)
    got.backward(torch.from_numpy(ds))
    assert got.dtype == torch.float32 and want["bf16"][0].dtype == jnp.float32
    assert_bf16_near(np32(got), want["bf16"][0], want["f32"][0], "s")
    for i, (name, leaf) in enumerate(zip(("dx", "dw12", "dwv"), leaves)):
        assert leaf.grad.dtype == torch.bfloat16 and want["bf16"][i + 1].dtype == jnp.bfloat16
        assert_bf16_near(np32(leaf.grad), np32(want["bf16"][i + 1]), want["f32"][i + 1], name)


# -- the DiT and the LDM task ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ldm_setup():
    """JAX's tiny LDM task at both dtypes on one state, its DiT's zero-init
    layers redrawn (adaLN-zero would make every block the identity)."""
    batch = make_batch(jax.random.PRNGKey(0), n_genes=G)
    vae_arch = dict(VAE_ARCH, n_layer=1)
    vae_params = jax.jit(jax_build_vae(**vae_arch).init)(
        jax.random.PRNGKey(0), batch["counts"], batch["genes"], batch["library_size"],
        batch["counts_subset"], batch["genes_subset"])
    jtasks = {k: JaxLDMTask(jax_build_vae(**vae_arch, dtype=jd), vae_params,
                            JaxDiT(**DIT_ARCH, dtype=jd), jax_create_transport(),
                            learning_rate=5e-4, **LDM_TASK)
              for k, (jd, _) in BF.items()}
    jt = jtasks["bf16"]
    state = jt.init_state(jax.random.PRNGKey(3), batch)
    rows = batch["counts"].shape[0]  # the latents: (rows, 4 inducing points, 8)
    jit_init = types.SimpleNamespace(init=jax.jit(jt.dit.init, static_argnames="train"))
    params = randomized_dit_params(jit_init, jnp.zeros((rows, 4, 8), jnp.float32),
                                   jnp.linspace(0.1, 0.9, rows),
                                   {"clusters": batch["clusters"]}, seed=1)
    state = state.replace(params=params, opt_state=jt.tx.init(params),
                          ema=jax_ema_init(params["params"]))
    return jtasks, vae_params, state, batch, vae_arch


def port_ldm(vae_params, dit_params, vae_arch, dtype=torch.bfloat16, **kw):
    tdit = DiT(**DIT_ARCH, dtype=dtype)
    load_reference_state_dict(tdit, export_torch_state_dict(dit_params), strict=True)
    return LDMTask(port_vae(vae_params, vae_arch, dtype), tdit, create_transport(),
                   learning_rate=5e-4, **LDM_TASK, **kw)


def test_dit_module_matches_jax_bf16(ldm_setup):
    """The module DiT's forward and its batched-CFG forward: f32 out."""
    jtasks, vae_params, state, _, vae_arch = ldm_setup
    task = port_ldm(vae_params, state.params, vae_arch)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 4, 8)).astype(np.float32)
    t = rng.uniform(size=(4,)).astype(np.float32)
    cond = {"clusters": np.array([0, 2, 1, 1], np.int32)}
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    tc = {k: torch.from_numpy(v).long() for k, v in cond.items()}
    for method, extra in (("__call__", ()), ("forward_with_cfg_batched", ({"clusters": 1.5},))):
        want = {k: jax.jit(lambda p, x, t, c, dit=jt.dit: dit.apply(p, x, t, c, *extra,
                                                                     method=method))(
                    state.params, jnp.asarray(x), jnp.asarray(t), jc) for k, jt in jtasks.items()}
        with torch.no_grad():
            fn = task.dit if method == "__call__" else task.dit.forward_with_cfg_batched
            got = fn(torch.from_numpy(x), torch.from_numpy(t), tc, *extra)
        assert got.dtype == torch.float32 and want["bf16"].dtype == jnp.float32
        assert_bf16_near(got.numpy(), want["bf16"], want["f32"], method)


def _ldm_draws(jt, state, batch):
    """The draws of JAX's bf16 `_train_step_impl` at `state`: t and x0 (bf16
    values, as JAX draws the noise in the latents' dtype) and the drop mask."""
    _, rng_t, rng_c, _ = jax.random.split(state.rng, 4)
    t, x0, _ = jt.transport.sample(rng_t, jax.jit(jt._encode)(batch))
    cond = jax_split_condition(batch, jt.dit.class_vocab_sizes)
    embed = jax.jit(lambda p, t, c, rng, train: jt.dit.apply(
        p, t, c, train=train, method="embed_condition", rngs={"condition": rng}),
        static_argnames="train")
    train = embed(state.params, t, cond, rng_c, True)
    plain = embed(state.params, t, cond, rng_c, False)
    dropped = np.abs(np.asarray(train, np.float32) - np.asarray(plain, np.float32)).max(1) > 0
    return t, x0, rng_c, {"t": torch.from_numpy(np.array(t)),
                          "x0": torch.from_numpy(np.asarray(x0, np.float32)),
                          "drop_mask": torch.from_numpy(dropped)}


def test_ldm_module_step_matches_jax_bf16(ldm_setup):
    """One module-path step: the port's loss and gradient norm against JAX's
    bf16 step; JAX's f32 reference is the same loss with the same draws
    (JAX's bf16 noise) through the f32 modules."""
    jtasks, vae_params, state, batch, vae_arch = ldm_setup
    jt = jtasks["bf16"]
    t, x0, rng_c, noise = _ldm_draws(jt, state, batch)
    _, want = jax.jit(jt._train_step_impl)(state, batch, vae_params)
    jf = jtasks["f32"]
    cond = jax_split_condition(batch, jf.dit.class_vocab_sizes)
    z = jax.jit(jf._encode)(batch)

    def f32_loss(p):
        _, xt, ut = jf.transport.path_sampler.plan(t, x0.astype(jnp.float32), z)
        pred = jf.dit.apply(p, xt, t, cond, train=True, rngs={"condition": rng_c})
        return jnp.mean((pred - ut) ** 2)

    loss_f, g = jax.jit(jax.value_and_grad(f32_loss))(state.params)
    norm_f = _global_norm(g)
    task = port_ldm(vae_params, state.params, vae_arch, fused_training=False)
    tstate = task.init_state(torch.Generator().manual_seed(0))
    assert task._encode(to_torch(batch)).dtype == torch.bfloat16
    tstate, mets = task.train_step(tstate, {k: torch.from_numpy(np.array(v))
                                            for k, v in batch.items()}, noise)
    assert_bf16_near(float(mets["train_loss"]), float(want["train_loss"]), float(loss_f), "loss")
    assert_bf16_near(float(mets["grad_norm"]), float(want["grad_norm"]), float(norm_f),
                     "grad_norm")
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tstate.module.parameters() if p.grad is not None)


def test_euler_generation_matches_jax_bf16(ldm_setup):
    """`generate_from_noise(fused_blocks=False)` (make_sample_fn's program
    with the draws given): euler over four time points (three steps) of the
    bf16 module denoiser under CFG, then the bf16 decode."""
    jtasks, vae_params, state, _, vae_arch = ldm_setup
    rng = np.random.default_rng(5)
    z0 = rng.normal(size=(2, 4, 8)).astype(np.float32)
    log_sf = rng.normal(4.0, 0.1, size=(2,)).astype(np.float32)
    genes = np.arange(1, G + 1, dtype=np.int32)
    cond = {"clusters": np.array([0, 2], np.int32)}
    guidance = {"clusters": 2.0}
    want = {}
    for k, jt in jtasks.items():
        sample_ode = jt.transport_sampler.sample_ode(sampling_method="euler", num_steps=4)
        cond_cfg = {n: jnp.concatenate([jnp.asarray(v)] * 2) for n, v in cond.items()}

        @jax.jit
        def generate(dit_params, vae_params, jt=jt, sample_ode=sample_ode, cond_cfg=cond_cfg):
            samples = sample_ode(
                jnp.concatenate([jnp.asarray(z0)] * 2),
                lambda x, t, condition=None: jt.dit.apply(
                    dit_params, x, t, condition, cfg_scale=guidance,
                    method="forward_with_cfg_batched"), condition=cond_cfg)
            sf = jnp.exp(jnp.asarray(log_sf)).reshape(-1, 1)
            out = jt.vae.apply(vae_params, samples, jnp.asarray(genes),
                               jnp.concatenate([sf, sf]), method="decode")
            return samples, out["mu"]

        want[k] = generate(state.params, vae_params)
    task = port_ldm(vae_params, state.params, vae_arch)
    samples, out, evals = task.generate_from_noise(
        torch.from_numpy(z0), torch.from_numpy(log_sf), torch.from_numpy(genes).long(),
        {k: torch.from_numpy(v).long() for k, v in cond.items()}, guidance_weight=guidance,
        sampling_method="euler", num_steps=4, fused_blocks=False)
    assert evals == 3 and samples.dtype == torch.float32
    assert_bf16_near(samples.numpy(), want["bf16"][0], want["f32"][0], "samples")
    assert_bf16_near(out["mu"].numpy(), want["bf16"][1], want["f32"][1], "mu")


def test_dit_kernel_path_stays_f32_under_bf16(ldm_setup):
    """`LDMTask(fused_training=True)`'s trunk on CPU tensors (the DiT
    kernels' plain versions) under a bf16 DiT computes in f32, as JAX's
    `fused_dit_train_apply` (interpret mode) does: given JAX's bf16
    conditioning embedding, the output and the input gradient agree at f32's
    1e-4, and the output is much nearer the f32 module's than the bf16
    module's is."""
    jtasks, vae_params, state, _, vae_arch = ldm_setup
    jt = jtasks["bf16"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 4, 8)).astype(np.float32)
    t = rng.uniform(size=(4,)).astype(np.float32)
    cond = {"clusters": jnp.asarray([0, 2, 1, 1], jnp.int32)}
    t_emb = jax.jit(lambda p, t, c: jt.dit.apply(p, t, c, method="embed_condition"))(
        state.params, jnp.asarray(t), cond)
    assert t_emb.dtype == jnp.bfloat16
    dy = rng.normal(size=x.shape).astype(np.float32)
    d = jt.dit

    @jax.jit
    def fwd_bwd(p, x, t_emb, dy):
        out, vjp = jax.vjp(lambda xx: jax_fused_dit_train_apply(
            p, xx, t_emb, n_layer=d.n_layer, n_head=d.n_head, n_embed=d.n_embed,
            seq_len=d.seq_len, eps=d.layernorm_eps, interpret=True), x)
        return out, vjp(dy)[0]

    want, want_dx = fwd_bwd(state.params, jnp.asarray(x), t_emb, jnp.asarray(dy))
    task = port_ldm(vae_params, state.params, vae_arch, fused_training=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = fused_dit_train_apply(task.dit, xt, torch.from_numpy(np.asarray(t_emb, np.float32))
                                .to(torch.bfloat16))
    got.backward(torch.from_numpy(dy))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)
    f32_module, bf16_module = (jax.jit(lambda p, x, t, c, dit=jtasks[k].dit: dit.apply(
        p, x, t, c))(state.params, jnp.asarray(x), jnp.asarray(t), cond) for k in ("f32", "bf16"))
    near = np.abs(got.detach().numpy() - np.asarray(f32_module)).max()
    assert near < 0.25 * np.abs(np.asarray(bf16_module) - np.asarray(f32_module)).max()


# -- remat and the f32 config --------------------------------------------------------------

def _vae_grads(tvae, batch):
    tvae.zero_grad(set_to_none=True)
    loss, _ = tvt.VAETask(tvae, **TASK).loss(to_torch(batch))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in tvae.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gradients_are_bitwise_equal(vae_setup, dtype):
    """`remat` recomputes each trunk block in the backward: the VAE's and the
    DiT's gradients equal the plain run's bit for bit."""
    _, state = vae_setup
    batch = lean_batch(seed=7)
    runs = [_vae_grads(port_vae(state.params, dtype=dtype, remat=r), batch) for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1].keys() == runs[1][1].keys()
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(4, 4, 8)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(size=(4,)).astype(np.float32))
    cond = {"clusters": torch.tensor([0, 2, 1, 1])}
    grads = []
    for remat in (False, True):
        dit = DiT(**DIT_ARCH, remat=remat, dtype=dtype)
        torch.manual_seed(0)
        for p in dit.parameters():
            nn.init.normal_(p, std=0.2)
        dit(x, t, cond).square().mean().backward()
        grads.append([p.grad for p in dit.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_f32_config_step_is_bitwise_the_plain_modules(vae_setup, monkeypatch):
    """An f32 config computes what the port computed before it had a compute
    dtype: a module-path `VAETask.train_step` gives the same loss, gradients
    and parameters bit for bit as with every dense layer and embedding run
    as a plain `nn.Linear` / `nn.Embedding`."""
    _, state = vae_setup

    def step():
        task = tvt.VAETask(port_vae(state.params, dtype=torch.float32), **TASK)
        tstate = task.init_state(torch.Generator().manual_seed(0))
        tstate, mets = task.train_step(tstate, to_torch(lean_batch(seed=9, dtype=np.uint16)))
        return mets, {n: p.detach().clone() for n, p in tstate.module.named_parameters()}

    mets, params = step()
    monkeypatch.setattr(layers.Linear, "forward", lambda self, x, dtype=None:
                        F.linear(x, self.weight, self.bias))
    monkeypatch.setattr(layers, "embed", lambda table, ids, dtype: table(ids))
    plain_mets, plain_params = step()
    for k in ("train_loss", "grad_norm"):
        assert torch.equal(mets[k], plain_mets[k]), k
    assert all(torch.equal(params[n], plain_params[n]) for n in params)
