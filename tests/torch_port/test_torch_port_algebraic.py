"""The census-width VAE path against the JAX package: `swiglu_vec` (the port's
plain version on CPU tensors; JAX's Pallas kernel in interpret mode), the
algebraic tail `algebraic_nb_apply` with and without the output-projection
fold and the fused gate, one `VAETask.train_step` on the algebraic path, and
the task's dispatch.

Size: a census-like VAE cut to run on the CPU in seconds (E=256, 8 self and 8
cross heads, multiple_of 64 so the SwiGLU hidden width is 704, 64 inducing
points, a 64-wide latent, 2 layers), G=300 genes, an S=64-token window, B=4
cells; weights carried across by `export_torch_state_dict`, inputs from
numpy. Everything is f32 on both sides, with
`jax.default_matmul_precision("highest")`.

Tolerances: 1e-4, as a share of each tensor's largest magnitude where the
tensor is a sum over many rows (the gradients, the swiglu_vec outputs), and
relative otherwise; both sides compute the same f32 products and differ in
the order of their sums. The one optimizer step is held like
test_torch_port_vae_train.py's module-path step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.ops.fused_swiglu import swiglu_vec as jax_swiglu_vec
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_swiglu as fs
from scldm_torch.ops.transforms import canonical_gene_ids
from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
from scldm_torch.training import vae_task as tvt
from scldm_torch.utils.weights import load_reference_state_dict

G, S, B = 300, 64, 4
ARCH = dict(n_genes=G, n_embed=256, n_embed_latent=64, n_layer=2, n_inducing_points=64,
            n_head=8, n_head_cross=8, multiple_of=64)
HD = 704  # the SwiGLU hidden width at E=256, multiple_of 64
TASK = dict(num_training_steps=100)
NOT_COMPARED = ("decoder_head.params.bias",)  # softmax-invariant: its gradient is noise


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def lean_batch(seed=0, dtype=np.int32):
    """A lean wire batch: 32 to 63 expressed genes a cell, Poisson(3)+1
    counts, zero-padded to the window."""
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


@pytest.fixture(scope="module")
def setup():
    with jax.default_matmul_precision("highest"):
        jvae = jax_build_vae(**ARCH)
        jtask = jvt.VAETask(jvae, **TASK)
        state = jtask.init_state(jax.random.PRNGKey(0), to_jax(lean_batch()))
    return jvae, jtask, state


def port_task(state, **kw):
    """A port VAETask whose module holds the JAX state's parameters."""
    tvae = build_transformer_vae(**ARCH, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(state.params))
    task = tvt.VAETask(tvae, **TASK, **kw)
    return task, task.init_state(torch.Generator().manual_seed(0))


def assert_near(got, want, what, share=1e-4):
    """Every entry within `share` of the reference's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert np.abs(got - want).max() <= share * scale, (what, np.abs(got - want).max(), scale)


def assert_grads_near(tvae, want_grads: dict, share=1e-4):
    n = 0
    for name, p in tvae.named_parameters():
        if name in NOT_COMPARED or not p.requires_grad:
            continue
        assert_near(p.grad.numpy(), want_grads[name], name, share)
        n += 1
    assert n > 40


# -- swiglu_vec ------------------------------------------------------------------

@pytest.mark.parametrize("R", [777, 1200])  # ragged against JAX's 512-row tiles; the tail's rows
def test_swiglu_vec_matches_jax(R):
    rng = np.random.default_rng(R)
    E = ARCH["n_embed"]
    x = rng.normal(size=(R, E)).astype(np.float32)
    w12 = (rng.normal(size=(E, 2 * HD)) / np.sqrt(E)).astype(np.float32)
    wv = (rng.normal(size=(HD, 1)) / np.sqrt(HD)).astype(np.float32)
    ds = rng.normal(size=(R, 1)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jax_swiglu_vec(*a, 512, True), *map(jnp.asarray, (x, w12, wv)))
    want_grads = vjp(jnp.asarray(ds))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w12, wv)]
    launches = (fs.SWIGLU_VEC_FWD_LAUNCHES.count, fs.SWIGLU_VEC_BWD_LAUNCHES.count)
    got = fs.swiglu_vec(*leaves)
    got.backward(torch.from_numpy(ds))
    # CPU tensors: the plain version both ways, no kernel launch
    assert (fs.SWIGLU_VEC_FWD_LAUNCHES.count, fs.SWIGLU_VEC_BWD_LAUNCHES.count) == launches
    assert got.shape == (R, 1) and got.dtype == torch.float32
    assert_near(got.detach().numpy(), want, "out")
    for name, leaf, w in zip(("dx", "dw12", "dwv"), leaves, want_grads):
        assert_near(leaf.grad.numpy(), w, name)


@pytest.mark.parametrize("case,match", [
    ("w12 shape", "w12 must be"),
    ("wv shape", "wv must be"),
    ("ds shape", "ds must be"),
    ("bf16", "float32"),
    ("strided", "contiguous"),
    ("pitches off 16 bytes", None),
])
def test_swiglu_vec_check_raises(case, match):
    """The kernels' operand check (device-free, so it runs here): shapes,
    float32 only, contiguous. On CUDA tensors the wrapper raises with it and
    never takes the plain version. Widths whose rows are not 16 bytes apart
    (E = 30, Hd = 70) pass it: the wrappers pad them for TMA."""
    if match is None:
        R, E, hd = 777, 30, 70
        assert fs._check(torch.zeros(R, E), torch.zeros(E, 2 * hd), torch.zeros(hd, 1),
                         torch.zeros(R, 1)) == (R, E, hd)
        return
    R, E, hd = 10, 8, 6
    x, w12 = torch.zeros(R, E), torch.zeros(E, 2 * hd)
    wv, ds = torch.zeros(hd, 1), torch.zeros(R, 1)
    if case == "w12 shape":
        w12 = torch.zeros(E, 2 * hd + 1)
    elif case == "wv shape":
        wv = torch.zeros(hd, 2)
    elif case == "ds shape":
        ds = torch.zeros(R, 2)
    elif case == "bf16":
        x = x.bfloat16()
    else:
        x = torch.zeros(E, R).t()
    with pytest.raises(ValueError, match=match):
        fs._check(x, w12, wv, ds)


def _parents_workspace_floats(R, E, Hd, vec):
    """The workspace of the SIMT kernels these replaced: du of a 32,768-row
    chunk, dw12's 8 partials, and swiglu_vec's dwv partials a 128-row tile."""
    rows = min(R, 32_768)
    return rows * 2 * Hd + 8 * E * 2 * Hd + (-(-rows // 128) * Hd if vec else 0)


# below the 32,768-row chunk (the GPU tests' shapes, one with pitches off 16
# bytes), at it, and above it (the GPU test across a chunk, the census decoder)
@pytest.mark.parametrize("R,E,Hd", [(300, 200, 100), (777, 30, 70), (1001, 512, 1408),
                                    (32_768, 512, 1408), (40_000, 64, 100),
                                    (16 * 36_601, 512, 1408)])
def test_swiglu_workspace_within_the_parents(R, E, Hd):
    """The backward's workspace (the wrappers allocate what the C entries
    state; the cuda tests hold the two equal) stays within the one it
    replaced: the census step's peak memory is what the fused gate is for."""
    vec, gate = fs.swiglu_vec_workspace_floats(R, E, Hd), fs.swiglu_gate_workspace_floats(R, E, Hd)
    assert 0 < gate < vec <= _parents_workspace_floats(R, E, Hd, True)
    assert gate <= _parents_workspace_floats(R, E, Hd, False)
    # bounded by the chunk, not by R
    assert fs.swiglu_vec_workspace_floats(2 * R, E, Hd) == vec or R < fs.SWIGLU_CHUNK


def test_swiglu_tma_operands():
    """What the wrappers hand the kernels: x and w12 as they are where their
    rows start 16 bytes apart; else copies padded with zero columns, w12's w2
    block moved to a column that is a multiple of 4."""
    x = torch.randn(5, 32)
    assert fs._tma_operand(x) == (x, 32)
    x30 = torch.randn(5, 30)
    xk, ldx = fs._tma_operand(x30)
    assert ldx == 32 and xk.shape == (5, 32)
    assert torch.equal(xk[:, :30], x30) and not xk[:, 30:].any()
    w1, w2 = torch.randn(3, 64), torch.randn(3, 64)
    w12, ldw = fs._tma_weights(w1, w2)
    assert ldw == 128 and torch.equal(w12, torch.cat((w1, w2), dim=1))
    w1, w2 = torch.randn(3, 70), torch.randn(3, 70)
    w12, ldw = fs._tma_weights(w1, w2)
    assert ldw == 144 and w12.shape == (3, 144)
    assert torch.equal(w12[:, :70], w1) and torch.equal(w12[:, 72:142], w2)
    assert not w12[:, 70:72].any() and not w12[:, 142:].any()
    vec, ldv = fs._vec_weights(torch.cat((w1, w2), dim=1), 70)
    assert ldv == 144 and torch.equal(vec, w12)


# -- the algebraic tail ------------------------------------------------------------

@pytest.mark.parametrize("fused_gate", [False, True])
@pytest.mark.parametrize("vw_fold", [False, True])
def test_algebraic_nb_apply_matches_jax(setup, vw_fold, fused_gate):
    """mu, theta, the loss and every parameter's gradient; JAX runs its
    Pallas swiglu_vec in interpret mode where `fused_gate` asks for it."""
    jvae, jtask, state = setup
    jb = jtask._materialize(to_jax(lean_batch()))

    def jloss(params):
        out, z = jvt.algebraic_nb_apply(jvae, params, jb, train=True, fused_gate=fused_gate,
                                        interpret=fused_gate, vw_fold=vw_fold)
        return jvt.vae_loss(jb["counts"], out, False), (out, z)

    (want_loss, (want, want_z)), jgrads = jax.value_and_grad(jloss, has_aux=True)(state.params)
    task, _ = port_task(state)
    tb = task._materialize(to_torch(lean_batch()))
    got, got_z = tvt.algebraic_nb_apply(task.vae, tb, fused_gate=fused_gate, vw_fold=vw_fold)
    loss = tvt.vae_loss(tb["counts"], got)
    loss.backward()
    np.testing.assert_allclose(got_z.detach().numpy(), np.asarray(want_z), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["theta"].detach().numpy(), np.asarray(want["theta"]), rtol=1e-6)
    np.testing.assert_allclose(got["mu"].detach().numpy(), np.asarray(want["mu"]), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want["mu"]).max()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    assert_grads_near(task.vae, export_torch_state_dict(jgrads))


@pytest.mark.parametrize("vw_fold", [False, True])
def test_algebraic_path_matches_module_path(setup, vw_fold):
    """The port's algebraic tail against its own module decoder, the same
    function reassociated: loss within 1e-5 relative (JAX's bound between
    its two paths), each gradient within 1e-4 of its largest magnitude."""
    *_, state = setup
    task, _ = port_task(state)
    tb = task._materialize(to_torch(lean_batch(seed=1)))
    grads = []
    for fn in (lambda: tvt.algebraic_nb_apply(task.vae, tb, vw_fold=vw_fold),
               lambda: task._apply(tb)):
        task.vae.zero_grad(set_to_none=True)
        loss = tvt.vae_loss(tb["counts"], fn()[0])
        loss.backward()
        grads.append((float(loss.detach()), {n: p.grad.clone() for n, p
                                             in task.vae.named_parameters() if p.grad is not None}))
    (la, ga), (lm, gm) = grads
    np.testing.assert_allclose(la, lm, rtol=1e-5)
    assert set(ga) == set(gm)
    for name in gm:
        if name not in NOT_COMPARED:
            assert_near(ga[name].numpy(), gm[name].numpy(), name)


def f64_gradients(state) -> dict:
    """The port's gradients of the algebraic step's loss evaluated in f64
    throughout (weights, activations, and the f32 casts the modules make,
    which keep f64 here): a reference that no f32 summation order sets."""
    tvae = build_transformer_vae(**ARCH, device="cpu", dtype=torch.float64)
    load_reference_state_dict(tvae, export_torch_state_dict(state.params))
    tvae = tvae.double()
    task = tvt.VAETask(tvae, **TASK)
    to_f32 = torch.Tensor.float
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float",
                   lambda t: t if t.dtype == torch.float64 else to_f32(t))
        batch = to_torch(lean_batch())
        assert task._use_algebraic(batch)
        loss, _ = task.loss(batch)
        loss.backward()
    return {n: p.grad.numpy() for n, p in tvae.named_parameters() if p.grad is not None}


def test_train_step_matches_jax(setup):
    """One optimizer step on the plain algebraic path (fold on, the default)
    from the same parameters and batch: the metrics at 1e-5 relative and the
    parameters within a tenth of the first AdamW step's size where the
    gradient's sign is sure. Sure means beyond 1e-6 of the tensor's largest
    in the f64 gradient (`f64_gradients`): both packages' f32 gradients
    carry about 1e-6 of their largest in summation-order noise, so an f32
    gradient alone (JAX's, or the port's at any thread count) would call an
    entry sure that its order set."""
    jvae, jtask, state = setup
    assert jtask.algebraic_tail and jtask.algebraic_vw_fold and not jtask.algebraic_fused_gate
    ref_grad = f64_gradients(state)
    # the jitted step donates its state: run the same program undonated
    new_state, want = jax.jit(jtask._train_step_impl)(state, to_jax(lean_batch()))
    task, tstate = port_task(state)
    lean = to_torch(lean_batch())
    assert task._use_algebraic(lean) and not task._use_fused(lean)
    before = {n: p.detach().clone() for n, p in tstate.module.named_parameters()}
    tstate, mets = task.train_step(tstate, to_torch(lean_batch(dtype=np.uint16)))
    for k in ("train_loss", "grad_norm", "train_theta"):
        np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-5)
    step = 1e-3 * float(mets["lr_mult"])  # learning_rate * lr_mult at step 0
    got = {n: p.detach().numpy() for n, p in tstate.module.named_parameters()}
    for name, w in export_torch_state_dict(new_state.params).items():
        if name in NOT_COMPARED:
            continue
        g = np.abs(ref_grad[name]) if name in ref_grad else np.zeros_like(w)
        sure = g > 1e-6 * (g.max() + 1e-30)
        assert np.abs(got[name] - w)[sure].max(initial=0.0) <= 0.1 * step, name
        assert np.all(np.abs(got[name] - before[name].numpy()) <= 1.01 * step), name


def test_eval_step_takes_the_algebraic_path(setup):
    jvae, jtask, state = setup
    task, tstate = port_task(state)
    want = jtask.eval_step(state, to_jax(lean_batch()), jax.random.PRNGKey(3))
    calls = []
    real = tvt.algebraic_nb_apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvt, "algebraic_nb_apply", lambda *a, **k: calls.append(k) or real(*a, **k))
        got = task.eval_step(tstate, to_torch(lean_batch()), torch.Generator().manual_seed(3))
    assert calls == [{"fused_gate": False, "vw_fold": True}]
    for k in ("val_loss", "val_llh", "val_theta"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


# -- dispatch -----------------------------------------------------------------------

@pytest.mark.parametrize("E,kw", [
    (256, {}),
    (256, {"algebraic_fused_gate": True}),
    (256, {"algebraic_tail": False, "algebraic_fused_gate": True}),
    (256, {"algebraic_vw_fold": False}),
    (48, {}),
    (48, {"algebraic_fused_gate": True}),
    (48, {"algebraic_tail": True}),
    (48, {"algebraic_tail": True, "algebraic_vw_fold": False, "algebraic_fused_gate": True}),
])
def test_dispatch_resolves_as_jax(E, kw):
    """algebraic_tail, algebraic_vw_fold and algebraic_fused_gate resolve as
    in JAX (tests/test_algebraic_tail.py::test_auto_default_follows_width):
    the tail at E > 128 unless refused, the fold with it, the gate only when
    asked; a lean batch takes the tail, a dense one the module path."""
    arch = {**ARCH, "n_embed": E, "n_layer": 1}
    jtask = jvt.VAETask(jax_build_vae(**arch), **TASK, **kw)
    task = tvt.VAETask(build_transformer_vae(**arch, device="cpu"), **TASK, **kw)
    flags = ("algebraic_tail", "algebraic_vw_fold", "algebraic_fused_gate")
    assert [getattr(task, f) for f in flags] == [bool(getattr(jtask, f)) for f in flags]
    lean = to_torch(lean_batch())
    assert task._use_algebraic(lean) == task.algebraic_tail
    assert not task._use_algebraic({**lean, "counts": torch.zeros(B, G)})
    assert not (task._use_fused(lean) and task._use_algebraic(lean))  # lean CPU batch, E=48


def test_algebraic_path_ok_follows_the_jax_gate():
    assert tvt._algebraic_path_ok(build_transformer_vae(**ARCH, device="cpu"))
    assert not tvt._algebraic_path_ok(build_transformer_vae(**{**ARCH, "bias": True}, device="cpu"))
    assert jvt._algebraic_path_ok(jax_build_vae(**ARCH))
    assert not jvt._algebraic_path_ok(jax_build_vae(**{**ARCH, "bias": True}))


def test_census_model_shapes():
    """The vae_census.yaml widths build unchanged (on the meta device: no
    memory): 64 inducing points, a 64-wide latent, 8 + 8 heads, SwiGLU hidden
    1,408, and the algebraic tail with the fused gate is what the task takes."""
    vae = build_transformer_vae(n_genes=36_601, n_embed=512, n_embed_latent=64, n_layer=16,
                                n_inducing_points=64, n_head=8, n_head_cross=8, multiple_of=64,
                                device="meta")
    ca = vae.decoder.decoder_cross_attention
    assert vae.encoder.ca_layer.inducing_points.shape == (64, 512)
    assert vae.encoder.encoder_latent_input[0].weight.shape == (64, 512)
    assert ca.mlp.w1.weight.shape == (1408, 512) and ca.mlp.c_proj.weight.shape == (512, 1408)
    assert ca.attn.n_head == 8 and vae.encoder.encoder_layers[0].attn.n_head == 8
    assert vae.input_layer.gene_embedding.weight.shape == (36_602, 512)
    assert len(vae.encoder.encoder_layers) == len(vae.decoder.decoder_layers) == 16
    task = tvt.VAETask(vae, learning_rate=3e-4, algebraic_fused_gate=True)
    assert task.algebraic_tail and task.algebraic_vw_fold and task.algebraic_fused_gate


def test_entry_points_need_a_device():
    """build_transformer_vae builds on the card unless asked for the CPU, and
    canonical_gene_ids and SizeFactorSampler.sample take the device they
    mean: with no card and no device="cpu" they raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default succeeds")
    with pytest.raises((AssertionError, RuntimeError)):
        build_transformer_vae(n_genes=10)
    with pytest.raises(TypeError):
        canonical_gene_ids(10)
    sfs = SizeFactorSampler(constant_stats({"clusters": 2}))
    with pytest.raises(TypeError):
        sfs.sample(torch.Generator(), None, 3)
    assert canonical_gene_ids(3, device="cpu").tolist() == [1, 2, 3]
    assert sfs.sample(torch.Generator(), None, 3, "cpu").device.type == "cpu"
