"""The VAE training slice against the JAX package: the count transforms, the
NB likelihood and loss, `fused_nb_apply` (the port's kernel path on CPU
tensors runs the kernels' plain version; JAX runs the Pallas kernel in
interpret mode), one whole training step on the kernel path and on the module
path, and the validation metrics (the steps at E = 64 and through the dense
pool are in `test_torch_port_vae_train_widths.py`; JAX's kernel-path step is
computed once, for the forward and the step tests). Small sizes (G=60 genes, B=8 cells, a
window of S=20 tokens, as tests/test_fused_decoder.py), weights carried
across by `export_torch_state_dict`, inputs from numpy.

Tolerances: module math in f32 on both sides agrees to 1e-4 (sums in other
orders). The kernel path rounds six operands to bf16 on both sides, at the
same points; its mu and loss agree to 1e-3 relative and its gradients to
2e-2 of each tensor's largest magnitude (JAX rounds its reduced gradients to
bf16 per tile, the port after the whole sum)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.ops import transforms as jtr
from scldm_tpu.ops.distributions import log_nb_positive as jax_log_nb
from scldm_tpu.training import metrics as JM
from scldm_tpu.training.vae_task import VAETask as JaxVAETask
from scldm_tpu.training.vae_task import fused_nb_apply as jax_fused_nb_apply
from scldm_tpu.training.vae_task import vae_loss as jax_vae_loss
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_decoder
from scldm_torch.ops import transforms as ttr
from scldm_torch.ops.distributions import log_nb_positive
from scldm_torch.training import metrics as TM
from scldm_torch.training.vae_task import (
    VAETask,
    _fused_path_ok,
    fused_nb_apply,
    vae_loss,
    validation_metrics,
)
from scldm_torch.utils.weights import load_reference_state_dict

G, B, S = 60, 8, 20
TASK = dict(num_training_steps=100)


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def lean_batch(n_cells=B, seed=0, dtype=np.int32, window=S):
    """The bench's lean wire batch at a small size: expressed gene ids and
    counts, zero-padded to a window of `window` tokens."""
    rng = np.random.default_rng(seed)
    gs = np.zeros((n_cells, window), dtype)
    cs = np.zeros((n_cells, window), dtype)
    for i in range(n_cells):
        nnz = int(rng.integers(5, window))
        idx = np.sort(rng.choice(G, nnz, replace=False))
        gs[i, :nnz] = idx + 1
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
        jvae = jax_build_vae(n_genes=G)
        jtask = JaxVAETask(jvae, **TASK)
        state = jtask.init_state(jax.random.PRNGKey(0), to_jax(lean_batch()))
    return jvae, jtask, state


def port_task(state, **kw):
    """A port VAETask whose module holds the JAX state's parameters."""
    tvae = build_transformer_vae(n_genes=G, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(state.params))
    task = VAETask(tvae, **TASK, **kw)
    return task, task.init_state(torch.Generator().manual_seed(0))


def assert_grads_close(tvae, jgrads, rel, skip=()):
    want = export_torch_state_dict(jgrads)
    n = 0
    for name, p in tvae.named_parameters():
        if name in skip or not p.requires_grad:
            continue
        w = want[name]
        scale = np.abs(w).max() + 1e-6
        assert np.abs(p.grad.numpy() - w).max() <= rel * scale, name
        n += 1
    assert n > 20


# -- transforms and likelihood ---------------------------------------------------

def test_widen_lean_matches_jax():
    wire = lean_batch(dtype=np.uint16)
    want = jtr.widen_lean(to_jax(wire))
    got = ttr.widen_lean(to_torch(wire))
    assert got["genes_subset"].dtype == torch.int64 and got["counts_subset"].dtype == torch.float32
    for k in wire:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    wide = ttr.widen_lean(got)
    assert all(wide[k] is got[k] for k in got)  # wide dtypes pass through


@pytest.mark.parametrize("n_cells", [8, 300])  # one scatter, and 128-row slices
def test_densify_expressed_matches_jax(n_cells):
    batch = lean_batch(n_cells, seed=1)
    want = jtr.densify_expressed(jnp.asarray(batch["genes_subset"]),
                                 jnp.asarray(batch["counts_subset"], jnp.float32), G)
    got = ttr.densify_expressed(torch.from_numpy(batch["genes_subset"]),
                                torch.from_numpy(batch["counts_subset"]).float(), G)
    assert got.shape == (n_cells, G)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.sum(1).numpy(), batch["library_size"][:, 0])


def test_log1p_cpm_and_log_nb_match_jax():
    rng = np.random.default_rng(2)
    counts = rng.poisson(2.0, size=(6, G)).astype(np.float32)
    counts[3] = 0.0  # an all-zero row maps to zeros, not nan
    mu = rng.uniform(0.01, 30.0, size=(6, G)).astype(np.float32)
    theta = rng.uniform(0.1, 10.0, size=(G,)).astype(np.float32)
    np.testing.assert_allclose(ttr.log1p_cpm(torch.from_numpy(counts)).numpy(),
                               np.asarray(jtr.log1p_cpm(jnp.asarray(counts))), rtol=1e-6)
    got = log_nb_positive(*map(torch.from_numpy, (counts, mu, theta)))
    want = jax_log_nb(*map(jnp.asarray, (counts, mu, theta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    params = {"mu": mu, "theta": theta}
    np.testing.assert_allclose(
        float(vae_loss(torch.from_numpy(counts), {k: torch.from_numpy(v) for k, v in params.items()})),
        float(jax_vae_loss(jnp.asarray(counts), to_jax(params), False)), rtol=1e-6)


# -- the model paths ---------------------------------------------------------------

def test_module_forward_matches_jax(setup):
    jvae, jtask, state = setup
    task, _ = port_task(state)
    jb = jtask._materialize(to_jax(lean_batch()))
    want, want_z = jtask._apply(state.params, jb, train=False)
    with torch.no_grad():
        got, got_z = task._apply(task._materialize(to_torch(lean_batch())))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=1e-4, atol=1e-4)
    for k in ("mu", "theta"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def kernel_reference(setup):
    """JAX's kernel path on `setup`'s state and the lean batch (its Pallas
    tail in interpret mode), computed once for the tests that hold the port
    to it: ((loss, out, h_z), gradients), then the step's (parameters,
    clipped gradients, metrics)."""
    jvae, jtask, state = setup
    forward, grads = _jax_kernel_path_grads(jvae, jtask, state, to_jax(lean_batch()))
    return (forward, grads), _jax_kernel_path_apply(jtask, state, forward, grads)


def test_fused_nb_apply_matches_jax(setup, kernel_reference):
    jvae, jtask, state = setup
    task, _ = port_task(state)
    assert _fused_path_ok(task.vae)
    tb = task._materialize(to_torch(lean_batch()))
    ((want_loss, want, want_z), jgrads), _ = kernel_reference
    fwd = fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count
    got, got_z = fused_nb_apply(task.vae, tb)
    loss = vae_loss(tb["counts"], got)
    loss.backward()
    assert fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count == fwd  # CPU: the plain version
    np.testing.assert_allclose(got_z.detach().numpy(), np.asarray(want_z), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["theta"].detach().numpy(), np.asarray(want["theta"]), rtol=1e-6)
    mu, want_mu = got["mu"].detach().numpy(), np.asarray(want["mu"])
    assert np.abs(mu - want_mu).max() <= 1e-3 * np.abs(want_mu).max()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-3)
    # the head's bias cancels in the softmax: its true gradient is 0, both are noise
    assert_grads_close(task.vae, jgrads, 2e-2, skip=("decoder_head.params.bias",))


def test_batch_chunks_match_one_launch(setup):
    *_, state = setup
    task, _ = port_task(state)
    tb = task._materialize(to_torch(lean_batch()))
    one, _ = fused_nb_apply(task.vae, tb)
    chunked, _ = fused_nb_apply(task.vae, tb, batch_chunk=3)
    torch.testing.assert_close(chunked["mu"], one["mu"], rtol=1e-6, atol=1e-6)
    # the task's setting reaches the tail: the same loss from three launches
    chunk_task, _ = port_task(state, fused_batch_chunk=3, fused_decoder=True)
    whole_task, _ = port_task(state, fused_decoder=True)
    fwd = fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count
    calls = []
    real = fused_decoder._DecoderTail.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_decoder._DecoderTail, "apply",
                   lambda *a: calls.append(a[2].shape[0]) or real(*a))
        chunked_loss, _ = chunk_task.loss(to_torch(lean_batch()))
        assert calls == [3, 3, 2]
        whole_loss, _ = whole_task.loss(to_torch(lean_batch()))
        assert calls[3:] == [B]
    assert fused_decoder.DECODER_TAIL_FWD_LAUNCHES.count == fwd  # CPU: the plain version
    torch.testing.assert_close(chunked_loss, whole_loss, rtol=1e-6, atol=1e-6)


def test_dispatch():
    task = VAETask(build_transformer_vae(n_genes=G, device="cpu"), **TASK)
    lean = to_torch(lean_batch())
    assert not task._use_fused(lean)  # auto: CUDA tensors only
    assert VAETask(task.vae, fused_decoder=True, **TASK)._use_fused(lean)
    assert not VAETask(task.vae, fused_decoder=True, **TASK)._use_fused(
        {**lean, "counts": torch.zeros(B, G)})  # dense batch: module path
    assert not VAETask(task.vae, fused_decoder=False, **TASK)._use_fused(lean)
    # JAX's architecture gate: E <= 128 and no qkv biases, whatever the
    # kernels are compiled for
    narrow = build_transformer_vae(n_genes=G, n_embed=16, n_head=4, n_head_cross=2,
                                   device="cpu")
    assert _fused_path_ok(narrow)
    assert VAETask(narrow, fused_decoder=True, **TASK)._use_fused(lean)
    for other in (build_transformer_vae(n_genes=G, n_embed=256, n_layer=1, device="cpu"),
                  build_transformer_vae(n_genes=G, bias=True, n_layer=1, device="cpu")):
        assert not _fused_path_ok(other)
        assert not VAETask(other, fused_decoder=True, **TASK)._use_fused(lean)
    # the narrow architecture's widths take the kernels, at any number of
    # latent tokens; outside their band (here a head count that does not
    # divide E) the CUDA launch raises before it reaches the library (the
    # check is device-free)
    E, H, M, Hd = 16, 2, 16, 44
    qp = torch.zeros(G, E)
    kf = torch.zeros(B, H * M, E)
    weights = (torch.zeros(1, E), torch.zeros(1, E), torch.zeros(E, 2 * Hd),
               torch.zeros(1, Hd), torch.zeros(1, E), torch.zeros(1, 1))
    assert fused_decoder._check(qp, qp, kf, kf, weights, H) == (B, G, E, M, Hd)
    kf = torch.zeros(B, H * 65, E)
    assert fused_decoder._check(qp, qp, kf, kf, weights, H) == (B, G, E, 65, Hd)
    kf = torch.zeros(B, 3 * M, E)
    with pytest.raises(ValueError, match="built for"):
        fused_decoder._check(qp, qp, kf, kf, weights, 3)


def _jax_kernel_path_grads(jvae, jtask, state, batch):
    """The loss, outputs and gradients of `VAETask._train_step_impl` as it
    composes the fused path (JAX vae_task.py:1088-1119), with the Pallas tail
    in interpret mode: ((loss, out, h_z), gradients)."""
    batch = jtask._materialize(batch)

    def loss_fn(params):
        out, h_z = jax_fused_nb_apply(jvae, params, batch, train=True, interpret=True)
        return jax_vae_loss(batch["counts"], out, False), (out, h_z)

    (loss, (out, h_z)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    return (loss, out, h_z), grads


def _jax_kernel_path_apply(jtask, state, forward, grads):
    """The rest of that step: the global-norm clip and the optimizer update
    -> (parameters, clipped gradients, metrics)."""
    loss, out, _ = forward
    gnorm = optax.global_norm(grads)
    scale = jnp.minimum(1.0, jtask.grad_clip / (gnorm + 1e-12))
    grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
    updates, _ = jtask.tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return params, grads, {"train_loss": loss, "grad_norm": gnorm,
                           "train_theta": out["theta"].mean()}


def _jax_kernel_path_step(jvae, jtask, state, batch):
    """The whole step: (parameters, clipped gradients, metrics)."""
    forward, grads = _jax_kernel_path_grads(jvae, jtask, state, batch)
    return _jax_kernel_path_apply(jtask, state, forward, grads)


@pytest.mark.parametrize("path", ["kernel", "module"])
def test_train_step_matches_jax(setup, kernel_reference, path):
    """One optimizer step from the same parameters and batch. The first
    AdamW step moves each parameter by about lr_mult * lr * sign(grad)
    (1e-5 here), so the parameters are held to a tenth of that, except where
    a gradient is so small against its tensor's largest that rounding can
    flip its sign (2e-2 of it on the kernel path, 1e-6 on the module path)."""
    jvae, jtask, state = setup
    if path == "kernel":
        _, (want_params, jgrad, want) = kernel_reference
        task, tstate = port_task(state, fused_decoder=True)
        small, loss_rtol = 2e-2, 1e-3
    else:
        jb = jtask._materialize(to_jax(lean_batch()))
        jgrad = jax.grad(lambda p: jax_vae_loss(
            jb["counts"], jtask._apply(p, jb, train=False)[0], False))(state.params)
        # the jitted step donates its state: run the same program undonated
        new_state, want = jax.jit(jtask._train_step_impl)(state, to_jax(lean_batch()))
        want_params = new_state.params
        task, tstate = port_task(state, fused_decoder=False)
        small, loss_rtol = 1e-6, 1e-5
    jgrad = export_torch_state_dict(jgrad)
    before = {n: p.detach().clone() for n, p in tstate.module.named_parameters()}
    tstate, mets = task.train_step(tstate, to_torch(lean_batch(dtype=np.uint16)))
    assert tstate.step == 1
    for k in ("train_loss", "grad_norm", "train_theta"):
        np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=loss_rtol)
    assert float(mets["lr_mult"]) == pytest.approx(0.01)
    step = 1e-3 * 0.01  # learning_rate * lr_mult at step 0
    got = {n: p.detach().numpy() for n, p in tstate.module.named_parameters()}
    for name, w in export_torch_state_dict(want_params).items():
        if name == "decoder_head.params.bias":
            continue  # softmax-invariant: its gradient is noise on both sides
        g = np.abs(jgrad[name])
        sure = g > small * (g.max() + 1e-30)
        moved = np.abs(got[name] - before[name].numpy())
        assert np.abs(got[name] - w)[sure].max(initial=0.0) <= 0.1 * step, name
        assert np.all(moved <= 1.01 * step), name


DENSE_S = 50  # a window that passes JAX's dense-pool gate: G = 60 <= 1.3 * 50


@pytest.fixture(scope="module")
def dense_setup():
    with jax.default_matmul_precision("highest"):
        jvae = jax_build_vae(n_genes=G)
        jtask = JaxVAETask(jvae, **TASK)
        state = jtask.init_state(jax.random.PRNGKey(1), to_jax(lean_batch(window=DENSE_S)))
    return jvae, jtask, state


def test_train_steps_means_and_eval(setup):
    jvae, jtask, state = setup
    task, tstate = port_task(state, fused_decoder=True)
    stacked = {k: torch.stack([v, v]) for k, v in to_torch(lean_batch()).items()}
    tstate, mets = task.train_steps(tstate, stacked)
    assert tstate.step == 2 and tstate.optimizer.step_count == 2
    assert all(torch.isfinite(v) for v in mets.values())
    np.testing.assert_allclose(float(mets["lr_mult"]), (0.01 + 0.109) / 2, rtol=1e-6)
    z = task.encode(to_torch(lean_batch(dtype=np.uint16)))
    assert z.shape == (B, 16, 16)


def test_eval_metrics_match_jax(setup):
    """val_loss and val_theta from eval_step; the sampled metrics from the
    same injected NB draw on both sides."""
    jvae, jtask, state = setup
    task, tstate = port_task(state)
    want = jtask.eval_step(state, to_jax(lean_batch()), jax.random.PRNGKey(3))
    got = task.eval_step(tstate, to_torch(lean_batch()), torch.Generator().manual_seed(3))
    for k in ("val_loss", "val_llh", "val_theta"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)

    jb = jtask._materialize(to_jax(lean_batch()))
    out, _ = jtask._apply(state.params, jb, train=False)
    draw = np.random.default_rng(4).poisson(np.asarray(out["mu"])).astype(np.float32)
    draw[1] = 0.0  # a cell with no counts drawn
    counts = np.array(jb["counts"])
    pred, true = jtr.log1p_cpm(jnp.asarray(draw)), jtr.log1p_cpm(jnp.asarray(counts))
    want = {"val_zeros_accuracy": JM.zeros_accuracy(jnp.asarray(draw), jnp.asarray(counts)),
            "val_mse": JM.mse(pred, true),
            "val_pcc": JM.nanmean(JM.pearson_corrcoef(pred, true))}
    got = validation_metrics(torch.from_numpy(counts),
                             {k: torch.from_numpy(np.array(v)) for k, v in out.items()},
                             torch.from_numpy(draw))
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5, atol=1e-6)


def test_grad_norms_by_module_match_jax(setup):
    *_, state = setup
    rng = np.random.default_rng(5)
    jgrads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), state.params)
    want = JM.grad_norms_by_module(jgrads, depth=1)
    named = [(k, torch.from_numpy(np.array(v)))
             for k, v in export_torch_state_dict(jgrads).items()]
    got = TM.grad_norms_by_module(named, depth=1)
    assert set(got) == set(want) == {f"grad_norm/{m}" for m in
                                     ("input_layer", "encoder", "decoder", "decoder_head")}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    assert "grad_norm/encoder/ca_layer" in TM.grad_norms_by_module(named)
