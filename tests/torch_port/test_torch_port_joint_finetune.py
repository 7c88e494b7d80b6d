"""The LDM task under the whole transport family, joint VAE finetuning
(`LDMTask(train_vae=True)`) and the densify-free NB loss (`vae_loss_lean`,
`VAETask(lean_loss=True)`), against the JAX package.

- One LDM step under GVP/velocity, VP/noise/likelihood and
  Linear/score/velocity: the port on the DiT kernels' plain versions
  (`fused_training=True` on CPU tensors) against JAX's `_train_step_impl`
  on its module path, with JAX's draws injected; the loss, the gradient
  norm and every parameter's gradient. One more case at bf16 holds the
  port's module step to JAX's bf16 step by `test_torch_port_bf16.py`'s
  bound (K = 2.25 times JAX's own bf16-versus-f32 distance plus 4e-3 of
  the f32 result's largest).
- `train_vae` over three steps at weight decay 0.01: the loss, the DiT and
  VAE parameters and the EMA against JAX's after each step; the decoder,
  which the loss does not reach, decays as optax decays it; the EMA covers
  the DiT alone; eval and sampling run on the finetuned trees; a
  checkpoint resumes to the step, bit for bit; the CLIs carry the finetuned
  VAE from `train_ldm` into `inference`, whose encode path keeps the VAE
  checkpoint's weights, as JAX's does.
- `vae_loss_lean` against JAX's and against the dense `vae_loss`, for both
  theta shapes and uint16 wire counts, and the task's gate and step.

Tolerances: f32 losses at 1e-5 relative (the lean loss against JAX's at
1e-4: XLA's and torch's lgamma differ by an ulp at the wire's 65535); gradients at 1e-4 of each
tensor's largest (the same products, sums in other orders); parameters
after an AdamW step within a tenth of the step where the gradient's sign
is sure, as `test_torch_port_ldm_train.py` holds them; the decayed decoder
at 1e-6 relative; the lean loss against the dense one at 1e-6 relative,
as JAX's own test holds it."""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training import vae_task as jvt
from scldm_tpu.training.ema import ema_init as jax_ema_init
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.training.ldm_task import split_condition as jax_split_condition
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.heads import GaussianTransformerHead
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_dit
from scldm_torch.ops.transforms import canonical_gene_ids
from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
from scldm_torch.training import vae_task as tvt
from scldm_torch.training.checkpoint import CheckpointManager, read_payload
from scldm_torch.training.ldm_task import JointLDM, LDMTask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import load_reference_ema_, load_reference_state_dict
from tests.test_training import make_batch
from tests.torch_port import test_torch_port_bf16 as bf
from tests.torch_port.test_torch_port_bf16 import ldm_setup  # noqa: F401 (a fixture)
from tests.torch_port.test_torch_port_cli import DIT as CLI_DIT
from tests.torch_port.test_torch_port_cli import GENERATION, config, overrides
from tests.torch_port.test_torch_port_cli import workspace  # noqa: F401 (a fixture)
from tests.torch_port.test_torch_port_dit import randomized_dit_params

N_GENES = 40
VAE_ARCH = dict(n_genes=N_GENES, n_embed=16, n_embed_latent=8, n_layer=1, n_inducing_points=4,
                n_head=2, n_head_cross=2)
DIT_ARCH = dict(n_embed=32, n_embed_input=8, n_layer=2, n_head=2, seq_len=4,
                class_vocab_sizes={"clusters": 3}, cfg_dropout_prob=0.8)
TASK = dict(num_training_steps=10, ema_update_every=1, ema_update_after_step=0)
LR = 5e-4
TRANSPORTS = {"GVP-velocity": ("GVP", "velocity", None),
              "VP-noise-likelihood": ("VP", "noise", "likelihood"),
              "Linear-score-velocity": ("Linear", "score", "velocity")}


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def assert_grad_near(got, want, what, share=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= share * (np.abs(want).max() + 1e-30), what


@pytest.fixture(scope="module")
def base():
    """JAX's tiny VAE weights, a batch, and DiT weights whose zero-init
    layers are redrawn (adaLN-zero would zero most block gradients)."""
    with jax.default_matmul_precision("highest"):
        batch = make_batch(jax.random.PRNGKey(0), n_genes=N_GENES)
        jvae = jax_build_vae(**VAE_ARCH)
        vae_params = jax.jit(jvae.init)(jax.random.PRNGKey(0), batch["counts"], batch["genes"],
                                        batch["library_size"], batch["counts_subset"],
                                        batch["genes_subset"])
        jdit = JaxDiT(**DIT_ARCH)
        rows = batch["counts"].shape[0]
        jit_init = types.SimpleNamespace(init=jax.jit(jdit.init, static_argnames="train"))
        dit_params = randomized_dit_params(jit_init, jnp.zeros((rows, 4, 8)),
                                           jnp.linspace(0.1, 0.9, rows),
                                           {"clusters": batch["clusters"]}, seed=1)
    return jvae, jdit, vae_params, dit_params, batch


def jax_task(base, transport, train_vae=False, **kw):
    """JAX's task and a train state holding `base`'s weights."""
    jvae, jdit, vae_params, dit_params, batch = base
    jtask = JaxLDMTask(jvae, vae_params, jdit, transport, learning_rate=LR, train_vae=train_vae,
                       **TASK, **kw)
    state = jtask.init_state(jax.random.PRNGKey(3), batch)
    params = {"dit": dit_params, "vae": vae_params} if train_vae else dit_params
    state = state.replace(params=params, opt_state=jtask.tx.init(params),
                          ema=jax_ema_init(dit_params["params"]))
    return jtask, state


def port_task(base, transport, **kw):
    """The port's task on the same weights."""
    _, _, vae_params, dit_params, _ = base
    tvae = build_transformer_vae(**VAE_ARCH, device="cpu")
    load_reference_state_dict(tvae, export_torch_state_dict(vae_params))
    tdit = DiT(**DIT_ARCH)
    load_reference_state_dict(tdit, export_torch_state_dict(dit_params))
    task = LDMTask(tvae, tdit, transport, learning_rate=LR, **TASK, **kw)
    tstate = task.init_state(torch.Generator().manual_seed(0))
    load_reference_ema_(tstate.ema, export_torch_state_dict(dit_params))
    return task, tstate


def jax_draws(jtask, state, batch):
    """The draws of JAX's `_train_step_impl` at `state` as the port's
    injected noise: t and x0 from its transport key, the CFG drop mask
    recovered from its conditioning key."""
    _, rng_t, rng_c, _ = jax.random.split(state.rng, 4)
    dit_params = state.params["dit"] if jtask.train_vae else state.params
    z = jax.eval_shape(jtask._encode, batch)  # x0's shape and dtype
    t, x0, _ = jtask.transport.sample(rng_t, jnp.zeros(z.shape, z.dtype))
    cond = jax_split_condition(batch, jtask.dit.class_vocab_sizes)
    embed = jax.jit(lambda p, t, c, rng, train: jtask.dit.apply(
        p, t, c, train=train, method="embed_condition", rngs={"condition": rng}),
        static_argnames="train")
    train = embed(dit_params, t, cond, rng_c, True)
    plain = embed(dit_params, t, cond, rng_c, False)
    dropped = np.abs(np.asarray(train) - np.asarray(plain)).max(1) > 1e-6
    return {"t": torch.from_numpy(np.array(t)), "x0": torch.from_numpy(np.array(x0)),
            "drop_mask": torch.from_numpy(dropped)}


def jax_loss_and_grads(jtask, state, batch, vae_params):
    """The loss of JAX's `_train_step_impl` at `state` (its module path) and
    its gradients, as the step computes them before the clip."""
    if not hasattr(jtask, "_test_loss_and_grads"):
        jtask._test_loss_and_grads = jax.jit(
            lambda params, rng, batch, vae_params: _jax_loss_and_grads(
                jtask, params, rng, batch, vae_params))
    return jtask._test_loss_and_grads(state.params, state.rng, batch, vae_params)


def _jax_loss_and_grads(jtask, params, rng, batch, vae_params):
    _, rng_t, rng_c, rng_d = jax.random.split(rng, 4)
    cond = jax_split_condition(batch, jtask.dit.class_vocab_sizes)

    def loss_fn(params):
        dit_p, vae_p = jtask._split_trees(params, vae_params)
        z = jtask._encode_with(vae_p, batch)
        if not jtask.train_vae:
            z = jax.lax.stop_gradient(z)

        def model_fn(xt, t, condition):
            return jtask.dit.apply(dit_p, xt, t, condition, train=True,
                                   rngs={"condition": rng_c, "dropout": rng_d})

        return jtask.transport.training_losses(model_fn, rng_t, z,
                                               {"condition": cond})["loss"].mean()

    return jax.value_and_grad(loss_fn)(params)


# -- one step under every new transport --------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRANSPORTS))
def test_ldm_step_matches_jax_under_transport(base, name):
    jvae, jdit, vae_params, dit_params, batch = base
    jtask, state = jax_task(base, jax_create_transport(*TRANSPORTS[name]))
    noise = jax_draws(jtask, state, batch)
    loss, grads = jax_loss_and_grads(jtask, state, batch, vae_params)
    _, want = jax.jit(jtask._train_step_impl)(state, batch, vae_params)
    np.testing.assert_allclose(float(loss), float(want["train_loss"]), rtol=1e-6)

    task, tstate = port_task(base, create_transport(*TRANSPORTS[name]), fused_training=True)
    calls = []
    real = fused_dit.fused_dit_train_apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("scldm_torch.training.ldm_task.fused_dit_train_apply",
                   lambda *a: calls.append(1) or real(*a))
        got_loss = task.loss(to_torch(batch), tstate.generator, noise)
        got_loss.backward()
    assert calls  # the kernel path (its plain version on CPU tensors)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    want_g = export_torch_state_dict(grads)
    for n, p in tstate.module.named_parameters():
        assert_grad_near(p.grad.numpy(), want_g[n], n)
    tstate.optimizer.zero_grad(set_to_none=True)
    tstate, mets = task.train_step(tstate, to_torch(batch), noise)
    np.testing.assert_allclose(float(mets["train_loss"]), float(want["train_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mets["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)


def test_ldm_step_matches_jax_bf16_under_transport(ldm_setup):  # noqa: F811
    """The configs' bf16 compute under VP/noise/likelihood: the port's
    module step against JAX's bf16 step, JAX's f32 loss at the same draws
    the reference of the bound."""
    jtasks, vae_params, state, batch, vae_arch = ldm_setup
    spec = TRANSPORTS["VP-noise-likelihood"]
    jt = {k: JaxLDMTask(j.vae, vae_params, j.dit, jax_create_transport(*spec), learning_rate=LR,
                        **bf.LDM_TASK) for k, j in jtasks.items()}
    t, x0, rng_c, noise = bf._ldm_draws(jt["bf16"], state, batch)
    _, want = jax.jit(jt["bf16"]._train_step_impl)(state, batch, vae_params)
    jf = jt["f32"]
    ref = copy.copy(jf.transport)
    ref.sample = lambda rng, x1: (t, x0.astype(jnp.float32), x1)  # the bf16 step's draws
    cond = jax_split_condition(batch, jf.dit.class_vocab_sizes)
    z = jax.jit(jf._encode)(batch)

    def f32_loss(p):
        model = lambda xt, tt, condition: jf.dit.apply(  # noqa: E731
            p, xt, tt, condition, train=True, rngs={"condition": rng_c})
        return ref.training_losses(model, rng_c, z, {"condition": cond})["loss"].mean()

    loss_f, g = jax.jit(jax.value_and_grad(f32_loss))(state.params)
    task = bf.port_ldm(vae_params, state.params, vae_arch, fused_training=False)
    task.transport = create_transport(*spec)
    tstate = task.init_state(torch.Generator().manual_seed(0))
    tstate, mets = task.train_step(tstate, to_torch(batch), noise)
    bf.assert_bf16_near(float(mets["train_loss"]), float(want["train_loss"]), float(loss_f),
                        "loss")
    bf.assert_bf16_near(float(mets["grad_norm"]), float(want["grad_norm"]),
                        float(bf._global_norm(g)), "grad_norm")


# -- joint finetuning ---------------------------------------------------------------------

WD = 0.01


@pytest.fixture(scope="module")
def joint_run(base):
    """Three `train_vae` steps at weight decay WD on both sides, JAX's draws
    injected; the states after each."""
    jvae, jdit, vae_params, dit_params, batch = base
    with jax.default_matmul_precision("highest"):
        jtask, state = jax_task(base, jax_create_transport(), train_vae=True, weight_decay=WD)
        task, tstate = port_task(base, create_transport(), train_vae=True, weight_decay=WD,
                                 fused_training=True)
        step_fn = jax.jit(jtask._train_step_impl)
        runs = []
        for _ in range(3):
            noise = jax_draws(jtask, state, batch)
            _, grads = jax_loss_and_grads(jtask, state, batch, vae_params)
            state, want = step_fn(state, batch, vae_params)
            tstate, mets = task.train_step(tstate, to_torch(batch), noise)
            runs.append((want, mets, state, export_torch_state_dict(grads["dit"]),
                         export_torch_state_dict(grads["vae"]),
                         {n: p.detach().clone() for n, p in tstate.module.named_parameters()},
                         {n: t.clone() for n, t in tstate.ema.params.items()}))
    return jtask, state, task, tstate, runs


def test_train_vae_steps_match_jax(base, joint_run):
    """The loss and gradient norm, the DiT and VAE parameters after each
    step, the EMA over the DiT alone; the encoder moves, the decoder (which
    the loss does not reach) decays exactly as optax decays it."""
    jvae, jdit, vae_params, dit_params, batch = base
    jtask, _, task, tstate, runs = joint_run
    assert isinstance(tstate.module, JointLDM) and task.train_vae
    assert not task.fused_training and not task.fused_encode and not task._use_fused(torch.ones(1))
    dit_names = {n for n, _ in task.dit.named_parameters()}
    initial = export_torch_state_dict(vae_params)
    for want, mets, state, g_dit, g_vae, params, ema in runs:
        for k in ("train_loss", "lr_mult"):
            np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-5)
        np.testing.assert_allclose(float(mets["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)
        step = LR * float(want["lr_mult"])
        want_p = {f"{tree}.{k}": v for tree in ("dit", "vae")
                  for k, v in export_torch_state_dict(state.params[tree]).items()}
        grads = {**{f"dit.{k}": v for k, v in g_dit.items()},
                 **{f"vae.{k}": v for k, v in g_vae.items()}}
        assert set(params) == set(want_p)
        for name, p in params.items():
            g = np.abs(grads[name])
            if g.max() == 0.0:  # not reached by the loss: the decay alone
                np.testing.assert_allclose(p.numpy(), want_p[name], rtol=1e-6, atol=1e-9,
                                           err_msg=name)
                continue
            sure = g > 1e-4 * g.max()
            assert np.abs(p.numpy() - want_p[name])[sure].max(initial=0.0) <= 0.1 * step, name
        assert set(ema) == dit_names
        want_ema = export_torch_state_dict(state.ema.params)
        for name, t in ema.items():
            np.testing.assert_allclose(t.numpy(), want_ema[name], rtol=1e-5, atol=0.1 * step,
                                       err_msg=name)
    final = runs[-1][5]
    enc = [n for n in final if n.startswith("vae.encoder.")]
    dec = [n for n in final if n.startswith("vae.decoder.") or n.startswith("vae.decoder_head.")]
    assert enc and dec
    assert any(not np.allclose(final[n].numpy(), initial[n[4:]]) for n in enc)
    for n in dec:  # three decays of (1 - lr * lr_mult * WD), nothing more
        decay = np.prod([1 - LR * float(r[0]["lr_mult"]) * WD for r in runs])
        np.testing.assert_allclose(final[n].numpy(), initial[n[4:]] * decay, rtol=2e-6,
                                   atol=1e-9, err_msg=n)


@pytest.mark.parametrize("use_ema", [False, True])
def test_train_vae_eval_uses_the_finetuned_vae(joint_run, base, use_ema):
    _, _, _, _, batch = base
    jtask, state, task, tstate, _ = joint_run
    key = jax.random.PRNGKey(4)
    want = jtask.eval_step(state, batch, key, ema=use_ema)
    t, x0, _ = jtask.transport.sample(jax.random.split(key)[0], jtask._encode(batch))
    got = task.eval_step(tstate, to_torch(batch), torch.Generator().manual_seed(0),
                         use_ema=use_ema, noise={"t": torch.from_numpy(np.array(t)),
                                                 "x0": torch.from_numpy(np.array(x0))})
    prefix = "val_ema" if use_ema else "val"
    np.testing.assert_allclose(float(got[f"{prefix}_loss"]), float(want[f"{prefix}_loss"]),
                               rtol=1e-4)


def test_train_vae_sampling_decodes_with_the_finetuned_vae(joint_run):
    """Generation from the joint state: the EMA DiT's samples decoded by the
    finetuned VAE, held against JAX's decode with its finetuned tree."""
    jtask, state, task, tstate, _ = joint_run
    sfs = SizeFactorSampler(constant_stats({"clusters": 3}))
    cond = {"clusters": torch.tensor([0, 2])}
    genes = canonical_gene_ids(N_GENES, device="cpu")
    kw = dict(guidance_weight={"clusters": 1.0}, sampling_method="euler", num_steps=4)
    counts, z = task.make_sample_fn(sfs, **kw)(torch.Generator().manual_seed(1), genes, cond,
                                               state=tstate)
    assert counts.shape == (4, N_GENES) and torch.isfinite(z).all()
    log_sf = torch.zeros(2)
    samples, out, _ = task.generate_from_noise(torch.randn(2, 4, 8), log_sf, genes, cond,
                                               dit=task.ema_module(tstate), **kw)
    decode = jax.jit(lambda p, z, g: jtask.vae.apply(p, z, g, jnp.ones((4, 1)),
                                                     method="decode")["mu"])
    args = (jnp.asarray(samples.numpy()), jnp.asarray(genes.numpy()))
    assert_grad_near(out["mu"].numpy(), decode(state.params["vae"], *args), "mu")
    frozen = decode(jtask.vae_params, *args)
    assert np.abs(np.asarray(frozen) - out["mu"].numpy()).max() > 1e-6


def test_train_vae_checkpoint_resumes_to_the_step(base, tmp_path):
    """Three steps straight against one step, a save, a restore into fresh
    modules and two more: the same bits, the module carrying both
    networks."""
    _, _, _, _, batch = base
    kw = dict(train_vae=True, weight_decay=WD)
    task, tstate = port_task(base, create_transport(), **kw)
    for _ in range(3):
        tstate, _ = task.train_step(tstate, to_torch(batch))
    task2, tstate2 = port_task(base, create_transport(), **kw)
    tstate2, _ = task2.train_step(tstate2, to_torch(batch))
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tstate2)
    payload = read_payload(tmp_path / "1")
    assert any(k.startswith("vae.") for k in payload["module"])
    assert set(payload["ema"]["params"]) == {n for n, _ in task2.dit.named_parameters()}
    task3, tstate3 = port_task(base, create_transport(), **kw)
    tstate3 = mgr.restore(tstate3)
    mgr.close()
    assert tstate3.step == 1
    for _ in range(2):
        tstate3, _ = task3.train_step(tstate3, to_torch(batch))
    assert tstate3.step == tstate.step == 3 and tstate3.ema.step == 3
    for (n, a), (_, b) in zip(tstate.module.named_parameters(),
                              tstate3.module.named_parameters()):
        assert torch.equal(a, b), n
    for n, t in tstate.ema.params.items():
        assert torch.equal(t, tstate3.ema.params[n]), n


def test_train_vae_through_the_clis(workspace, monkeypatch):  # noqa: F811
    """`train` a VAE, `train_ldm` with `model.vae_as_tokenizer.train=true`,
    then `inference`: the LDM checkpoint carries a VAE whose encoder moved
    and whose decoder did not (no weight decay); generation decodes with
    it, and the encode path keeps the VAE checkpoint's weights."""
    from scldm_torch.cli import inference, train, train_ldm

    ov = overrides(workspace, out="joint") + ["device=cpu", "epochs=1"]
    assert train.main(config("vae_training.yaml") + ov) == 0
    joint = ov + CLI_DIT + ["model.vae_as_tokenizer.train=true"]
    assert train_ldm.main(config("ldm_training.yaml") + joint) == 0
    ckpts = workspace / "joint" / "checkpoints"
    vae_ck = read_payload(max((ckpts / "vae_dentate_gyrus").glob("[0-9]*"),
                              key=lambda p: int(p.name)))["module"]
    ldm_ck = read_payload(max((ckpts / "ldm_dentate_gyrus").glob("[0-9]*"),
                              key=lambda p: int(p.name)))["module"]
    tuned = {k[4:]: v for k, v in ldm_ck.items() if k.startswith("vae.")}
    assert set(tuned) == set(vae_ck)
    assert any(not torch.equal(tuned[k], vae_ck[k]) for k in tuned if k.startswith("encoder."))
    assert all(torch.equal(tuned[k], vae_ck[k]) for k in tuned if k.startswith("decoder"))

    seen = {}
    real_gen, real_enc = LDMTask.generate_from_noise, LDMTask._encode

    def gen(self, *a, **kw):
        seen["gen"] = {k: v.clone() for k, v in self.vae.state_dict().items()}
        return real_gen(self, *a, **kw)

    def enc(self, batch, vae=None):
        seen["enc"] = {k: v.clone() for k, v in (vae or self.vae).state_dict().items()}
        return real_enc(self, batch, vae)

    monkeypatch.setattr(LDMTask, "generate_from_noise", gen)
    monkeypatch.setattr(LDMTask, "_encode", enc)
    assert inference.main(config("generation.yaml") + joint + GENERATION) == 0
    assert inference.main(config("inference.yaml") + joint) == 0
    assert all(torch.equal(seen["gen"][k], tuned[k]) for k in tuned)
    assert all(torch.equal(seen["enc"][k], vae_ck[k]) for k in vae_ck)


# -- the densify-free NB loss ---------------------------------------------------------------

B, S = 6, 20
# against JAX the lean loss is held at the f32 1e-4: one count sits at the
# wire's ceiling, 65535, where lgamma is about 6.6e5 and XLA's and torch's
# f32 lgamma differ by an ulp (0.0625; measured), 3.3e-5 of this batch's loss
LEAN_RTOL = 1e-4


def lean_pairs(seed=0, n_genes=N_GENES):
    """uint16 wire subsets: distinct expressed genes a cell, zero-padded,
    counts up to the wire's ceiling."""
    rng = np.random.default_rng(seed)
    gs = np.zeros((B, S), np.uint16)
    cs = np.zeros((B, S), np.uint16)
    for i in range(B):
        nnz = int(rng.integers(S // 2, S))
        gs[i, :nnz] = rng.choice(n_genes, nnz, replace=False) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    cs[0, 0] = 65535
    return gs, cs


def dense_counts(gs, cs, n_genes=N_GENES):
    out = np.zeros((gs.shape[0], n_genes), np.float32)
    for i in range(gs.shape[0]):
        for g, c in zip(gs[i], cs[i]):
            if g:
                out[i, g - 1] = c
    return out


@pytest.mark.parametrize("theta_shape", ["shared", "per_token"])
def test_vae_loss_lean_matches_jax_and_dense(theta_shape):
    rng = np.random.default_rng(1)
    gs, cs = lean_pairs()
    mu = rng.gamma(2.0, 2.0, size=(B, N_GENES)).astype(np.float32)
    theta = rng.gamma(2.0, 1.0, size=(N_GENES,) if theta_shape == "shared"
                      else (B, N_GENES)).astype(np.float32)
    jl, (jg_mu, jg_theta) = jax.jit(jax.value_and_grad(
        lambda m, t: jvt.vae_loss_lean(jnp.asarray(gs.astype(np.int32)),
                                       jnp.asarray(cs.astype(np.int32)), {"mu": m, "theta": t}),
        argnums=(0, 1)))(jnp.asarray(mu), jnp.asarray(theta))
    tmu, ttheta = (torch.from_numpy(a).requires_grad_(True) for a in (mu, theta))
    loss = tvt.vae_loss_lean(torch.from_numpy(gs), torch.from_numpy(cs),
                             {"mu": tmu, "theta": ttheta})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LEAN_RTOL)
    assert_grad_near(tmu.grad.numpy(), jg_mu, "mu")
    assert_grad_near(ttheta.grad.numpy(), jg_theta, "theta")
    dmu, dtheta = (torch.from_numpy(a).requires_grad_(True) for a in (mu, theta))
    dense = tvt.vae_loss(torch.from_numpy(dense_counts(gs, cs)), {"mu": dmu, "theta": dtheta})
    dense.backward()
    np.testing.assert_allclose(float(loss), float(dense), rtol=1e-6)
    assert_grad_near(tmu.grad.numpy(), dmu.grad.numpy(), "mu vs dense")
    assert_grad_near(ttheta.grad.numpy(), dtheta.grad.numpy(), "theta vs dense")


ALG_ARCH = dict(n_genes=N_GENES, n_embed=64, n_embed_latent=16, n_layer=1, n_inducing_points=4,
                n_head=2, n_head_cross=2, multiple_of=16)


def _lean_batch(seed=0):
    gs, cs = lean_pairs(seed)
    return {"genes_subset": gs, "counts_subset": cs,
            "library_size": cs.astype(np.float32).sum(1, keepdims=True)}


@pytest.mark.parametrize("path", ["algebraic", "kernel"])
def test_lean_loss_task_matches_dense_and_jax(path):
    """`VAETask(lean_loss=True)` on the algebraic tail and on the kernel
    path (the tail's plain version on CPU tensors): the loss and every
    gradient against the dense-loss task on the same weights, and on the
    algebraic tail the step's loss and gradient norm against JAX's lean
    task. On the kernel path the gradients are held at 1e-3 of each
    tensor's largest: the tail rounds its operands and cotangent products to
    bf16, as JAX's kernel does, so the last-bit differences between the two
    losses' d(mu) flip a rounding now and then (measured: 1.6e-4 at most;
    `test_torch_port_vae_train.py` holds this path to JAX's at 2e-2)."""
    arch = ALG_ARCH if path == "algebraic" else VAE_ARCH
    jvae = jax_build_vae(**arch)
    lean = _lean_batch()
    kw = dict(algebraic_tail=True) if path == "algebraic" else dict(fused_decoder=True)
    jtask = jvt.VAETask(jvae, num_training_steps=100, lean_loss=True,
                        **(kw if path == "algebraic" else dict(fused_decoder=False)))
    wide = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.uint16 else v)
            for k, v in lean.items()}
    state = jtask.init_state(jax.random.PRNGKey(0), wide)
    grads = {}
    losses = {}
    for lean_loss in (True, False):
        tvae = build_transformer_vae(**arch, device="cpu")
        load_reference_state_dict(tvae, export_torch_state_dict(state.params))
        task = tvt.VAETask(tvae, num_training_steps=100, lean_loss=lean_loss, **kw)
        batch = {k: torch.from_numpy(v) for k, v in lean.items()}
        assert task._use_lean_loss(batch, True) == lean_loss
        on_path = task._use_algebraic(batch) if path == "algebraic" else task._use_fused(batch)
        assert on_path
        loss, _ = task.loss(batch)
        loss.backward()
        losses[lean_loss] = float(loss)
        grads[lean_loss] = {n: p.grad.clone() for n, p in tvae.named_parameters()
                            if p.grad is not None}
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
    assert set(grads[True]) == set(grads[False])
    for n in grads[True]:
        if n in ("decoder_head.params.bias",):  # softmax-invariant: its gradient is noise
            continue
        if path == "algebraic":
            assert_grad_near(grads[True][n].numpy(), grads[False][n].numpy(), n)
        else:
            assert_grad_near(grads[True][n].numpy(), grads[False][n].numpy(), n, share=1e-3)
    if path == "algebraic":
        _, want = jax.jit(jtask._train_step_impl)(state, wide)
        tvae = build_transformer_vae(**arch, device="cpu")
        load_reference_state_dict(tvae, export_torch_state_dict(state.params))
        task = tvt.VAETask(tvae, num_training_steps=100, lean_loss=True, **kw)
        tstate = task.init_state(torch.Generator().manual_seed(0))
        tstate, mets = task.train_step(tstate, {k: torch.from_numpy(v) for k, v in lean.items()})
        np.testing.assert_allclose(float(mets["train_loss"]), float(want["train_loss"]),
                                   rtol=LEAN_RTOL)
        np.testing.assert_allclose(float(mets["grad_norm"]), float(want["grad_norm"]), rtol=1e-4)


def test_lean_loss_gate_matches_jax():
    """JAX's `_use_lean_loss` cases: opted in, on the kernel or algebraic
    path, the NB head, a lean batch; a dense batch, no opt-in, the Gaussian
    head or the module path keep `vae_loss`."""
    lean = {k: torch.from_numpy(v) for k, v in _lean_batch().items()}
    dense = dict(lean, counts=torch.zeros(B, N_GENES))
    jlean = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in lean.items()}
    jdense = dict(jlean, counts=jnp.zeros((B, N_GENES)))
    for head in ("negative_binomial_shared_theta", "gaussian"):
        jvae = jax_build_vae(**VAE_ARCH, decoder_head=head)
        tvae = build_transformer_vae(**VAE_ARCH, decoder_head=head, device="cpu")
        assert isinstance(tvae.decoder_head, GaussianTransformerHead) == (head == "gaussian")
        for opt in (True, False):
            jtask = jvt.VAETask(jvae, num_training_steps=10, lean_loss=opt)
            task = tvt.VAETask(tvae, num_training_steps=10, lean_loss=opt)
            for (b, jb) in ((lean, jlean), (dense, jdense)):
                for on_path in (True, False):
                    assert task._use_lean_loss(b, on_path) == jtask._use_lean_loss(jb, on_path)
    task = tvt.VAETask(build_transformer_vae(**VAE_ARCH, device="cpu"), lean_loss=True)
    assert task._use_lean_loss(lean, True) and not task._use_lean_loss(dense, True)
    assert not task._use_lean_loss(lean, False)
