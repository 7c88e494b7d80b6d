"""The LDM training slice against the JAX package: the flow-matching loss,
the training conditioning, the EMA, the optimizer, and whole
`LDMTask.train_step`s on the kernel path (on CPU tensors, the kernels' plain
versions) and on the module path, at the tiny configuration of
tests/test_fused_dit.py. Weights are carried across by
`export_torch_state_dict`; the JAX draws are reproduced from its keys and
injected into the port.

Tolerances: f32 on both sides, sums in other orders. Single functions agree
to 1e-5 (the conditioning, the loss, the EMA and the optimizer); a train
step's loss and gradient norm to 1e-5 relative (JAX's bounds between its
kernel and module paths are 1e-4 and 1e-3), and the parameters after it to a
tenth of the step AdamW takes."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scldm_tpu.nn.nnets import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training.ema import current_decay as jax_current_decay
from scldm_tpu.training.ema import ema_init as jax_ema_init
from scldm_tpu.training.ema import ema_update as jax_ema_update
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.training.ldm_task import split_condition as jax_split_condition
from scldm_tpu.training.metrics import grad_norms_by_module as jax_grad_norms
from scldm_tpu.training.optim import wsd_schedule as jax_wsd
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.transport.transport import mean_flat as jax_mean_flat
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.ops import fused_dit, fused_encoder
from scldm_torch.ops.transforms import canonical_gene_ids
from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
from scldm_torch.training.ema import current_decay, ema_init, ema_update
from scldm_torch.training.ldm_task import LDMTask, split_condition
from scldm_torch.training.optim import AdamW, wsd_schedule
from scldm_torch.transport import create_transport, mean_flat
from scldm_torch.utils.weights import load_reference_ema_, load_reference_state_dict
from tests.test_training import make_batch
from tests.torch_port.test_torch_port_dit import B as PAIR_B
from tests.torch_port.test_torch_port_dit import _t, make_pair, randomized_dit_params

N_GENES = 40
VAE_ARCH = dict(n_genes=N_GENES, n_embed=16, n_embed_latent=8, n_layer=1, n_inducing_points=4,
                n_head=2, n_head_cross=2)
DIT_ARCH = dict(n_embed=32, n_embed_input=8, n_layer=2, n_head=2, seq_len=4,
                class_vocab_sizes={"clusters": 3}, cfg_dropout_prob=0.8)
# an EMA that copies at the first step and blends from the second
TASK = dict(num_training_steps=10, ema_update_every=1, ema_update_after_step=0,
            calculate_grad_norms=True)
LR = 5e-4


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# -- transport ---------------------------------------------------------------------

def test_training_losses_match_jax():
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(6, 4, 8)).astype(np.float32)
    jt, tt = jax_create_transport(), create_transport()
    key = jax.random.PRNGKey(3)
    want = jt.training_losses(lambda x, t: x * (1.0 + t[:, None, None]) + jnp.sin(3.0 * x),
                              key, jnp.asarray(x1))
    t, x0, _ = jt.sample(key, jnp.asarray(x1))  # JAX's draws, injected
    got = tt.losses_at(lambda x, t: x * (1.0 + t[:, None, None]) + torch.sin(3.0 * x),
                       torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0)),
                       torch.from_numpy(x1))
    for k in ("loss", "pred"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean_flat(torch.from_numpy(x1)).numpy(),
                               np.asarray(jax_mean_flat(jnp.asarray(x1))), rtol=1e-5, atol=1e-7)
    # the port's own draws: t on [0, 1), the loss per sample
    calls = []
    terms = tt.training_losses(lambda x, t, c: calls.append((t, c)) or x,
                               torch.Generator().manual_seed(0), torch.from_numpy(x1), {"c": 1})
    t_drawn, c = calls[0]
    assert terms["loss"].shape == (6,) and c == 1
    assert ((t_drawn >= 0) & (t_drawn < 1)).all()


@pytest.mark.parametrize("flags", [dict(), dict(eval=True)])
def test_check_interval_matches_jax(flags):
    kw = dict(train_eps=1e-3, sample_eps=2e-2)
    jt = jax_create_transport("Linear", "velocity", **kw)
    tt = create_transport("Linear", "velocity", **kw)
    assert tt.check_interval(**flags) == pytest.approx(
        jt.check_interval(jt.train_eps, jt.sample_eps, **flags))
    assert create_transport().check_interval() == jax_create_transport().check_interval(0.0, 0.0)


def test_create_transport_keys():
    t = create_transport(loss_weight="velocity")
    assert (t.loss_weight, t.train_eps, t.sample_eps) == ("velocity", 0.0, 0.0)
    for path, pred in (("GVP", "velocity"), ("Linear", "noise")):
        with pytest.raises(NotImplementedError):
            create_transport(path, pred)


# -- conditioning --------------------------------------------------------------------

def _recover_draws(want, keep, drop):
    """JAX's drop mask from its train-mode embedding: each row is either
    the kept or the dropped one; None if some row is neither."""
    d_keep = np.abs(want - keep).max(1)
    d_drop = np.abs(want - drop).max(1)
    if not np.all(np.minimum(d_keep, d_drop) <= 1e-5):
        return None
    return d_drop <= 1e-5


@pytest.mark.parametrize("strategy", ["mutually_exclusive", "joint"])
@pytest.mark.parametrize("vocab", [{"clusters": 5}, {"clusters": 5, "tissue": 3}])
def test_embed_condition_matches_jax(strategy, vocab):
    """Train mode: JAX's class choice and drop mask are recovered by trying
    each choice with every row kept and every row dropped; the port, given
    them, matches JAX's embedding and its module-path forward."""
    jdit, params, tdit, (x, t, cond) = make_pair(strategy, vocab)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    tt, tc = torch.from_numpy(t), _t(cond)
    choices = range(len(vocab)) if strategy == "mutually_exclusive" else [None]
    found = False
    for seed in range(12):
        rngs = {"condition": jax.random.PRNGKey(seed)}
        want = np.asarray(jdit.apply(params, jnp.asarray(t), jc, train=True,
                                     method="embed_condition", rngs=rngs))
        for s in choices:
            sel = {} if s is None else {"selected": torch.tensor(s)}
            with torch.no_grad():
                keep, drop = (tdit.embed_condition(tt, tc, train=True, **sel,
                                                   drop_mask=torch.full((PAIR_B,), d)).numpy()
                              for d in (False, True))
            mask = _recover_draws(want, keep, drop)
            if mask is None or mask.all() or not mask.any():
                continue  # not JAX's choice, or a mask that would not test both rows
            draws = dict(sel, drop_mask=torch.from_numpy(mask))
            with torch.no_grad():
                got = tdit.embed_condition(tt, tc, train=True, **draws)
                fwd = tdit(torch.from_numpy(x), tt, tc, train=True, **draws)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
            want_fwd = jdit.apply(params, jnp.asarray(x), jnp.asarray(t), jc, train=True, rngs=rngs)
            np.testing.assert_allclose(fwd.numpy(), np.asarray(want_fwd), rtol=1e-4, atol=1e-4)
            found = True
        if found:
            break
    assert found


@pytest.mark.parametrize("vocab", [{"clusters": 5}, {"clusters": 5, "tissue": 3}])
def test_embed_condition_without_draws_matches_jax(vocab):
    """No generator: JAX's no-rng branch (the first present class, no
    dropout; one class alone needs no null row); training dropout raises."""
    jdit, params, tdit, (_, t, cond) = make_pair("mutually_exclusive", vocab)
    want = jdit.apply(params, jnp.asarray(t), {k: jnp.asarray(v) for k, v in cond.items()},
                      train=False, method="embed_condition")
    with torch.no_grad():
        got = tdit.embed_condition(torch.from_numpy(t), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        tdit.embed_condition(torch.from_numpy(t), _t(cond), train=True)


def test_embed_condition_draws_from_the_generator():
    *_, tdit, (_, t, cond) = make_pair("mutually_exclusive", {"clusters": 5, "tissue": 3})
    tt, tc = torch.from_numpy(t), _t(cond)
    with torch.no_grad():
        outs = [tdit.embed_condition(tt, tc, torch.Generator().manual_seed(s), train=True)
                for s in (0, 0, 1, 2, 3, 4)]
    assert torch.equal(outs[0], outs[1])
    assert any(not torch.equal(outs[0], o) for o in outs[2:])


def test_split_condition_matches_jax():
    batch = {"counts": np.zeros(3), "genes": np.zeros(3), "clusters": np.arange(3),
             "tissue": np.arange(3), "donor": np.arange(3), "library_size": np.ones(3)}
    vocab = {"clusters": 5, "tissue": 3}
    assert set(split_condition(batch, vocab)) == set(jax_split_condition(batch, vocab)) == set(vocab)


# -- EMA and optimizer -------------------------------------------------------------------

@pytest.mark.parametrize("update_every", [1, 3])
def test_ema_matches_jax(update_every):
    """25 calls with update_after_step 5: the copies of the first calls, then
    the decay ramp."""
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (4, 3), "b.bias": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = dict(beta=0.999, update_every=update_every, update_after_step=5)
    js = jax_ema_init({k: jnp.asarray(v) for k, v in params.items()})
    ts = ema_init((k, torch.from_numpy(v)) for k, v in params.items())
    assert all(ts.params[k].data_ptr() != 0 for k in shapes)
    for i in range(25):
        online = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        js = jax_ema_update(js, {k: jnp.asarray(v) for k, v in online.items()}, **cfg)
        ts = ema_update(ts, [(k, torch.from_numpy(v)) for k, v in online.items()], **cfg)
        assert ts.step == int(js.step) == i + 1
        for k in shapes:
            np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            current_decay(i + 1, 0.999, 5),
            float(jax_current_decay(jnp.asarray(i + 1), 0.999, 5)), rtol=1e-6, atol=1e-7)
    assert current_decay(25, 0.999, 5) > 0.8  # the ramp ran


def test_adamw_matches_optax():
    rng = np.random.default_rng(1)
    shapes = {"w": (5, 7), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(num_training_steps=20, num_warmup_steps=3, fract_decay=1.0, decay_type="cosine")
    sched, jsched = wsd_schedule(**kw), jax_wsd(**kw)
    tx = optax.adamw(learning_rate=lambda c: 1e-2 * jsched(c), b1=0.9, b2=0.999,
                     weight_decay=0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(tp.values(), learning_rate=1e-2, schedule=sched, betas=(0.9, 0.999),
                weight_decay=0.05)
    for _ in range(8):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)
    assert opt.step_count == 8
    assert not np.allclose(tp["w"].detach().numpy(), params["w"], atol=1e-3)


# -- the train step ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """JAX's tiny LDMTask on the module path, with a DiT state whose
    zero-init layers are redrawn (adaLN-zero would zero most block
    gradients)."""
    with jax.default_matmul_precision("highest"):
        batch = make_batch(jax.random.PRNGKey(0), n_genes=N_GENES)
        jvae = jax_build_vae(**VAE_ARCH)
        vae_params = jvae.init(jax.random.PRNGKey(0), batch["counts"], batch["genes"],
                               batch["library_size"], batch["counts_subset"],
                               batch["genes_subset"])
        jdit = JaxDiT(**DIT_ARCH)
        jtask = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), learning_rate=LR,
                           **TASK)
        state = jtask.init_state(jax.random.PRNGKey(3), batch)
        z = jtask._encode(batch)
        params = randomized_dit_params(jdit, jnp.zeros(z.shape), jnp.linspace(0.1, 0.9, z.shape[0]),
                                       {"clusters": batch["clusters"]}, seed=1)
        state = state.replace(params=params, opt_state=jtask.tx.init(params),
                              ema=jax_ema_init(params["params"]))
    return jtask, vae_params, state, batch


def jax_draws(jtask, state, batch):
    """The draws of JAX's `_train_step_impl` at `state`, as the port's
    injected noise: t and x0 from its transport key, the drop mask recovered
    from its conditioning key (one class: no choice to make)."""
    _, rng_t, rng_c, _ = jax.random.split(state.rng, 4)
    z = jtask._encode(batch)
    t, x0, _ = jtask.transport.sample(rng_t, z)
    cond = jax_split_condition(batch, jtask.dit.class_vocab_sizes)
    train = jtask.dit.apply(state.params, t, cond, train=True, method="embed_condition",
                            rngs={"condition": rng_c})
    plain = jtask.dit.apply(state.params, t, cond, train=False, method="embed_condition")
    dropped = np.abs(np.asarray(train) - np.asarray(plain)).max(1) > 1e-6
    return {"t": torch.from_numpy(np.array(t)), "x0": torch.from_numpy(np.array(x0)),
            "drop_mask": torch.from_numpy(dropped)}


def port_task(jtask, vae_params, state, **kw):
    """A port LDMTask whose modules and EMA hold the JAX state's weights."""
    tvae = build_transformer_vae(**VAE_ARCH)
    load_reference_state_dict(tvae, export_torch_state_dict(vae_params))
    tdit = DiT(**DIT_ARCH)
    load_reference_state_dict(tdit, export_torch_state_dict(state.params))
    task = LDMTask(tvae, tdit, create_transport(), learning_rate=LR, **TASK, **kw)
    tstate = task.init_state(torch.Generator().manual_seed(0))
    load_reference_ema_(tstate.ema, export_torch_state_dict(state.ema.params))
    return task, tstate


@pytest.mark.parametrize("path", ["kernel", "module"])
def test_train_steps_match_jax(setup, path):
    """Two steps from the same parameters, batch and draws: loss, gradient
    norm, the grouped norms, the parameters and the EMA after each. AdamW's
    first steps move a parameter by about lr * lr_mult * sign(grad), so the
    parameters are held to a tenth of that where the gradient is not so
    small against its tensor's largest that rounding could flip its sign."""
    jtask, vae_params, state, batch = setup
    task, tstate = port_task(jtask, vae_params, state, fused_training=path == "kernel")
    step_fn = jax.jit(jtask._train_step_impl)  # the public step donates its state
    bwd = fused_dit.DIT_BLOCK_BWD_LAUNCHES.count
    for i in range(2):
        noise = jax_draws(jtask, state, batch)
        state, want = step_fn(state, batch, vae_params)
        tstate, mets = task.train_step(tstate, to_torch(batch), noise)
        assert tstate.step == i + 1 and tstate.ema.step == i + 1
        for k in ("train_loss", "grad_norm", "lr_mult"):
            np.testing.assert_allclose(float(mets[k]), float(want[k]), rtol=1e-5)
        for jk, tk in (("block_0", "blocks/0"), ("t_embedder", "t_embedder"),
                       ("final_layer", "final_layer"), ("input_proj", "input_proj")):
            np.testing.assert_allclose(float(mets[f"grad_norm/diffusion/{tk}"]),
                                       float(want[f"grad_norm/diffusion/{jk}"]), rtol=1e-4)
        step = LR * float(want["lr_mult"])
        want_p = export_torch_state_dict(state.params)
        want_ema = export_torch_state_dict(state.ema.params)
        assert set(want_p) == set(tstate.ema.params)
        for name, p in tstate.module.named_parameters():
            g = p.grad.abs().numpy()  # the step's clipped gradient
            sure = g > 1e-4 * (g.max() + 1e-30)
            assert np.abs(p.detach().numpy() - want_p[name])[sure].max(initial=0.0) <= 0.1 * step, name
            np.testing.assert_allclose(tstate.ema.params[name].numpy(), want_ema[name],
                                       rtol=1e-5, atol=0.1 * step, err_msg=name)
    assert fused_dit.DIT_BLOCK_BWD_LAUNCHES.count == bwd  # CPU: the plain version


def test_grouped_grad_norms_match_jax(setup):
    jtask, _, state, _ = setup
    rng = np.random.default_rng(5)
    jgrads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), state.params)
    from scldm_torch.training.metrics import grad_norms_by_module

    want = jax_grad_norms(jgrads, depth=1, prefix="grad_norm/diffusion")
    got = grad_norms_by_module([(k, torch.from_numpy(np.array(v)))
                                for k, v in export_torch_state_dict(jgrads).items()],
                               depth=1, prefix="grad_norm/diffusion")
    np.testing.assert_allclose(float(got["grad_norm/diffusion/t_embedder"]),
                               float(want["grad_norm/diffusion/t_embedder"]), rtol=1e-5)
    blocks = np.sqrt(sum(float(want[f"grad_norm/diffusion/block_{i}"]) ** 2 for i in range(2)))
    np.testing.assert_allclose(float(got["grad_norm/diffusion/blocks"]), blocks, rtol=1e-5)


def test_fused_encode_matches_jax(setup):
    """`LDMTask(fused_encode=True)`: the frozen encode pools the token window
    through the window pool (its plain version on CPU tensors), as JAX's
    does through its Pallas kernel in interpret mode. Both round the same
    operands to bf16 in one tile: latents within 1e-4 of their largest
    magnitude; against the module encode, JAX's own bound of 0.02."""
    jtask, vae_params, state, batch = setup
    jfused = JaxLDMTask(jtask.vae, vae_params, jtask.dit, jax_create_transport(),
                        fused_encode=True, **TASK)
    jfused.fused_encode_interpret = True
    want = np.asarray(jfused._encode(batch))
    task, _ = port_task(jtask, vae_params, state, fused_encode=True)
    module, _ = port_task(jtask, vae_params, state)
    assert task.fused_encode and not module.fused_encode
    calls = []
    real = fused_encoder._WindowPool.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_encoder._WindowPool, "apply", lambda *a: calls.append(1) or real(*a))
        got = task._encode(to_torch(batch)).numpy()
        plain = module._encode(to_torch(batch)).numpy()
    assert len(calls) == 1
    mag = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4 * mag
    assert np.abs(got - plain).max() < 0.02 * np.abs(plain).max()


@pytest.mark.parametrize("use_ema", [False, True])
def test_eval_step_matches_jax(setup, use_ema):
    """Validation loss with the online and the EMA weights, JAX's draws
    injected; the EMA weights differ from the online ones here."""
    jtask, vae_params, state, batch = setup
    rng = np.random.default_rng(2)
    ema_params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 0.05),
        state.params["params"])
    state = state.replace(ema=state.ema._replace(params=ema_params))
    key = jax.random.PRNGKey(4)
    want = jtask.eval_step(state, batch, key, ema=use_ema)
    t, x0, _ = jtask.transport.sample(jax.random.split(key)[0], jtask._encode(batch))
    task, tstate = port_task(jtask, vae_params, state)
    got = task.eval_step(tstate, to_torch(batch), torch.Generator().manual_seed(0), use_ema=use_ema,
                         noise={"t": torch.from_numpy(np.array(t)),
                                "x0": torch.from_numpy(np.array(x0))})
    prefix = "val_ema" if use_ema else "val"
    for k in ("loss", "diff"):
        np.testing.assert_allclose(float(got[f"{prefix}_{k}"]), float(want[f"{prefix}_{k}"]),
                                   rtol=1e-5)


def test_train_steps_and_sampling_from_ema(setup):
    """`train_steps` over a stacked batch, and generation from the state's EMA
    weights: the same draws as a DiT that holds those weights."""
    jtask, vae_params, state, batch = setup
    task, tstate = port_task(jtask, vae_params, state, fused_training=True)
    stacked = {k: torch.stack([v, v]) for k, v in to_torch(batch).items()}
    tstate, mets = task.train_steps(tstate, stacked)
    assert tstate.step == 2 and tstate.ema.step == 2 and tstate.optimizer.step_count == 2
    assert all(torch.isfinite(v) for v in mets.values())

    with torch.no_grad():
        for p in tstate.ema.params.values():
            p.add_(0.05)  # EMA weights unlike the online ones
    twin = copy.deepcopy(task.dit)
    load_reference_state_dict(twin, tstate.ema.params)
    other = LDMTask(task.vae, twin, create_transport())
    sfs = SizeFactorSampler(constant_stats({"clusters": 3}))
    cond = {"clusters": torch.tensor([0, 2])}
    genes = canonical_gene_ids(N_GENES)
    kw = dict(guidance_weight={"clusters": 1.0}, sampling_method="euler", num_steps=4)
    from_state = task.make_sample_fn(sfs, **kw)(torch.Generator().manual_seed(1), genes, cond,
                                                state=tstate)
    from_twin = other.make_sample_fn(sfs, **kw)(torch.Generator().manual_seed(1), genes, cond)
    online = task.make_sample_fn(sfs, **kw)(torch.Generator().manual_seed(1), genes, cond)
    online_state = task.make_sample_fn(sfs, use_ema=False, **kw)(
        torch.Generator().manual_seed(1), genes, cond, state=tstate)
    for a, b in zip(from_state, from_twin):
        torch.testing.assert_close(a, b)
    for a, b in zip(online, online_state):
        torch.testing.assert_close(a, b)
    assert not torch.allclose(from_state[1], online[1])
