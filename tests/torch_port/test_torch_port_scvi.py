"""The port's scVI baseline against the JAX package's, on the same weights
(the bridge, `batch_stats` included) and the same numpy inputs from a seed:
EncoderScvi, DecoderScvi and the two heads in train and eval mode at 1e-5;
the BatchNorm running buffers after one and three `ScviTask` steps against
JAX's `batch_stats`; the task's loss, every gradient and `eval_step`'s
metrics at 1e-4; `train_steps(K)` against K single steps; the builders on
configs/vae_scvi_training.yaml as shipped; `python -m
scldm_torch.cli.train_scvi` on the CPU, preempted and resumed bit for bit
against an uninterrupted run; and the fresh initialisation (theta ones).

JAX's draws cannot be made in torch: the reparameterisation eps is
recovered from JAX's z, loc and scale ((z - loc) / scale), the dropout
masks from the outputs of its Dropout modules (`capture_intermediates`),
and the NB draw of `eval_step` is JAX's own; all are injected (`noise`)."""

import csv
import json
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.config import build as jax_build
from scldm_tpu.config.loader import load_config as jax_load_config
from scldm_tpu.config.loader import merge_overrides as jax_merge_overrides
from scldm_tpu.config.loader import resolve as jax_resolve
from scldm_tpu.data.h5ad import write_h5ad
from scldm_tpu.nn import heads as jheads
from scldm_tpu.nn import nnets as jnnets
from scldm_tpu.ops.distributions import nb_sample as jax_nb_sample
from scldm_tpu.training import scvi_task as jst
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.cli import train_scvi
from scldm_torch.config import build
from scldm_torch.config.loader import load_config, merge_overrides, resolve
from scldm_torch.nn import heads, nnets
from scldm_torch.nn.vae import build_scvi_vae
from scldm_torch.training.checkpoint import read_payload
from scldm_torch.training.scvi_task import ScviTask
from scldm_torch.utils.weights import (
    batch_stats_state_dict,
    init_reference_,
    load_reference_state_dict,
)

ROOT = Path(__file__).resolve().parents[2]
G, B, H, Z, S = 40, 12, 16, 6, 20
ARCH = dict(n_genes=G, n_hidden=H, n_latent=Z, n_layers=2, dropout=0.1)
TASK = dict(n_latent=Z, kl_weight=0.7, num_training_steps=50)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
TASK_TOL = dict(rtol=1e-4, atol=1e-4)
# the biases of the dense layers that feed a BatchNorm: it subtracts the
# batch mean, so their gradient is zero but for rounding, and AdamW turns
# that rounding into steps of the learning rate's size on either side
BN_INVARIANT = {f"{m}.dense_{i}.bias" for m in ("encoder", "decoder") for i in range(2)}


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def np32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def dense_batch(seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(rng.uniform(0.2, 3.0, size=(B, G))).astype(np.float32)
    counts[:, 0] += 1  # no empty cell
    return {"counts": counts, "library_size": counts.sum(1, keepdims=True),
            "genes": np.tile(np.arange(1, G + 1, dtype=np.int32), (B, 1))}


def lean_batch(seed=0):
    """The DataModule's lean wire: expressed genes and counts, uint16."""
    rng = np.random.default_rng(seed)
    gs = np.zeros((B, S), np.uint16)
    cs = np.zeros((B, S), np.uint16)
    for i in range(B):
        nnz = int(rng.integers(S // 2, S))
        gs[i, :nnz] = np.sort(rng.choice(G, nnz, replace=False)) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    return {"genes_subset": gs, "counts_subset": cs}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_vae(arch=ARCH, shared_theta=True):
    return jax_build.build_scvi_vae({"model": {"scvi": dict(arch, shared_theta=shared_theta)}})


def port_vae(variables, arch=ARCH, shared_theta=True):
    tvae = build_scvi_vae(**arch, shared_theta=shared_theta, device="cpu")
    load_reference_state_dict(tvae, {**export_torch_state_dict(variables["params"]),
                                     **batch_stats_state_dict(variables["batch_stats"])})
    return tvae


def keep_masks(intermediates, n_layers):
    """The keep masks of a body's Dropout modules, from their outputs."""
    return [torch.from_numpy(np.asarray(intermediates[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(n_layers)]


def port_buffers(module):
    return {n: b.detach().numpy() for n, b in module.named_buffers()}


# -- the modules --------------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_scvi_bodies_match_jax(part, train):
    """EncoderScvi (log1p, then Dense, BatchNorm, SiLU, Dropout a layer) and
    DecoderScvi: the output, and in train mode the moved buffers."""
    rng = np.random.default_rng(1)
    if part == "encoder":
        jmod = jnnets.EncoderScvi(n_genes=G, n_hidden=H, n_layers=2, dropout=0.1)
        tmod = nnets.EncoderScvi(G, H, 2, 0.1)
        x = rng.poisson(2.0, size=(B, G)).astype(np.float32)
    else:
        jmod = jnnets.DecoderScvi(n_latent=Z, n_hidden=H, n_layers=2, dropout=0.1)
        tmod = nnets.DecoderScvi(Z, H, 2, 0.1)
        x = rng.normal(size=(B, Z)).astype(np.float32)
    variables = jmod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                          jnp.asarray(x), train=True)
    # running statistics away from their initial values, so eval mode reads them
    stats = jax.tree_util.tree_map(lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(np.float32),
                                   variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    load_reference_state_dict(tmod, {**export_torch_state_dict(variables["params"]),
                                     **batch_stats_state_dict(stats)})
    if train:
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                                   rngs={"dropout": jax.random.PRNGKey(2)},
                                   mutable=["batch_stats", "intermediates"],
                                   capture_intermediates=True)
        keep = keep_masks(mutated["intermediates"], 2)
        assert 0 < sum(int((~k).sum()) for k in keep)  # some entries dropped
        got = tmod(torch.from_numpy(x), train=True, keep=keep)
        want_buffers = batch_stats_state_dict(mutated["batch_stats"])
        got_buffers = port_buffers(tmod)
        assert set(got_buffers) == set(want_buffers)
        for name in want_buffers:
            np.testing.assert_allclose(got_buffers[name], want_buffers[name], **MODULE_TOL,
                                       err_msg=name)
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(np32(got), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("shared_theta", [True, False])
def test_scvi_heads_match_jax(shared_theta):
    """GaussianLinearHead (log-scale clipped to [-7, 5], exp in f32) and
    NegativeBinomialLinearHead (softplus theta, f32 softmax times the
    library), with logits wide enough that the clip binds."""
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(B, H)) * 8).astype(np.float32)
    lib = rng.uniform(50, 500, size=(B, 1)).astype(np.float32)
    jg = jheads.GaussianLinearHead(n_hidden=H, n_latent=Z)
    pg = jg.init(jax.random.PRNGKey(0), jnp.asarray(h))
    tg = heads.GaussianLinearHead(H, Z)
    load_reference_state_dict(tg, export_torch_state_dict(pg))
    want = jg.apply(pg, jnp.asarray(h))
    got = tg(torch.from_numpy(h))
    assert float(np.abs(np.log(np.asarray(want[1]))).max()) >= 5.0  # the clip binds
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np.asarray(w), **MODULE_TOL)

    jn = jheads.NegativeBinomialLinearHead(n_genes=G, n_hidden=H, shared_theta=shared_theta)
    pn = jn.init(jax.random.PRNGKey(1), jnp.asarray(h), None, jnp.asarray(lib))
    if shared_theta:  # away from the initial ones
        pn = {"params": dict(pn["params"], theta=jnp.asarray(rng.normal(size=G), jnp.float32))}
    tn = heads.NegativeBinomialLinearHead(G, H, shared_theta)
    load_reference_state_dict(tn, export_torch_state_dict(pn))
    want = jn.apply(pn, jnp.asarray(h), None, jnp.asarray(lib))
    got = tn(torch.from_numpy(h), torch.from_numpy(lib))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(np32(g), np.asarray(w), **MODULE_TOL)


# -- the task ------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_setup():
    jtask = jst.ScviTask(jax_vae(), **TASK)
    state = jtask.init_state(jax.random.PRNGKey(3), to_jax(dense_batch()))
    return jtask, state


def jax_step_draws(jtask, state, batch):
    """The draws of JAX's `_train_step_impl` at `state`, as injectable noise:
    its rng splits, then eps from (z - loc) / scale and the dropout masks
    from the Dropout outputs of the same apply."""
    _, rng_s = jax.random.split(state.rng)
    rng_z, rng_d = jax.random.split(rng_s)
    (_, (loc, scale), z), mutated = jtask.vae.apply(
        {"params": state.params["params"], "batch_stats": state.extra},
        counts=batch["counts"], genes=None, library_size=batch["library_size"], train=True,
        rngs={"sample": rng_z, "dropout": rng_d}, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True)
    inter = mutated["intermediates"]
    eps = (np.asarray(z, np.float64) - np.asarray(loc, np.float64)) / np.asarray(scale, np.float64)
    return {"eps": torch.from_numpy(eps.astype(np.float32)),
            "keep": {k: keep_masks(inter[k], 2) for k in ("encoder", "decoder")}}


def port_task(state, **kw):
    task = ScviTask(port_vae({"params": state.params["params"], "batch_stats": state.extra}),
                    **TASK, **kw)
    return task, task.init_state(torch.Generator().manual_seed(0))


def test_scvi_task_loss_and_gradients_match_jax(jax_setup):
    """One training ELBO (the NB NLL over genes plus kl_weight * (log q -
    log p)) and every gradient, on a lean uint16 batch the task densifies."""
    jtask, state = jax_setup
    lean = lean_batch(4)
    jb = jtask._materialize(to_jax(lean))
    _, rng_s = jax.random.split(state.rng)

    def loss_fn(params):
        out, (posterior, z), _ = jtask._apply(params, state.extra, jb, rng_s, train=True)
        llh, kl = jtask._elbo(out, (posterior, z), jb["counts"])
        return llh + kl, (llh, kl)

    (loss, (llh, kl)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    noise = jax_step_draws(jtask, state, jb)
    task, _ = port_task(state)
    got, aux = task.loss(to_torch(lean), torch.Generator(), noise)
    got.backward()
    got = got.detach()
    for name, g, w in (("loss", got, loss), ("llh", aux["train_llh"], llh),
                       ("kl", aux["train_kl"], kl)):
        np.testing.assert_allclose(float(g), float(w), **TASK_TOL, err_msg=name)
    want = export_torch_state_dict(grads)
    named = dict(task.vae.named_parameters())
    assert set(named) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in named.items():
        if name in BN_INVARIANT:  # rounding on both sides
            assert max(float(p.grad.abs().max()), float(np.abs(want[name]).max())) < 1e-5 * scale
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name], **TASK_TOL, err_msg=name)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_batchnorm_buffers_and_steps_track_jax(jax_setup, n_steps):
    """`n_steps` optimizer steps (clip, AdamWLegacy on the sqrt WSD
    schedule) with JAX's draws injected: the metrics of each step, then the
    BatchNorm running buffers against JAX's `batch_stats` and the
    parameters against JAX's."""
    jtask, state = jax_setup
    task, tstate = port_task(state)
    step = jax.jit(jtask._train_step_impl)
    for i in range(n_steps):
        batch = to_jax(dense_batch(10 + i))
        noise = jax_step_draws(jtask, state, batch)
        state, want = step(state, batch)
        tstate, got = task.train_step(tstate, to_torch(dense_batch(10 + i)), noise)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), **TASK_TOL, err_msg=k)
    assert tstate.step == n_steps
    want = batch_stats_state_dict(state.extra)
    got = port_buffers(tstate.module)
    assert set(got) == set(want) and len(want) == 8
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **MODULE_TOL, err_msg=name)
    want = export_torch_state_dict(state.params)
    for name, p in tstate.module.named_parameters():
        if name not in BN_INVARIANT:
            np.testing.assert_allclose(p.detach().numpy(), want[name], **TASK_TOL, err_msg=name)


def test_scvi_eval_step_matches_jax(jax_setup):
    """`eval_step` in evaluation mode (running averages, no dropout): the
    ELBO at JAX's sampled z and the count metrics on JAX's NB draw."""
    jtask, state = jax_setup
    batch = to_jax(dense_batch(20))
    rng = jax.random.PRNGKey(7)
    want = jax.jit(jtask._eval_step_impl)(state.params, state.extra, batch, rng)
    rng_s, rng_nb = jax.random.split(rng)
    out, (loc, scale), z = jtask.vae.apply(
        {"params": state.params["params"], "batch_stats": state.extra}, counts=batch["counts"],
        genes=None, library_size=batch["library_size"], train=False, rngs={"sample": rng_s})
    eps = (np.asarray(z, np.float64) - np.asarray(loc, np.float64)) / np.asarray(scale, np.float64)
    counts_pred = jax_nb_sample(rng_nb, out["mu"], out["theta"])
    task, tstate = port_task(state)
    got = task.eval_step(tstate, to_torch(dense_batch(20)), torch.Generator(),
                         noise={"eps": torch.from_numpy(eps.astype(np.float32)),
                                "counts_pred": torch.from_numpy(np.array(counts_pred))})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TASK_TOL, err_msg=k)
    # the buffers do not move in evaluation mode
    assert all(np.array_equal(b, port_buffers(port_task(state)[0].vae)[n])
               for n, b in port_buffers(tstate.module).items())


def test_train_steps_equal_single_steps(jax_setup):
    """`train_steps` over K stacked batches is K `train_step`s, bit for bit,
    the generator's draws included; and prior sampling gives counts."""
    _, state = jax_setup
    batches = [to_torch(lean_batch(30 + i)) for i in range(3)]
    task_a, a = port_task(state)
    task_b, b = port_task(state)
    a, mets = task_a.train_steps(a, {k: torch.stack([x[k] for x in batches]) for k in batches[0]})
    singles = []
    for x in batches:
        b, m = task_b.train_step(b, x)
        singles.append(m)
    for k in mets:
        assert torch.equal(mets[k], torch.stack([m[k] for m in singles]).mean()), k
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    counts = task_a.sample(a, torch.Generator().manual_seed(1), torch.full((5, 1), 100.0))
    assert counts.shape == (5, G) and bool((counts >= 0).all()) and bool(torch.isfinite(counts).all())


def test_fresh_init_matches_jax_distributions():
    """`init_reference_` starts where flax's init does: xavier-uniform Dense
    kernels, zero biases, BatchNorm scale 1 and bias 0 with running mean 0
    and variance 1, and the shared theta at ones."""
    arch = dict(n_genes=300, n_hidden=128, n_latent=10, n_layers=1, dropout=0.1)
    variables = jax.jit(jax_vae(arch).init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, counts=jnp.ones((4, 300)), genes=None,
        library_size=jnp.ones((4, 1)), train=True)
    jflat = {**export_torch_state_dict(variables["params"])}
    # flax's init pass itself moved the running statistics; the initialisers are zeros / ones
    tvae = init_reference_(build_scvi_vae(**arch, device="cpu"), torch.Generator().manual_seed(0))
    named = dict(tvae.named_parameters())
    assert set(named) == set(jflat)
    for name, p in named.items():
        got, want = p.detach().numpy(), jflat[name]
        assert got.shape == want.shape, name
        if p.ndim == 2:  # xavier-uniform: the same bound and spread
            bound = np.sqrt(6.0 / sum(p.shape))
            for v in (got, want):
                assert np.abs(v).max() <= bound
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.05, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert np.array_equal(named["decoder_head.theta"].detach().numpy(), np.ones(300, np.float32))
    for n, b in port_buffers(tvae).items():
        assert np.array_equal(b, np.zeros_like(b) if n.endswith("mean") else np.ones_like(b)), n


# -- the builders and the CLI ------------------------------------------------------------------

def scvi_cfg(extra=()):
    ov = ["device=cpu", *extra]
    return resolve(merge_overrides(load_config(ROOT / "configs/vae_scvi_training.yaml"), ov))


def test_build_scvi_task_from_the_shipped_yaml():
    """configs/vae_scvi_training.yaml as shipped: the module's parameter
    names and shapes are JAX builder's (through the bridge), and the task
    carries the config (dropout 0.1, kl_weight 1, lr 1e-3, betas, clip)."""
    cfg = scvi_cfg()
    jcfg = jax_resolve(jax_merge_overrides(jax_load_config(ROOT / "configs/vae_scvi_training.yaml"),
                                           []))
    task = build.build_scvi_task(cfg, max_steps=100)
    jtask = jax_build.build_scvi_task(jcfg, max_steps=100)
    n = cfg["model"]["scvi"]["n_genes"]
    assert n == 17_002 and task.vae.decoder_head.n_genes == n
    variables = jax.eval_shape(lambda: jtask.vae.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(0)}, counts=jnp.ones((2, n)), genes=None,
        library_size=jnp.ones((2, 1)), train=True))
    variables = jax.tree_util.tree_map(lambda v: np.zeros(v.shape, v.dtype), variables)
    want = {k: tuple(v.shape) for k, v in export_torch_state_dict(variables["params"]).items()}
    want.update({k: tuple(v.shape) for k, v in
                 batch_stats_state_dict(variables["batch_stats"]).items()})
    assert {k: tuple(v.shape) for k, v in task.vae.state_dict().items()} == want
    assert task.vae.encoder.dropout == task.vae.decoder.dropout == 0.1
    assert task.kl_weight == jtask.kl_weight == 1.0 and task.grad_clip == 10.0
    assert [task.schedule(s) for s in (0, 5, 50, 99)] == pytest.approx(
        [float(jtask.schedule(s)) for s in (0, 5, 50, 99)], rel=1e-6)
    opt = task.init_state(torch.Generator().manual_seed(0)).optimizer
    assert opt.defaults["lr"] == 1e-3 and opt.defaults["betas"] == (0.9, 0.95)
    assert opt.defaults["weight_decay"] == 0.0
    assert all(p.device.type == "cpu" for p in task.vae.parameters())


@pytest.fixture(scope="module")
def scvi_workspace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scvi_cli")
    rng = np.random.default_rng(0)
    n, g = 96, 24
    X = rng.poisson(1.0, size=(n, g)).astype(np.float32)
    write_h5ad(tmp / "train.h5ad", X, obs={"clusters": rng.choice(["c0", "c1"], size=n)},
               var_names=[f"g{i}" for i in range(g)])
    (tmp / "meta.json").write_text(json.dumps(
        {"genes": [f"g{i}" for i in range(g)], "labels": {"clusters": ["c0", "c1"]}}))
    d = "datamodule.dataset_params.dentate_gyrus"
    args = [f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
            f"{d}.metadata_json={tmp / 'meta.json'}", f"{d}.n_genes={g}", f"{d}.genes_seq_len={g}",
            "model.batch_size=16", "model.test_batch_size=8", "epochs=2",
            "datamodule.datamodule.prefetch=0", "training.log_every_steps=2",
            "model.scvi.n_hidden=32", "device=cpu"]
    return tmp, args


def test_cli_train_scvi_preempted_and_resumed_bitwise(scvi_workspace, monkeypatch):
    """`train_scvi.main` on configs/vae_scvi_training.yaml: an uninterrupted
    run, and a run stopped by SIGTERM after its third step (the guard's
    checkpoint) then resumed; the two end on the same step with the same
    parameters, BatchNorm buffers, optimizer state and generator, bit for
    bit, and write their metrics and checkpoints."""
    tmp, args = scvi_workspace
    config = ["--config", str(ROOT / "configs/vae_scvi_training.yaml")]
    assert train_scvi.main(config + args + [f"paths.output_path={tmp / 'full'}"]) == 0

    real_step = ScviTask.train_step

    def preempting(self, state, batch, noise=None):
        out = real_step(self, state, batch, noise)
        if state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(ScviTask, "train_step", preempting)
    cut = config + args + [f"paths.output_path={tmp / 'cut'}"]
    assert train_scvi.main(cut) == 0
    ck = tmp / "cut" / "checkpoints" / "scvi_dentate_gyrus"
    # the guard stops the loop at its next dispatch boundary (8 steps a dispatch)
    cut_at = max(int(p.name) for p in ck.iterdir() if p.name.isdigit())
    assert 3 <= cut_at < 10
    monkeypatch.setattr(ScviTask, "train_step", real_step)
    assert train_scvi.main(cut) == 0

    full_ck = tmp / "full" / "checkpoints" / "scvi_dentate_gyrus"
    last = max(int(p.name) for p in full_ck.iterdir() if p.name.isdigit())
    assert last == 10  # 86 train cells: 5 steps of 16 an epoch, 2 epochs
    a, b = read_payload(ck / str(last)), read_payload(full_ck / str(last))
    assert a["step"] == b["step"] == last
    assert set(a["module"]) == set(b["module"]) and any("running_var" in k for k in a["module"])
    assert all(torch.equal(a["module"][k], b["module"][k]) for k in a["module"])
    assert torch.equal(a["generator"], b["generator"])
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i] if torch.is_tensor(sa[i][k]))
    rows = list(csv.DictReader((full_ck / "metrics.csv").open()))
    train_rows = [r for r in rows if r.get("train_loss")]
    assert train_rows and all(np.isfinite(float(r["train_loss"])) for r in train_rows)
    assert {"train_llh", "train_kl", "train_theta"} <= set(train_rows[0])
    val = [r for r in rows if r.get("val_loss")]
    assert val and all(np.isfinite(float(r[k])) for r in val
                       for k in ("val_loss", "val_kl", "val_mse", "val_pcc"))
