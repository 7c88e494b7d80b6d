"""The port's fit loop, checkpoints and preemption guard, against the JAX
package's where JAX has a counterpart: `fit` on the VAE task from weights
carried over from JAX, against JAX's `fit` over the same h5ad file (the same
steps, learning rates and logged metrics within 1e-4 relative; at
steps_per_dispatch 1 and 3), a checkpoint round trip of the optimizer, the
generator and the EMA with best-k and asynchronous saves, a preempted and
resumed run bit for bit equal to an uninterrupted one for the VAE and the LDM
task, `max_steps` never overshot, the epoch-end flush skipped on preemption,
the guard's signal path, and a `CSVLogger` file byte for byte equal to
JAX's for the same rows. Small sizes (G = 24 genes, a 1-layer VAE, as
tests/test_e2e.py), on the CPU."""

import csv
import json
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.data.datamodule import DataModule as JaxDataModule
from scldm_tpu.data.encoder import VocabularyEncoder as JaxEncoder
from scldm_tpu.data.h5ad import write_h5ad
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.training.loop import CSVLogger as JaxCSVLogger
from scldm_tpu.training.loop import fit as jax_fit
from scldm_tpu.training.vae_task import VAETask as JaxVAETask
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.data.datamodule import DataModule
from scldm_torch.data.encoder import VocabularyEncoder
from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.training.checkpoint import CheckpointManager
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.training.loop import CSVLogger, fit, validate
from scldm_torch.training.preemption import PreemptionGuard
from scldm_torch.training.vae_task import VAETask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import init_reference_, load_reference_state_dict

N, G, B = 96, 24, 16
VAE = dict(n_genes=G, n_embed=16, n_embed_latent=8, n_layer=1, n_inducing_points=4, n_head=2,
           n_head_cross=2)
# metrics that do not depend on a random draw (the validation NB sample does)
DETERMINISTIC = ("train_loss", "train_llh", "train_theta", "grad_norm", "lr_mult", "val_loss",
                 "val_llh", "val_theta")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    rng = np.random.default_rng(0)
    X = rng.poisson(1.0, size=(N, G)).astype(np.float32)
    clusters = rng.choice([f"c{i}" for i in range(14)], size=N)
    write_h5ad(tmp / "train.h5ad", X, obs={"clusters": clusters},
               var_names=[f"g{i}" for i in range(G)])
    (tmp / "meta.json").write_text(json.dumps(
        {"genes": [f"g{i}" for i in range(G)],
         "labels": {"clusters": [f"c{i}" for i in range(14)]}}))
    return tmp


def datamodule(workspace, jax_side=False, **kw):
    enc = dict(class_vocab_sizes={"clusters": 14}, metadata_json=str(workspace / "meta.json"))
    args = dict(train_adata_path=str(workspace / "train.h5ad"), batch_size=B,
                test_batch_size=8, genes_seq_len=G, prefetch=0, dense_transfer=False)
    args.update(kw)
    dm = (JaxDataModule(vocabulary_encoder=JaxEncoder(**enc), **args) if jax_side
          else DataModule(vocabulary_encoder=VocabularyEncoder(**enc), **args))
    dm.setup("fit")
    return dm


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# -- fit against JAX ------------------------------------------------------------------------------

MAX_STEPS = 12  # 5 steps an epoch: the budget cuts through epoch 2


@pytest.fixture(scope="module")
def jax_task(workspace):
    """One JAX VAE task for both dispatch settings (its jitted steps compile
    once), and its initial state on the host (JAX's steps donate theirs)."""
    with jax.default_matmul_precision("highest"):
        jtask = JaxVAETask(jax_build_vae(**VAE), num_training_steps=MAX_STEPS)
        jdm = datamodule(workspace, jax_side=True)
        example = {k: jnp.asarray(v) for k, v in next(iter(jdm.train_batches(0))).items()}
        state = jax.device_get(jtask.init_state(jax.random.PRNGKey(0), example))
    return jtask, state


@pytest.mark.parametrize("steps_per_dispatch", [1, 3])
def test_fit_matches_jax(workspace, tmp_path, jax_task, steps_per_dispatch):
    jtask, host_state = jax_task
    jdm, tdm = datamodule(workspace, jax_side=True), datamodule(workspace)
    assert tdm.steps_per_epoch == jdm.steps_per_epoch == 5
    fit_kw = dict(max_steps=MAX_STEPS, epochs=3, log_every_steps=1,
                  steps_per_dispatch=steps_per_dispatch, eval_rng_seed=0)
    with jax.default_matmul_precision("highest"):
        jstate = jax_fit(jtask, jdm, jax.tree_util.tree_map(jnp.asarray, host_state),
                         csv_logger=JaxCSVLogger(tmp_path / "jax.csv"), **fit_kw)
    vae = build_transformer_vae(**VAE, device="cpu")
    load_reference_state_dict(vae, export_torch_state_dict(host_state.params))
    task = VAETask(vae, num_training_steps=MAX_STEPS)
    state = fit(task, tdm, task.init_state(torch.Generator().manual_seed(0)),
                csv_logger=CSVLogger(tmp_path / "port.csv"), **fit_kw)
    assert state.step == int(jstate.step) == MAX_STEPS
    got, want = read_rows(tmp_path / "port.csv"), read_rows(tmp_path / "jax.csv")
    assert len(got) == len(want) > 0
    assert list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        assert (g["step"], g["epoch"]) == (w["step"], w["epoch"])
        for k in DETERMINISTIC:
            if w.get(k):
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-4, err_msg=k)


# -- checkpoints -----------------------------------------------------------------------------------

def vae_state(seed=0, steps=0, workspace=None):
    vae = init_reference_(build_transformer_vae(**VAE, device="cpu"),
                          torch.Generator().manual_seed(seed))
    task = VAETask(vae, num_training_steps=20)
    state = task.init_state(torch.Generator().manual_seed(seed))
    if steps:
        dm = datamodule(workspace)
        for batch in list(dm.train_batches(0))[:steps]:
            state, _ = task.train_step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    return task, state


def ldm_parts(seed=0):
    vae = init_reference_(build_transformer_vae(**VAE, device="cpu"),
                          torch.Generator().manual_seed(seed)).requires_grad_(False).eval()
    dit = init_reference_(DiT(32, 8, 1, 2, 4, class_vocab_sizes={"clusters": 14},
                              cfg_dropout_prob=0.5), torch.Generator().manual_seed(seed + 1),
                          zero_init=False)
    task = LDMTask(vae, dit, create_transport(), num_training_steps=20, ema_update_after_step=0,
                   ema_update_every=1)
    return task, task.init_state(torch.Generator().manual_seed(seed + 2))


def assert_states_equal(a, b):
    assert a.step == b.step
    for (na, ta), (nb, tb) in zip(a.module.state_dict().items(), b.module.state_dict().items()):
        assert na == nb and torch.equal(ta, tb), na
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["step_count"] == sb["step_count"] and sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert (a.ema is None) == (b.ema is None)
    if a.ema is not None:
        assert a.ema.step == b.ema.step
        assert all(torch.equal(a.ema.params[k], b.ema.params[k]) for k in a.ema.params)


def test_checkpoint_round_trip_vae(workspace, tmp_path):
    _, state = vae_state(steps=3, workspace=workspace)
    torch.rand(3, generator=state.generator)  # a generator that has moved
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.latest_step() is None and mgr.save(3, state)
    assert not mgr.save(3, state) and not mgr.save(2, state)  # at or before the latest
    _, template = vae_state(seed=1)
    restored = mgr.restore(template)
    assert restored is template
    assert_states_equal(restored, state)
    assert not list((tmp_path / "ck").rglob("*.tmp"))


def test_checkpoint_round_trip_ldm_with_ema(workspace, tmp_path):
    task, state = ldm_parts()
    dm = datamodule(workspace)
    for batch in list(dm.train_batches(0))[:2]:
        state, _ = task.train_step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    mgr = CheckpointManager(tmp_path / "ck", async_save=True)
    mgr.save(2, state)
    _, template = ldm_parts(seed=5)
    resumed, step = mgr.maybe_restore(template)
    assert step == 2
    assert_states_equal(resumed, state)
    mgr.close()


def test_checkpoint_retention_and_best_k(workspace, tmp_path):
    _, state = vae_state()
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2, monitor="val_loss", save_top_k=2,
                            mode="min", async_save=True)
    losses = {1: 5.0, 2: 3.0, 3: 4.0, 4: 6.0}
    for step, loss in losses.items():
        state.step = step
        mgr.save(step, state, metrics={"val_loss": loss})
    state.step = 5
    mgr.save(5, state)  # no monitored metric: not a candidate for best/
    assert mgr.latest_step() == 5
    assert sorted(int(p.name) for p in (tmp_path / "ck").iterdir() if p.name.isdigit()) == [4, 5]
    assert mgr.best_step() == 2
    assert sorted(int(p.name) for p in (tmp_path / "ck" / "best").iterdir()) == [2, 3]
    _, template = vae_state(seed=3)
    assert mgr.restore_best(template).step == 2
    mgr.save_config({"a": {"b": [1, 2]}})
    assert mgr.load_config() == {"a": {"b": [1, 2]}}
    mgr.close()
    maximize = CheckpointManager(tmp_path / "mx", monitor="val_pcc", save_top_k=1, mode="max")
    for step, pcc in ((1, 0.2), (2, 0.9), (3, 0.5)):
        maximize.save(step, state, metrics={"val_pcc": pcc})
    assert maximize.best_step() == 2


# -- preemption and resume -------------------------------------------------------------------------

class StopAfter:
    """A DataModule whose train stream asks the guard to stop once it has
    handed out `n` batches (the signal arrives mid-group)."""

    def __init__(self, dm, guard, n):
        self.dm, self.guard, self.n = dm, guard, n
        self.steps_per_epoch, self.n_val_batches = dm.steps_per_epoch, dm.n_val_batches
        self.val_batches = dm.val_batches

    def train_batches(self, epoch=0, skip=0):
        for i, batch in enumerate(self.dm.train_batches(epoch, skip=skip)):
            if i == self.n:
                self.guard.request_stop()
            yield batch


@pytest.mark.parametrize("kind", ["vae", "ldm"])
def test_preempted_and_resumed_run_equals_uninterrupted(workspace, tmp_path, kind):
    make = (lambda: vae_state()) if kind == "vae" else ldm_parts
    fit_kw = dict(max_steps=9, epochs=2, steps_per_dispatch=3, log_every_steps=1,
                  eval_rng_seed=0)
    task, state = make()
    full = fit(task, datamodule(workspace), state,
               ckpt_manager=CheckpointManager(tmp_path / "full"), **fit_kw)
    assert full.step == 9

    guard = PreemptionGuard()
    task, state = make()
    mgr = CheckpointManager(tmp_path / "cut")
    # the 4th batch is pending when the stop is seen: the flush at epoch end
    # must not run it, so the checkpoint is at step 3
    cut = fit(task, StopAfter(datamodule(workspace), guard, 4), state, ckpt_manager=mgr,
              preemption=guard, csv_logger=CSVLogger(tmp_path / "cut.csv"), **fit_kw)
    assert cut.step == 3 and mgr.latest_step() == 3
    assert not any(p.name.isdigit() and int(p.name) > 3 for p in (tmp_path / "cut").iterdir())

    task, state = make()  # a new process: fresh weights, then auto-resume
    resumed = fit(task, datamodule(workspace), state, ckpt_manager=mgr,
                  csv_logger=CSVLogger(tmp_path / "cut.csv"), **fit_kw)
    assert resumed.step == 9
    assert_states_equal(resumed, full)
    steps = [int(float(r["step"])) for r in read_rows(tmp_path / "cut.csv") if r["train_loss"]]
    assert steps == sorted(steps) and steps[-1] == 9


def test_max_steps_never_overshot(workspace, tmp_path):
    task, state = vae_state()
    mgr = CheckpointManager(tmp_path / "ck")
    state = fit(task, datamodule(workspace), state, max_steps=7, epochs=4, steps_per_dispatch=3,
                ckpt_manager=mgr)
    assert state.step == 7 and mgr.latest_step() == 7
    task, state = vae_state()
    state = fit(task, datamodule(workspace), state, max_steps=7, epochs=4, steps_per_dispatch=3,
                ckpt_manager=mgr)  # resumes at the budget: nothing more to do
    assert state.step == 7 and mgr.latest_step() == 7


def test_validate_reports_raw_and_ema_for_ldm(workspace):
    task, state = ldm_parts()
    dm = datamodule(workspace)
    metrics = validate(task, dm, state, seed=3)
    assert set(metrics) == {"val_loss", "val_diff", "val_ema_loss", "val_ema_diff"}
    assert metrics == validate(task, dm, state, seed=3)  # seeded per batch
    assert all(np.isfinite(v) for v in metrics.values())


def test_guard_signal_path():
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    before = signal.getsignal(signal.SIGUSR1)
    guard.install()
    assert guard.install() is guard  # idempotent
    if threading.current_thread() is threading.main_thread():
        assert signal.getsignal(signal.SIGUSR1) == guard._on_signal
        signal.raise_signal(signal.SIGUSR1)
        assert guard.stop_requested and guard.stop_requested_global()
    else:  # no handlers off the main thread; the flag still works
        guard.request_stop()
        assert guard.stop_requested_global()
    guard.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == before


def test_guard_degrades_off_the_main_thread():
    result = {}

    def run():
        guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
        result["installed"] = signal.getsignal(signal.SIGUSR1) == guard._on_signal
        guard.request_stop()
        result["stop"] = guard.stop_requested_global()
        guard.uninstall()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert result == {"installed": False, "stop": True}


# -- the CSV logger ------------------------------------------------------------------------------

def test_csv_logger_file_matches_jax(tmp_path):
    rows = [
        {"train_loss": np.float32(1.25), "grad_norm": 3.5, "step": 1, "epoch": 0},
        {"step": 1, "epoch": 0, "val_loss": 2.0, "val_pcc": np.float64(0.125)},
        {"train_loss": 0.5, "grad_norm": 1.0, "cells_per_sec": 1e4, "step": 2, "epoch": 1},
        {"note": "text", "step": 3},
    ]
    for logger_cls, name in ((CSVLogger, "port.csv"), (JaxCSVLogger, "jax.csv")):
        first = logger_cls(tmp_path / name)
        for row in rows[:2]:
            first.log(row)
        resumed = logger_cls(tmp_path / name)  # adopts the header
        for row in rows[2:]:
            resumed.log(row)
    port_bytes = (tmp_path / "port.csv").read_bytes()
    assert port_bytes == (tmp_path / "jax.csv").read_bytes()
    header = port_bytes.decode().splitlines()[0].split(",")
    assert header[-2:] == ["cells_per_sec", "note"]
    CSVLogger(tmp_path / "t.csv").log({"loss": torch.tensor(0.25), "step": 1})
    assert read_rows(tmp_path / "t.csv") == [{"loss": "0.25", "step": "1.0"}]
