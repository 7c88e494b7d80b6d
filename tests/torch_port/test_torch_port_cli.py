"""The port's command-line entry points end to end on the CPU (device=cpu),
modelled on tests/test_e2e.py: `python -m scldm_torch.cli.train` on a
synthetic h5ad file (the configs as shipped: bf16 compute), then
`train_ldm` on its checkpoint, then `inference`
for generation (configs/generation.yaml), for latents and reconstruction
(configs/inference.yaml) and with `vae_only=true`. The VAE's dims differ from
ldm_training.yaml's fallback `model.vae` block, so `train_ldm` must graft
them from the VAE run's config snapshot. The h5ad files the port writes are
read back with the port's reader and held against those that JAX's
inference CLI writes for the same config (obs columns, var names, obsm keys
and shapes), from JAX checkpoints of the same architecture. Last, a profile
capture writes a trace, and a checkpoint of another architecture is refused
by parameter name."""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scldm_tpu.cli.inference import main as jax_inference
from scldm_tpu.config import build as jax_build
from scldm_tpu.config.loader import load_config as jax_load_config
from scldm_tpu.config.loader import merge_overrides as jax_merge_overrides
from scldm_tpu.config.loader import resolve as jax_resolve
from scldm_tpu.data.h5ad import write_h5ad
from scldm_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from scldm_torch.cli import inference, train, train_ldm
from scldm_torch.data.h5ad import H5ADFile
from scldm_torch.training.checkpoint import read_payload

ROOT = Path(__file__).resolve().parents[2]
N, G = 96, 24
DIT = ["model.diffusion_model.n_embed=32", "model.diffusion_model.n_layer=1",
       "model.diffusion_model.n_head=2", "model.ema.update_after_step=0",
       "model.ema.update_every=1"]
GENERATION = ["generation_args.timesteps=4", "generation_args.sampling_method=euler",
              "generation_args.n_batches=1"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    X = rng.poisson(1.0, size=(N, G)).astype(np.float32)
    clusters = rng.choice([f"c{i}" for i in range(14)], size=N)
    write_h5ad(tmp / "train.h5ad", X, obs={"clusters": clusters},
               var_names=[f"g{i}" for i in range(G)])
    (tmp / "meta.json").write_text(json.dumps(
        {"genes": [f"g{i}" for i in range(G)],
         "labels": {"clusters": [f"c{i}" for i in range(14)]}}))
    (tmp / "mu.json").write_text(json.dumps({"clusters": {f"c{i}": 3.5 for i in range(14)}}))
    (tmp / "sd.json").write_text(json.dumps({"clusters": {f"c{i}": 0.1 for i in range(14)}}))
    return tmp


def overrides(tmp, out="outputs"):
    """tests/test_e2e.py's overrides, on the CPU and into `out`."""
    d = "datamodule.dataset_params.dentate_gyrus"
    return [
        f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
        f"datamodule.datamodule.test_adata_path={tmp / 'train.h5ad'}",
        f"{d}.metadata_json={tmp / 'meta.json'}", f"{d}.n_genes={G}", f"{d}.genes_seq_len={G}",
        f"{d}.mu_size_factor={tmp / 'mu.json'}", f"{d}.sd_size_factor={tmp / 'sd.json'}",
        f"paths.output_path={tmp / out}", f"paths.inference_path={tmp / out / 'inference'}",
        "model.batch_size=16", "model.test_batch_size=8",
        "epochs=2", "datamodule.datamodule.prefetch=0", "training.log_every_steps=5",
        "training.steps_per_dispatch=2",
        # a VAE whose dims differ from ldm_training.yaml's fallback block
        "model.vae.n_embed=16", "model.vae.n_embed_latent=8", "model.vae.n_layer=1",
        "model.vae.n_inducing_points=4", "model.vae.n_head=2", "model.vae.n_head_cross=2",
    ]


def config(name):
    return ["--config", str(ROOT / "configs" / name)]


@pytest.fixture(scope="module")
def port_run(workspace):
    """The port's chain: train (as a module, in its own process), train_ldm,
    generation, inference, vae_only."""
    ov = overrides(workspace) + ["device=cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "scldm_torch.cli.train", *ov],
                          capture_output=True, text=True, timeout=300, env=env, cwd=workspace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert train_ldm.main(config("ldm_training.yaml") + ov + DIT) == 0
    assert inference.main(config("generation.yaml") + ov + DIT + GENERATION) == 0
    assert inference.main(config("inference.yaml") + ov + DIT) == 0
    assert inference.main(config("inference.yaml") + ov + [
        "vae_only=true", f"paths.inference_path={workspace / 'outputs' / 'vae_inference'}"]) == 0
    return workspace / "outputs"


def test_train_writes_checkpoints_config_and_metrics(port_run):
    ckpt = port_run / "checkpoints" / "vae_dentate_gyrus"
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["device"] == "cpu" and cfg["model"]["vae"]["n_embed"] == 16
    steps = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    assert steps == [5, 10]  # 86 train cells: 5 steps an epoch, 2 epochs
    payload = read_payload(ckpt / "10")
    assert payload["step"] == 10 and payload["ema"] is None
    assert payload["optimizer"]["step_count"] == 10
    rows = list(csv.DictReader((ckpt / "metrics.csv").open()))
    train_rows = [r for r in rows if r["train_loss"]]
    assert [float(r["step"]) for r in train_rows] == [5.0, 10.0]
    assert all(np.isfinite(float(r["train_loss"])) for r in train_rows)
    assert any(r["val_loss"] for r in rows)
    assert (ckpt / "best").is_dir()


def test_train_ldm_grafts_the_vae(port_run):
    ckpt = port_run / "checkpoints" / "ldm_dentate_gyrus"
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["model"]["vae"]["n_embed"] == 16  # not the fallback's 32
    assert cfg["model"]["diffusion_model"]["n_embed_input"] == 8
    assert cfg["model"]["diffusion_model"]["seq_len"] == 4
    payload = read_payload(ckpt / "10")
    assert payload["ema"]["step"] == 10
    assert payload["ema"]["params"] and set(payload["ema"]["params"]) <= set(payload["module"])
    rows = [r for r in csv.DictReader((ckpt / "metrics.csv").open()) if r.get("val_ema_loss")]
    assert rows and np.isfinite(float(rows[-1]["val_ema_loss"]))


def test_generation_output(port_run):
    (path,) = (port_run / "inference").glob("*generated*.h5ad")
    f = H5ADFile(path)
    assert f.shape() == (16, G)
    assert list(f.obs_column("generation_type")) == ["unconditional"] * 8 + ["conditional"] * 8
    counts = f.rows(slice(0, f.n_obs))
    assert (counts >= 0).all() and np.isfinite(counts).all()
    assert all(str(c).startswith("c") for c in f.obs_column("clusters"))
    assert np.asarray(f._f["obsm"]["z"]).shape == (16, 4 * 8)


def jax_checkpoints(workspace):
    """JAX checkpoints of the same architecture, written by JAX's own
    CheckpointManager: a VAE train state and an LDM train state."""
    ov = overrides(workspace, out="jax_outputs")
    with jax.default_matmul_precision("highest"):
        cfg = jax_resolve(jax_merge_overrides(jax_load_config(ROOT / "configs/ldm_training.yaml"),
                                              ov + DIT))
        vae = jax_build.build_vae(cfg)
        vtask = jax_build.build_vae_task(cfg, vae, max_steps=1)
        example = {"counts_subset": jnp.ones((8, G)), "library_size": jnp.ones((8, 1)),
                   "genes_subset": jnp.broadcast_to(jnp.arange(1, G + 1), (8, G)),
                   "clusters": jnp.zeros((8,), jnp.int32)}
        vstate = vtask.init_state(jax.random.PRNGKey(0), example)
        vae_dir = workspace / "jax_outputs" / "checkpoints" / "vae_dentate_gyrus"
        mgr = JaxCheckpointManager(vae_dir)
        mgr.save(1, vstate)
        mgr.save_config(cfg)
        mgr.close()
        dit = jax_build.build_dit(cfg)
        ltask = jax_build.build_ldm_task(cfg, vae, vstate.params, dit, max_steps=1)
        lstate = ltask.init_state(jax.random.PRNGKey(1), example)
        mgr = JaxCheckpointManager(workspace / "jax_outputs" / "checkpoints" / "ldm_dentate_gyrus")
        mgr.save(1, lstate)
        mgr.close()
    return ov


def describe(path):
    """What an output file holds, as the port's reader sees it."""
    f = H5ADFile(path)
    obsm = {k: tuple(v.shape) for k, v in f._f["obsm"].items()} if "obsm" in f._f else {}
    return {"shape": f.shape(), "obs": f.obs_columns(), "var": list(f.var_names), "obsm": obsm,
            "labels": {c: sorted({str(v)[0] for v in f.obs_column(c)}) for c in f.obs_columns()
                       if c != "generation_type"}}


def test_outputs_match_jax_cli_files(port_run, workspace):
    ov = jax_checkpoints(workspace)
    jax_out = workspace / "jax_outputs"
    with jax.default_matmul_precision("highest"):
        assert jax_inference(config("generation.yaml") + ov + DIT + GENERATION) == 0
        assert jax_inference(config("inference.yaml") + ov + DIT) == 0
        assert jax_inference(config("inference.yaml") + ov + [
            "vae_only=true", f"paths.inference_path={jax_out / 'vae_inference'}"]) == 0
    for sub, pattern in (("inference", "*generated*.h5ad"), ("inference", "*inference*.h5ad"),
                         ("vae_inference", "*inference*.h5ad")):
        got = sorted((port_run / sub).glob(pattern))
        want = sorted((jax_out / sub).glob(pattern))
        assert [p.name for p in got] == [p.name for p in want] and got
        for g, w in zip(got, want):
            assert describe(g) == describe(w), g.name


def test_vae_checkpoint_of_another_architecture_is_refused(port_run, workspace, tmp_path):
    ov = overrides(workspace) + ["device=cpu"]
    vae_dir = port_run / "checkpoints" / "vae_dentate_gyrus"
    wrong = tmp_path / "wrong_vae"
    wrong.mkdir()
    for step in ("10",):
        (wrong / step).symlink_to(vae_dir / step, target_is_directory=True)
    cfg = json.loads((vae_dir / "config.json").read_text())
    cfg["model"]["vae"]["n_embed"] = 32
    (wrong / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="input_layer|encoder|decoder"):
        train_ldm.main(config("ldm_training.yaml") + ov + DIT + [f"vae_checkpoint_dir={wrong}"])


def test_profile_capture_writes_a_trace(workspace, tmp_path):
    ov = overrides(workspace, out=str(tmp_path / "profiled")) + [
        "device=cpu", f"training.profile_dir={tmp_path / 'trace'}", "training.profile_steps=2",
        "training.steps_per_dispatch=1", "epochs=1"]
    assert train.main(ov) == 0
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
