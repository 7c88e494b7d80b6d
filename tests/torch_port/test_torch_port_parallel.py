"""The port's parallel layouts against the JAX package's on its 8 virtual CPU
devices (tests/conftest.py), over gloo: two processes (and four for the
layouts that need both mesh axes above 1) run
`tests/torch_port/parallel_worker.py` under torchrun's environment, each rank
on its rows of the same global batches, with every random draw JAX made
injected; this process computes JAX's steps on `make_mesh` meanwhile.

- data parallelism: two steps of `VAETask`, `LDMTask` and `ScviTask` at two
  data ranks against JAX at `make_mesh(n_data=2)` (tests/test_training.py:247;
  scVI's BatchNorm takes the global batch's statistics, as JAX's does);
- FSDP (`fsdp=True`, and with `caution=True`) against JAX's ZeRO-3 layout
  (:286, :457): the same steps, the same leaves sharded, each rank's AdamW
  moments half of each sharded leaf;
- gene-SP at `n_model=2` with an odd gene count (:324, :509): the VAE step on
  the module path and on the algebraic tail, with FSDP on a 2 x 2 mesh (:366),
  the generation decode, the unshared decoder's ValueError (:388), and the
  Megatron and GPipe layouts building where JAX builds them and raising its
  ValueErrors where it raises (test_torch_port_model_axis.py runs them);
- `make_sample_fn(split_over_data=True)` against one process;
- `cli.train` with `training.fsdp=true`: a world-1 checkpoint resumed at two
  ranks, a two-rank run whose rank 1 takes SIGTERM (both stop at the same
  step, tests/test_multiprocess.py:127), its checkpoint resumed at world 1;
- the bootstrap's no-op and environment cases (tests/test_multihost_guards.py).

Tolerances: f32 on both sides, the sums in other orders and over ranks.
Losses, gradient norms and metrics within 1e-4 relative; parameters after
each AdamW step within a tenth of the step where every step's gradient was
not so small against its tensor's largest (1e-4) that rounding could flip
its sign (tests/torch_port/test_torch_port_ldm_train.py's rule); scVI's
parameters and BatchNorm buffers as test_torch_port_scvi.py holds them."""

import csv
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from scldm_tpu.data.h5ad import write_h5ad
from scldm_tpu.nn import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from scldm_tpu.parallel.mesh import shard_batch as jax_shard_batch
from scldm_tpu.parallel.sharding_rules import shard_params
from scldm_tpu.training import scvi_task as jst
from scldm_tpu.training.ema import ema_init as jax_ema_init
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.training.vae_task import VAETask as JaxVAETask
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.parallel import distributed
from scldm_torch.parallel.gene_sp import split_sizes
from scldm_torch.parallel.sharding_rules import fit_spec
from scldm_torch.training.checkpoint import read_payload
from scldm_torch.utils.weights import batch_stats_state_dict
from tests.test_training import make_batch
from tests.torch_port.test_torch_port_ldm_train import DIT_ARCH, LR, TASK, jax_draws
from tests.torch_port.test_torch_port_scvi import ARCH as SCVI_ARCH
from tests.torch_port.test_torch_port_scvi import BN_INVARIANT
from tests.torch_port.test_torch_port_scvi import TASK as SCVI_TASK
from tests.torch_port.test_torch_port_scvi import dense_batch, jax_step_draws, jax_vae

ROOT = Path(__file__).resolve().parents[2]
G = 40
G_ODD = 41  # the gene-SP cases: 21 + 20 genes over two model ranks
B = 16
SMALL = dict(n_embed=16, n_embed_latent=8, n_layer=1, n_inducing_points=4, n_head=2,
             n_head_cross=2)
WIDE = dict(n_embed=64, n_embed_latent=16, n_layer=1, n_inducing_points=4, n_head=4,
            n_head_cross=4)  # JAX's FSDP tests' VAE: several leaves pass the 1,024 floor
VAE_TASK = dict(num_training_steps=100, learning_rate=1e-3)
REL = 1e-4


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def np_tree(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def lean(key, n_genes, batch=16, window=24):
    """A lean batch (expressed genes and counts only), the algebraic tail's."""
    rng = np.random.default_rng(key)
    gs = np.zeros((batch, window), np.int32)
    cs = np.zeros((batch, window), np.float32)
    for i in range(batch):
        nnz = int(rng.integers(window // 2, window))
        gs[i, :nnz] = np.sort(rng.choice(n_genes, nnz, replace=False)) + 1
        cs[i, :nnz] = rng.poisson(3.0, nnz) + 1
    return {"genes_subset": gs, "counts_subset": cs, "library_size": cs.sum(1, keepdims=True)}


def sharded_names(params) -> set:
    """The reference names of the leaves JAX's sharding puts on "data"."""
    flags = jax.tree_util.tree_map(
        lambda leaf: np.full(leaf.shape, float("data" in str(leaf.sharding.spec)), np.float32),
        params)
    return {k for k, v in export_torch_state_dict(flags).items() if v.size and v.min() > 0}


def one_program(step_impl, mesh, state):
    """`jax.jit(step_impl)` with the state's shardings pinned on the way in and
    out (replicated where a leaf has none), so that every step after the
    first reuses the first one's compilation; and the state placed so."""
    sh = jax.tree_util.tree_map(
        lambda x: x.sharding if isinstance(x.sharding, NamedSharding)
        else NamedSharding(mesh, PartitionSpec()), state)
    return jax.jit(step_impl, out_shardings=(sh, None)), jax.device_put(state, sh)


# -- JAX's side: each case function returns the port's case and a function
# that computes JAX's reference, called while the ranks run -------------------------------

def redrawn(params, seed):
    """A DiT's parameters with the zero-init layers (adaLN, the final
    linear) redrawn (adaLN-zero would zero most block gradients)."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(params["params"])
    flat = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.1, jnp.float32)
                if ("adaln" in "/".join(k) or k[-2] == "linear") else v)
            for k, v in flat.items()}
    return {"params": flax.traverse_util.unflatten_dict(flat)}


_INITS: dict = {}


def vae_weights(arch, n_genes):
    """The weights JAX's VAETask.init_state(PRNGKey(1)) draws for this
    architecture (they depend on the shapes alone), as the bridge's state
    dict; one jitted init an architecture."""
    key = (tuple(sorted(arch.items())), n_genes)
    if key not in _INITS:
        b = make_batch(jax.random.PRNGKey(0), n_genes=n_genes)
        params = jax.jit(jax_build_vae(n_genes=n_genes, **arch).init)(
            jax.random.PRNGKey(1), counts=b["counts"], genes=b["genes"],
            library_size=b["library_size"], counts_subset=b["counts_subset"],
            genes_subset=b["genes_subset"])
        _INITS[key] = export_torch_state_dict(params)
    return _INITS[key]


def jax_vae_case(arch, n_genes, batches, mesh_shape, port_meshes, **task_kw):
    """The port's case on each of `port_meshes` (JAX's initial weights), and
    the reference: JAX's VAETask on make_mesh(*mesh_shape), its metrics and
    parameters after each step and the leaves it puts on "data"."""
    port_kw = {k: v for k, v in task_kw.items() if k not in ("gene_sp", "fsdp")}
    cases = [{"fn": "vae_steps", "arch": dict(n_genes=n_genes, **arch),
              "weights": vae_weights(arch, n_genes),
              "batches": [np_tree(b) for b in batches], "mesh": m,
              "task": dict(VAE_TASK, **port_kw, **extra)} for m, extra in port_meshes]

    def reference():
        mesh = jax_make_mesh(*mesh_shape)
        task = JaxVAETask(jax_build_vae(n_genes=n_genes, **arch), mesh=mesh, **VAE_TASK,
                          **task_kw)
        state = task.init_state(jax.random.PRNGKey(1), batches[0])
        sharded = sharded_names(state.params)
        step, s = one_program(task._train_step_impl, mesh, state)
        want = []
        for b in batches:
            s, m = step(s, jax_shard_batch(b, mesh))
            want.append({"metrics": {k: float(v) for k, v in m.items()},
                         "params": export_torch_state_dict(s.params)})
        return {"steps": want, "sharded": sharded}

    return cases, reference


def jax_ldm_case(mesh_shape, port_meshes):
    """The port's cases (redrawn DiT weights, JAX's draws: the t, x0 and CFG
    drop mask of its key), and the reference: one step of JAX's LDMTask under
    FSDP on a mesh."""
    batch = make_batch(jax.random.PRNGKey(0), n_genes=G)
    jvae = jax_build_vae(n_genes=G, **SMALL)
    vae_params = jax.jit(jvae.init)(jax.random.PRNGKey(0), batch["counts"], batch["genes"],
                                    batch["library_size"], batch["counts_subset"],
                                    batch["genes_subset"])
    jdit = JaxDiT(**DIT_ARCH)
    kw = dict(learning_rate=LR, **TASK)
    one = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), **kw)
    state = one.init_state(jax.random.PRNGKey(3), batch)
    params = redrawn(state.params, 1)
    state = state.replace(params=params, ema=jax_ema_init(params["params"]))
    cases = [{"fn": "ldm_steps", "vae_arch": dict(n_genes=G, **SMALL), "dit_arch": DIT_ARCH,
              "vae_weights": export_torch_state_dict(vae_params),
              "dit_weights": export_torch_state_dict(state.params),
              "ema": export_torch_state_dict(state.ema.params), "mesh": m,
              "task": dict(learning_rate=LR, fsdp=fsdp, **TASK), "batches": [np_tree(batch)],
              "noise": [jax_draws(one, state, batch)]} for m, fsdp in port_meshes]

    def reference():
        mesh = jax_make_mesh(*mesh_shape)
        task = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), mesh=mesh, fsdp=True,
                          **kw)
        sharded_params = shard_params(params, mesh, fsdp=True)
        sharded = sharded_names(sharded_params)
        s = task.init_state(jax.random.PRNGKey(3), batch).replace(
            params=sharded_params, opt_state=task.tx.init(sharded_params),
            ema=jax_ema_init(sharded_params["params"]))
        s, m = jax.jit(task._train_step_impl)(s, jax_shard_batch(batch, mesh), vae_params)
        return {"steps": [{"metrics": {k: float(v) for k, v in m.items()},
                           "params": export_torch_state_dict(s.params),
                           "ema": export_torch_state_dict(s.ema.params)}], "sharded": sharded}

    return cases, reference


def jax_scvi_case():
    """The port's case (JAX's weights and the step's draws: eps and the
    dropout masks), and the reference: one step of JAX's ScviTask on a
    two-device mesh, its BatchNorm statistics over the global batch."""
    one = jst.ScviTask(jax_vae(), **SCVI_TASK)
    batch = {k: jnp.asarray(v) for k, v in dense_batch(10).items()}
    state = one.init_state(jax.random.PRNGKey(3), batch)
    case = {"fn": "scvi_steps", "arch": dict(SCVI_ARCH, shared_theta=True), "mesh": (2,),
            "weights": {**export_torch_state_dict(state.params["params"]),
                        **batch_stats_state_dict(state.extra)},
            "task": SCVI_TASK, "batches": [np_tree(batch)],
            "noise": [jax_step_draws(one, state, batch)]}

    def reference():
        mesh = jax_make_mesh(2)
        task = jst.ScviTask(jax_vae(), mesh=mesh, **SCVI_TASK)
        s, m = jax.jit(task._train_step_impl)(task.init_state(jax.random.PRNGKey(3), batch),
                                              jax_shard_batch(batch, mesh))
        return {"steps": [{"metrics": {k: float(v) for k, v in m.items()},
                           "params": export_torch_state_dict(s.params)}],
                "buffers": batch_stats_state_dict(s.extra)}

    return case, reference


def jax_generation_case():
    """JAX's gene-SP generation (euler-3 under CFG) on a (1, 2) mesh: the
    port's case with JAX's draws, and the reference (its latents and their
    decode's NB mean)."""
    batch = make_batch(jax.random.PRNGKey(0), n_genes=G_ODD)
    jvae = jax_build_vae(n_genes=G_ODD, **SMALL)
    vae_params = jax.jit(jvae.init)(jax.random.PRNGKey(0), batch["counts"], batch["genes"],
                                    batch["library_size"], batch["counts_subset"],
                                    batch["genes_subset"])
    jdit = JaxDiT(**DIT_ARCH)
    mesh = jax_make_mesh(1, 2)
    task = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), mesh=mesh, gene_sp=True,
                      **TASK)
    params = redrawn(task.init_state(jax.random.PRNGKey(3), batch).params, 2)
    from scldm_tpu.sampling.size_factors import SizeFactorSampler as JaxSFS

    sfs = JaxSFS.__new__(JaxSFS)
    sfs.strategy, sfs.tables, sfs.joint_table, sfs.joint_components = (
        "mutually_exclusive", {}, None, None)
    guidance = {"clusters": 1.0}
    key = jax.random.PRNGKey(7)
    cond = {"clusters": batch["clusters"]}
    k_sf, k_z, _ = jax.random.split(key, 3)
    log_sf = sfs.sample(k_sf, cond, B)
    z0 = jax.random.normal(k_z, (B, DIT_ARCH["seq_len"], DIT_ARCH["n_embed_input"]), jnp.float32)
    case = {"fn": "generate", "vae_arch": dict(n_genes=G_ODD, **SMALL), "dit_arch": DIT_ARCH,
            "vae_weights": export_torch_state_dict(vae_params),
            "dit_weights": export_torch_state_dict(params), "task": dict(TASK),
            "z0": torch.from_numpy(np.array(z0)), "log_sf": torch.from_numpy(np.array(log_sf)),
            "genes": torch.from_numpy(np.array(batch["genes"])), "guidance": guidance,
            "condition": {"clusters": torch.from_numpy(np.array(batch["clusters"]))}, "steps": 3}

    def reference():
        fn = task.make_sample_fn(sfs, guidance_weight=guidance, sampling_method="euler",
                                 num_steps=3, use_ema=False)
        _, z = fn(params, key, batch["genes"], cond)
        genes_cfg = jnp.concatenate([batch["genes"], batch["genes"]])
        sf = jnp.exp(log_sf).reshape(-1, 1)
        out = jax.jit(lambda p, zz, g, l: jvae.apply(p, zz, g, l, method="decode"))(
            vae_params, z, genes_cfg, jnp.concatenate([sf, sf]))
        return {"z": np.asarray(z), "mu": np.asarray(out["mu"]), "theta": np.asarray(out["theta"])}

    return case, reference


# -- the launches ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cases: dict, world: int, tmp: Path):
    """Start `world` ranks of the worker on `cases`; returns (procs, out dir)."""
    out = tmp / f"out{world}"
    out.mkdir()
    torch.save(cases, tmp / f"cases{world}.pt")
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        log = open(tmp / f"rank{world}_{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_port.parallel_worker",
             str(tmp / f"cases{world}.pt"), str(out)],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    return procs, out


def wait(procs, tmp: Path, world: int):
    for r, (p, log) in enumerate(procs):
        p.wait(timeout=300)
        log.close()
        assert p.returncode == 0, (tmp / f"rank{world}_{r}.log").read_text()[-4000:]


def cli_workspace(tmp: Path):
    """A train and a test h5ad file, their metadata and size-factor
    statistics; returns the dentate overrides at a small width (FSDP on)."""
    rng = np.random.default_rng(0)
    n, g = 96, 24
    for name in ("train", "test"):
        X = rng.poisson(1.0, size=(n, g)).astype(np.float32)
        write_h5ad(tmp / f"{name}.h5ad", X, obs={"clusters": rng.choice(["c0", "c1"], size=n)},
                   var_names=[f"g{i}" for i in range(g)])
    (tmp / "meta.json").write_text(json.dumps(
        {"genes": [f"g{i}" for i in range(g)], "labels": {"clusters": ["c0", "c1"]}}))
    (tmp / "mu.json").write_text(json.dumps({"clusters": {"c0": 3.5, "c1": 3.0}}))
    (tmp / "sd.json").write_text(json.dumps({"clusters": {"c0": 0.1, "c1": 0.1}}))
    d = "datamodule.dataset_params.dentate_gyrus"
    return [f"datamodule.datamodule.train_adata_path={tmp / 'train.h5ad'}",
            f"datamodule.datamodule.test_adata_path={tmp / 'test.h5ad'}",
            f"{d}.metadata_json={tmp / 'meta.json'}", f"{d}.n_genes={g}", f"{d}.genes_seq_len={g}",
            f"{d}.mu_size_factor={tmp / 'mu.json'}", f"{d}.sd_size_factor={tmp / 'sd.json'}",
            "model.batch_size=4", "model.test_batch_size=4", "epochs=3",
            "datamodule.datamodule.prefetch=0", "training.log_every_steps=2",
            "model.compute_dtype=float32", "model.vae.n_layer=1", "model.vae.n_inducing_points=4",
            "model.diffusion_model.n_embed=32", "model.diffusion_model.n_layer=1",
            "model.diffusion_model.n_head=2", "training.fsdp=true",
            "training.checkpoint.save_every_epochs=100", "device=cpu"]


def config(name):
    return ["--config", str(ROOT / "configs" / name)]


GENERATION = ["generation_args.timesteps=4", "generation_args.sampling_method=euler",
              "generation_args.n_batches=2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of this module, JAX's references computed while the
    ranks run. Returns (results by case and rank, JAX's references by case,
    the CLI directories)."""
    tmp = tmp_path_factory.mktemp("parallel")
    from scldm_torch.cli import train

    base = cli_workspace(tmp)
    args = config("vae_training.yaml") + base
    resume_dir, cut_dir = tmp / "resume", tmp / "cut"
    # a world-1 run for the two ranks to resume
    assert train.main(args + [f"paths.output_path={resume_dir}", "training.max_steps=3"]) == 0

    with jax.default_matmul_precision("highest"):
        odd = [make_batch(jax.random.PRNGKey(i), n_genes=G_ODD) for i in range(2)]
        two, four, later = {}, {}, {}
        # the port's data ranks and model ranks against JAX's gene-SP program
        (two["dp_vae"], two["gene_sp_vae"]), later["small"] = jax_vae_case(
            SMALL, G_ODD, odd, (1, 2), [((2,), {}), ((1, 2), {"gene_sp": True})], gene_sp=True)
        (two["gene_sp_algebraic"],), later["algebraic"] = jax_vae_case(
            SMALL, G_ODD, [lean(i, G_ODD) for i in range(2)], (1, 2),
            [((1, 2), {"gene_sp": True})], gene_sp=True, algebraic_tail=True)
        (two["fsdp_vae"],), later["wide"] = jax_vae_case(
            WIDE, G_ODD, odd, (2,), [((2,), {"fsdp": True})], fsdp=True)
        (two["fsdp_vae_caution"], four["gene_sp_fsdp"]), later["caution"] = jax_vae_case(
            WIDE, G_ODD, odd, (2, 2), [((2,), {"fsdp": True}), ((2, 2), {"fsdp": True,
                                                                       "gene_sp": True})],
            fsdp=True, gene_sp=True, caution=True)
        (two["dp_ldm"], two["fsdp_ldm"]), later["ldm"] = jax_ldm_case(
            (2,), [((2,), False), ((2,), True)])
        two["dp_scvi"], later["scvi"] = jax_scvi_case()
        gen, later["generate"] = jax_generation_case()
        two["gene_sp_generate"] = dict(gen, mesh=(1, 2), task=dict(TASK, gene_sp=True))
        two["split_generate"] = dict({k: v for k, v in gen.items() if k != "z0"}, mesh=(2,))
        four["generate_2x2"] = dict(gen, mesh=(2, 2), task=dict(TASK, gene_sp=True))
        two["refusals"] = {"fn": "refusals", "mesh": (1, 2), "arch": dict(n_genes=G, **SMALL),
                           "ldm": dict(two["dp_ldm"], task=dict(TASK))}
        out = [f"paths.output_path={resume_dir}"]
        two["cli"] = {"fn": "cli", "mesh": (2,), "args": args,
                      "resume": out + ["training.max_steps=12"],
                      "cut": [f"paths.output_path={cut_dir}", "training.max_steps=12"],
                      "ldm": config("ldm_training.yaml") + base + out + ["training.max_steps=4"],
                      "gen": config("generation.yaml") + base + out + GENERATION,
                      "gen_dirs": {2: tmp / "gen_sp", 1: tmp / "gen_split"},
                      "scvi": config("vae_scvi_training.yaml") + base + [
                          f"paths.output_path={tmp / 'scvi'}", "training.max_steps=4",
                          "model.scvi.n_hidden=16"]}
        procs2, out2 = launch(two, 2, tmp)
        procs4, out4 = launch(four, 4, tmp)
        done = {k: fn() for k, fn in later.items()}
    refs = {"dp_vae": done["small"], "gene_sp_vae": done["small"],
            "gene_sp_algebraic": done["algebraic"], "fsdp_vae": done["wide"],
            "fsdp_vae_caution": done["caution"], "gene_sp_fsdp": done["caution"],
            "dp_ldm": done["ldm"], "fsdp_ldm": done["ldm"], "dp_scvi": done["scvi"],
            "generate": done["generate"]}
    wait(procs2, tmp, 2)
    wait(procs4, tmp, 4)
    results = {}
    for cases, world, out in ((two, 2, out2), (four, 4, out4)):
        for name in cases:
            results[name] = [torch.load(out / f"{name}_{r}.pt", weights_only=False)
                             for r in range(world)]
            for r, res in enumerate(results[name]):
                assert "error" not in res, f"{name} rank {r}:\n{res['error']}"
    return results, refs, {"resume": resume_dir, "cut": cut_dir, "args": args, "tmp": tmp,
                           "gen": two["cli"]["gen"]}


# -- the checks -----------------------------------------------------------------------------

def hold_steps(got_steps, want_steps, lr, keys):
    """Each step's metrics at REL, and the parameters after it within a
    tenth of AdamW's step where every gradient so far was sure."""
    sure = {}
    for got, want in zip(got_steps, want_steps):
        for k in keys:
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=REL, err_msg=k)
        step = lr * want["metrics"]["lr_mult"]
        assert set(got["params"]) == set(want["params"])
        for name, p in got["params"].items():
            if name not in got["grads"]:  # frozen (the encoder's all-zeros table)
                np.testing.assert_array_equal(p.numpy(), want["params"][name].reshape(p.shape))
                continue
            if name == SHIFT_INVARIANT:
                scale = max(float(g.abs().max()) for g in got["grads"].values())
                assert float(got["grads"][name].abs().max()) < 1e-5 * scale
                continue
            g = got["grads"][name].abs().numpy()
            now = g > 1e-4 * (g.max() + 1e-30)
            sure[name] = sure.get(name, now) & now
            gap = np.abs(p.numpy() - want["params"][name].reshape(p.shape))
            assert gap[sure[name]].max(initial=0.0) <= 0.1 * step, name


def same_on_every_rank(ranks):
    for other in ranks[1:]:
        for a, b in zip(ranks[0]["steps"], other["steps"]):
            assert a["metrics"] == b["metrics"]
            assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


VAE_KEYS = ("train_loss", "train_llh", "train_theta", "grad_norm", "lr_mult")
# the NB head's logit bias: a shift every gene shares, which the softmax over
# the genes cancels, so its gradient is zero but for rounding, and AdamW
# turns that rounding into steps of the learning rate's size either way
SHIFT_INVARIANT = "decoder_head.params.bias"


@pytest.mark.parametrize("name", ["dp_vae", "fsdp_vae", "fsdp_vae_caution", "gene_sp_vae",
                                  "gene_sp_algebraic", "gene_sp_fsdp"])
def test_vae_layout_matches_jax(runs, name):
    """Two VAE steps on each layout against JAX's on the same mesh, every
    rank in lockstep."""
    results, refs, _ = runs
    ranks = results[name]
    hold_steps(ranks[0]["steps"], refs[name]["steps"], VAE_TASK["learning_rate"], VAE_KEYS)
    same_on_every_rank(ranks)
    # the gates stay as on one card under DP and FSDP; gene-SP closes them
    assert ranks[0]["gates"]["fused_decoder"] is (False if "gene" in name else None)
    assert ranks[0]["gates"]["gene_sp"] == ("gene_sp" in name)


@pytest.mark.parametrize("name", ["dp_ldm", "fsdp_ldm"])
def test_ldm_layout_matches_jax(runs, name):
    """Two LDM steps (JAX's t, x0 and CFG drop mask injected, each rank its
    rows) with the EMA after each; the grouped gradient norms under FSDP sum
    the slices' squares."""
    results, refs, _ = runs
    ranks = results[name]
    keys = ("train_loss", "grad_norm", "lr_mult", "grad_norm/diffusion/blocks/0",
            "grad_norm/diffusion/t_embedder")
    want = [dict(w, metrics=dict(w["metrics"], **{
        "grad_norm/diffusion/blocks/0": w["metrics"]["grad_norm/diffusion/block_0"],
        "grad_norm/diffusion/t_embedder": w["metrics"]["grad_norm/diffusion/t_embedder"]}))
        for w in refs[name]["steps"]]
    hold_steps(ranks[0]["steps"], want, LR, keys)
    same_on_every_rank(ranks)
    ema_want = refs[name]["steps"][-1]["ema"]
    step = LR * want[-1]["metrics"]["lr_mult"]
    for n, t in ranks[0]["ema"].items():
        np.testing.assert_allclose(t.numpy(), ema_want[n], rtol=1e-5, atol=0.1 * step, err_msg=n)
    assert ranks[0]["gates"]["fused_training"] is None  # as on one card, under FSDP too


def test_scvi_data_parallel_matches_jax(runs):
    """A scVI step (eps and dropout masks injected) with the BatchNorm
    statistics of the global batch: metrics, parameters and buffers."""
    results, refs, _ = runs
    ranks = results["dp_scvi"]
    for got, want in zip(ranks[0]["steps"], refs["dp_scvi"]["steps"]):
        assert set(got["metrics"]) == set(want["metrics"])
        for k in want["metrics"]:
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=REL,
                                       atol=REL, err_msg=k)
    for name, p in ranks[0]["steps"][-1]["params"].items():
        if name not in BN_INVARIANT:
            np.testing.assert_allclose(p.numpy(), refs["dp_scvi"]["steps"][-1]["params"][name],
                                       rtol=REL, atol=REL, err_msg=name)
    for name, want in refs["dp_scvi"]["buffers"].items():
        np.testing.assert_allclose(ranks[0]["buffers"][name].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    same_on_every_rank(ranks)


@pytest.mark.parametrize("name", ["fsdp_vae", "fsdp_vae_caution", "fsdp_ldm", "gene_sp_fsdp"])
def test_fsdp_shards_what_jax_shards(runs, name):
    """The port slices exactly the leaves JAX's ZeRO-3 rule puts on "data",
    and each rank's AdamW moments hold half of each (the other half on the
    other data rank)."""
    results, refs, _ = runs
    for res in results[name]:
        assert set(res["sharded"]) == refs[name]["sharded"] != set()
        for leaf, moments in res["sharded"].items():
            assert moments and all(n * 2 == res["full_numel"][leaf] for n in moments.values())


@pytest.mark.parametrize("name", ["gene_sp_generate", "generate_2x2"])
def test_gene_sp_generation_matches_jax(runs, name):
    """The CFG samples from JAX's noise, and the NB mean each model rank
    decodes over its genes, gathered, against JAX's gene-sharded program;
    with data ranks too (2 x 2) each takes half the rows."""
    results, refs, _ = runs
    want = refs["generate"]
    for res in results[name]:
        np.testing.assert_allclose(res["samples"].numpy(), want["z"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["mu"].numpy(), want["mu"], rtol=REL, atol=REL)
        np.testing.assert_allclose(res["theta"].numpy(), want["theta"], rtol=1e-6)


@pytest.mark.parametrize("name", ["split_generate", "generate_2x2"])
def test_split_generation_matches_one_process(runs, name):
    """`make_sample_fn(split_over_data=True)`: every rank returns the whole
    batch, dopri5 takes the one-process steps (its error norm over every
    rank's rows) and the NB draws agree but for a vanishing share of
    threshold flips."""
    results, _, _ = runs
    for res in results[name]:
        assert res["evals"][0] == res["evals"][1]
        np.testing.assert_allclose(res["split_z"].numpy(), res["single_z"].numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert (res["split_counts"] != res["single_counts"]).float().mean() < 1e-3


def test_refusals_on_a_model_axis(runs):
    """A "model" axis of 2 without gene-SP builds JAX's Megatron layout, and
    a pipeline there its GPipe trunk; they raise JAX's ValueErrors where JAX
    does (a pipeline beside gene-SP names "model", DiT dropout "dropout", a
    layer count the stages do not divide "stages"), as does gene-SP on an
    unshared decoder. Also the bootstrap at two ranks (a second call does
    nothing) and `shard_batch` / `shard_stacked_batch`, each rank its rows."""
    results, _, _ = runs
    for r, res in enumerate(results["refusals"]):
        for key in ("vae_without_gene_sp", "ldm_without_gene_sp", "ldm_pipeline"):
            assert res[key] is None, (key, res[key])
        for key, word in (("ldm_pipeline_gene_sp", "model"), ("ldm_pipeline_dropout", "dropout"),
                          ("ldm_pipeline_stages", "stages"),
                          ("vae_unshared_gene_sp", "shared-embedding")):
            kind, msg = res[key]
            assert kind == "ValueError" and word in msg, (key, msg)
        assert (res["world"], res["rank"], res["again"]) == (2, r, True)
        x = np.arange(24).reshape(2, 4, 3)
        assert res["rows"] == x[0, 2 * r: 2 * r + 2].tolist()
        assert res["stacked_rows"] == x[:, 2 * r: 2 * r + 2].tolist()


def test_cli_train_resumes_across_world_sizes_and_stops_in_lockstep(runs):
    """`cli.train` with `training.fsdp=true`: a world-1 checkpoint (step 3)
    resumed at two ranks to step 12, through epoch 0's validation (means
    over the ranks, logged by rank 0); a fresh two-rank run whose rank 1 took
    SIGTERM after its second step, where both ranks stop at the guard's next
    agreement (step 8) and save full tensors, which world 1 resumes to 12."""
    from scldm_torch.cli import train

    results, _, dirs = runs
    ends = [res["ends"] for res in results["cli"]]
    rcs = [res["rc"] for res in results["cli"]]
    assert rcs == [(0, 0), (0, 0)] and ends == [[12, 4, 4, 8], [12, 4, 4, 8]]
    resumed = dirs["resume"] / "checkpoints" / "vae_dentate_gyrus"
    assert max(int(p.name) for p in resumed.iterdir() if p.name.isdigit()) == 12
    rows = list(csv.DictReader((resumed / "metrics.csv").open()))
    val = [(float(r["epoch"]), float(r["step"])) for r in rows if r.get("val_loss")]
    steps = [float(r["step"]) for r in rows if r.get("train_loss")]
    # world 1 validated at its step 3; the two ranks at epoch 0's end and at step 12
    assert val == [(0.0, 3.0), (0.0, 10.0), (1.0, 12.0)]
    assert steps[-1] == 12.0 and len(steps) == len(set(steps))
    cut = dirs["cut"] / "checkpoints" / "vae_dentate_gyrus"
    assert max(int(p.name) for p in cut.iterdir() if p.name.isdigit()) == 8
    payload = read_payload(cut / "8")
    assert payload["step"] == 8 and len(payload["generators"]) == 2
    want = read_payload(resumed / "12")
    assert all(payload["module"][k].shape == v.shape for k, v in want["module"].items())
    assert train.main(dirs["args"] + [f"paths.output_path={dirs['cut']}",
                                      "training.max_steps=12"]) == 0
    assert read_payload(cut / "12")["step"] == 12


def test_cli_generation_at_two_ranks_matches_one(runs):
    """`train_ldm` (FSDP) and `train_scvi` at two ranks, and `inference` generation at two
    ranks with `n_model=2` (each rank decodes half the genes) and with
    `n_model=1` (each data rank integrates half the batch): rank 0 writes
    one h5ad file, and its latents match the same checkpoint's generation
    in one process (the module DiT against the kernels' plain version:
    sums in other orders), its counts but for a vanishing share of NB
    threshold flips."""
    from scldm_torch.cli import inference
    from scldm_torch.data.h5ad import H5ADFile

    results, _, dirs = runs
    assert all(res["ldm_gen_rcs"] == [0, 0, 0, 0] for res in results["cli"])
    scvi = dirs["tmp"] / "scvi" / "checkpoints" / "scvi_dentate_gyrus"
    assert read_payload(scvi / "4")["step"] == 4  # train_scvi at two ranks
    ldm = dirs["resume"] / "checkpoints" / "ldm_dentate_gyrus"
    assert read_payload(ldm / "4")["step"] == 4
    one = dirs["tmp"] / "gen_one"
    assert inference.main(dirs["gen"] + ["n_model=1", f"paths.inference_path={one}"]) == 0

    def read(d):
        (path,) = Path(d).glob("*generated*.h5ad")
        f = H5ADFile(path)
        return f.rows(slice(0, f.n_obs)), np.asarray(f._f["obsm"]["z"])

    want_counts, want_z = read(one)
    assert want_counts.shape == (16, 24)  # two batches of 4 cells, both CFG halves
    for d in ("gen_sp", "gen_split"):
        counts, z = read(dirs["tmp"] / d)
        np.testing.assert_allclose(z, want_z, rtol=1e-4, atol=1e-4, err_msg=d)
        assert (counts != want_counts).mean() < 2e-2, d


# -- one process ----------------------------------------------------------------------------

def test_bootstrap_is_a_no_op_for_one_process(monkeypatch):
    for var in distributed._TORCHRUN + distributed._JAX:
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize_distributed("cpu") is False
    assert (distributed.world_size(), distributed.rank()) == (1, 0)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert distributed.maybe_initialize_distributed("cpu") is False  # one process of one


@pytest.mark.parametrize("env,call", [
    ({"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.1",
      "MASTER_PORT": "1234"}, dict(init_method="env://", world_size=4, rank=1)),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
      "JAX_PROCESS_ID": "2"}, dict(init_method="tcp://10.0.0.1:1234", world_size=4, rank=2)),
])
def test_bootstrap_reads_the_launch_environment(monkeypatch, env, call):
    """torchrun's variables, or JAX's explicit triple, start one gloo group
    on the CPU; a second call does nothing."""
    for var in distributed._TORCHRUN + distributed._JAX:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    up, level = [], distributed.logger.level
    try:
        with mock.patch("torch.distributed.init_process_group",
                        side_effect=lambda *a, **k: up.append((a, k))) as init, \
                mock.patch("torch.distributed.is_initialized", side_effect=lambda: bool(up)):
            assert distributed.maybe_initialize_distributed("cpu") is True
            assert distributed.maybe_initialize_distributed("cpu") is True
    finally:
        distributed.logger.setLevel(level)  # rank 1's log is quiet
    init.assert_called_once_with("gloo", **call)


def test_bootstrap_refuses_nccl_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        distributed.maybe_initialize_distributed("cuda")


def test_checkpoint_refuses_a_host_local_dir_across_machines(monkeypatch, tmp_path):
    """JAX's guard where the ranks span machines (torchrun's
    LOCAL_WORLD_SIZE below the world): every rank must read what rank 0
    wrote, so /tmp, /var and /dev/shm are refused; on one machine they are
    fine."""
    from scldm_torch.training import checkpoint

    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distributed.spans_nodes()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert not distributed.spans_nodes()
    monkeypatch.setattr(checkpoint, "spans_nodes", lambda: True)
    with pytest.raises(ValueError, match="host-local"):
        checkpoint.CheckpointManager("/tmp/ckpts-multinode-test")
    monkeypatch.setattr(checkpoint, "spans_nodes", lambda: False)
    checkpoint.CheckpointManager(tmp_path / "ok").close()


@pytest.mark.parametrize("n,parts,want", [(36_601, 2, [18_301, 18_300]), (41, 2, [21, 20]),
                                          (10, 4, [3, 3, 2, 2])])
def test_gene_ranges(n, parts, want):
    assert split_sizes(n, parts) == want


@pytest.mark.parametrize("shape,n,want", [((88, 32), 2, True), ((64, 41), 2, True),
                                          ((33, 63), 2, False), ((16, 16), 2, False),
                                          ((2048,), 1, False), ((2048,), 4, True)])
def test_fsdp_rule_is_jax_rule(shape, n, want):
    """`fit_spec` with fsdp and no "model" axis is JAX's `_fit_spec`: 1,024
    elements or more and a dimension the data axis divides (n = 1 shards
    nothing)."""
    assert fit_spec("w", shape, 1, n, True) == (None, want)
