"""The port's Megatron and GPipe layouts over the mesh's "model" axis against
the JAX package's on its 8 virtual CPU devices (tests/conftest.py), over
gloo: two and four processes run `tests/torch_port/parallel_worker.py` under
torchrun's environment, each rank on its rows of the same global batches,
with every random draw JAX made injected; this process computes JAX's steps
on `make_mesh` meanwhile.

- Megatron `VAETask` (a "model" axis of 2 without gene-SP,
  tests/test_training.py:263) at (1, 2) and (2, 2) for two steps: the module
  path, the algebraic tail at E = 144 (the port with `swiglu_vec` on each
  rank's hidden slice, which JAX closes under a mesh: the same math), with
  `caution=True`, with FSDP on 2 x 2, and with three heads over two model
  ranks (3E divisible, the heads not); each rank's parameter and AdamW
  moment elements per leaf against JAX's per-device shard of the leaf;
- Megatron `LDMTask`: two steps and generation against JAX's (:554);
- `LDMTask(pipeline_microbatches=2)`: two steps against JAX's task on the
  same mesh (tests/test_pipeline.py:130), and generation (euler under CFG)
  from a pipeline task, each model rank decoding its genes;
- `pipeline_blocks` forward and gradients against JAX's at
  (n_data, n_model, n_micro) = (1, 2, 2), (1, 4, 8) and (2, 2, 2), and its
  guards (tests/test_pipeline.py:216);
- a one-process checkpoint resumed by Megatron ranks, and theirs at one
  process.

Tolerances as test_torch_port_parallel.py's: f32 losses, gradient norms and
metrics within 1e-4 relative; parameters after each AdamW step within a
tenth of the step where every step's gradient was not so small against its
tensor's largest (1e-4) that rounding could flip its sign."""

import math
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.nn import DiT as JaxDiT
from scldm_tpu.nn.vae import build_transformer_vae as jax_build_vae
from scldm_tpu.ops.fused_dit import WEIGHT_NAMES
from scldm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from scldm_tpu.parallel.mesh import shard_batch as jax_shard_batch
from scldm_tpu.parallel.pipeline import pipeline_blocks as jax_pipeline_blocks
from scldm_tpu.parallel.pipeline import stack_block_params as jax_stack_block_params
from scldm_tpu.parallel.sharding_rules import shard_params
from scldm_tpu.training.ema import ema_init as jax_ema_init
from scldm_tpu.training.ldm_task import LDMTask as JaxLDMTask
from scldm_tpu.training.vae_task import VAETask as JaxVAETask
from scldm_tpu.transport import create_transport as jax_create_transport
from scldm_tpu.utils.torch_import import export_torch_state_dict
from scldm_torch.nn.vae import build_transformer_vae
from scldm_torch.parallel.sharding_rules import fit_spec, param_pspec
from scldm_torch.training.checkpoint import load_into, snapshot
from scldm_torch.training.vae_task import VAETask
from scldm_torch.utils.weights import load_reference_state_dict
from tests.test_training import make_batch
from tests.torch_port.test_torch_port_ldm_train import DIT_ARCH, LR, TASK, jax_draws
from tests.torch_port.test_torch_port_parallel import (
    G,
    G_ODD,
    REL,
    SMALL,
    VAE_KEYS,
    VAE_TASK,
    WIDE,
    hold_steps,
    launch,
    lean,
    np_tree,
    one_program,
    redrawn,
    same_on_every_rank,
    vae_weights,
)

ALGEBRAIC = dict(n_embed=144, n_embed_latent=16, n_layer=1, n_inducing_points=4, n_head=2,
                 n_head_cross=2)
ODD_HEADS = dict(n_embed=24, n_embed_latent=8, n_layer=1, n_inducing_points=4, n_head=3,
                 n_head_cross=3)
PIPE = dict(B=16, T=4, E=32, L=8, H=2)
LDM_KEYS = ("train_loss", "grad_norm", "lr_mult", "grad_norm/diffusion/blocks/0",
            "grad_norm/diffusion/t_embedder")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def per_device(params) -> dict:
    """{reference name: the elements of one device's shard} of a sharded tree."""
    tree = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, math.prod(x.sharding.shard_shape(x.shape)), np.float32),
        params)
    return {k: int(v.flat[0]) for k, v in export_torch_state_dict(tree).items() if v.size}


# -- JAX's side ------------------------------------------------------------------------------

def vae_case(arch, n_genes, batches, mesh_shape, port=None, **task_kw):
    """The port's case (JAX's initial weights; `port` the port's own task
    options) and JAX's VAETask on the same mesh: its metrics and parameters
    after each step and each leaf's per-device elements."""
    case = {"fn": "vae_steps", "arch": dict(n_genes=n_genes, **arch), "mesh": mesh_shape,
            "weights": vae_weights(arch, n_genes), "batches": [np_tree(b) for b in batches],
            "task": dict(VAE_TASK, **task_kw, **(port or {}))}

    def reference():
        mesh = jax_make_mesh(*mesh_shape)
        task = JaxVAETask(jax_build_vae(n_genes=n_genes, **arch), mesh=mesh, **VAE_TASK,
                          **task_kw)
        state = task.init_state(jax.random.PRNGKey(1), batches[0])
        numels = per_device(state.params)
        step, s = one_program(task._train_step_impl, mesh, state)
        want = []
        for b in batches:
            s, m = step(s, jax_shard_batch(b, mesh))
            want.append({"metrics": {k: float(v) for k, v in m.items()},
                         "params": export_torch_state_dict(s.params)})
        return {"steps": want, "numels": numels}

    return case, reference


def ldm_setup(n_genes):
    batch = make_batch(jax.random.PRNGKey(0), n_genes=n_genes)
    jvae = jax_build_vae(n_genes=n_genes, **SMALL)
    vae_params = jax.jit(jvae.init)(jax.random.PRNGKey(0), batch["counts"], batch["genes"],
                                    batch["library_size"], batch["counts_subset"],
                                    batch["genes_subset"])
    return batch, jvae, vae_params, JaxDiT(**DIT_ARCH)


def ldm_case(**layout):
    """Two LDM steps on a (1, 2) mesh (Megatron, or the pipeline with
    `pipeline_microbatches`): the port's case (redrawn DiT weights, JAX's
    draws of each step) and JAX's task on the same mesh."""
    batch, jvae, vae_params, jdit = ldm_setup(G)
    batches = [batch, make_batch(jax.random.PRNGKey(5), n_genes=G)]
    kw = dict(learning_rate=LR, **TASK)
    one = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), **kw)
    state = one.init_state(jax.random.PRNGKey(3), batch)
    params = redrawn(state.params, 1)
    state = state.replace(params=params, ema=jax_ema_init(params["params"]))
    second = state.replace(rng=jax.random.split(state.rng, 4)[0])
    case = {"fn": "ldm_steps", "vae_arch": dict(n_genes=G, **SMALL), "dit_arch": DIT_ARCH,
            "vae_weights": export_torch_state_dict(vae_params),
            "dit_weights": export_torch_state_dict(params),
            "ema": export_torch_state_dict(state.ema.params), "mesh": (1, 2),
            "task": dict(kw, **layout), "batches": [np_tree(b) for b in batches],
            "noise": [jax_draws(one, state, batches[0]), jax_draws(one, second, batches[1])]}

    def reference():
        mesh = jax_make_mesh(1, 2)
        task = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), mesh=mesh, **kw,
                          **layout)
        s = task.init_state(jax.random.PRNGKey(3), batch)
        sharded = shard_params(params, mesh, megatron=not layout)
        s = s.replace(params=sharded, opt_state=task.tx.init(sharded),
                      ema=jax_ema_init(sharded["params"]))
        step = jax.jit(task._train_step_impl)
        want = []
        for b in batches:
            s, m = step(s, jax_shard_batch(b, mesh), task.vae_params)
            want.append({"metrics": {k: float(v) for k, v in m.items()},
                         "params": export_torch_state_dict(s.params),
                         "ema": export_torch_state_dict(s.ema.params)})
        return {"steps": want, "numels": per_device(sharded)}

    return case, reference


def generation_case(**layout):
    """Generation (euler-3 under CFG) from a (1, 2) mesh's task: the port's
    case with JAX's draws, and JAX's latents and their decode's NB mean."""
    batch, jvae, vae_params, jdit = ldm_setup(G_ODD)
    mesh = jax_make_mesh(1, 2)
    task = JaxLDMTask(jvae, vae_params, jdit, jax_create_transport(), mesh=mesh, **TASK,
                      **layout)
    params = redrawn(task.init_state(jax.random.PRNGKey(3), batch).params, 2)
    from scldm_tpu.sampling.size_factors import SizeFactorSampler as JaxSFS

    sfs = JaxSFS.__new__(JaxSFS)
    sfs.strategy, sfs.tables, sfs.joint_table, sfs.joint_components = (
        "mutually_exclusive", {}, None, None)
    guidance = {"clusters": 1.0}
    key = jax.random.PRNGKey(7)
    cond = {"clusters": batch["clusters"]}
    k_sf, k_z, _ = jax.random.split(key, 3)
    B = batch["clusters"].shape[0]
    log_sf = sfs.sample(k_sf, cond, B)
    z0 = jax.random.normal(k_z, (B, DIT_ARCH["seq_len"], DIT_ARCH["n_embed_input"]), jnp.float32)
    case = {"fn": "layout_generate", "vae_arch": dict(n_genes=G_ODD, **SMALL),
            "dit_arch": DIT_ARCH, "vae_weights": export_torch_state_dict(vae_params),
            "dit_weights": export_torch_state_dict(params), "task": dict(TASK, **layout),
            "z0": torch.from_numpy(np.array(z0)), "log_sf": torch.from_numpy(np.array(log_sf)),
            "genes": torch.arange(1, G_ODD + 1), "guidance": guidance,
            "condition": {"clusters": torch.from_numpy(np.array(batch["clusters"]))},
            "steps": 3, "mesh": (1, 2)}

    def reference():
        fn = task.make_sample_fn(sfs, guidance_weight=guidance, sampling_method="euler",
                                 num_steps=3, use_ema=False)
        genes = jnp.arange(1, G_ODD + 1)
        _, z = fn(params, key, genes, cond)
        sf = jnp.exp(log_sf).reshape(-1, 1)
        out = jax.jit(lambda p, zz, g, l: jvae.apply(p, zz, g, l, method="decode"))(
            vae_params, z, genes, jnp.concatenate([sf, sf]))
        return {"z": np.asarray(z), "mu": np.asarray(out["mu"]), "theta": np.asarray(out["theta"])}

    return case, reference


def pipeline_case(mesh_shape, n_micro):
    """`pipeline_blocks` on random stacked blocks: the port's case and JAX's
    output and gradients of sum(out * cot) on the same mesh."""
    B, T, E, L, H = (PIPE[k] for k in ("B", "T", "E", "L", "H"))
    rng = np.random.default_rng(n_micro)
    dit = JaxDiT(n_embed=E, n_embed_input=8, n_layer=L, n_head=H, seq_len=T,
                 class_vocab_sizes={"clusters": 3}, cfg_dropout_prob=0.8)
    params = dit.init({"params": jax.random.PRNGKey(3), "condition": jax.random.PRNGKey(4)},
                      jnp.zeros((B, T, 8)), jnp.zeros((B,)),
                      {"clusters": jnp.zeros((B,), jnp.int32)}, train=True)
    stacked = {k: jnp.asarray(rng.normal(size=v.shape) * 0.1, jnp.float32)
               for k, v in jax_stack_block_params(params, L).items()}
    h, c, cot = (jnp.asarray(rng.normal(size=s), jnp.float32)
                 for s in ((B, T, E), (B, E), (B, T, E)))
    case = {"fn": "pipeline", "mesh": mesh_shape, "n_micro": n_micro, "n_head": H,
            **{k: torch.from_numpy(np.array(v)) for k, v in (("h", h), ("c", c), ("cot", cot))},
            "stacked": {k: torch.from_numpy(np.array(v)) for k, v in stacked.items()}}

    def reference():
        mesh = jax_make_mesh(*mesh_shape)

        def f(h, c, st):
            return jax_pipeline_blocks(h, c, st, mesh=mesh, n_micro=n_micro, n_head=H, eps=1e-8)

        out = f(h, c, stacked)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * cot), argnums=(0, 1, 2)))(
            h, c, stacked)
        return {"out": np.asarray(out), "h": np.asarray(grads[0]), "c": np.asarray(grads[1]),
                **{k: np.asarray(v) for k, v in grads[2].items()}}

    return case, reference


# -- the launches ---------------------------------------------------------------------------

def finish(procs, tmp: Path, world: int, timeout: float = 400):
    """Wait for the ranks; one that outlives `timeout` is killed, failing the
    test rather than stalling the suite."""
    for r, (p, log) in enumerate(procs):
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise
        finally:
            log.close()
        assert p.returncode == 0, (tmp / f"rank{world}_{r}.log").read_text()[-4000:]


def resume_payload(tmp: Path, batch, arch):
    """A one-process VAE step on JAX's initial weights, saved as a checkpoint
    payload; returns its path."""
    vae = build_transformer_vae(n_genes=G, **arch, device="cpu")
    load_reference_state_dict(vae, vae_weights(arch, G))
    task = VAETask(vae, **VAE_TASK)
    state = task.init_state(torch.Generator().manual_seed(0))
    task.train_step(state, batch)
    path = tmp / f"world1_{arch['n_embed']}.pt"
    torch.save(snapshot(state), path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of this module, JAX's references computed while the ranks
    run. Returns (results by case and rank, JAX's references by case, the
    checkpoint paths and batches)."""
    tmp = tmp_path_factory.mktemp("model_axis")
    with jax.default_matmul_precision("highest"):
        dense = [make_batch(jax.random.PRNGKey(i), n_genes=G) for i in range(3)]
        two, four, later = {}, {}, {}
        two["mt_vae"], later["mt_vae"] = vae_case(SMALL, G, dense[:2], (1, 2))
        two["mt_vae_algebraic"], later["mt_vae_algebraic"] = vae_case(
            ALGEBRAIC, G, [lean(i, G) for i in range(2)], (1, 2), algebraic_tail=True,
            port={"algebraic_fused_gate": True})
        two["mt_vae_caution"], later["mt_vae_caution"] = vae_case(SMALL, G, dense[:2], (1, 2),
                                                                  caution=True)
        two["mt_vae_odd_heads"], later["mt_vae_odd_heads"] = vae_case(ODD_HEADS, G, dense[:2],
                                                                      (1, 2))
        four["mt_vae_2x2"], later["mt_vae_2x2"] = vae_case(SMALL, G, dense[:2], (2, 2))
        four["mt_vae_fsdp"], later["mt_vae_fsdp"] = vae_case(WIDE, G, dense[:2], (2, 2),
                                                             fsdp=True, caution=True)
        two["mt_ldm"], later["mt_ldm"] = ldm_case()
        two["pp_ldm"], later["pp_ldm"] = ldm_case(pipeline_microbatches=2)
        two["mt_generate"], later["mt_generate"] = generation_case()
        two["pp_generate"], later["pp_generate"] = generation_case(pipeline_microbatches=2)
        two["pp_1x2x2"], later["pp_1x2x2"] = pipeline_case((1, 2), 2)
        four["pp_1x4x8"], later["pp_1x4x8"] = pipeline_case((1, 4), 8)
        four["pp_2x2x2"], later["pp_2x2x2"] = pipeline_case((2, 2), 2)
        batches = [np_tree(b) for b in dense]
        paths = {}
        for name, arch, mesh, task in (("resume", SMALL, (1, 2), VAE_TASK),
                                       ("resume_fsdp", WIDE, (2, 2), dict(VAE_TASK, fsdp=True))):
            paths[name] = (resume_payload(tmp, batches[0], arch), tmp / f"{name}.pt", arch)
            (two if mesh == (1, 2) else four)[name] = {
                "fn": "vae_resume", "mesh": mesh, "arch": dict(n_genes=G, **arch), "task": task,
                "batch": batches[1], "load": str(paths[name][0]), "save": str(paths[name][1])}
        procs2, out2 = launch(two, 2, tmp)
        procs4, out4 = launch(four, 4, tmp)
        try:
            refs = {k: fn() for k, fn in later.items()}
        finally:
            finish(procs2, tmp, 2)
            finish(procs4, tmp, 4)
    results = {}
    for cases, world, out in ((two, 2, out2), (four, 4, out4)):
        for name in cases:
            results[name] = [torch.load(out / f"{name}_{r}.pt", weights_only=False)
                             for r in range(world)]
            for r, res in enumerate(results[name]):
                assert "error" not in res, f"{name} rank {r}:\n{res['error']}"
    return results, refs, {"paths": paths, "batches": batches}


# -- the checks -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mt_vae", "mt_vae_algebraic", "mt_vae_caution",
                                  "mt_vae_odd_heads", "mt_vae_2x2", "mt_vae_fsdp"])
def test_megatron_vae_matches_jax(runs, name):
    """Two Megatron VAE steps against JAX's on the same mesh, every rank in
    lockstep; the whole-module kernels closed, the fused gate open."""
    results, refs, _ = runs
    ranks = results[name]
    hold_steps(ranks[0]["steps"], refs[name]["steps"], VAE_TASK["learning_rate"], VAE_KEYS)
    same_on_every_rank(ranks)
    gates = ranks[0]["gates"]
    assert gates["megatron"] and gates["fused_decoder"] is False and not gates["gene_sp"]
    assert gates["algebraic_fused_gate"] == (name == "mt_vae_algebraic")


@pytest.mark.parametrize("name", ["mt_vae", "mt_vae_algebraic", "mt_vae_odd_heads",
                                  "mt_vae_2x2", "mt_vae_fsdp", "mt_ldm"])
def test_each_rank_holds_jax_per_device_share(runs, name):
    """Each rank's elements of every leaf and of its AdamW moments are JAX's
    per-device shard of that leaf (the Megatron slice, under FSDP its
    slice over "data" too); some leaf is sharded over "model"."""
    results, refs, _ = runs
    want = refs[name]["numels"]
    for res in results[name]:
        got = res["numels"]
        assert set(got) == set(want)
        for leaf, (n, moments) in got.items():
            assert n == want[leaf], leaf
            assert moments is None or moments and all(m == n for m in moments.values()), leaf
    whole = {k: math.prod(v.shape) for k, v in refs[name]["steps"][0]["params"].items()}
    assert any(want[k] < whole[k] for k in want)


@pytest.mark.parametrize("name", ["mt_ldm", "pp_ldm"])
def test_ldm_layout_matches_jax(runs, name):
    """Two LDM steps (JAX's t, x0 and CFG drop mask injected) under Megatron
    and under the pipeline, with the EMA after each; the grouped gradient
    norms count every slice once."""
    results, refs, _ = runs
    ranks = results[name]
    want = [dict(w, metrics=dict(w["metrics"], **{
        "grad_norm/diffusion/blocks/0": w["metrics"]["grad_norm/diffusion/block_0"],
        "grad_norm/diffusion/t_embedder": w["metrics"]["grad_norm/diffusion/t_embedder"]}))
        for w in refs[name]["steps"]]
    hold_steps(ranks[0]["steps"], want, LR, LDM_KEYS)
    same_on_every_rank(ranks)
    step = LR * want[-1]["metrics"]["lr_mult"]
    for n, t in ranks[0]["ema"].items():
        np.testing.assert_allclose(t.numpy(), want[-1]["ema"][n], rtol=1e-5, atol=0.1 * step,
                                   err_msg=n)
    gates = ranks[0]["gates"]
    assert gates["megatron"] == (name == "mt_ldm")
    assert gates["pipeline"] == (2 if name == "pp_ldm" else None)


@pytest.mark.parametrize("name", ["mt_generate", "pp_generate"])
def test_generation_from_a_model_axis_matches_jax(runs, name):
    """CFG samples from JAX's noise and their NB mean (every model rank
    decoding its genes under the pipeline) against JAX's; `make_sample_fn`
    from the train state against one process from one seed."""
    results, refs, _ = runs
    want = refs[name]
    for res in results[name]:
        np.testing.assert_allclose(res["samples"].numpy(), want["z"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["mu"].numpy(), want["mu"], rtol=REL, atol=REL)
        np.testing.assert_allclose(res["theta"].numpy(), want["theta"], rtol=1e-6)
        np.testing.assert_allclose(res["z"].numpy(), res["single_z"].numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(res["z_ema"], res["z"])  # the EMA's copy of the sliced DiT
        assert (res["counts"] != res["single_counts"]).float().mean() < 1e-3
        assert res["gates"]["gene_sp"] == (name == "pp_generate")


@pytest.mark.parametrize("name,n_micro", [("pp_1x2x2", 2), ("pp_1x4x8", 8), ("pp_2x2x2", 2)])
def test_pipeline_blocks_match_jax(runs, name, n_micro):
    """`pipeline_blocks`' output and its gradients in x, c and the stacked
    weights against JAX's on the same (n_data, n_model) mesh; JAX's guards."""
    results, refs, _ = runs
    want = refs[name]
    ranks = results[name]
    n_model = 4 if name == "pp_1x4x8" else 2
    b = PIPE["B"] // (len(ranks) // n_model)
    for r, res in enumerate(ranks):
        rows = slice((r // n_model) * b, (r // n_model + 1) * b)
        np.testing.assert_allclose(res["out"].numpy(), want["out"][rows], rtol=2e-4, atol=2e-5)
        for k in ("h", "c"):
            np.testing.assert_allclose(res["grads"][k].numpy(), want[k][rows], rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        for k in WEIGHT_NAMES:
            np.testing.assert_allclose(res["grads"][k].numpy(), want[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
        assert "microbatches" in res["guards"]["microbatches"]
        assert "stages" in res["guards"]["stages"]


@pytest.mark.parametrize("name", ["resume", "resume_fsdp"])
def test_checkpoints_resume_across_megatron_and_one_process(runs, name):
    """A one-process checkpoint resumed by Megatron ranks (two model ranks;
    and 2 x 2 under FSDP) takes the step one process takes from it; the
    ranks' checkpoint (whole tensors, the one-process format) resumed at one
    process takes the next step as the one-process run does."""
    results, _, saved = runs
    batches = saved["batches"]
    load, save, arch = saved["paths"][name]
    lr = VAE_TASK["learning_rate"]

    def resumed(path):
        vae = build_transformer_vae(n_genes=G, **arch, device="cpu")
        task = VAETask(vae, **VAE_TASK)
        state = task.init_state(torch.Generator().manual_seed(0))
        load_into(state, torch.load(path, weights_only=True))
        return task, state

    def step(task, state, batch):
        _, m = task.train_step(state, batch)
        return {"metrics": {k: float(v) for k, v in m.items()},
                "params": {k: v.detach().clone() for k, v in state.module.named_parameters()},
                "grads": {k: v.grad.clone() for k, v in state.module.named_parameters()
                          if v.grad is not None}}

    def numpy(snap):
        return dict(snap, params={k: v.numpy() for k, v in snap["params"].items()})

    task, state = resumed(load)
    hold_steps(results[name][0]["steps"], [numpy(step(task, state, batches[1]))], lr, VAE_KEYS)
    payload = torch.load(save, weights_only=True)
    assert payload["step"] == 2
    assert all(payload["module"][k].shape == v.shape for k, v in state.module.state_dict().items())
    task2, state2 = resumed(save)
    hold_steps([step(task2, state2, batches[2])], [numpy(step(task, state, batches[2]))], lr,
               VAE_KEYS)


# -- one process ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,want", [
    ("encoder.encoder_layers.0.attn.c_attn.weight", 0),
    ("encoder.encoder_layers.0.attn.c_attn.bias", 0),
    ("decoder.decoder_cross_attention.attn.c_attn_q.weight", 0),
    ("encoder.encoder_layers.0.attn.c_proj.weight", 1),
    ("encoder.encoder_layers.0.attn.c_proj.bias", None),
    ("encoder.encoder_layers.0.mlp.w1.weight", 0),
    ("encoder.encoder_layers.0.mlp.c_proj.weight", 1),
    ("blocks.3.adaln_modulation.1.weight", 0),
    ("blocks.3.adaln_modulation.1.bias", 0),
    ("final_layer.adaln_modulation.1.weight", 0),
    ("input_layer.gene_embedding.weight", 1),
    ("class_embeddings.clusters.weight", 1),
    ("decoder_head.theta.weight", None),
    ("decoder_head.params.weight", None),
    ("encoder.ca_layer.ln_1.weight", None),
    ("t_embedder.mlp.0.weight", None),
])
def test_param_pspec_is_jax_rule(name, want):
    """JAX's `param_pspec` over the port's names and (out, in) layout."""
    assert param_pspec(name) == want


@pytest.mark.parametrize("name,shape,n_data,fsdp,want", [
    ("blocks.0.attn.c_attn.weight", (96, 32), 1, False, (0, False)),
    ("blocks.0.attn.c_attn.weight", (75, 25), 1, False, (None, False)),  # 75 is odd
    ("blocks.0.attn.c_attn.weight", (96, 32), 2, False, (0, False)),  # no FSDP asked
    ("blocks.0.attn.c_proj.weight", (64, 64), 2, True, (1, True)),
    ("blocks.0.attn.c_proj.weight", (5, 400), 2, True, (1, False)),  # only "model"'s dim divides
    ("encoder.ca_layer.inducing_points", (4, 16), 2, True, (None, False)),  # under 1,024
])
def test_fit_spec_is_jax_rule(name, shape, n_data, fsdp, want):
    """JAX's `_fit_spec` at a "model" axis of 2: (the dimension on "model",
    whether the leaf goes over "data")."""
    assert fit_spec(name, shape, 2, n_data, fsdp) == want
