"""The ranks' side of test_torch_port_parallel.py and
test_torch_port_model_axis.py. Each of N processes runs

    python -m tests.torch_port.parallel_worker CASES OUT

under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), joins the gloo group it names (with a timeout, so that a hang
fails; `scldm_torch.parallel.maybe_initialize_distributed` then finds the
group up), runs every case of the
`torch.save`d dict CASES in order (each case names its function and its
mesh) and writes `OUT/<case>_<rank>.pt`: the case's metrics, parameters and
what else it reports, or the error it raised. It imports torch and the port
only, never jax."""

from __future__ import annotations

import datetime
import math
import os
import signal
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from scldm_torch.nn.nnets import DiT
from scldm_torch.nn.vae import build_scvi_vae, build_transformer_vae
from scldm_torch.parallel import (
    make_mesh,
    maybe_initialize_distributed,
    rank,
    shard_batch,
    shard_stacked_batch,
    world_size,
)
from scldm_torch.parallel.data_parallel import full_weights
from scldm_torch.parallel.pipeline import Hops, pipeline_blocks
from scldm_torch.parallel.tensor_parallel import megatron_of
from scldm_torch.training.checkpoint import load_into
from scldm_torch.training.checkpoint import snapshot as checkpoint_snapshot
from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
from scldm_torch.training.ldm_task import LDMTask
from scldm_torch.training.scvi_task import ScviTask
from scldm_torch.training.vae_task import VAETask
from scldm_torch.transport import create_transport
from scldm_torch.utils.weights import load_reference_ema_, load_reference_state_dict


def rows(tree, mesh):
    """This rank's rows of a global batch or noise dict (nested dicts and
    lists of tensors; a 0-d or row-free entry as it is)."""
    if isinstance(tree, dict):
        return {k: rows(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rows(v, mesh) for v in tree]
    return shard_batch({"x": tree}, mesh)["x"]


def full_grads(state):
    """Every trained parameter's gradient at its full shape (FSDP slices'
    gathered, then Megatron slices')."""
    shards, mt = state.shards, megatron_of(state.module)
    shapes = {} if shards is None else {name: shape for name, _, _, shape in shards.entries}
    out = {}
    for name, p in state.module.named_parameters():
        q = p if shards is None else shards.shard_of(p)
        if q.grad is None:
            continue
        g = q.grad
        if q is not p:
            full = g.new_empty(shards.n * g.numel())
            dist.all_gather_into_tensor(full, g.reshape(-1), group=shards.group)
            g = full.view(shapes[name])
        if mt is not None and id(p) in mt.by_id:
            g = mt.whole(mt.by_id[id(p)], g)
        out[name] = g.detach().clone()
    return out


def snapshot(task, state, mets):
    """A step's metrics, and the parameters (whole: FSDP and Megatron slices
    gathered) and (clipped) gradients after it."""
    with full_weights(task.layout, state):
        params = {n: p.detach().clone() for n, p in state.module.named_parameters()}
    mt = megatron_of(state.module)
    return {"metrics": {k: float(v) for k, v in mets.items()},
            "params": params if mt is None else mt.whole_state_dict(params),
            "grads": full_grads(state)}


def shard_numels(state):
    """{parameter name: (its elements on this rank, its AdamW moments'
    elements, None where it is not trained)}: the Megatron slice, or the
    FSDP slice of it."""
    shards = state.shards
    out = {}
    for name, p in state.module.named_parameters():
        q = p if shards is None else shards.shard_of(p)
        moments = {k: v.numel() for k, v in state.optimizer.state[q].items()
                   if torch.is_tensor(v) and v.ndim} if p.requires_grad else None
        out[name] = (q.numel(), moments)
    return out


def report(task, state, steps, **extra):
    with full_weights(task.layout, state):
        buffers = {n: b.detach().clone() for n, b in state.module.named_buffers()}
    out = {"steps": steps, "buffers": buffers, "numels": shard_numels(state), **extra}
    if state.ema is not None:
        mt = megatron_of(state.module)
        ema = {n: t.clone() for n, t in state.ema.params.items()}
        out["ema"] = ema if mt is None else mt.whole_named(state.module, ema)
    if state.shards is not None:
        ids = {id(s): name for name, _, s, _ in state.shards.entries}
        opt = state.optimizer
        out["sharded"] = {ids[id(p)]: {k: v.numel() for k, v in opt.state[p].items()
                                       if torch.is_tensor(v) and v.ndim}
                          for g in opt.param_groups for p in g["params"] if id(p) in ids}
        out["full_numel"] = {name: math.prod(shape) for name, _, _, shape in state.shards.entries}
    return out


def vae_steps(case, mesh):
    vae = build_transformer_vae(**case["arch"], device="cpu")
    load_reference_state_dict(vae, case["weights"])
    task = VAETask(vae, mesh=mesh, **case["task"])
    state = task.init_state(torch.Generator().manual_seed(0))
    steps = []
    for batch in case["batches"]:
        state, m = task.train_step(state, rows(batch, mesh))
        steps.append(snapshot(task, state, m))
    return report(task, state, steps, gates=dict(
        fused_decoder=task.fused_decoder, gene_sp=task.gene_sp, megatron=task.megatron,
        algebraic_fused_gate=task.algebraic_fused_gate))


def ldm_task(case, mesh, **kw):
    vae = build_transformer_vae(**case["vae_arch"], device="cpu")
    load_reference_state_dict(vae, case["vae_weights"])
    dit = DiT(**case["dit_arch"])
    if case["dit_weights"] is not None:
        load_reference_state_dict(dit, case["dit_weights"])
    return LDMTask(vae.requires_grad_(False), dit, create_transport(), mesh=mesh,
                   **case["task"], **kw)


def ldm_steps(case, mesh):
    task = ldm_task(case, mesh)
    state = task.init_state(torch.Generator().manual_seed(0))
    load_reference_ema_(state.ema, case["ema"], task.state_dit(state))
    steps = []
    for batch, noise in zip(case["batches"], case["noise"]):
        state, m = task.train_step(state, rows(batch, mesh), rows(noise, mesh))
        steps.append(snapshot(task, state, m))
    return report(task, state, steps, gates=dict(
        fused_training=task.fused_training, megatron=task.megatron, pipeline=task.pipeline))


def scvi_steps(case, mesh):
    vae = build_scvi_vae(**case["arch"], device="cpu")
    load_reference_state_dict(vae, case["weights"])
    task = ScviTask(vae, mesh=mesh, **case["task"])
    state = task.init_state(torch.Generator().manual_seed(0))
    steps = []
    for batch, noise in zip(case["batches"], case["noise"]):
        state, m = task.train_step(state, rows(batch, mesh), rows(noise, mesh))
        steps.append(snapshot(task, state, m))
    return report(task, state, steps)


def generate(case, mesh):
    """Gene-SP generation from injected noise (`generate_from_noise`), and
    `make_sample_fn(split_over_data=True)` against the same task's function
    without a mesh, from one seed."""
    task = ldm_task(case, mesh)
    out = {}
    if "z0" in case:
        samples, dec, _ = task.generate_from_noise(
            case["z0"], case["log_sf"], case["genes"], case["condition"],
            guidance_weight=case["guidance"], sampling_method="euler", num_steps=case["steps"])
        out.update(samples=samples, mu=dec["mu"], theta=dec["theta"])
    sfs = SizeFactorSampler(constant_stats(task.dit.class_vocab_sizes, mu=3.0, sd=0.2))
    kw = dict(guidance_weight=case["guidance"], sampling_method="dopri5")
    cond = {k: v for k, v in case["condition"].items()}
    split = task.make_sample_fn(sfs, split_over_data=True, **kw)
    counts, z = split(torch.Generator().manual_seed(7), case["genes"], cond)
    single = ldm_task(case, None)
    ref = single.make_sample_fn(sfs, **kw)
    counts1, z1 = ref(torch.Generator().manual_seed(7), case["genes"], cond)
    out.update(split_counts=counts, split_z=z, single_counts=counts1, single_z=z1,
               evals=(split.drift_evals, ref.drift_evals))
    return out


def layout_generate(case, mesh):
    """Generation from a train state on a "model" axis (Megatron, or the
    pipeline with `pipeline_microbatches`): from injected noise against
    JAX's, and `make_sample_fn(state=...)` against the same task's function
    in one process, from one seed."""
    task = ldm_task(case, mesh)
    state = task.init_state(torch.Generator().manual_seed(0))
    samples, dec, _ = task.generate_from_noise(
        case["z0"], case["log_sf"], case["genes"], case["condition"],
        guidance_weight=case["guidance"], sampling_method="euler", num_steps=case["steps"])
    sfs = SizeFactorSampler(constant_stats(task.dit.class_vocab_sizes, mu=3.0, sd=0.2))
    kw = dict(guidance_weight=case["guidance"], sampling_method="euler", num_steps=4,
              use_ema=False)
    cond = dict(case["condition"])
    counts, z = task.make_sample_fn(sfs, **kw)(torch.Generator().manual_seed(7), case["genes"],
                                               cond, state=state)
    # the EMA's copy of the DiT (no step taken: the EMA holds the same weights)
    _, z_ema = task.make_sample_fn(sfs, **dict(kw, use_ema=True))(
        torch.Generator().manual_seed(7), case["genes"], cond, state=state)
    single = ldm_task(case, None)
    counts1, z1 = single.make_sample_fn(sfs, **kw)(torch.Generator().manual_seed(7),
                                                   case["genes"], cond)
    return dict(samples=samples, mu=dec["mu"], theta=dec["theta"], counts=counts, z=z,
                z_ema=z_ema, single_counts=counts1, single_z=z1,
                gates=dict(megatron=task.megatron, pipeline=task.pipeline,
                           gene_sp=task._sp is not None))


def pipeline_case(case, mesh):
    """`pipeline_blocks` over this data rank's rows: the output, and the
    gradients of sum(out * cot) (the backward seeded on the last stage, the
    gradients summed over "model" and the weights' over "data" too)."""
    hops = Hops(mesh)
    model, data = mesh.get_group("model"), mesh.get_group("data")
    h, c, cot = (rows(case[k], mesh).clone().requires_grad_(k != "cot")
                 for k in ("h", "c", "cot"))
    stacked = {k: v.clone().requires_grad_() for k, v in case["stacked"].items()}
    out = pipeline_blocks(h, c, stacked, hops=hops, group=model, n_micro=case["n_micro"],
                          n_head=case["n_head"], eps=1e-8)
    loss = (out * cot).sum()
    loss.backward(torch.full_like(loss, float(hops.stage == hops.stages - 1)))
    grads = {"h": h.grad, "c": c.grad, **{k: v.grad for k, v in stacked.items()}}
    for k, g in grads.items():
        dist.all_reduce(g, group=model)
        if k not in ("h", "c"):
            dist.all_reduce(g, group=data)
    guards = {}
    for name, (hh, cc, st) in {"microbatches": (h[:3], c[:3], stacked),
                               "stages": (h, c, {k: v[:3] for k, v in stacked.items()})}.items():
        try:
            pipeline_blocks(hh, cc, st, hops=hops, group=model, n_micro=case["n_micro"],
                            n_head=case["n_head"], eps=1e-8)
            guards[name] = None
        except ValueError as e:
            guards[name] = str(e)
    return {"out": out.detach(), "grads": grads, "guards": guards}


def vae_resume(case, mesh):
    """A Megatron VAE state loaded from a one-process checkpoint payload,
    one step, then its own payload (rank 0 writes it to `case["save"]`) and
    the step's snapshot."""
    vae = build_transformer_vae(**case["arch"], device="cpu")
    task = VAETask(vae, mesh=mesh, **case["task"])
    state = task.init_state(torch.Generator().manual_seed(0))
    load_into(state, torch.load(case["load"], weights_only=True))
    state, m = task.train_step(state, rows(case["batch"], mesh))
    payload = checkpoint_snapshot(state, {})
    if payload is not None:
        torch.save(payload, case["save"])
    return {"steps": [snapshot(task, state, m)]}


def refusals(case, mesh):
    """What builds and what raises on a mesh with a "model" axis of 2."""
    out = {}
    ldm = case["ldm"]
    attempts = {
        "vae_without_gene_sp": lambda: VAETask(
            build_transformer_vae(**case["arch"], device="cpu"), mesh=mesh),
        "vae_unshared_gene_sp": lambda: VAETask(
            build_transformer_vae(**case["arch"], shared_embedding=False, device="cpu"),
            mesh=mesh, gene_sp=True),
        "ldm_without_gene_sp": lambda: ldm_task(ldm, mesh),
        "ldm_pipeline": lambda: ldm_task(ldm, mesh, pipeline_microbatches=2),
        "ldm_pipeline_gene_sp": lambda: ldm_task(ldm, mesh, gene_sp=True,
                                                 pipeline_microbatches=2),
        "ldm_pipeline_dropout": lambda: ldm_task(
            dict(ldm, dit_arch=dict(ldm["dit_arch"], dropout=0.1)), mesh,
            pipeline_microbatches=2),
        "ldm_pipeline_stages": lambda: ldm_task(
            dict(ldm, dit_arch=dict(ldm["dit_arch"], n_layer=3), dit_weights=None), mesh,
            pipeline_microbatches=2),
    }
    for name, fn in attempts.items():
        try:
            fn()
            out[name] = None
        except Exception as e:  # noqa: BLE001 (the type is the result)
            out[name] = (type(e).__name__, str(e))
    out["world"], out["rank"] = world_size(), rank()
    out["again"] = maybe_initialize_distributed("cpu")
    # a rank's rows of a global batch, and of a stacked (steps, batch) one
    data = make_mesh(n_data=2)
    x = torch.arange(24).reshape(2, 4, 3)
    out["rows"] = shard_batch({"x": x[0]}, data)["x"].tolist()
    out["stacked_rows"] = shard_stacked_batch({"x": x}, data)["x"].tolist()
    return out


def cli(case, mesh):
    """The CLIs at this world: `train` from a world-1 run's checkpoint (across
    an epoch's validation), `train_ldm` on it, `inference` generation with
    `n_model=2` (gene-SP) and `n_model=1` (the data ranks split the batch),
    `train_scvi`, then a fresh `train` whose rank 1 takes SIGTERM after its
    second step."""
    from scldm_torch.cli import _common, inference, train, train_ldm, train_scvi

    ends = []
    real_fit = _common.fit

    def recording_fit(*args, **kwargs):
        state = real_fit(*args, **kwargs)
        ends.append(int(state.step))
        return state

    _common.fit = recording_fit
    try:
        rc_resume = train.main(case["args"] + case["resume"])
        rcs = [train_ldm.main(case["ldm"])]
        rcs += [inference.main(case["gen"] + [f"n_model={n}", f"paths.inference_path={d}"])
                for n, d in case["gen_dirs"].items()]
        rcs.append(train_scvi.main(case["scvi"]))
        real_step = VAETask.train_step

        def preempting(self, state, batch):
            out = real_step(self, state, batch)
            if rank() == 1 and state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        VAETask.train_step = preempting
        try:
            rc_cut = train.main(case["args"] + case["cut"])
        finally:
            VAETask.train_step = real_step
    finally:
        _common.fit = real_fit
    return {"rc": (rc_resume, rc_cut), "ends": ends, "ldm_gen_rcs": rcs}


CASES = {"vae_steps": vae_steps, "ldm_steps": ldm_steps, "scvi_steps": scvi_steps,
         "generate": generate, "refusals": refusals, "cli": cli,
         "layout_generate": layout_generate, "pipeline": pipeline_case, "vae_resume": vae_resume}


def main(cases_path: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    # torchrun's environment names the group; the timeout makes a hang fail the
    # case rather than stall the suite
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(seconds=240))
    cases = torch.load(cases_path, weights_only=False)
    out = Path(out_dir)
    for name, case in cases.items():
        mesh = make_mesh(*case["mesh"])
        try:
            result = CASES[case["fn"]](case, mesh)
        except Exception:  # noqa: BLE001 (reported to the test)
            result = {"error": traceback.format_exc()}
        torch.save(result, out / f"{name}_{rank()}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
