#!/usr/bin/env python3
"""Where the time of one census-width VAE training step goes, on one NVIDIA GPU.

    python3 benchmarks_torch/profile_census.py [--fused-pool] [--dtype bfloat16] [--remat]
                                               [--reduction]

The census VAE of `chip_smoke.py` (configs/model/vae_census.yaml: E=512, 16
layers, 64 inducing points, G=36,601 genes; f32 and no remat unless asked:
`--dtype bfloat16 --remat` is the config as shipped) with random
weights from seed 0, on B=16 lean batches over a 4,096-token window made like
benchmarks/bench_census.py's, through the algebraic tail, twice: with the
`swiglu_vec` kernels (`VAETask(algebraic_fused_gate=True)`) and with the
plain algebraic path. With --fused-pool, on the module path instead
(`algebraic_tail=False`, as bench_census.py pairs its --fused-pool with
--no-algebraic-tail), twice: with the MCAB pooling as the wide window-pool
kernels (`fused_pool=True`) and as the module MCAB; the two arms are first
timed in turns (module, pool, pool, module; TURN_STEPS steps a turn, after a
warm-up step each). For each arm: a warm-up step, five unprofiled
`VAETask.train_step` calls (their median, and the peak device memory over
them), three steps' forward, backward and clip-plus-optimizer segments
(each ending in a synchronize; the last is `VAETask.apply_gradients`), then
PROFILED_STEPS more steps traced with `torch.profiler`: the device's busy
time (the union of its kernels' spans) and kernels per step, the idle share
of the unprofiled median, the time and share of busy time of the swiglu_vec
kernels (or the window pool's), and the profiler's table of the operators
that took the most device time. With --remat the algebraic tail's fused gate
is first timed in turns with remat and without it on the same weights (the
cost of recomputing the blocks). With --reduction (and bfloat16) the fused
gate's step is first timed in turns with cuBLAS's reduction of bf16 split-K
partials in bf16 off (as the CLIs and chip_smoke.py pin it) and on (PyTorch's
default), off, on, on, off, and one step's loss and gradients under each are
compared.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
PROFILED_STEPS = 2
UNPROFILED_STEPS = 5
TURN_STEPS = 3
# the wide window pool's kernels (kernels/csrc/window_pool_wide.cu)
POOL_KERNELS = ("prep_weights", "prep_q", "prep_cotangents", "ln_rows", "gemm_bf16", "attn_fwd",
                "attn_merge", "exact_max", "attn_dkdv", "attn_dq", "sum_dq", "ln_bwd",
                "sum_parts_kernel")


def short(kname: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    return kname.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]


def census_batches(cs, n: int) -> list:
    import numpy as np
    import torch

    G, B, S = cs.CENSUS["n_genes"], cs.CENSUS_BATCH, cs.CENSUS_WINDOW
    rng = np.random.default_rng(SEED)
    return [{k: torch.from_numpy(v).to("cuda")
             for k, v in cs.lean_batch(rng, B, G, S, (S // 2, S)).items()} for _ in range(n)]


def in_turns(cs, arms: dict) -> None:
    """The arms' steps timed in turns (first, second, second, first), each
    TURN_STEPS steps after a warm-up step, on the host clock ending in a
    synchronize; with each turn's peak device memory."""
    import torch

    batches = census_batches(cs, 2)
    states = {}
    for name, task in arms.items():
        states[name] = task.init_state(torch.Generator(device="cuda").manual_seed(SEED))
        task.train_step(states[name], batches[0])  # warm-up
    torch.cuda.synchronize()
    a, b = arms
    turns = []
    for name in (a, b, b, a):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(TURN_STEPS):
            arms[name].train_step(states[name], batches[i % 2])
        torch.cuda.synchronize()
        turns.append((name, round((time.perf_counter() - t0) / TURN_STEPS * 1e3, 2),
                      round(torch.cuda.max_memory_allocated() / 2**30, 2)))
    mean = {n: statistics.mean(ms for k, ms, _ in turns if k == n) for n in arms}
    print(f"== census in turns ({TURN_STEPS} steps a turn; name, ms/step, peak GiB): {turns}; "
          f"{b} / {a} {mean[b] / mean[a]:.4f}", flush=True)


def reduction_in_turns(cs, task) -> None:
    """The step timed in turns with allow_bf16_reduced_precision_reduction
    off and on (TURN_STEPS steps a turn after a warm-up step under each),
    then one step's loss and gradients under each on the same batch, and
    their largest gap. Leaves the flag off."""
    import torch

    matmul = torch.backends.cuda.matmul
    batches = census_batches(cs, 2)
    state = task.init_state(torch.Generator(device="cuda").manual_seed(SEED))
    turns = []
    for flag in (False, True):
        matmul.allow_bf16_reduced_precision_reduction = flag
        task.train_step(state, batches[0])  # warm-up under this setting
    for flag in (False, True, True, False):
        matmul.allow_bf16_reduced_precision_reduction = flag
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TURN_STEPS):
            task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        turns.append(("on" if flag else "off", round((time.perf_counter() - t0) / TURN_STEPS * 1e3,
                                                     2)))
    runs = {}
    for flag in (False, True):
        matmul.allow_bf16_reduced_precision_reduction = flag
        runs[flag] = cs.vae_loss_and_grads(task, batches[1])
    matmul.allow_bf16_reduced_precision_reduction = False
    (l0, g0), (l1, g1) = runs[False], runs[True]
    worst = max(((g1[k] - w).abs().max().item() / (w.abs().max().item() + 1e-30), k)
                for k, w in g0.items() if k != "decoder_head.params.bias")
    equal = sum(torch.equal(g1[k], w) for k, w in g0.items())
    print(f"== census bf16 reduction of split-K partials in turns ({TURN_STEPS} steps a turn; "
          f"name, ms/step): {turns}; one step, on vs off: loss {l1:.4f} vs {l0:.4f} "
          f"({abs(l1 - l0) / abs(l0):.2e} relative), largest gradient gap {worst[0]:.3e} of its "
          f"max ({worst[1]}), {equal} of {len(g0)} gradients bit for bit equal", flush=True)


def profile_step(cs, busy_us, task, name: str, ours_names: tuple) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    G, B, S = cs.CENSUS["n_genes"], cs.CENSUS_BATCH, cs.CENSUS_WINDOW
    state = task.init_state(torch.Generator(device="cuda").manual_seed(SEED))
    batches = census_batches(cs, 2)

    state, _ = task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(UNPROFILED_STEPS):
        t0 = time.perf_counter()
        state, _ = task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    seg = {"forward": [], "backward": [], "clip+optimizer": []}
    for i in range(3):
        state.optimizer.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss, _ = task.loss(batches[i % 2])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        task.apply_gradients(state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(seg, (t1 - t0, t2 - t1, t3 - t2)):
            seg[k].append(round(dt * 1e3, 2))
    print(f"== census {name}: segments ms (3 steps, each synchronised): {seg}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED_STEPS):
            state, _ = task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: not the device-side spans of record_function ranges
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("cuda", "Command Buffer", "Optimizer."))]
    if not kernels:
        raise RuntimeError("the trace holds no device kernel")
    spans = ((e.time_range.start, e.time_range.end) for e in kernels)
    busy_ms = busy_us(spans) / 1e3 / PROFILED_STEPS
    median = statistics.median(walls)
    print(f"== census {name} VAE train step B={B} G={G} S={S}: unprofiled walls ms "
          f"{[round(w, 2) for w in walls]} (median {median:.2f}, {B / median * 1e3:.1f} train "
          f"cells/s), peak memory {peak / 2**30:.2f} GiB, profiled wall "
          f"{wall_ms / PROFILED_STEPS:.2f} ms per step, device busy {busy_ms:.2f} ms per step over "
          f"{len(kernels) / PROFILED_STEPS:.0f} kernels, idle share of the unprofiled median "
          f"{1 - busy_ms / median:.4f}", flush=True)
    ours = [e for e in kernels if any(k in short(e.name) for k in ours_names)]
    for kname in sorted({short(e.name) for e in ours}):
        evs = [e for e in ours if short(e.name) == kname]
        ms = sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / PROFILED_STEPS
        print(f"   {kname}: {ms:.3f} ms per step over {len(evs) / PROFILED_STEPS:.0f} launches, "
              f"share of busy {ms / busy_ms:.4f}", flush=True)
    ms = sum(e.time_range.end - e.time_range.start for e in ours) / 1e3 / PROFILED_STEPS
    print(f"   all these kernels: {ms:.3f} ms per step, share of busy {ms / busy_ms:.4f}",
          flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12,
                                    max_name_column_width=60), flush=True)
    del state


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fused-pool", action="store_true",
                   help="the module path with the wide window pool against the module MCAB")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="the compute dtype (vae_census.yaml ships bfloat16)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each trunk block in the backward (vae_census.yaml's remat)")
    p.add_argument("--reduction", action="store_true",
                   help="time the bf16 step with cuBLAS's bf16 split-K reduction off and on")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_census: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmarks_torch"))
    import chip_smoke as cs
    from profile_generation import busy_us

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dtype = getattr(torch, args.dtype)
    vae = init_reference_(build_transformer_vae(**cs.CENSUS, dtype=dtype, remat=args.remat,
                                                device="cuda"),
                          torch.Generator(device="cuda").manual_seed(SEED))
    opt = dict(learning_rate=3e-4, betas=(0.9, 0.95))  # vae_census.yaml's optimizer
    print(f"== census VAE: {args.dtype}, remat {args.remat}", flush=True)
    if args.reduction and args.dtype == "bfloat16":
        reduction_in_turns(cs, VAETask(vae, **opt, algebraic_fused_gate=True))
        torch.cuda.empty_cache()
    if args.remat and not args.fused_pool:
        no_remat = build_transformer_vae(**cs.CENSUS, dtype=dtype, device="cuda")
        no_remat.load_state_dict(vae.state_dict())
        in_turns(cs, {"remat": VAETask(vae, **opt, algebraic_fused_gate=True),
                      "no remat": VAETask(no_remat, **opt, algebraic_fused_gate=True)})
        del no_remat
        torch.cuda.empty_cache()
    if args.fused_pool:
        arms = {"module MCAB": VAETask(vae, **opt, algebraic_tail=False),
                "window pool": VAETask(vae, **opt, algebraic_tail=False, fused_pool=True)}
        in_turns(cs, arms)
        torch.cuda.empty_cache()
        ours = {"module MCAB": POOL_KERNELS, "window pool": POOL_KERNELS}
    else:
        arms = {"fused gate": VAETask(vae, **opt, algebraic_fused_gate=True),
                "plain algebraic": VAETask(vae, **opt)}
        ours = {name: cs.SWIGLU_KERNELS for name in arms}
    for name, task in arms.items():
        profile_step(cs, busy_us, task, name, ours[name])
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
