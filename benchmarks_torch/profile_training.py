#!/usr/bin/env python3
"""Where the time of one VAE training step goes, on one NVIDIA GPU.

    python3 benchmarks_torch/profile_training.py [--fused-trunk]

For each of two configurations, the dentate-gyrus VAE of `chip_smoke.py`
(G=17,002 genes, lean batches over a window of 6,147 tokens: the module
encoder and the decoder-tail kernels) and the parse1m / replogle VAE (G = S
= 2,000: the dense encoder pool and the tail kernels), with random weights
from seed 0 and B=128 cells: takes a warm-up step, times five unprofiled
`VAETask.train_step` calls, times three steps' forward, backward and
clip-plus-optimizer segments (each ending in a synchronize; the last is
`VAETask.apply_gradients`), then traces PROFILED_STEPS more steps with
`torch.profiler`. It prints the unprofiled step times, the segments, the
profiled wall time, the device's busy time (the union of its kernels'
spans), the idle share of the median unprofiled wall time, the time,
launches and share of busy time of the tail and pool kernels, and the
profiler's table of the operators that took the most device time.

Then the dispatch gate: the encoder's front half (input embedding and MCAB
pooling), forward and backward, through the dense pool
(`fused_encoder_pooling`) and through the modules, in turns, at both
configurations' ratios of genes to window.

With --fused-trunk, instead: for both configurations, the step with the
whole-trunk kernels (`VAETask(fused_trunk=True)`) and with the module
trunks, unprofiled in turns (off, on, on, off, twice; TURN_STEPS steps a
turn, each step synchronised), their medians, then PROFILED_STEPS traced
steps of each arm: kernels per step, device busy time, the idle share of
the arm's median and the trunk kernels' time and launches.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED, BATCH = 0, 128
PROFILED_STEPS = 3
TURN_STEPS = 5
KERNELS = ("tail_fwd", "tail_bwd", "sum_partials", "pool_fwd_mma",
           "pool_bwd_kernel", "pool_bwd_sum", "trunk_forward_mma", "trunk_backward_mma",
           "grad_gemm", "grad_reduce")


def configurations(cs) -> dict:
    """name -> (genes, window, range of expressed genes per cell)."""
    return {"dentate": (cs.N_GENES, cs.WINDOW, (1500, 4000)),
            "parse1m": (cs.PARSE_GENES, cs.PARSE_GENES, (500, cs.PARSE_GENES))}


def build_vae(G: int):
    import torch

    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.utils.weights import init_reference_

    return init_reference_(build_transformer_vae(n_genes=G, device="cuda"),
                           torch.Generator(device="cuda").manual_seed(SEED))


def profile_step(cs, busy_us, name: str, G: int, S: int, nnz: tuple) -> None:
    import numpy as np
    import torch

    from scldm_torch.training.vae_task import VAETask

    task = VAETask(build_vae(G), num_training_steps=10_000)
    state = task.init_state(torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in cs.lean_batch(rng, BATCH, G, S, nnz).items()} for _ in range(2)]

    state, _ = task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        state, _ = task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # the step's segments on the host clock, each ending in a synchronize
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
    print(f"== {name}: segments ms (3 steps, each synchronised): {seg}", flush=True)
    profiled(busy_us, f"{name} VAE train step B={BATCH} G={G} S={S}", task, state, batches,
             walls)


def profiled(busy_us, label: str, task, state, batches, walls, table: bool = True) -> None:
    """Trace PROFILED_STEPS steps and print the profiled wall time, the
    device's busy time and kernels per step, the idle share of the median of
    `walls` (unprofiled step ms) and the named kernels' time and launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED_STEPS):
            state, _ = task.train_step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: not the device-side spans of record_function
    # ranges such as Optimizer.step, which cover queue time as well
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("cuda", "Command Buffer", "Optimizer."))]
    if not kernels:
        raise RuntimeError("the trace holds no device kernel")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / PROFILED_STEPS
    median = statistics.median(walls)
    print(f"== {label}: unprofiled walls ms {[round(w, 2) for w in walls]} (median {median:.2f}), "
          f"profiled wall {wall_ms / PROFILED_STEPS:.2f} ms per step, device busy {busy_ms:.2f} ms "
          f"per step, idle share of the unprofiled median {1 - busy_ms / median:.4f}", flush=True)
    kernel_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / PROFILED_STEPS
    print(f"   device kernel time (sum) {kernel_ms:.2f} ms per step over "
          f"{len(kernels) / PROFILED_STEPS:.0f} kernels", flush=True)
    for kname in KERNELS:
        evs = [e for e in kernels if kname in e.name]
        ms = sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / PROFILED_STEPS
        print(f"   {kname}: {ms:.3f} ms per step over {len(evs)} launches, share of busy "
              f"{ms / busy_ms:.4f}", flush=True)
    if table:
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                        max_name_column_width=60), flush=True)


def trunk_ab(busy_us, cs, name: str, G: int, S: int, nnz: tuple) -> None:
    """The step with the whole-trunk kernels against the module trunks, on
    one VAE, each arm with its own optimizer state: unprofiled in turns,
    then profiled."""
    import numpy as np
    import torch

    from scldm_torch.training.vae_task import VAETask

    vae = build_vae(G)
    arms = {}
    for arm in ("off", "on"):
        task = VAETask(vae, num_training_steps=10_000, fused_trunk=arm == "on")
        arms[arm] = (task, task.init_state(torch.Generator(device="cuda").manual_seed(SEED)))
    rng = np.random.default_rng(SEED)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in cs.lean_batch(rng, BATCH, G, S, nnz).items()} for _ in range(2)]
    for task, state in arms.values():
        task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    walls = {"off": [], "on": []}
    for arm in ("off", "on", "on", "off") * 2:
        task, state = arms[arm]
        for i in range(TURN_STEPS):
            t0 = time.perf_counter()
            task.train_step(state, batches[i % 2])
            torch.cuda.synchronize()
            walls[arm].append((time.perf_counter() - t0) * 1e3)
    on, off = (statistics.median(walls[a]) for a in ("on", "off"))
    print(f"== {name} trunk A/B, B={BATCH} G={G} S={S}, in turns: median ms/step with the trunk "
          f"kernels {on:.2f} ({BATCH * 1e3 / on:.1f} cells/s), with the module trunks {off:.2f} "
          f"({BATCH * 1e3 / off:.1f} cells/s), on / off {on / off:.3f}", flush=True)
    for arm in ("off", "on"):
        task, state = arms[arm]
        profiled(busy_us, f"{name} trunk {arm}", task, state, batches, walls[arm], table=False)


def gate(cs, name: str, G: int, S: int, nnz: tuple) -> None:
    """The encoder's front half, forward and backward, at B=128: the dense
    pool over all G genes against the modules over the S-token window."""
    import numpy as np
    import torch

    from scldm_torch.ops.transforms import densify_expressed, widen_lean
    from scldm_torch.training.vae_task import fused_encoder_pooling

    vae = build_vae(G)
    rng = np.random.default_rng(SEED)
    lean = widen_lean({k: torch.from_numpy(v).to("cuda")
                       for k, v in cs.lean_batch(rng, BATCH, G, S, nnz).items()})
    c_sub, g_sub = lean["counts_subset"], lean["genes_subset"]
    counts = densify_expressed(g_sub, c_sub, G)
    ca = vae.encoder.ca_layer
    cot = torch.randn(BATCH, ca.inducing_points.shape[0], ca.ln_1.n, device="cuda")

    def dense():
        vae.zero_grad(set_to_none=True)
        (fused_encoder_pooling(vae, counts, S) * cot).sum().backward()

    def module():
        vae.zero_grad(set_to_none=True)
        (ca(vae.input_layer(c_sub, g_sub)) * cot).sum().backward()

    for f in (dense, module):
        cs.cuda_ms(f, 2)  # warm-up
    turns = [cs.cuda_ms(f, 10) for f in (module, dense, dense, module)]
    d, m = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    print(f"== gate at {name} (G={G}, S={S}, G/S {G / S:.2f}): encoder front half, forward and "
          f"backward, B={BATCH}: dense pool {d:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}), module "
          f"{m:.4f} ms ({turns[0]:.4f}, {turns[3]:.4f}), dense / module {d / m:.3f}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fused-trunk", action="store_true",
                   help="only the whole-trunk A/B of both configurations")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmarks_torch"))
    import chip_smoke as cs
    from profile_generation import busy_us

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    configs = configurations(cs)
    if args.fused_trunk:
        for name, shape in configs.items():
            trunk_ab(busy_us, cs, name, *shape)
        return 0
    for name, shape in configs.items():
        profile_step(cs, busy_us, name, *shape)
    for name, shape in configs.items():
        gate(cs, name, *shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
