#!/usr/bin/env python3
"""Where the time of one VAE training step goes, on one NVIDIA GPU.

    python3 benchmarks_torch/profile_training.py

Builds the dentate-gyrus VAE of `chip_smoke.py` (random weights from seed 0)
and its lean wire batches (B=128 cells, a window of 6,147 tokens), takes a
warm-up step, times five unprofiled `VAETask.train_step` calls, times three
steps' forward, backward and clip-plus-optimizer segments (each ending in a
synchronize), then traces PROFILED_STEPS more steps with `torch.profiler`.
It prints the unprofiled step times, the segments, the profiled wall time,
the device's busy time (the union of its kernels' spans), the idle share of
the median unprofiled wall time, the time, launches and share of busy time
of the two decoder-tail kernels, and the profiler's table of the operators
that took the most device time.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED, BATCH = 0, 128
PROFILED_STEPS = 3


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmarks_torch"))
    import chip_smoke as cs
    from profile_generation import busy_us
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.training.metrics import global_norm
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vae = init_reference_(build_transformer_vae(n_genes=cs.N_GENES), torch.Generator().manual_seed(SEED))
    task = VAETask(vae.to("cuda"), num_training_steps=10_000)
    state = task.init_state(torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in cs.lean_batch(rng, BATCH).items()}
               for _ in range(2)]

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
        grads = [q.grad for q in vae.parameters() if q.grad is not None]
        gnorm = global_norm(grads)
        torch._foreach_mul_(grads, torch.clamp(task.grad_clip / (gnorm + 1e-12), max=1.0))
        state.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(seg, (t1 - t0, t2 - t1, t3 - t2)):
            seg[k].append(round(dt * 1e3, 2))
    print(f"== segments ms (3 steps, each synchronised): {seg}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILED_STEPS):
            state, _ = task.train_step(state, batches[i % 2])
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
    print(f"== VAE train step B={BATCH} G={cs.N_GENES} S={cs.WINDOW}: unprofiled walls ms "
          f"{[round(w, 2) for w in walls]} (median {median:.2f}), profiled wall "
          f"{wall_ms / PROFILED_STEPS:.2f} ms per step, device busy {busy_ms:.2f} ms per step, idle "
          f"share of the unprofiled median {1 - busy_ms / median:.4f}", flush=True)
    kernel_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / PROFILED_STEPS
    print(f"   device kernel time (sum) {kernel_ms:.2f} ms per step over "
          f"{len(kernels) / PROFILED_STEPS:.0f} kernels", flush=True)
    for name in ("decoder_tail_fwd_kernel", "decoder_tail_bwd_kernel"):
        evs = [e for e in kernels if name in e.name]
        ms = sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / PROFILED_STEPS
        print(f"   {name}: {ms:.3f} ms per step over {len(evs)} launches, share of busy "
              f"{ms / busy_ms:.4f}", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
