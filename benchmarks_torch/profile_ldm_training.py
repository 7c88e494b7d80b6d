#!/usr/bin/env python3
"""Where the time of one LDM training step goes, on one NVIDIA GPU.

    python3 benchmarks_torch/profile_ldm_training.py [--census] [--fused-encode]

Builds the dentate-gyrus VAE and DiT of `chip_smoke.py` (random weights from
seed 0), the `LDMTask` defaults and lean wire batches with cluster labels
(B=128 cells) or, with --census, the census VAE (frozen) and the census DiT
(T = 64 latent tokens) of its phase 7 with census batches (B=16); with
--fused-encode the frozen encode pools through the window-pool kernels
(`LDMTask(fused_encode=True)`; the wide design at census width), else
through the module MCAB. It takes a warm-up step, times five unprofiled
`LDMTask.train_step` calls, times three steps' segments (each ending in a
synchronize): the frozen encode alone, the loss (which encodes again), the
backward, and the clip, optimizer and EMA (`LDMTask.apply_gradients`, the
step's own code). Then it traces PROFILED_STEPS
more steps with `torch.profiler` and prints the unprofiled step times, the
segments, the profiled wall time, the device's busy time (the union of its
kernels' spans), the idle share of the median unprofiled wall time, kernels
per step, the time, launches and share of busy time of each of the DiT
block's kernels (the forward and the backward share the `tiled` stages: the
GEMM, the attention, the LayerNorm and silu; the backward adds the attention
backward, its LayerNorm backward and the weight-gradient GEMM) and of the
window pool's, and the profiler's table of
the operators that took the most device time.
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
PROFILED_STEPS = 3
# the DiT block's kernels: the `tiled` stages of the forward and of the
# backward's recompute and products, then the backward's own
DIT_KERNELS = ("gemm", "attention", "ln_modulate_tokens", "silu_rows", "grad_gemm", "grad_reduce",
               "attention_dq", "attention_dkv", "ln_bwd", "sum_parts", "dc_rows")
# the window pool's forward kernels (narrow: encoder_pool.cu; wide: window_pool_wide.cu)
POOL_KERNELS = ("pool_fwd_mma", "prep_weights", "prep_q", "ln_rows", "gemm_bf16", "attn_fwd",
                "attn_merge", "exact_max")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--census", action="store_true", help="the census pair (T = 64, B = 16)")
    p.add_argument("--fused-encode", action="store_true",
                   help="the frozen encode through the window pool (LDMTask(fused_encode=True))")
    args = p.parse_args(argv)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_ldm_training: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmarks_torch"))
    import chip_smoke as cs
    from profile_generation import busy_us
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    if args.census:
        vae, dit = cs.build_census_ldm_models(SEED)
        batches, batch = cs.census_ldm_batches(rng, 2), cs.CENSUS_LDM_BATCH
    else:
        vae, dit = cs.build_models(SEED)
        batches, batch = cs.ldm_batches(rng, 128, 2), 128
    task = LDMTask(vae, dit, create_transport(), fused_encode=args.fused_encode)
    print(f"== LDMTask(fused_encode={task.fused_encode})", flush=True)
    state = task.init_state(torch.Generator(device="cuda").manual_seed(SEED))

    state, _ = task.train_step(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        state, _ = task.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # the step's segments on the host clock, each ending in a synchronize
    seg = cs.ldm_step_segments(task, state, batches)
    print(f"== segments ms (3 steps, each synchronised; the loss encodes again): {seg}",
          flush=True)
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
    print(f"== LDM train step B={batch}: unprofiled walls ms {[round(w, 2) for w in walls]} "
          f"(median {median:.2f}, {batch / median * 1e3:.1f} train cells/s), profiled wall "
          f"{wall_ms / PROFILED_STEPS:.2f} ms per step, device busy {busy_ms:.2f} ms per step, idle "
          f"share of the unprofiled median {1 - busy_ms / median:.4f}", flush=True)
    kernel_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / PROFILED_STEPS
    print(f"   device kernel time (sum) {kernel_ms:.2f} ms per step over "
          f"{len(kernels) / PROFILED_STEPS:.0f} kernels", flush=True)
    for name in DIT_KERNELS + POOL_KERNELS:
        evs = [e for e in kernels if re.search(rf"\b{re.escape(name)}\b", e.name)]
        if not evs:
            continue
        ms = sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / PROFILED_STEPS
        print(f"   {name}: {ms:.3f} ms per step over {len(evs)} launches, share of busy "
              f"{ms / busy_ms:.4f}", flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
