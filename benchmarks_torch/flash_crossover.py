#!/usr/bin/env python3
"""Flash attention against plain attention over growing sequence lengths, on
one NVIDIA GPU: where the hand-written kernel beats the materialized path,
and where the plain path stops fitting at all.

    python3 benchmarks_torch/flash_crossover.py [--lens 64 128 ...]

The H100 counterpart of benchmarks/bench_flash_crossover.py: self-attention
(M = S) at its B = 2, H = 4, D = 64, in f32 (the port's compute type; JAX's
sweep takes bf16 operands). At each length, three paths on the same
operands: the kernel (`ops.flash_attention.flash_attention`), the plain
path (`ops.attention.sdpa_plain`, which materializes the (B, H, M, S) f32
scores and probabilities), and `torch.nn.functional.scaled_dot_product_
attention` with TF32 off (the library yardstick; the port never calls it).
Each is timed with CUDA events over REPS calls, after a warm-up, twice in
turns (plain, kernel, library, library, kernel, plain), and the two means
averaged: the wall of a call, host work included. Beside it, each path's
device time a call, the sum of its kernels' times from `torch.profiler`
over three calls: at short lengths the wall is the host's launch path, not
the device's work. A path that runs out of device memory records `null` and the
error: this is a measurement, not a check. One JSON line per length, with
the plain path's score bytes (one f32 (B, H, M, S) tensor) and the
kernel's bound (the larger of its bytes over 3.35 TB/s and its 4*B*H*M*S*D
operations, three TF32 passes of them, over the TF32 tensor-core peak of 495
TFLOP/s: `chip_smoke.flash_attention_bound`), then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, D = 2, 4, 64
LENS = (64, 128, 256, 512, 1_024, 2_048, 4_096, 8_192, 16_384, 32_768)


def device_ms(fn, reps: int = 3) -> float:
    """The device time of one call of `fn`: its kernels' times summed, from
    the profiler, over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lens", nargs="+", type=int, default=list(LENS))
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_crossover: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    import chip_smoke as cs
    from scldm_torch.ops import attention
    from scldm_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    for S in args.lens:
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda") for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        reps = max(1, min(20, (4_096 // S) ** 2))
        paths = {"kernel": lambda: fa.flash_attention(q, k, v),
                 "plain": lambda: attention.sdpa_plain(q, k, v),
                 "library": lambda: F.scaled_dot_product_attention(qt, kt, vt)}
        row = {"metric": "flash_crossover", "seq_len": S, "B": B, "H": H, "D": D,
               "dtype": "float32", "plain_score_bytes_gb": B * H * S * S * 4 / 1e9,
               **cs.flash_attention_bound(B, S, S, H, D)}
        times = {}
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
            if name in times and times[name] is None:
                continue
            try:
                if name not in times:
                    cs.cuda_ms(paths[name], 1)  # warm-up
                times.setdefault(name, []).append(cs.cuda_ms(paths[name], reps))
            except torch.cuda.OutOfMemoryError as e:
                times[name] = None
                row[f"{name}_error"] = str(e).splitlines()[0][:200]
            torch.cuda.empty_cache()
        for name in ("kernel", "plain", "library"):
            row[f"{name}_ms"] = None if times[name] is None else sum(times[name]) / len(times[name])
            row[f"{name}_device_ms"] = None if times[name] is None else device_ms(paths[name])
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        del q, k, v, qt, kt, vt, paths
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
