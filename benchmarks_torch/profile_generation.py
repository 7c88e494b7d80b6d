#!/usr/bin/env python3
"""Where the time of one CFG generation call goes, on one NVIDIA GPU.

    python3 benchmarks_torch/profile_generation.py [--census]

Builds the dentate-gyrus VAE and DiT of `chip_smoke.py` (random weights from
seed 0; batch 128 per CFG half) or, with --census, the census VAE and DiT
of its phase 7 (T = 64 latent tokens, the algebraic decode; batch 16) and,
for dopri5 and euler-50, times three calls of the sample function after a
warm-up, then traces one more with `torch.profiler`. For each sampler it
prints the unprofiled wall times, the profiled wall time, the device's busy
time (the union of its kernels' spans), the idle share of the wall time, and
the DiT block forward kernels' time (the tiled design's nine: its GEMMs,
LayerNorms, silu and attention, namespace `tiled`), launches and share of the busy time,
followed by the profiler's table of the kernels that took the most device
time.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
# the DiT block forward's kernels: all of them in dit_block.cu's namespace `tiled`
DIT_FWD_KERNELS = ("tiled",)


def busy_us(spans) -> float:
    """Length of the union of (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--census", action="store_true", help="the census pair (T = 64, batch 16)")
    args = p.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_generation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from scldm_torch.ops.transforms import canonical_gene_ids
    from scldm_torch.sampling.size_factors import SizeFactorSampler, constant_stats
    from scldm_torch.training.ldm_task import LDMTask
    from scldm_torch.transport import create_transport

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.census:
        vae, dit = cs.build_census_ldm_models(SEED)
        batch, n_genes = cs.CENSUS_LDM_BATCH, cs.CENSUS["n_genes"]
    else:
        vae, dit = cs.build_models(SEED)
        batch, n_genes = 128, cs.N_GENES
    task = LDMTask(vae, dit, create_transport())
    sfs = SizeFactorSampler(constant_stats({"clusters": cs.N_CLUSTERS}, mu=8.6, sd=0.3))
    genes = canonical_gene_ids(n_genes, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cond = {"clusters": torch.randint(0, cs.N_CLUSTERS, (batch,), generator=g,
                                      device="cuda")}

    for method in ("dopri5", "euler"):
        fn = task.make_sample_fn(sfs, guidance_weight=cs.GUIDANCE, sampling_method=method,
                                 num_steps=50)
        fn(g, genes, cond)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(g, genes, cond)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(g, genes, cond)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("cuda", "Command Buffer"))]
        if not kernels:
            raise RuntimeError("the trace holds no device kernel")
        busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
        dit = [e for e in kernels
               if any(re.search(rf"\b{name}\b", e.name) for name in DIT_FWD_KERNELS)]
        dit_ms = sum(e.time_range.end - e.time_range.start for e in dit) / 1e3
        print(f"== {method}: unprofiled walls ms {[round(w, 2) for w in walls]}, profiled wall "
              f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share of wall "
              f"{1 - busy_ms / wall_ms:.4f}, dit_block kernels {dit_ms:.2f} ms over {len(dit)} "
              f"kernel launches ({dit_ms / max(len(dit), 1) * 1e3:.1f} us each), share of busy "
              f"{dit_ms / busy_ms:.4f}, DiT evals {fn.drift_evals}", flush=True)
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=14,
                                        max_name_column_width=60), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
