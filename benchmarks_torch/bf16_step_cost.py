#!/usr/bin/env python3
"""Train cells/s and peak device memory of the bf16 VAEs that the configs
ship, from the tree at --root, on one NVIDIA GPU.

    python3 benchmarks_torch/bf16_step_cost.py [--root DIR]

Three arms, random weights from seed 0: the dentate VAE as
configs/vae_training.yaml ships it (bf16; B = 128 lean batches over
chip_smoke's 6,147-token window, through the decoder-tail kernels, the
optimizer of configs/model/vae_base.yaml), and the census VAE as
vae_census.yaml ships it (bf16, remat; `chip_smoke.census_training_setup`:
B = 16 over 4,096 tokens) through the algebraic tail with the fused gate
and through the plain algebraic path. For each arm: a warm-up step, then
STEPS steps on the host clock ending in a synchronize, and the peak device
memory over them. The script imports `scldm_torch` and `chip_smoke.py` from
--root (default: the tree it sits in), so two trees are compared by running
this copy once per tree, in turns (parent, change, change, parent), inside
one call. The last line is a JSON object of the readings.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

STEPS = {"dentate": 10, "census fused gate": 5, "census plain algebraic": 5}
SEED = 0


def timed(task, batches, steps: int) -> tuple:
    """(ms a step over `steps` steps after one warm-up step, peak GiB)."""
    import torch

    state = task.init_state(torch.Generator(device="cuda").manual_seed(SEED))
    state, _ = task.train_step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(steps):
        state, mets = task.train_step(state, batches[1 + i % (len(batches) - 1)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    if not torch.isfinite(mets["train_loss"]):
        raise AssertionError(f"non-finite loss {mets['train_loss']}")
    return ms, torch.cuda.max_memory_allocated() / 2**30


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                   help="the tree whose scldm_torch and chip_smoke.py to run")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bf16_step_cost: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import numpy as np
    import scldm_torch
    from scldm_torch.nn.vae import build_transformer_vae
    from scldm_torch.training.vae_task import VAETask
    from scldm_torch.utils.weights import init_reference_

    for mod in (cs, scldm_torch):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise AssertionError(f"{mod.__name__} imported from {mod.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"root": str(root), "card": smi}

    vae = init_reference_(build_transformer_vae(n_genes=cs.N_GENES, dtype=torch.bfloat16,
                                                device="cuda"),
                          torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    B = 128
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in cs.lean_batch(rng, B).items()}
               for _ in range(3)]
    ms, peak = timed(VAETask(vae, learning_rate=1e-3, betas=(0.9, 0.95)), batches,
                     STEPS["dentate"])
    out["dentate"] = {"ms": ms, "cells_per_s": B * 1e3 / ms, "peak_gib": peak}
    del vae, batches
    torch.cuda.empty_cache()

    vae, vae32, opt, batches = cs.census_training_setup(SEED)
    del vae32
    for name, kw in (("census fused gate", dict(algebraic_fused_gate=True)),
                     ("census plain algebraic", {})):
        torch.cuda.empty_cache()
        ms, peak = timed(VAETask(vae, **opt, **kw), batches[:3], STEPS[name])
        out[name] = {"ms": ms, "cells_per_s": cs.CENSUS_BATCH * 1e3 / ms, "peak_gib": peak}
    for name in STEPS:
        r = out[name]
        print(f"{root.name} {name}: {r['ms']:.2f} ms/step, {r['cells_per_s']:.1f} train cells/s, "
              f"peak {r['peak_gib']:.2f} GiB ({smi})", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
