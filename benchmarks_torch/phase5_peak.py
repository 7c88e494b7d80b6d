#!/usr/bin/env python3
"""The peak device memory of chip_smoke.py's phase 5 for one tree, on one NVIDIA GPU.

    python3 benchmarks_torch/phase5_peak.py [ROOT]

Imports `chip_smoke` and `scldm_torch` from ROOT (default: the tree this
script sits in; give another checkout, such as the parent commit unpacked
with `git archive` into a gitignored directory, to compare two trees), runs
its `phase5_parse1m_training` (the parse1m / replogle VAE, B = 128, G = S =
2,000: ten steps through the dense encoder pool and the tail kernels, one
step against the module path, then three `VAETask(fused_pool=True)` steps
and their check) with TF32 off, and prints the largest device memory the
whole phase allocated (`torch.cuda.max_memory_allocated`). Run each tree's
copy in turns in one call (parent, change, change, parent) to compare.
"""

from __future__ import annotations

import sys
from pathlib import Path


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("phase5_peak: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args[0] if args else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.reset_peak_memory_stats()
    cs.phase5_parse1m_training(0, 128)
    print(f"phase5_peak {root}: {torch.cuda.max_memory_allocated() / 2**30:.4f} GiB on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
