#!/usr/bin/env python3
"""Which summation order reproduces the plain pools' scores, on one NVIDIA GPU.

    python3 benchmarks_torch/pool_max_order.py

The plain versions of the encoder pools (`scldm_torch/ops/fused_encoder.py`,
`_ln_kv_scores`) take the scores as an f32 matrix product `bf(k) @ bf(qfull).T`
on the card (TF32 off). A pool kernel that retakes a row's max score must land
on the same bits, or every exponential of the row moves. For random bf16 k
(T tokens) and the block-diagonal query operand at a few (E, heads, queries)
this prints the share of scores where each candidate differs from that
product: the exact sum rounded once to f32, a sequential f32 sum over the
columns in order, and two accumulators (even and odd columns) added at the end.
Each product of two bf16 values is exact in f32, so only the order of the sums
differs. Exits non-zero without CUDA.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pool_max_order: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from scldm_torch.ops import fused_encoder as fe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def bf(t):
        return t.to(torch.bfloat16).float()

    for E, H, Q, T in ((128, 8, 128, 32_000), (128, 8, 64, 32_000), (64, 4, 32, 32_000),
                       (16, 2, 64, 4_000), (128, 16, 64, 8_000)):
        g = torch.Generator(device="cuda").manual_seed(1)
        k = bf(torch.randn(T, E, generator=g, device="cuda"))
        qfull = bf(fe.build_query_operand(torch.randn(Q, E, generator=g, device="cuda"), H))
        plain = k @ qfull.t()
        exact = (k.double() @ qfull.double().t()).float()
        seq = torch.zeros_like(plain)
        a0, a1 = torch.zeros_like(plain), torch.zeros_like(plain)
        for c in range(E):  # each step rounded in f32; the zeros off the head add nothing
            p = k[:, c:c + 1] * qfull[:, c][None, :]
            seq = seq + p
            if c % 2:
                a1 = a1 + p
            else:
                a0 = a0 + p
        share = {name: (v != plain).float().mean().item()
                 for name, v in (("exact", exact), ("sequential", seq), ("even/odd", a0 + a1))}
        print(f"E={E} heads={H} Q={Q} T={T}: share of scores off the plain product: "
              + ", ".join(f"{n} {v:.4f}" for n, v in share.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
