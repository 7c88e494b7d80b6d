"""Per-tensor bf16 ratios of the port against the JAX package.

Runs `test_torch_port_bf16.py` with SCLDM_BF16_RATIOS set, so that each
tensor it holds writes one line (`record_ratio`), then prints, per test and
tensor, the ratio of the port's distance from JAX's bf16 result to JAX's own
bf16-versus-f32 distance, and the K the bound needs beside its floor; last
the worst of each. On the CPU, about a minute:

    JAX_PLATFORMS=cpu python -m tests.torch_port.bf16_ratios [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json", help="also write the rows here")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ratios.jsonl"
        env = dict(os.environ, SCLDM_BF16_RATIOS=str(out), JAX_PLATFORMS="cpu")
        rc = subprocess.call([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                              str(HERE / "test_torch_port_bf16.py")], env=env,
                             cwd=HERE.parents[1])
        rows = [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))
    for r in rows:
        ratio = "nan" if r["ratio"] is None else f"{r['ratio']:.3f}"
        need = "nan" if r["needed_k"] is None else f"{r['needed_k']:.3f}"
        print(f"{r['test']:<48} {r['what']:<50} ratio {ratio:>7} needed_k {need:>7}")
    rated = [r for r in rows if r["ratio"] is not None]
    if rated:
        worst = max(rated, key=lambda r: r["ratio"])
        need = max(rated, key=lambda r: r["needed_k"])
        print(f"worst ratio {worst['ratio']:.4f} ({worst['test']} {worst['what']}); "
              f"worst needed K {need['needed_k']:.4f} ({need['test']} {need['what']}); "
              f"{len(rows)} tensors, pytest rc {rc}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
