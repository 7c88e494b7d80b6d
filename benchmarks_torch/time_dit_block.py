#!/usr/bin/env python3
"""Times one tree's DiT block kernels (forward and backward) and decoder-tail
backward on one NVIDIA GPU.

    python3 benchmarks_torch/time_dit_block.py [--root DIR]

Imports `scldm_torch` from DIR (default: this repository), builds its
kernels and times, with CUDA events (three warm-up calls, then the mean of
20), `fused_dit.dit_block` and `fused_dit.dit_block_bwd` at the dentate
shapes (T = 16: the sampler's R = 384 rows, the training step's R = 128),
the census ones (T = 64: R = 48 and R = 16) and the long-latent pair's (T =
1,024, R = 12), E = 256, 8 heads, Hd = 684, random weights from seed 0; and
`fused_decoder.decoder_tail_bwd` at the VAE training step's shape (B = 128
cells, G = 17,002 genes, E = 32, 4 heads of 16 latent tokens, Hd = 88). A
shape the tree's kernels do not take prints the error instead of a time.
The last line is a JSON object of the times. To compare two trees, run
this once per tree in turns within one chip call (parent, change, change,
parent): cards differ between calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = (("fwd", 384, 16), ("fwd", 128, 16), ("bwd", 128, 16), ("fwd", 48, 64), ("fwd", 16, 64),
          ("bwd", 16, 64), ("fwd", 12, 1024), ("tail_bwd", 128, 17_002))
TAIL_E, TAIL_H, TAIL_M, TAIL_HD = 32, 4, 16, 88
E, H, HIDDEN, EPS = 256, 8, 684, 1e-8


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", type=Path, default=HERE)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_dit_block: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from scldm_torch.ops import fused_decoder, fused_dit

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"tree {args.root.resolve()}: {fused_dit.__file__}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    w = {"wada": rnd(E, 6 * E, scale=E**-0.5), "bada": rnd(6 * E, scale=0.1),
         "wqkv": rnd(E, 3 * E, scale=E**-0.5), "bqkv": rnd(3 * E, scale=0.1),
         "wproj": rnd(E, E, scale=E**-0.5), "bproj": rnd(E, scale=0.1),
         "w1": rnd(E, HIDDEN, scale=E**-0.5), "w2": rnd(E, HIDDEN, scale=E**-0.5),
         "wmlp": rnd(HIDDEN, E, scale=HIDDEN**-0.5)}

    def tail_bwd(B, G):
        E_, H_, M_, Hd_ = TAIL_E, TAIL_H, TAIL_M, TAIL_HD
        raw = [rnd(E_, scale=0.3) + 1.0, rnd(E_, scale=0.3), rnd(E_, Hd_, scale=0.3),
               rnd(E_, Hd_, scale=0.3), rnd(Hd_, E_, scale=0.3), rnd(E_, 1, scale=0.3),
               rnd(1, scale=0.3)]
        tw = [t.contiguous() for t in fused_decoder.pack_weights(*raw)]
        kf, vp = fused_decoder.build_attention_operands(
            rnd(B, M_, E_, scale=0.3), rnd(B, M_, E_, scale=0.3), rnd(E_, E_, scale=0.3), H_)
        qp, q, dy = rnd(G, E_, scale=0.3), rnd(G, E_, scale=0.3), rnd(B, G)
        return lambda: fused_decoder.decoder_tail_bwd(qp, q, kf, vp, tw, dy, H_, EPS)

    times = {}
    for part, R, T in SHAPES:
        if part == "tail_bwd":
            fn = tail_bwd(R, T)
            key = f"tail_bwd B={R} G={T}"
        else:
            x, dy, c = rnd(R, T, E), rnd(R, T, E), rnd(R, E)
            fn = ((lambda: fused_dit.dit_block(x, c, w, H, EPS)) if part == "fwd" else
                  (lambda: fused_dit.dit_block_bwd(x, c, w, dy, H, EPS)))
            key = f"{part} R={R} T={T}"
        try:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        except (ValueError, RuntimeError) as err:
            print(f"{key}: {type(err).__name__}: {err}", flush=True)
            times[key] = None
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[key] = start.elapsed_time(end) / 20
        print(f"{key}: {times[key]:.4f} ms", flush=True)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
