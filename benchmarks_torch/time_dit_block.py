#!/usr/bin/env python3
"""Times one tree's DiT block kernels (forward and backward), decoder-tail
kernels (forward and backward) and whole-trunk kernels (forward, saving
forward, backward) on one NVIDIA GPU.

    python3 benchmarks_torch/time_dit_block.py [--root DIR]

Imports `scldm_torch` from DIR (default: this repository), builds its
kernels and times, with CUDA events (three warm-up calls, then the mean of
20), `fused_dit.dit_block` and `fused_dit.dit_block_bwd` at the dentate
shapes (T = 16: the sampler's R = 384 rows, the training step's R = 128),
the census ones (T = 64: R = 48 and R = 16) and the long-latent pair's (T =
1,024: the sampler's R = 12, the training step's R = 16), E = 256, 8 heads,
Hd = 684, random weights from seed 0; and `fused_decoder.decoder_tail_fwd`
and `decoder_tail_bwd` at the VAE training step's shape (B = 128 cells, G =
17,002 genes, E = 32, 4 heads of 16 latent tokens, Hd = 88); and
`fused_trunk.fused_trunk_blocks`, `fused_trunk_fwd_saving` and
`fused_trunk_bwd` at the VAE's trunk (R = 128 rows of T = 16 tokens, E = 32,
8 heads, hidden 88, L = 8). Beside each time a call through the entry point
it prints the device time a call: the kernels' own times under the
profiler, summed over 20 more calls (the wrappers' host time can exceed the
kernels', and then sets the first). A shape the tree's kernels do not take
prints the error instead of a time. The last line is a JSON object, {"ms":
{shape: ms}, "device_ms": {shape: ms}}. To compare two trees, run this
once per tree in turns within one chip call (parent, change, change,
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
          ("bwd", 16, 64), ("fwd", 12, 1024), ("bwd", 16, 1024), ("tail_fwd", 128, 17_002),
          ("tail_bwd", 128, 17_002), ("trunk_fwd", 128, 16), ("trunk_fwd_saving", 128, 16),
          ("trunk_bwd", 128, 16))
TRUNK_E, TRUNK_H, TRUNK_HD, TRUNK_L = 32, 8, 88, 8
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
    from scldm_torch.ops import fused_decoder, fused_dit, fused_trunk
    from flash_crossover import device_ms

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

    def tail_fn(B, G, backward):
        E_, H_, M_, Hd_ = TAIL_E, TAIL_H, TAIL_M, TAIL_HD
        raw = [rnd(E_, scale=0.3) + 1.0, rnd(E_, scale=0.3), rnd(E_, Hd_, scale=0.3),
               rnd(E_, Hd_, scale=0.3), rnd(Hd_, E_, scale=0.3), rnd(E_, 1, scale=0.3),
               rnd(1, scale=0.3)]
        tw = [t.contiguous() for t in fused_decoder.pack_weights(*raw)]
        kf, vp = fused_decoder.build_attention_operands(
            rnd(B, M_, E_, scale=0.3), rnd(B, M_, E_, scale=0.3), rnd(E_, E_, scale=0.3), H_)
        qp, q, dy = rnd(G, E_, scale=0.3), rnd(G, E_, scale=0.3), rnd(B, G)
        if not backward:
            return lambda: fused_decoder.decoder_tail_fwd(qp, q, kf, vp, tw, H_, EPS)
        return lambda: fused_decoder.decoder_tail_bwd(qp, q, kf, vp, tw, dy, H_, EPS)

    def trunk_fn(R, T, part):
        E_, Hd_, L_ = TRUNK_E, TRUNK_HD, TRUNK_L
        sizes = {"wqkv": (3 * E_, E_), "wproj": (E_, E_), "w1": (Hd_, E_), "w2": (Hd_, E_),
                 "wmlp": (E_, Hd_)}
        tw = {k: [rnd(*s, scale=s[1] ** -0.5) for _ in range(L_)] for k, s in sizes.items()}
        for k in ("g1", "g2", "b1", "b2"):
            tw[k] = [rnd(E_, scale=0.1) + (k[0] == "g") for _ in range(L_)]
        x, dy = rnd(R, T, E_), rnd(R, T, E_)
        if part == "trunk_fwd":
            return lambda: fused_trunk.fused_trunk_blocks(x, tw, TRUNK_H, EPS)
        if part == "trunk_fwd_saving":
            return lambda: fused_trunk.fused_trunk_fwd_saving(x, tw, TRUNK_H, EPS)
        _, xs = fused_trunk.fused_trunk_fwd_saving(x, tw, TRUNK_H, EPS)
        return lambda: fused_trunk.fused_trunk_bwd(xs, tw, dy, TRUNK_H, EPS)

    times, dev_times = {}, {}
    for part, R, T in SHAPES:
        if part.startswith("trunk"):
            fn = trunk_fn(R, T, part)
            key = f"{part} R={R} T={T}"
        elif part.startswith("tail"):
            fn = tail_fn(R, T, part == "tail_bwd")
            key = f"{part} B={R} G={T}"
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
            times[key] = dev_times[key] = None
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[key] = start.elapsed_time(end) / 20
        dev_times[key] = device_ms(fn, 20)
        print(f"{key}: {times[key]:.4f} ms a call, {dev_times[key]:.4f} ms on the device",
              flush=True)
    print(json.dumps({"ms": times, "device_ms": dev_times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
