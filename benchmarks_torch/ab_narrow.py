#!/usr/bin/env python3
"""Times one tree's narrow decoder-tail and encoder-pool kernels (rows 3-8 of
PERF.md's table) at the dentate decoder's and the reference encoder's shape
(E = 32, 4 heads, 16 latent tokens or inducing points, hidden 88) on one
NVIDIA GPU.

    python3 benchmarks_torch/ab_narrow.py [--root DIR]

Imports `scldm_torch` from DIR (default: this repository), builds its
kernels and times, with CUDA events (three warm-up calls, then the mean of
20), a call through each entry point: `fused_decoder.decoder_tail_fwd` and
`decoder_tail_bwd` at the VAE training step's shape (B = 128 cells, G =
17,002 genes), `fused_encoder.encoder_pool_fwd` and `encoder_pool_bwd` at
parse1m's (B = 128, G = 2,000) and `window_pool_fwd` and `window_pool_bwd`
at the dentate window (B = 128, S = 6,147), on random inputs from seed 0;
beside each, the device time a call (the profiler, every kernel of 20 more
calls). Where the tree has the any-width designs (decoder_tail_gen.cu,
encoder_pool_gen.cu), it also times them at the same shapes (`*_gen`), the
wrappers' dispatch by shape turned off for those calls: the shape the
dentate designs are tuned for, where the two are compared. Then the tail
both ways at chip_smoke.py's phase 13 shapes (`decoder_tail_*_e64`: B = 128,
G = 17,002, E = 64, 4 heads, 32 latent tokens, hidden 172; `*_e128`: G =
2,000, E = 128, 8 heads, 64 tokens, hidden 344), which only the any-width
design takes, and the pools both ways at phase 13's shapes
(`window_pool_*_e64`: B = 128, S = 6,147, E = 64, 4 heads, 32 inducing
points; `encoder_pool_*_e128`: B = 128, G = 2,000, E = 128, 8 heads, 64),
and the dense pool there at 128 inducing points (`encoder_pool_*_e128_q128`)
where the tree's kernels take it. The last line is
a JSON object, {"ms": {name: ms}, "device_ms": {name: ms}}. To compare two
trees, run this once per tree in turns within one chip call (parent,
change, change, parent): cards differ between calls.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
E, H, M, HD, EPS = 32, 4, 16, 88, 1e-8
N_GENES, PARSE_GENES, WINDOW, B = 17_002, 2_000, 6_147, 128


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", type=Path, default=HERE)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_narrow: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from flash_crossover import device_ms

    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_encoder as fe

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"tree {args.root.resolve()}: {fd.__file__}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    raw = [rnd(E, scale=0.3, shift=1.0), rnd(E, scale=0.3), rnd(E, HD, scale=0.3),
           rnd(E, HD, scale=0.3), rnd(HD, E, scale=0.3), rnd(E, 1, scale=0.3), rnd(1, scale=0.3)]
    tw = [t.contiguous() for t in fd.pack_weights(*raw)]
    kf, vp = fd.build_attention_operands(rnd(B, M, E, scale=0.3), rnd(B, M, E, scale=0.3),
                                         rnd(E, E, scale=0.3), H)
    qp, q, dy = rnd(N_GENES, E, scale=0.3), rnd(N_GENES, E, scale=0.3), rnd(B, N_GENES)
    fns = {"decoder_tail_fwd": lambda: fd.decoder_tail_fwd(qp, q, kf, vp, tw, H, EPS),
           "decoder_tail_bwd": lambda: fd.decoder_tail_bwd(qp, q, kf, vp, tw, dy, H, EPS)}
    qfull = fe.build_query_operand(rnd(M, E), H)
    pw = [rnd(1, E, scale=0.3, shift=1.0), rnd(1, E, scale=0.3), rnd(E, E, scale=E**-0.5),
          rnd(E, E, scale=E**-0.5)]
    table, emb = rnd(PARSE_GENES, E), rnd(B, WINDOW, E)
    counts = (torch.poisson(torch.full((B, PARSE_GENES), 3.0, device="cuda"), generator=g)
              * (torch.rand(B, PARSE_GENES, generator=g, device="cuda") < 0.6))
    dense_m = fe.encoder_pool_fwd(counts, table, qfull, pw, H, EPS)[2]
    window_m = fe.window_pool_fwd(emb, qfull, pw, H, EPS)[2]
    cot = (rnd(B, M, E), rnd(B, M * H))
    fns.update({
        "encoder_pool_fwd": lambda: fe.encoder_pool_fwd(counts, table, qfull, pw, H, EPS),
        "encoder_pool_bwd": lambda: fe.encoder_pool_bwd(counts, table, qfull, pw, dense_m, *cot,
                                                        H, EPS),
        "window_pool_fwd": lambda: fe.window_pool_fwd(emb, qfull, pw, H, EPS),
        "window_pool_bwd": lambda: fe.window_pool_bwd(emb, qfull, pw, window_m, *cot, H, EPS),
    })
    if hasattr(fd, "specialised"):  # the any-width designs, at the same shapes
        def gen(fn):
            def call():
                spec, shape = fd.specialised, fe.SPECIALISED
                fd.specialised, fe.SPECIALISED = (lambda *a: False), (0, 0, 0)
                try:
                    return fn()
                finally:
                    fd.specialised, fe.SPECIALISED = spec, shape
            return call

        fns.update({f"{k}_gen": gen(f) for k, f in list(fns.items())})
    # the tail at chip_smoke.py's phase 13 shapes, which only the any-width design takes
    for e, h, m, hid, genes in ((64, 4, 32, 172, N_GENES), (128, 8, 64, 344, PARSE_GENES)):
        raw = [rnd(e, scale=0.3, shift=1.0), rnd(e, scale=0.3), rnd(e, hid, scale=0.3),
               rnd(e, hid, scale=0.3), rnd(hid, e, scale=0.3), rnd(e, 1, scale=0.3),
               rnd(1, scale=0.3)]
        w_ = [t.contiguous() for t in fd.pack_weights(*raw)]
        k_, v_ = fd.build_attention_operands(rnd(B, m, e, scale=0.3), rnd(B, m, e, scale=0.3),
                                             rnd(e, e, scale=0.3), h)
        qp_, q_, dy_ = rnd(genes, e, scale=0.3), rnd(genes, e, scale=0.3), rnd(B, genes)
        fns[f"decoder_tail_fwd_e{e}"] = (
            lambda a=(qp_, q_, k_, v_, w_), h=h: fd.decoder_tail_fwd(*a, h, EPS))
        fns[f"decoder_tail_bwd_e{e}"] = (
            lambda a=(qp_, q_, k_, v_, w_, dy_), h=h: fd.decoder_tail_bwd(*a, h, EPS))
    # the pools at chip_smoke.py's phase 13 shapes (and the dense one past 64 queries)
    for variant, e, h, nq, n in (("window", 64, 4, 32, WINDOW), ("encoder", 128, 8, 64, PARSE_GENES),
                                 ("encoder", 128, 8, 128, PARSE_GENES)):
        if not fe.narrow_kernel_takes(e, h, nq):
            continue
        qf_ = fe.build_query_operand(rnd(nq, e), h)
        pw_ = [rnd(1, e, scale=0.3, shift=1.0), rnd(1, e, scale=0.3), rnd(e, e, scale=e**-0.5),
               rnd(e, e, scale=e**-0.5)]
        pre = (counts,) if variant == "encoder" else ()
        src_ = rnd(n, e) if variant == "encoder" else rnd(B, n, e)
        fwd, bwd = ((fe.encoder_pool_fwd, fe.encoder_pool_bwd) if variant == "encoder"
                    else (fe.window_pool_fwd, fe.window_pool_bwd))
        m_ = fwd(*pre, src_, qf_, pw_, h, EPS)[2]
        cot_ = (rnd(B, nq, e), rnd(B, nq * h))
        tag = f"e{e}" + ("_q128" if nq == 128 else "")
        fns[f"{variant}_pool_fwd_{tag}"] = (
            lambda a=(*pre, src_, qf_, pw_, h, EPS), f=fwd: f(*a))
        fns[f"{variant}_pool_bwd_{tag}"] = (
            lambda a=(*pre, src_, qf_, pw_, m_, *cot_, h, EPS), f=bwd: f(*a))
    ms, dev = {}, {}
    for name, fn in fns.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / 20
        dev[name] = device_ms(fn, 20)
        print(f"{name}: {ms[name]:.4f} ms a call, {dev[name]:.4f} ms on the device", flush=True)
    print(json.dumps({"ms": ms, "device_ms": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
