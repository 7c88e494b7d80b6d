#!/usr/bin/env python3
"""Device time by kernel of the any-width decoder-tail and narrow-pool designs
(decoder_tail_gen.cu, encoder_pool_gen.cu) at chip_smoke.py's phase 13
shapes, on one NVIDIA GPU.

    python3 benchmarks_torch/profile_widths.py

Builds the kernels and profiles (torch.profiler, the mean of three calls
after a warm-up) `fused_decoder.decoder_tail_fwd` and `decoder_tail_bwd` at
the dentate step (B = 128, G = 17,002, E = 64, 4 heads of 32 latent tokens,
hidden 172) and the parse1m step (G = 2,000, E = 128, 8 heads of 64, hidden
344), the window pool at the dentate window (B = 128, S = 6,147, E = 64, 4
heads, 32 inducing points) and the dense pool at parse1m (B = 128, G = 2,000,
E = 128, 8 heads, 64), random inputs from seed 0. Prints one line a call:
each kernel's name and ms a call, largest first; then the ptxas report's
registers and spills of each any-width kernel (the tail's `tailw_*`: pack,
rows <EP, backward>, qside, kside <EP, 0 dvproj / 1 dkfull>, w12, sums; the
pools' `poolw_*`: q <EP, dense, 0 max / 1 forward / 2 dq>, t, tok <EP, dense>,
w <EP>, exact, pack, sums), and any line where ptxas serialises wgmma.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile(label: str, fn, reps: int = 3) -> None:
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / reps / 1e3, e.key) for e in prof.key_averages()
                   if e.device_time_total > 0), reverse=True)
    names = [(t, re.search(r"(\w+)(<[^(]*>)?\(", k)) for t, k in rows]
    print(label + ": " + ", ".join(f"{m.group(1) if m else k[:30]} {t:.3f}"
                                   for (t, m), (_, k) in zip(names, rows)), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_widths: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from scldm_torch.kernels import build
    from scldm_torch.ops import fused_decoder as fd
    from scldm_torch.ops import fused_encoder as fe

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.load()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=0.3, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    for E, H, M, Hd, B, G in ((64, 4, 32, 172, 128, 17_002), (128, 8, 64, 344, 128, 2_000)):
        raw = [rnd(E, shift=1.0), rnd(E), rnd(E, Hd), rnd(E, Hd), rnd(Hd, E), rnd(E, 1), rnd(1)]
        w = [t.contiguous() for t in fd.pack_weights(*raw)]
        kf, vp = fd.build_attention_operands(rnd(B, M, E), rnd(B, M, E), rnd(E, E), H)
        qp, q, dy = rnd(G, E), rnd(G, E), rnd(B, G, scale=1.0)
        profile(f"decoder_tail_fwd E={E}", lambda: fd.decoder_tail_fwd(qp, q, kf, vp, w, H, 1e-8))
        profile(f"decoder_tail_bwd E={E}",
                lambda: fd.decoder_tail_bwd(qp, q, kf, vp, w, dy, H, 1e-8))
    for variant, E, H, Q, B, N in (("window", 64, 4, 32, 128, 6_147),
                                   ("dense", 128, 8, 64, 128, 2_000)):
        dense = variant == "dense"
        src = rnd(N, E, scale=1.0) if dense else rnd(B, N, E, scale=1.0)
        counts = torch.poisson(torch.full((B, N), 3.0, device="cuda"), generator=g) if dense \
            else None
        qfull = fe.build_query_operand(rnd(Q, E, scale=1.0), H)
        w = [rnd(1, E, shift=1.0), rnd(1, E), rnd(E, E, scale=E**-0.5), rnd(E, E, scale=E**-0.5)]
        pre = (counts,) if dense else ()
        fwd, bwd = ((fe.encoder_pool_fwd, fe.encoder_pool_bwd) if dense
                    else (fe.window_pool_fwd, fe.window_pool_bwd))
        m = fwd(*pre, src, qfull, w, H, 1e-8)[2]
        cot = (rnd(B, Q, E, scale=1.0), rnd(B, Q * H, scale=1.0))
        profile(f"{variant}_pool_fwd E={E}", lambda: fwd(*pre, src, qfull, w, H, 1e-8))
        profile(f"{variant}_pool_bwd E={E}", lambda: bwd(*pre, src, qfull, w, m, *cot, H, 1e-8))
    report = build.report_path(build.library_path()).read_text().splitlines()
    for i, line in enumerate(report):
        name = re.search(r"\d((?:tailw|poolw)_[a-z0-9_]+?)I(L[ib]\d+E)+", line)
        if "Compiling entry" in line and name:
            args = ", ".join(re.findall(r"L[ib](\d+)E", name.group(0)))
            info = [k.split(":", 1)[-1].strip() for k in report[i + 1:i + 4]
                    if "Compiling" not in k and ("Used" in k or "spill" in k)]
            print(f"{name.group(1)}<{args}>: " + "; ".join(info))
        if "serializ" in line or "Performance Loss" in line:
            print(line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
