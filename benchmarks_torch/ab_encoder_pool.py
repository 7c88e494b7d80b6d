#!/usr/bin/env python3
"""Versions of the narrow encoder-pool kernels side by side, on one NVIDIA GPU.

    python3 benchmarks_torch/ab_encoder_pool.py OTHER.cu [OTHER2.cu ...]

Builds the repo's kernels (`scldm_torch/kernels/csrc`) and each OTHER.cu,
another version of `encoder_pool.cu`, into a library of its own (OTHER.cu
with `-I` its own directory, then the repo's csrc directory) and prints its
ptxas lines; for the parent commit, `git show
HEAD~1:scldm_torch/kernels/csrc/encoder_pool.cu` into a gitignored directory
such as `chip_checkout/`. It adapts to each library's C entries: a library
with `scldm_encoder_pool_workspace_floats` writes every gradient and takes a
workspace of that size; one without it adds into zeroed gradients (the
zeroing then counts as part of its call). Holds both forwards and both
backwards against the plain versions
(`ops/fused_encoder.encoder_pool_reference`, `window_pool_reference` and
their `*_backward_reference`, f32, the backwards given the plain forward's
m) at chip_smoke.py's phase-1d shapes with phase 1d's bounds (`held_bf16`:
every output within 1e-2 of its largest magnitude, at most 5% of the
entries beyond 1e-4 of it, 3e-4 for num), and runs each twice to see
whether it repeats its bits; then times both forwards and both backwards at
the dense pool's parse1m shape (B = 128 cells of G = 2,000 genes) and the
window pool's dentate window (B = 128 cells of S = 6,147 tokens) with CUDA
events, in turns (other, repo, repo, other) for each other version, ten
calls each, and prints each version's device time there by kernel (the
profiler, three calls). Compare versions only within one run: cards differ
between runs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EPS = 1e-8
E, H, Q = 32, 4, 16
SCALE = (E // H) ** -0.5


def by_kernel(fn, reps: int = 3) -> list:
    """(ms a call, launches a call, name) of the device kernels of `fn`, the
    largest first, from the profiler over `reps` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.device_time_total / reps / 1e3, e.count / reps, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0), reverse=True)


def bind(lib: ctypes.CDLL) -> bool:
    """Type the library's backward entries; whether it takes a workspace."""
    from scldm_torch.kernels import build

    try:
        lib.scldm_encoder_pool_workspace_floats
    except AttributeError:
        has_ws = False
    else:
        has_ws = True
    names = ["scldm_encoder_pool_forward", "scldm_window_pool_forward",
             "scldm_encoder_pool_backward", "scldm_window_pool_backward"]
    names += ["scldm_encoder_pool_workspace_floats"] if has_ws else []
    for name in names:
        argtypes, restype = build._SIGNATURES[name]
        if not has_ws and "backward" in name:
            argtypes = argtypes[:argtypes.index(ctypes.c_int) - 1] + argtypes[
                argtypes.index(ctypes.c_int):]  # no workspace pointer
        getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, restype
    return has_ws


def forward(lib, counts, src, qfull, w) -> dict:
    """One forward launch of `lib`: (num, den, m)."""
    import torch

    dense = counts is not None
    B, N = (counts.shape if dense else src.shape[:2])
    num = torch.empty(B, Q, E, device="cuda")
    den, m = torch.empty(B, Q * H, device="cuda"), torch.empty(B, Q * H, device="cuda")
    pre = [counts.data_ptr()] if dense else []
    entry = lib.scldm_encoder_pool_forward if dense else lib.scldm_window_pool_forward
    code = entry(*pre, src.data_ptr(), qfull.data_ptr(), *(t.data_ptr() for t in w), num.data_ptr(),
                 den.data_ptr(), m.data_ptr(), B, N, E, H, Q, EPS, SCALE,
                 torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"forward launch: CUDA error {code}")
    return {"num": num, "den": den, "m": m}


def backward(lib, has_ws: bool, counts, src, qfull, w, m, dnum, dden) -> dict:
    """One backward launch of `lib`: the gradients, with the wrapper's bf16
    rounding of the reduced qfull, wk and wv gradients."""
    import torch

    from scldm_torch.ops.fused_decoder import _bf

    dense = counts is not None
    B, N = (counts.shape if dense else src.shape[:2])
    new = torch.empty_like if has_ws else torch.zeros_like
    dsrc = new(src)
    grads = [new(t) for t in (qfull, *w)]
    extra = []
    if has_ws:
        ws = torch.empty(lib.scldm_encoder_pool_workspace_floats(B, N, int(dense)), device="cuda")
        extra = [ws.data_ptr()]
    pre = [counts.data_ptr()] if dense else []
    entry = lib.scldm_encoder_pool_backward if dense else lib.scldm_window_pool_backward
    code = entry(*pre, src.data_ptr(), qfull.data_ptr(), *(t.data_ptr() for t in w), m.data_ptr(),
                 dnum.data_ptr(), dden.data_ptr(), dsrc.data_ptr(), *(g.data_ptr() for g in grads),
                 *extra, B, N, E, H, Q, EPS, SCALE, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"backward launch: CUDA error {code}")
    dq, dln1g, dln1b, dwk, dwv = grads
    return {"dsrc": dsrc, "dqfull": _bf(dq), "dln1g": dln1g, "dln1b": dln1b, "dwk": _bf(dwk),
            "dwv": _bf(dwv)}


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_encoder_pool: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from scldm_torch.kernels import build
    from scldm_torch.ops import fused_encoder as fe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    repo = build.load()
    libs = {"repo": (repo, bind(repo))}
    srcs = {Path(a).stem: Path(a).resolve() for a in args}
    builds = {tag: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(src.parent), "-I",
         str(build.CSRC), "-o", str(build.BUILD_DIR / f"ab_{tag}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for tag, src in srcs.items()}
    for tag, proc in builds.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {srcs[tag]}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):  # registers and spills of the forward and backward
            if "Compiling entry function" in line and "pool_" in line and "sum" not in line:
                name = line.split("'")[1]
                print(f"{tag}: {name[-40:]}: " + " ".join(x.strip() for x in lines[i + 2:i + 4]),
                      flush=True)
        lib = ctypes.CDLL(str(build.BUILD_DIR / f"ab_{tag}.so"))
        libs[tag] = (lib, bind(lib))
    others = [tag for tag in libs if tag != "repo"]
    blocks = fe.build_query_operand(torch.ones(Q, E, device="cuda"), H) != 0

    g = torch.Generator(device="cuda").manual_seed(0)
    failed = False
    for variant, B, N in (("dense", 128, cs.PARSE_GENES), ("dense", 19, 300),
                          ("window", 128, cs.WINDOW), ("window", 19, 250)):
        dense = variant == "dense"
        src = torch.randn(*((N, E) if dense else (B, N, E)), generator=g, device="cuda")
        qfull = fe.build_query_operand(torch.randn(Q, E, generator=g, device="cuda"), H)
        w = [torch.randn(1, E, generator=g, device="cuda") * 0.3 + 1.0,
             torch.randn(1, E, generator=g, device="cuda") * 0.3,
             *(torch.randn(E, E, generator=g, device="cuda") * E**-0.5 for _ in range(2))]
        counts = (torch.poisson(torch.full((B, N), 3.0, device="cuda"), generator=g)
                  * (torch.rand(B, N, generator=g, device="cuda") < 0.6)) if dense else None
        dnum = torch.randn(B, Q, E, generator=g, device="cuda")
        dden = torch.randn(B, Q * H, generator=g, device="cuda")
        pre = (counts,) if dense else ()
        reference = fe.encoder_pool_reference if dense else fe.window_pool_reference
        reference_bwd = (fe.encoder_pool_backward_reference if dense
                         else fe.window_pool_backward_reference)
        num, den, m = reference(*pre, src, qfull, w, H, EPS)
        dsrc, dq, (dln1g, dln1b, dwk, dwv) = reference_bwd(*pre, src, qfull, w, m, dnum, dden, H,
                                                           EPS)
        want = {"forward": {"num": num, "den": den, "m": m},
                "backward": {"dsrc": dsrc, "dqfull": dq * blocks, "dln1g": dln1g,
                             "dln1b": dln1b, "dwk": dwk, "dwv": dwv}}
        calls = {
            "forward": {tag: (lambda lib=lib: forward(lib, counts, src, qfull, w))
                        for tag, (lib, _) in libs.items()},
            "backward": {tag: (lambda lib=lib, has_ws=has_ws: backward(
                lib, has_ws, counts, src, qfull, w, m, dnum, dden))
                for tag, (lib, has_ws) in libs.items()},
        }
        for part, call in calls.items():
            for tag in libs:
                got, again = call[tag](), call[tag]()
                torch.cuda.synchronize()
                report = []
                for k, v in want[part].items():
                    try:
                        worst = cs.held_bf16(f"{tag} {k}", got[k], v,
                                             cs.POOL_NUM_NEAR if k == "num" else 1e-4)
                        report.append(f"{k} {worst[1]:.1e} of max, {worst[2]:.1e} beyond")
                    except AssertionError as e:
                        failed = True
                        report.append(f"FAILED {e}")
                same = all(torch.equal(got[k], again[k]) for k in got)
                print(f"{tag} {variant} {part} B={B} N={N}: " + "; ".join(report)
                      + ("; repeats its bits" if same else "; other bits on a second run"),
                      flush=True)
                if tag == "repo" and not same:
                    failed = True
                del got, again
            if B == 128:
                for fn in call.values():
                    cs.cuda_ms(fn, 2)  # warm-up
                for other in others:
                    t = [cs.cuda_ms(call[tag], 10) for tag in (other, "repo", "repo", other)]
                    print(f"{variant} {part} at B={B} N={N}: {other} {(t[0] + t[3]) / 2:.4f} ms, "
                          f"repo {(t[1] + t[2]) / 2:.4f} ms (turns {[round(v, 4) for v in t]})",
                          flush=True)
                for tag in libs:
                    for ms, n, name in by_kernel(call[tag]):
                        print(f"  {tag} {variant} {part}: {ms:.4f} ms a call, {n:g} launches, "
                              f"{name[:90]}", flush=True)
        del src, want, dnum, counts, calls
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
