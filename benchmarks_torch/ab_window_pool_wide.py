#!/usr/bin/env python3
"""Two versions of the wide window-pool kernels side by side, on one NVIDIA GPU.

    python3 benchmarks_torch/ab_window_pool_wide.py OTHER.cu

Builds the repo's kernels (`scldm_torch/kernels/csrc`) and OTHER.cu, another
version of `window_pool_wide.cu`, into two libraries (OTHER.cu with `-I` its
own directory, then the repo's csrc directory, so that an earlier version
finds the headers it includes where they sit beside it: for the parent
commit, `git show HEAD~1:scldm_torch/kernels/csrc/window_pool_wide.cu` and the
headers it names, into a gitignored directory such as `chip_checkout/`). The
two libraries' C entries take the same arguments; each sizes its own
workspace (`scldm_window_pool_wide_workspace_floats`, 0 for a shape it does
not take, which is then skipped). Holds both against the plain version
(`ops/fused_encoder.window_pool_reference` and its autograd backward,
evaluated in f64, as chip_smoke.py holds them; the backwards given its m) at
chip_smoke.py's phase-1d shapes with phase 1d's bounds (`held_bf16`, num
within 3e-4 and dln1g within 1e-3 of their largest on all but 5% of the
entries), then times the forward and the backward of both at the census
window (B = 16 cells of S = 4,096 tokens, E = 512, 8 heads, 64 inducing
points) with CUDA events, in turns (other, repo, repo, other), ten calls
each, and prints the repo version's device time there by kernel (the
profiler, three calls). Last, a rough ceiling for the pool's k/v projection
at that window: `torch.matmul` of bf(x2) (65,536 x 512) against [wk | wv]
(512 x 1,024), bf16, with a bf16 output and, where this PyTorch takes
`out_dtype`, an f32 one (the pool keeps f32 sums), with CUDA events; used
nowhere in the port. Compare two versions only within one run: cards differ
between runs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENTRIES = ("scldm_window_pool_wide_forward", "scldm_window_pool_wide_backward",
           "scldm_window_pool_wide_workspace_floats")
EPS = 1e-8


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


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_window_pool_wide: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from scldm_torch.kernels import build
    from scldm_torch.ops import fused_encoder as fe
    from scldm_torch.ops.fused_decoder import _bf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    repo = build.load()
    other_src = Path(args[0]).resolve()
    other_so = build.BUILD_DIR / "ab_other_window_pool_wide.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(other_src.parent),
                    "-I", str(build.CSRC), "-o", str(other_so), str(other_src)],
                   check=True, capture_output=True)
    other = ctypes.CDLL(str(other_so))
    for name in ENTRIES:
        argtypes, restype = build._SIGNATURES[name]
        getattr(other, name).argtypes, getattr(other, name).restype = argtypes, restype

    def forward(lib, emb, qfull, w, H):
        (B, S, E), Q = emb.shape, qfull.shape[0] // H
        num = torch.empty(B, Q, E, device="cuda")
        den, m = (torch.empty(B, Q * H, device="cuda") for _ in range(2))
        ws = torch.empty(lib.scldm_window_pool_wide_workspace_floats(B, S, E, H, Q, 0),
                         device="cuda")
        code = lib.scldm_window_pool_wide_forward(
            emb.data_ptr(), qfull.data_ptr(), *(t.data_ptr() for t in w), num.data_ptr(),
            den.data_ptr(), m.data_ptr(), ws.data_ptr(), B, S, E, H, Q, EPS, 64**-0.5,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"forward launch: CUDA error {code}")
        return {"num": num, "den": den, "m": m}

    def backward(lib, emb, qfull, w, m, dnum, dden, H):
        (B, S, E), Q = emb.shape, qfull.shape[0] // H
        demb, dq = torch.empty_like(emb), torch.zeros_like(qfull)
        dln, dw = torch.empty(2, E, device="cuda"), torch.empty(E, 2 * E, device="cuda")
        ws = torch.empty(lib.scldm_window_pool_wide_workspace_floats(B, S, E, H, Q, 1),
                         device="cuda")
        code = lib.scldm_window_pool_wide_backward(
            emb.data_ptr(), qfull.data_ptr(), *(t.data_ptr() for t in w), m.data_ptr(),
            dnum.data_ptr(), dden.data_ptr(), demb.data_ptr(), dq.data_ptr(), dln.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), B, S, E, H, Q, EPS, 64**-0.5,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"backward launch: CUDA error {code}")
        # the wrapper's rounding of the reduced qfull, wk and wv gradients
        return {"demb": demb, "dqfull": _bf(dq), "dln1g": dln[:1], "dln1b": dln[1:],
                "dwk": _bf(dw[:, :E]), "dwv": _bf(dw[:, E:])}

    near = {"num": cs.POOL_NUM_NEAR, "dln1g": cs.POOL_LN_GAIN_NEAR}
    g = torch.Generator(device="cuda").manual_seed(0)
    failed = False
    for B, S, E, H, Q in cs.WIDE_POOL_CASES:
        emb = torch.randn(B, S, E, generator=g, device="cuda")
        qfull = fe.build_query_operand(torch.randn(Q, E, generator=g, device="cuda"), H)
        w = [torch.randn(1, E, generator=g, device="cuda") * 0.3 + 1.0,
             torch.randn(1, E, generator=g, device="cuda") * 0.3,
             *(torch.randn(E, E, generator=g, device="cuda") * E**-0.5 for _ in range(2))]
        dnum = torch.randn(B, Q, E, generator=g, device="cuda")
        dden = torch.randn(B, Q * H, generator=g, device="cuda")
        # the yardstick, and the m the kernels' backward is given
        w64 = [t.double() for t in w]
        num, den, m = fe.window_pool_reference(emb.double(), qfull.double(), w64, H, EPS)
        demb, dq, (dln1g, dln1b, dwk, dwv) = fe.window_pool_backward_reference(
            emb.double(), qfull.double(), w64, m, dnum.double(), dden.double(), H, EPS)
        m = m.float()
        blocks = fe.build_query_operand(torch.ones(Q, E, device="cuda"), H) != 0
        want = {"num": num, "den": den, "m": m, "demb": demb, "dqfull": dq * blocks,
                "dln1g": dln1g, "dln1b": dln1b, "dwk": dwk, "dwv": dwv}
        for tag, lib in (("repo", repo), ("other", other)):
            if lib.scldm_window_pool_wide_workspace_floats(B, S, E, H, Q, 1) == 0:
                print(f"{tag} B={B} S={S} E={E} H={H} Q={Q}: not taken", flush=True)
                continue
            got = forward(lib, emb, qfull, w, H)
            got.update(backward(lib, emb, qfull, w, m, dnum, dden, H))
            torch.cuda.synchronize()
            report = []
            for k, v in want.items():
                try:
                    worst = cs.held_bf16(f"{tag} {k}", got[k], v, near.get(k, 1e-4))
                    report.append(f"{k} {worst[1]:.1e} of max, {worst[2]:.1e} beyond")
                except AssertionError as e:
                    failed = True
                    report.append(f"FAILED {e}")
            print(f"{tag} B={B} S={S} E={E} H={H} Q={Q}: " + "; ".join(report), flush=True)
            del got
        if (B, S) == (cs.CENSUS_BATCH, cs.CENSUS_WINDOW):
            for part, fn in (("forward", lambda lib: forward(lib, emb, qfull, w, H)),
                             ("backward", lambda lib: backward(lib, emb, qfull, w, m, dnum, dden,
                                                               H))):
                for lib in (other, repo):
                    cs.cuda_ms(lambda: fn(lib), 2)  # warm-up
                t = [cs.cuda_ms(lambda: fn(lib), 10) for lib in (other, repo, repo, other)]
                print(f"{part} at B={B} S={S} E={E} H={H} Q={Q}: other {(t[0] + t[3]) / 2:.4f} ms, "
                      f"repo {(t[1] + t[2]) / 2:.4f} ms (turns {[round(v, 4) for v in t]})",
                      flush=True)
                for ms, n, name in by_kernel(lambda: fn(repo)):
                    print(f"  repo {part}: {ms:.4f} ms a call, {n:g} launches, {name[:90]}",
                          flush=True)
        del emb, want, dnum
        torch.cuda.empty_cache()
    projection_floor(cs.CENSUS_BATCH * cs.CENSUS_WINDOW, 512)
    return 1 if failed else 0


def projection_floor(N: int, E: int) -> None:
    """Prints the time of `torch.matmul` of (N, E) against (E, 2E), bf16,
    with a bf16 output and, where this PyTorch takes `out_dtype`, an f32 one,
    and its rate against the card's 989 TFLOP/s bf16 peak: three calls after
    a warm-up, twice."""
    import torch

    import chip_smoke as cs

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(N, E, generator=g, device="cuda").bfloat16()
    w = (torch.randn(E, 2 * E, generator=g, device="cuda") * E**-0.5).bfloat16()
    calls = {"bf16 out": lambda: torch.matmul(x, w)}
    try:
        torch.mm(x, w, out_dtype=torch.float32)
        calls["f32 out"] = lambda: torch.mm(x, w, out_dtype=torch.float32)
    except TypeError:
        print("floor: this PyTorch's torch.mm takes no out_dtype: bf16 output only", flush=True)
    flops = 2 * N * E * 2 * E
    for name, fn in calls.items():
        fn()
        times = [cs.cuda_ms(fn, 3) for _ in range(2)]
        print(f"floor: torch.matmul ({N} x {E}) @ ({E} x {2 * E}) {name}: "
              f"{[round(t, 4) for t in times]} ms a call, {flops / min(times) / 1e9:.1f} TFLOP/s "
              f"({flops / min(times) / 1e9 / cs.BF16_FLOPS * 1e12:.1%} of the bf16 peak)",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
