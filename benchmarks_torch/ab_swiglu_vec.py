#!/usr/bin/env python3
"""Two versions of the swiglu_vec kernels side by side, on one NVIDIA GPU.

    python3 benchmarks_torch/ab_swiglu_vec.py OTHER.cu

Builds the repo's kernels (`scldm_torch/kernels/csrc`) and OTHER.cu, another
version of `swiglu_vec.cu`, into two libraries (OTHER.cu with `-I
scldm_torch/kernels/csrc` and CUTLASS's headers, so that a copy of an earlier
version, put anywhere, finds the headers it includes); OTHER.cu's C entries
take x and w12 as the repo's do (with their row pitches, in the kernels'
layout) or, where its source says so, as bare pointers (earlier versions);
holds both against the plain version (`ops/fused_swiglu.swiglu_vec_reference`
and its autograd backward) at ragged shapes and at the census decoder's rows
(R = 16 x 36,601, E = 512, Hd = 1,408), printing each output's largest error
as a share of the reference's largest magnitude; then times the forward and
the backward of both at the census shape with CUDA events, in turns (other,
repo, repo, other), three calls each. Compare two versions only within one
run: cards differ between runs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1_001, 512, 1_408), (300, 200, 100), (777, 30, 70), (40_000, 64, 100),
          (16 * 36_601, 512, 1_408))


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_swiglu_vec: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from scldm_torch.kernels import build
    from scldm_torch.ops import fused_swiglu as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    repo = build.load()
    other_so = build.BUILD_DIR / "ab_other_swiglu_vec.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-I",
                    "/usr/local/cutlass/include", "-o", str(other_so), args[0]],
                   check=True, capture_output=True)
    other = ctypes.CDLL(str(other_so))
    pitched = {repo: True, other: "int ldx" in Path(args[0]).read_text()}
    _P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (argtypes, restype) in build._SIGNATURES.items():
        if name.startswith("scldm_swiglu_vec"):
            if not pitched[other] and name != "scldm_swiglu_vec_workspace_floats":
                n_ptr = 4 if name.endswith("forward") else 8
                argtypes = [_P] * n_ptr + [_L, _I, _I, _P]
            getattr(other, name).argtypes, getattr(other, name).restype = argtypes, restype

    def operands(lib, x, w12, hd):
        """x and w12 as the library takes them: pointers, with their pitches
        where it takes those."""
        if not pitched[lib]:
            return (x.data_ptr(), w12.data_ptr()), (x, w12)
        (xk, ldx), (wk, ldw) = fs._tma_operand(x), fs._vec_weights(w12, hd)
        return (xk.data_ptr(), ldx, wk.data_ptr(), ldw), (xk, wk)

    def forward(lib, x, w12, wv, ds):
        R, E = x.shape
        out = torch.empty(R, 1, device="cuda")
        ptrs, _keep = operands(lib, x, w12, wv.shape[0])
        code = lib.scldm_swiglu_vec_forward(*ptrs, wv.data_ptr(), out.data_ptr(), R, E,
                                            wv.shape[0], torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"forward launch: CUDA error {code}")
        return out

    def backward(lib, x, w12, wv, ds):
        (R, E), hd = x.shape, wv.shape[0]
        dx, dw12, dwv = torch.empty_like(x), torch.empty_like(w12), torch.empty_like(wv)
        ws = torch.empty(lib.scldm_swiglu_vec_workspace_floats(R, E, hd), device="cuda")
        ptrs, _keep = operands(lib, x, w12, hd)
        code = lib.scldm_swiglu_vec_backward(
            *ptrs, wv.data_ptr(), ds.data_ptr(), dx.data_ptr(), dw12.data_ptr(), dwv.data_ptr(),
            ws.data_ptr(), R, E, hd, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"backward launch: CUDA error {code}")
        return dx, dw12, dwv

    g = torch.Generator(device="cuda").manual_seed(0)
    for R, E, hd in SHAPES:
        x = torch.randn(R, E, generator=g, device="cuda")
        w12 = torch.randn(E, 2 * hd, generator=g, device="cuda") * E**-0.5
        wv = torch.randn(hd, 1, generator=g, device="cuda") * hd**-0.5
        ds = torch.randn(R, 1, generator=g, device="cuda")
        want = [fs.swiglu_vec_reference(x, w12, wv),
                *fs.swiglu_vec_backward_reference(x, w12, wv, ds)]
        for tag, lib in (("repo", repo), ("other", other)):
            got = [forward(lib, x, w12, wv, ds), *backward(lib, x, w12, wv, ds)]
            torch.cuda.synchronize()
            errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
            print(f"{tag} R={R} E={E} Hd={hd}: out, dx, dw12, dwv errors as shares of their "
                  f"largest {[f'{e:.2e}' for e in errs]}", flush=True)
        del want, got
        if R < 100_000:
            continue
        for part, fn in (("forward", forward), ("backward", backward)):
            t = [cs.cuda_ms(lambda: fn(lib, x, w12, wv, ds), 3)
                 for lib in (other, repo, repo, other)]
            print(f"{part} at R={R}: other {(t[0] + t[3]) / 2:.4f} ms, repo "
                  f"{(t[1] + t[2]) / 2:.4f} ms (turns {[round(v, 4) for v in t]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
