#!/usr/bin/env python3
"""Two yardsticks for the swiglu_vec kernels' up projection, on one NVIDIA GPU.

    python3 benchmarks_torch/swiglu_floor.py

At the census decoder's shape (x: R = 16 x 36,601 rows by E = 512, w12:
512 by 2 x 1,408) it times, with CUDA events, three calls each:
- the port's tensor-core GEMM of the DiT kernels (`tiled::gemm<Out::kPlain>`
  of `scldm_torch/kernels/csrc/dit_tiled.cuh`: mma.sync with three TF32
  passes a product), built here into a library of its own: the floor a new
  tensor-core design of swiglu_vec has to beat;
- one `torch.matmul` of x @ w12 with TF32 on (one TF32 pass, cuBLAS): a rough
  ceiling for one pass on this card;
- the same in exact f32 (TF32 off), the plain version's product.
Each time is printed with its rate in TFLOP/s of f32 products (2 R E 2Hd
operations), beside the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include "dit_tiled.cuh"
extern "C" int floor_gemm(const float* a, const float* w, float* out, int M, int K, int N,
                          void* stream) {
  tiled::Gemm g{};
  g.a = a;
  g.w0 = w;
  g.out = out;
  g.M = M;
  g.K = K;
  g.N = N;
  g.T = 1;
  return (int)tiled::launch_gemm<tiled::Out::kPlain>(g, (cudaStream_t)stream);
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("swiglu_floor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from scldm_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, so = build.BUILD_DIR / "swiglu_floor.cu", build.BUILD_DIR / "swiglu_floor.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
                    str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.floor_gemm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.floor_gemm.restype = ctypes.c_int

    R, E, Hd = 16 * 36_601, 512, 1_408
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(R, E, generator=g, device="cuda")
    w12 = torch.randn(E, 2 * Hd, generator=g, device="cuda") * E**-0.5
    out = torch.empty(R, 2 * Hd, device="cuda")
    flops = 2 * R * E * 2 * Hd

    def tiled():
        code = lib.floor_gemm(x.data_ptr(), w12.data_ptr(), out.data_ptr(), R, E, 2 * Hd,
                              torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"tiled::gemm launch: CUDA error {code}")

    def matmul():
        torch.matmul(x, w12, out=out)

    tiled()
    torch.backends.cuda.matmul.allow_tf32 = False
    exact = x @ w12
    err = ((out - exact).abs().max() / exact.abs().max()).item()
    del exact
    rows = [("tiled::gemm<kPlain> (mma.sync, TF32 x3)", tiled, False),
            ("torch.matmul, TF32 on (one pass)", matmul, True),
            ("torch.matmul, exact f32", matmul, False)]
    for name, fn, tf32 in rows:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        fn()
        torch.cuda.synchronize()
        ms = cs.cuda_ms(fn, 3)
        print(f"{name} at R={R} E={E} N={2 * Hd}: {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s "
              "of f32 products", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tiled::gemm's largest error as a share of the product's largest: {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
