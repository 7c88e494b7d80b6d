"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`), one `nvcc` per
source, all started together, and the objects are linked into one shared
library with a plain C interface, on first use, into `_build/` beside this
file (listed in `.gitignore`). The library's name carries a hash of the
sources and flags, so an edited source builds anew; the ptxas report
(registers, shared memory and spills per kernel) is kept beside it. Nothing
here runs at import time: the CPU-only tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # pointers: x, c, wada, bada, wqkv, bqkv, wproj, bproj, w1, w2, wmlp, out,
    # workspace
    "scldm_dit_block_forward": (
        [_P] * 13
        + [ctypes.c_int] * 5  # R, T, E, H, Hd
        + [ctypes.c_float, _P],  # eps, stream
        ctypes.c_int,
    ),
    # pointers: x, c, the nine (in, out) weights, the six (out, in) matrices,
    # dy, dx, dc, dwada_t, dbada, dwqkv_t, dbqkv, dwproj_t, dbproj, dw12_t,
    # dwmlp_t, workspace
    "scldm_dit_block_backward": (
        [_P] * 29
        + [ctypes.c_int] * 5  # R, T, E, H, Hd
        + [ctypes.c_float, _P],  # eps, stream
        ctypes.c_int,
    ),
    "scldm_dit_block_backward_workspace_floats": (
        [ctypes.c_int] * 5, ctypes.c_longlong,  # R, T, E, H, Hd
    ),
    # pointers: qp, q, kfull, vproj, ln2g, ln2b, w12, wv, wmu, bmu, out
    "scldm_decoder_tail_forward": (
        [_P] * 11
        + [ctypes.c_int] * 6  # B, G, E, H, M, Hd
        + [ctypes.c_float, ctypes.c_float, _P],  # eps, scale, stream
        ctypes.c_int,
    ),
    # pointers: qp, q, kfull, vproj, ln2g, ln2b, w12, wv, wmu, dy, then qq (dqp | dq),
    # dkfull, dvproj, wvec (dw12 | dln2g | dln2b | dwmu | dwv | dbmu), workspace
    "scldm_decoder_tail_backward": (
        [_P] * 15
        + [ctypes.c_int] * 6  # B, G, E, H, M, Hd
        + [ctypes.c_float, ctypes.c_float, _P],  # eps, scale, stream
        ctypes.c_int,
    ),
    "scldm_decoder_tail_backward_workspace_floats": (
        [ctypes.c_int] * 3, ctypes.c_longlong,  # B, G, Hd
    ),
    "scldm_decoder_tail_gen_takes": ([ctypes.c_int] * 4, ctypes.c_int),  # E, H, M, Hd
    "scldm_decoder_tail_gen_workspace_floats": (  # B, G, E, H, M, Hd, backward
        [ctypes.c_int] * 7, ctypes.c_longlong,
    ),
    # scldm_decoder_tail_forward's pointers, then the workspace
    "scldm_decoder_tail_gen_forward": (
        [_P] * 12
        + [ctypes.c_int] * 6  # B, G, E, H, M, Hd
        + [ctypes.c_float, ctypes.c_float, _P],  # eps, scale, stream
        ctypes.c_int,
    ),
    # scldm_decoder_tail_backward's pointers (the workspace last)
    "scldm_decoder_tail_gen_backward": (
        [_P] * 15
        + [ctypes.c_int] * 6  # B, G, E, H, M, Hd
        + [ctypes.c_float, ctypes.c_float, _P],  # eps, scale, stream
        ctypes.c_int,
    ),
    # pointers: counts, table, qfull, ln1g, ln1b, wk, wv, num, den, m
    "scldm_encoder_pool_forward": (
        [_P] * 10
        + [ctypes.c_int] * 5  # B, G, E, H, Q
        + [ctypes.c_float, ctypes.c_float, _P],  # eps, scale, stream
        ctypes.c_int,
    ),
    # pointers: emb, qfull, ln1g, ln1b, wk, wv, num, den, m
    "scldm_window_pool_forward": (
        [_P] * 9
        + [ctypes.c_int] * 5  # B, S, E, H, Q
        + [ctypes.c_float, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    # pointers: counts, table, qfull, the four weights, m, dnum, dden, then
    # dtable, dqfull, dln1g, dln1b, dwk, dwv, workspace
    "scldm_encoder_pool_backward": (
        [_P] * 17
        + [ctypes.c_int] * 5  # B, G, E, H, Q
        + [ctypes.c_float, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    # pointers: emb, qfull, the four weights, m, dnum, dden, then demb,
    # dqfull, dln1g, dln1b, dwk, dwv, workspace
    "scldm_window_pool_backward": (
        [_P] * 16
        + [ctypes.c_int] * 5  # B, S, E, H, Q
        + [ctypes.c_float, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "scldm_encoder_pool_workspace_floats": (
        [ctypes.c_int] * 3, ctypes.c_longlong,  # B, N, dense
    ),
    "scldm_encoder_pool_forward_rows": ([ctypes.c_int], ctypes.c_longlong),  # N
    "scldm_encoder_pool_gen_takes": ([ctypes.c_int] * 3, ctypes.c_int),  # E, H, Q
    "scldm_encoder_pool_gen_workspace_floats": (  # B, N, E, H, Q, dense, backward
        [ctypes.c_int] * 7, ctypes.c_longlong,
    ),
    # the forwards' pointers as the narrow entries', then the workspace
    "scldm_encoder_pool_gen_forward": (
        [_P] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float, _P], ctypes.c_int,
    ),
    "scldm_window_pool_gen_forward": (
        [_P] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float, _P], ctypes.c_int,
    ),
    # the backwards' pointers as the narrow entries' (the workspace last)
    "scldm_encoder_pool_gen_backward": (
        [_P] * 17 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float, _P], ctypes.c_int,
    ),
    "scldm_window_pool_gen_backward": (
        [_P] * 16 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float, _P], ctypes.c_int,
    ),
    # pointers: emb, qfull, ln1g, ln1b, wk, wv, num, den, m, workspace
    "scldm_window_pool_wide_forward": (
        [_P] * 10
        + [ctypes.c_int] * 5  # B, S, E, H, Q
        + [ctypes.c_float, ctypes.c_float, _P],  # eps, scale, stream
        ctypes.c_int,
    ),
    # pointers: emb, qfull, the four weights, m, dnum, dden, then demb, dqfull,
    # dln (2, E), dw (E, 2E), workspace
    "scldm_window_pool_wide_backward": (
        [_P] * 14
        + [ctypes.c_int] * 5  # B, S, E, H, Q
        + [ctypes.c_float, ctypes.c_float, _P],
        ctypes.c_int,
    ),
    "scldm_window_pool_wide_workspace_floats": (
        [ctypes.c_int] * 6, ctypes.c_longlong,  # B, S, E, H, Q, backward
    ),
    # x and w12 with their row pitches (multiples of 4 floats): x, ldx, w12,
    # ldw, then the pointers wv, out
    "scldm_swiglu_vec_forward": (
        [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 2
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],  # R, E, Hd, stream
        ctypes.c_int,
    ),
    # x, ldx, w12, ldw, then the pointers wv, ds, dx, dw12, dwv, workspace
    "scldm_swiglu_vec_backward": (
        [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 6
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],  # R, E, Hd, stream
        ctypes.c_int,
    ),
    "scldm_swiglu_vec_workspace_floats": (
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int], ctypes.c_longlong,  # R, E, Hd
    ),
    # the bf16 entries: x, w12 and wv bf16, pitches multiples of 8 values;
    # out, ds, dw12, dwv and the workspace f32, dx bf16
    "scldm_swiglu_vec_bf16_forward": (
        [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 2
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],  # R, E, Hd, stream
        ctypes.c_int,
    ),
    "scldm_swiglu_vec_bf16_backward": (
        [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 6
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],  # R, E, Hd, stream
        ctypes.c_int,
    ),
    "scldm_swiglu_vec_bf16_workspace_floats": (
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int], ctypes.c_longlong,  # R, E, Hd
    ),
    # x, ldx, w12, ldw, out
    "scldm_swiglu_gate_forward": (
        [_P, ctypes.c_int, _P, ctypes.c_int, _P]
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],  # R, E, Hd, stream
        ctypes.c_int,
    ),
    # x, ldx, w12, ldw, then the pointers dg, dx, dw12, workspace
    "scldm_swiglu_gate_backward": (
        [_P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],  # R, E, Hd, stream
        ctypes.c_int,
    ),
    "scldm_swiglu_gate_workspace_floats": (
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int], ctypes.c_longlong,  # R, E, Hd
    ),
    # pointers: qp, k, v, y, workspace
    "scldm_flash_cross_forward": (
        [_P] * 5 + [ctypes.c_int] * 5 + [_P],  # G, B, M, E, H, stream
        ctypes.c_int,
    ),
    # pointers: x, the array of 9 * L weight pointers, out, xs (None: no save)
    "scldm_fused_trunk_forward": (
        [_P] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, _P],  # R, T, E, H, Hd, L; eps, stream
        ctypes.c_int,
    ),
    # pointers: xs, the array of 9 * L weight pointers, dy, dx, dw, workspace
    "scldm_fused_trunk_backward": (
        [_P] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, _P],  # R, T, E, H, Hd, L; eps, stream
        ctypes.c_int,
    ),
    "scldm_fused_trunk_smem_bytes": (  # T, E, H, Hd, backward
        [ctypes.c_int] * 5, ctypes.c_longlong,
    ),
    "scldm_fused_trunk_workspace_floats": (  # R, T, E, Hd, L
        [ctypes.c_int] * 5, ctypes.c_longlong,
    ),
    # pointers: q, k, v, out
    "scldm_flash_attention_forward": (
        [_P] * 4
        + [ctypes.c_int] * 5  # B, M, S, H, D
        + [ctypes.c_longlong] * 9  # the strides of q, k and v: cell, token, head
        + [ctypes.c_int, _P],  # bf16, stream
        ctypes.c_int,
    ),
    "scldm_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libscldm_kernels_{h.hexdigest()[:16]}.so"


def report_path(library: Path) -> Path:
    """The ptxas report written when `library` was built."""
    return library.with_suffix(".ptxas.txt")


def _run_nvcc(cmds: list[list[str]]) -> str:
    """Run the nvcc commands all at once and wait for every one; return their
    joined output, or raise with the output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}"
              for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build() -> Path:
    """Compile the kernels if the current sources have no library yet, and
    return the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc, srcs = _nvcc(), _sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    try:
        report = _run_nvcc([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                            for src, obj in zip(srcs, objs)])
        _run_nvcc([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    report_path(out).write_text(report)
    os.replace(tmp, out)  # the library last: where it exists, so does its report
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.scldm_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
