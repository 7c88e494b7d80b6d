"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled for Hopper (`sm_90a`) into one shared
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # pointers: x, c, wada, bada, wqkv, bqkv, wproj, bproj, w1, w2, wmlp, out
    "scldm_dit_block_forward": (
        [_P] * 12
        + [ctypes.c_int] * 5  # R, T, E, H, Hd
        + [ctypes.c_float, ctypes.c_longlong, _P],  # eps, smem_bytes, stream
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


def build() -> Path:
    """Compile the kernels if the current sources have no library yet, and
    return the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    report_path(out).write_text(proc.stdout + proc.stderr)
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
