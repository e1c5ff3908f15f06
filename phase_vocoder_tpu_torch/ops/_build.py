"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

The sources have a plain C interface and need only the CUDA toolkit, so
one nvcc call builds them in seconds. The library goes to
phase_vocoder_tpu_torch/build/libpvoc_kernels.so at first use and is
rebuilt when a source, or the command, changes (a sha256 stamp beside it).
A missing nvcc or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libpvoc_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "pvoc_fused": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # buffers and tables
        _LL, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,  # geometry
        _P,  # stream
    ],
    "resample_lerp": [_P, _P, _LL, _LL, ctypes.c_double, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "need the CUDA toolkit to build"
        )
    return path


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu into LIB_PATH unless the stamp says it is current."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(sources)
    stamp = LIB_PATH.with_suffix(".so.sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return LIB_PATH


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pvoc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pvoc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry returned a non-zero cudaError_t."""
    if rc != 0:
        msg = kernels().pvoc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
