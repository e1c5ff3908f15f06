"""Build the CUDA kernels of csrc/ with nvcc and load them with ctypes.

The sources have a plain C interface and need only the CUDA toolkit. Each
csrc/*.cu compiles to an object file in its own nvcc process, all started
together, and one more nvcc call links them into
phase_vocoder_tpu_torch/build/libpvoc_kernels.so at first use. The library
is rebuilt when any file under csrc/ (sources and shared headers) or the
command changes (a sha256 stamp beside it). A missing nvcc or a failed
build raises with the compiler's output. Loading is the set-up span
pv.setup.library, a compile pv.setup.nvcc inside it.

Every call of a kernel entry goes through launch(), which makes the
tensors' device current, passes that device's current stream, times the
call as the span pv.launch:<wrapper>, raises on its return code and counts
it as launches.<wrapper> (utils/profiling.py). check_cuda() is the one
check of a kernel's tensor inputs.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libpvoc_kernels.so"
# The library links the shared CUDA runtime (libcudart.so.12): in a process
# that has imported torch, the loader binds it to the runtime torch already
# loaded, so the kernels launch through the runtime that torch.profiler
# traces. The rpath to the toolkit's lib64 serves any other process.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-cudart", "shared",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "pvoc_fused": [
        *[_P] * 11,  # buffers and tables
        _LL, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,  # geometry
        _P,  # stream
    ],
    "pvoc_fused_zrev": [
        *[_P] * 12,  # ... and the half table
        _LL, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
        _P,
    ],
    "pvoc_fused_segment": [
        *[_P] * 15,  # signal, outputs, state, scratch and tables
        _LL, _LL, _LL, _LL,  # n_valid, seg_frames, goff, nf_total
        _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,  # started, geometry
        _P,  # stream
    ],
    "pvoc_fused_batch": [
        *[_P] * 12,  # x, frame counts, out, scratch and tables
        _I, _LL, _LL,  # batch, x row stride, frames per row
        _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,  # geometry
        _P,  # stream
    ],
    "pvoc_terms": [
        *[_P] * 9,  # x, spec, mag, t, u, tot, carry, fft, consts
        _LL, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,  # geometry, scan
        _I, _LL,  # batch, x row stride
        _P,  # stream
    ],
    # mag, pre, pim, mask, y, frames, out, fft table, norm rows,
    # batch, nf, n_fft, rs, stream
    "pvoc_phasor_synth": [*[_P] * 9, _I, _LL, _I, _I, _P],
    "resample_lerp": [_P, _P, _LL, _LL, ctypes.c_double, _P],
    # x, start_int, start_frac, jo_int, jo_frac, out, n, out_len, stream
    "resample_blocked": [_P, _P, _P, _P, _P, _P, _LL, _LL, _P],
    # x, origin, bases, k, fr, out, n, nb, B, c, stream
    "select_lerp": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P],
    # x, fft table, mag, phi (re, im), nf, n_fft, hop, stream
    "stft_polar": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "stft_fused": [_P, _P, _P, _P, _LL, _I, _I, _P],
    # mag, psi, mask, fft table, frames, out, nf, n_fft, rs, stream
    "istft_ola": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    # a, b, mask, fft table, frames, nf, n_fft, polar, stream
    "istft_frames": [_P, _P, _P, _P, _P, _LL, _I, _I, _P],
    # phi, phi_prev, carry hi/lo, phi0, het hi/lo, psi, carry out, block
    # totals, F, nb, n_fft, rs mod n_fft, frame offset, offset mod n_fft,
    # n_valid, the host array of PhaseConsts, stream
    "segment_phase": [*[_P] * 10, _I, _I, _I, _I, _LL, _I, _I, _P, _P],
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


def _csrc_files(csrc: Path) -> list[Path]:
    """Every file under csrc/, sorted: the .cu sources and their headers."""
    return sorted(p for p in csrc.rglob("*") if p.is_file())


def _link_flags(nvcc: str) -> list[str]:
    """The link's own flags: an rpath to the toolkit's runtime."""
    lib64 = Path(nvcc).resolve().parent.parent / "lib64"
    return ["-Xlinker", f"-rpath,{lib64}"]


def _digest(csrc: Path, extra: tuple = ()) -> str:
    """sha256 of the nvcc flags (and `extra` ones) and of every file under
    csrc/ (path and bytes), so that editing a shared header also triggers
    a rebuild."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *extra]).encode())
    for f in _csrc_files(csrc):
        h.update(f.relative_to(csrc).as_posix().encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands as parallel processes; raise on the first failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def build() -> Path:
    """Compile csrc/*.cu into LIB_PATH unless the stamp says it is current."""
    nvcc = _nvcc()
    digest = _digest(CSRC, tuple(_link_flags(nvcc)))
    stamp = LIB_PATH.with_suffix(".so.sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    sources = [f for f in _csrc_files(CSRC) if f.suffix == ".cu"]
    # nvcc tells inputs apart by their extension: objects end in .o.
    objects = [BUILD_DIR / f"{src.stem}.{pid}.tmp.o" for src in sources]
    tmp = LIB_PATH.with_suffix(f".so.{pid}.tmp")
    try:
        with profiling.setup("nvcc"):
            _run_all([
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objects)
            ])
            _run_all([[nvcc, *NVCC_FLAGS, *_link_flags(nvcc), "-shared", "-o", str(tmp),
                       *map(str, objects)]])
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    stamp.write_text(digest)
    return LIB_PATH


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with profiling.setup("library"):
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


@functools.cache
def _launch_names(wrapper: str) -> tuple[str, str, str]:
    return "pv.launch:" + wrapper, "launches." + wrapper, "channels." + wrapper


def launch(wrapper: str, entry: str, device: int, *args) -> None:
    """entry(*args, stream), the library's entry of that name, on device
    `device` (the index of the tensors' card) and its current stream,
    which every entry takes as its last argument. The C call alone is the
    span pv.launch:<wrapper>; raise on its return code (check) and count
    one launch as launches.<wrapper>, keyed by the launching wrapper's
    name, and inside profiling.channels(n) the n channels it covers as
    channels.<wrapper>."""
    fn = getattr(kernels(), entry)
    span, counter, per_channel = _launch_names(wrapper)
    with _device_guard(device):
        stream = _current_stream(device)
        with profiling.span(span):
            check(fn(*args, stream), entry)
    profiling.count(counter)
    channels = profiling.launch_channels()
    if channels:
        profiling.count(per_channel, channels)


def check_cuda(what: str, *tensors: torch.Tensor, dtype: torch.dtype | None = None) -> None:
    """Raise ValueError unless every tensor is a contiguous CUDA tensor (of
    `dtype` when one is given): what a kernel entry reads through a bare
    pointer. `what` names the wrapper in the message."""
    for t in tensors:
        if not t.is_cuda:  # builds no torch.device: ~0.5 us a call less than t.device.type
            raise ValueError(f"{what}: unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: needs a contiguous tensor")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{what}: needs {dtype} tensors, got {t.dtype}")


def _current_stream(index: int) -> int:
    """The handle of device `index`'s current CUDA stream, as
    torch.cuda.current_stream(index).cuda_stream gives it, without building
    a Stream object (0.2 against 8 us of host time a call on the H100's
    machine)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _device_guard(index: int):
    """torch.cuda.device(index), or no guard when device `index` is already
    current (entering and leaving the guard costs ~4.5 us a call)."""
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)
