"""ctypes binding for the native C++ WAV module (native/pvwav.cpp).

Built with `make -C native` (plain g++, no pybind11). If the shared library
is absent the scipy fallback in io/wav.py takes over transparently.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_NAMES = ("libpvwav.so",)
_lib = None


def _find_lib() -> str | None:
    here = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(os.path.dirname(here))
    candidates = [
        os.path.join(repo_root, "native", name) for name in _LIB_NAMES
    ] + [os.path.join(here, name) for name in _LIB_NAMES]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.pvwav_read.restype = ctypes.c_int
    lib.pvwav_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pvwav_free.restype = None
    lib.pvwav_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.pvwav_write.restype = ctypes.c_int
    lib.pvwav_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array, sample_rate). 2-D if multichannel."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native pvwav library not built (run: make -C native)")
    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    channels = ctypes.c_int()
    sr = ctypes.c_int()
    rc = lib.pvwav_read(
        path.encode(), ctypes.byref(out), ctypes.byref(n_frames),
        ctypes.byref(channels), ctypes.byref(sr),
    )
    if rc != 0:
        raise IOError(f"pvwav_read({path!r}) failed with code {rc}")
    try:
        total = n_frames.value * channels.value
        data = np.ctypeslib.as_array(out, shape=(total,)).copy()
    finally:
        lib.pvwav_free(out)
    if channels.value > 1:
        data = data.reshape(n_frames.value, channels.value)
    return data, sr.value


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write float32 samples (1-D mono or 2-D interleaved) as PCM16."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native pvwav library not built (run: make -C native)")
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 1:
        n_frames, channels = data.shape[0], 1
    elif data.ndim == 2:
        n_frames, channels = data.shape
    else:
        raise ValueError("data must be 1-D or 2-D")
    rc = lib.pvwav_write(
        path.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_frames,
        channels,
        sample_rate,
    )
    if rc != 0:
        raise IOError(f"pvwav_write({path!r}) failed with code {rc}")
