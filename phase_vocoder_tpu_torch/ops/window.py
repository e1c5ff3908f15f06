"""Window functions (counterpart of phase_vocoder_tpu/ops/window.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _hann_f64(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / n)


@functools.lru_cache(maxsize=32)
def _hann_cached(n: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_hann_f64(n), dtype=dtype, device=device)


def hann_window(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window: w[i] = 0.5 - 0.5*cos(2*pi*i/n), i in [0, n).

    Built in float64 on the host and then cast, so the near-zero edge taps
    keep full relative precision (OLA normalization divides by their
    squares). Cached per (n, device, dtype), so a loop on the card copies
    it from the host once; callers must not modify it in place.
    """
    return _hann_cached(n, str(torch.device(device or "cpu")), dtype)
