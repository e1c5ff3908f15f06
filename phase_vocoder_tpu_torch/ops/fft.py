"""FFT dispatch for the polar path (counterpart of phase_vocoder_tpu/ops/fft.py).

Two interchangeable backends, both returning/consuming (real, imag) pairs:

  * "xla": torch.fft.rfft / irfft (the name is the JAX package's, where
    this backend is XLA's FFT op).
  * "matmul": the DFT as two real matrix products against cos/sin
    matrices built in float64 and cast to float32 (bitwise the JAX
    package's matrices), with the Hann window optionally folded in.

The products go to torch.matmul, as the JAX package leaves them to XLA
outside any kernel, and must run in full FP32: TF32 keeps ~10 mantissa
bits and breaks the 1e-4 golden gate. Each product checks that
torch.get_float32_matmul_precision() is "highest" (PyTorch's default,
under which cuBLAS uses no TF32) and raises otherwise.

The inverse matmul reproduces numpy irfft semantics: imaginary parts of
bins 0 and N/2 are dropped (their sin rows are zero).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["rfft", "irfft"]


@functools.lru_cache(maxsize=16)
def _dft_matrices(n_fft: int, window: bool) -> tuple[np.ndarray, np.ndarray]:
    """Forward DFT matrices Fc, Fs of shape (n_fft, n_bins), float32.

    re = frames @ Fc ; im = frames @ Fs  (equals rfft(frames * w) when
    window=True, rfft(frames) otherwise). Built in float64, cast to float32.
    """
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    t = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft  # (n_fft, n_bins)
    fc = np.cos(ang)
    fs = -np.sin(ang)
    if window:
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / n_fft)  # periodic Hann
        fc *= w[:, None]
        fs *= w[:, None]
    return fc.astype(np.float32), fs.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _idft_matrices(n_fft: int, window: bool) -> tuple[np.ndarray, np.ndarray]:
    """Inverse matrices Ic, Is of shape (n_bins, n_fft), float32.

    x = re @ Ic + im @ Is  (equals irfft(re + 1j*im) * w when window=True).
    Bin weights: w_0 = w_{N/2} = 1, else 2 (hermitian fold), all / N.
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)
    t = np.arange(n_fft, dtype=np.float64)
    wk = np.full(n_bins, 2.0)
    wk[0] = 1.0
    if n_fft % 2 == 0:
        wk[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(k, t) / n_fft  # (n_bins, n_fft)
    ic = (wk[:, None] / n_fft) * np.cos(ang)
    is_ = -(wk[:, None] / n_fft) * np.sin(ang)
    if window:
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / n_fft)
        ic *= w[None, :]
        is_ *= w[None, :]
    return ic.astype(np.float32), is_.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_matrices(kind: str, n_fft: int, window: bool, device: str):
    build = _dft_matrices if kind == "dft" else _idft_matrices
    return tuple(torch.as_tensor(m, device=device) for m in build(n_fft, window))


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full FP32 (no TF32: see the module docstring)."""
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            f"float32 matmul precision is {precision!r}: the DFT products "
            "need full FP32, torch.set_float32_matmul_precision('highest')"
        )
    return torch.matmul(a, b)


def rfft(
    frames: torch.Tensor, backend: str = "matmul", fused_window: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched real FFT over the last axis. Returns (re, im), each (..., n_bins).

    With fused_window=True (matmul backend only) the periodic Hann analysis
    window is folded into the DFT matrices and `frames` must be unwindowed.
    """
    n_fft = frames.shape[-1]
    if backend == "xla":
        if fused_window:
            raise ValueError("fused_window requires the matmul backend")
        x = torch.fft.rfft(frames, dim=-1)
        return x.real.contiguous(), x.imag.contiguous()
    if backend == "matmul":
        fc, fs = _device_matrices("dft", n_fft, fused_window, str(frames.device))
        return _matmul_fp32(frames, fc), _matmul_fp32(frames, fs)
    raise ValueError(f"unknown fft backend {backend!r}")


def irfft(
    re: torch.Tensor,
    im: torch.Tensor,
    n_fft: int,
    backend: str = "matmul",
    fused_window: bool = False,
) -> torch.Tensor:
    """Batched inverse real FFT. Returns (..., n_fft) real frames.

    With fused_window=True (matmul backend only) the synthesis Hann window is
    folded in: output equals irfft(Y) * w.
    """
    if backend == "xla":
        if fused_window:
            raise ValueError("fused_window requires the matmul backend")
        return torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1)
    if backend == "matmul":
        ic, is_ = _device_matrices("idft", n_fft, fused_window, str(re.device))
        return _matmul_fp32(re, ic) + _matmul_fp32(im, is_)
    raise ValueError(f"unknown fft backend {backend!r}")
