"""Frozen configuration for the PyTorch/CUDA phase vocoder.

Mirrors phase_vocoder_tpu/config.py field for field, so a configuration
reads the same in both packages. The one difference is `fft_backend`:
"fused" (the hand-written CUDA kernels, the counterpart of the JAX
"pallas" backend) is the default, beside the JAX package's polar backends
"matmul" and "xla".
"""

from __future__ import annotations

import dataclasses
from typing import Literal, get_args

FFTBackend = Literal["fused", "matmul", "xla"]
PhaseMethod = Literal["wrapped_scan", "cumsum"]
OLAMethod = Literal["auto", "fold", "scatter"]


@dataclasses.dataclass(frozen=True)
class PvocConfig:
    """Static phase-vocoder parameters.

    Attributes:
      n_fft: FFT size N (frame length). Canonical: 1024.
      hop: analysis hop Ra in samples. Canonical: 256.
      sample_rate: audio sample rate in Hz (metadata only).
      fft_backend: "fused" — the CUDA kernels: the fused TSM kernel
        (ops/fused.py) where it covers the geometry, and the stft_polar /
        istft_ola kernels (ops/stft.py) on the branch-faithful polar route.
        "matmul" — the polar path with the DFT as FP32 matrix products;
        "xla" — the polar path with torch.fft (the JAX backend's name).
      phase_method: "wrapped_scan" (compensated wrapped scan, exact at any
        length) or "cumsum" (the literal prefix sum); the polar path reads it.
      ola_method: "auto"/"fold" or "scatter" overlap-add on the polar path.
      dtype: compute dtype; the kernels take float32 only.
    """

    n_fft: int = 1024
    hop: int = 256
    sample_rate: int = 16000
    fft_backend: FFTBackend = "fused"
    phase_method: PhaseMethod = "wrapped_scan"
    ola_method: OLAMethod = "auto"
    dtype: str = "float32"

    def __post_init__(self):
        if self.n_fft <= 0 or self.n_fft % 2 != 0:
            raise ValueError(f"n_fft must be positive and even, got {self.n_fft}")
        if not (0 < self.hop <= self.n_fft):
            raise ValueError(f"hop must be in (0, n_fft], got {self.hop}")
        if self.fft_backend not in get_args(FFTBackend):
            raise ValueError(f"unknown fft_backend {self.fft_backend!r}")
        if self.dtype != "float32":
            raise NotImplementedError(
                f"dtype={self.dtype!r}: the kernels take float32 only"
            )

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def synthesis_hop(self, stretch: float) -> int:
        """Rs = round(Ra * stretch); quantizes the ratio like the reference."""
        rs = int(round(self.hop * stretch))
        if rs <= 0:
            raise ValueError(f"stretch {stretch} gives non-positive synthesis hop")
        return rs
