"""Frozen configuration for the PyTorch/CUDA phase vocoder.

Mirrors phase_vocoder_tpu/config.py field for field, so a configuration
reads the same in both packages. The one difference is `fft_backend`: the
port has a single route, "fused" (the hand-written CUDA kernel of
ops/fused.py, the counterpart of the JAX "pallas" route), and it is the
default.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

FFTBackend = Literal["fused"]
PhaseMethod = Literal["wrapped_scan", "cumsum"]
OLAMethod = Literal["auto", "fold", "scatter"]

# JAX backends whose polar-path executors the port does not have yet.
_UNPORTED_BACKENDS = ("matmul", "xla")


@dataclasses.dataclass(frozen=True)
class PvocConfig:
    """Static phase-vocoder parameters.

    Attributes:
      n_fft: FFT size N (frame length). Canonical: 1024.
      hop: analysis hop Ra in samples. Canonical: 256.
      sample_rate: audio sample rate in Hz (metadata only).
      fft_backend: "fused" — the whole TSM in the fused CUDA kernel
        (ops/fused.py). "matmul" and "xla" name the JAX package's polar
        path and raise NotImplementedError until it is ported.
      phase_method, ola_method: the JAX package's polar-path options, kept
        so configurations carry across; the fused route does not read them.
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
        if self.fft_backend in _UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"fft_backend={self.fft_backend!r} is the polar path, not "
                "ported yet (ROADMAP queue 1 item 6); use 'fused'"
            )
        if self.fft_backend != "fused":
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
