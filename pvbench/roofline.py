"""The least time an H100 could take for a job: the yardstick of
`roofline_share`, frozen here so that a change to the program cannot move
it. The arithmetic is that of phase_vocoder_tpu_torch/utils/metrics.py.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s in
FP32 outside the tensor cores, at the card's full 700 W.

A time stretch reads its input once and writes its output once, 4 bytes a
sample in float32, and makes two real N-point transforms a frame
(analysis and synthesis), 2.5 N log2 N FP32 operations each. Whatever
implements the stretch moves at least those bytes or does at least those
operations, so the larger of the two times bounds it.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BYTES_PER_SAMPLE = 4


def fft_flop(n_fft: int) -> float:
    """FP32 operations of one real n_fft-point transform: 2.5 N log2 N."""
    return 2.5 * n_fft * math.log2(n_fft)


def frames(length: int, n_fft: int, hop: int) -> int:
    return 0 if length < n_fft else 1 + (length - n_fft) // hop


def stretch_work(in_samples: int, out_samples: int, n_fft: int, hop: int) -> tuple[float, float]:
    """(bytes, FP32 operations) the least implementation of one stretch of
    in_samples into out_samples needs."""
    moved = BYTES_PER_SAMPLE * (in_samples + out_samples)
    return float(moved), 2.0 * fft_flop(n_fft) * frames(in_samples, n_fft, hop)


def bound_s(bytes_moved: float, flop: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations", whichever binds)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flop / FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
