"""Metrics (counterpart of phase_vocoder_tpu/utils/metrics.py): the
audio-seconds-per-second figure, one-JSON-line metric records, a stage
timer and the H100 rooflines.

The rooflines are the least time one H100 SXM could take for the work
(NVIDIA's data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s in FP32 outside the
tensor cores). bound_ms holds one kernel call to them; the *_audio_s
functions state them per audio-second of a whole call, counted the same
way, so that the bench and the kernel table agree.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


@dataclass
class Timer:
    """Wall-clock stage timer: with Timer() as t: ... ; t.seconds."""

    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


def audio_seconds_per_second(
    n_samples: int, sample_rate: int, wall_seconds: float
) -> float:
    return (n_samples / sample_rate) / max(wall_seconds, 1e-12)


def fft_flop(n_fft: int) -> float:
    """FP32 operations of one real n_fft-point transform: 2.5 N log2 N
    (half the textbook 5 N log2 N of a complex one)."""
    return 2.5 * n_fft * math.log2(n_fft)


def bound_ms(bytes_moved: float, flop: float) -> dict:
    """The least time the card could take: the bytes over the memory rate
    or the FP32 operations over the peak rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flop / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def hbm_roofline_audio_s(
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    stretch: float = 2.0,
    hbm_bytes_per_s: float = HBM_BYTES_PER_S,
    pitch: bool = False,
) -> float:
    """Audio-seconds a second if the card did nothing but move the bytes
    any implementation must move.

    A time stretch reads its input once and writes its output once:
    4 sr (1 + stretch) bytes an audio-second in float32. A pitch shift by
    the factor f = stretch also writes and reads its stretched signal once:
    4 sr (2 + 2f). The JAX function adds a spectral round trip between
    analysis and synthesis; a fused kernel does not pay it, and with it
    the bound would exceed what the least implementation moves. n_fft and
    hop do not enter; they stay for the JAX signature.
    """
    per_sample = 2.0 + 2.0 * stretch if pitch else 1.0 + stretch
    return hbm_bytes_per_s / (sample_rate * 4 * per_sample)


def fft_flop_roofline_audio_s(
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    fp32_flops: float = FP32_FLOPS,
) -> float:
    """Audio-seconds a second if the card did nothing but the transforms'
    FP32 operations: two real transforms a frame (analysis and
    synthesis), sample_rate / hop frames an audio-second.

    A real transform counts 2.5 N log2 N (fft_flop), where the JAX function
    counts 5 N log2 N, the complex transform's count: the port's kernels
    transform real frames as N/2-point complex ones, and the least
    operation count is what a bound must take.
    """
    return fp32_flops / (2.0 * fft_flop(n_fft) * sample_rate / hop)


def binding_roofline_audio_s(
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    stretch: float = 2.0,
    pitch: bool = False,
) -> dict:
    """Both rooflines and the binding one (the lower rate), in the JAX
    function's dict shape without its TPU matmul-pass ("mxu") keys;
    `binding` is "bytes" or "operations"."""
    hbm = hbm_roofline_audio_s(sample_rate, n_fft, hop, stretch, pitch=pitch)
    fft = fft_flop_roofline_audio_s(sample_rate, n_fft, hop)
    return {
        "hbm_audio_s_per_s": hbm,
        "fft_audio_s_per_s": fft,
        "hw_audio_s_per_s": min(hbm, fft),
        "binding": "bytes" if hbm <= fft else "operations",
        "audio_s_per_s": min(hbm, fft),
    }


def emit_metric(metric: str, value: float, unit: str, **extra) -> dict:
    """Print one JSON metrics line to stdout and return it."""
    rec = {"metric": metric, "value": value, "unit": unit, **extra}
    print(json.dumps(rec), flush=True)
    return rec
