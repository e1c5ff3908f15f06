"""Metrics (counterpart of phase_vocoder_tpu/utils/metrics.py): the
audio-seconds-per-second figure and one-JSON-line metric records."""

from __future__ import annotations

import json


def audio_seconds_per_second(
    n_samples: int, sample_rate: int, wall_seconds: float
) -> float:
    return (n_samples / sample_rate) / max(wall_seconds, 1e-12)


def emit_metric(metric: str, value: float, unit: str, **extra) -> dict:
    """Print one JSON metrics line to stdout and return it."""
    rec = {"metric": metric, "value": value, "unit": unit, **extra}
    print(json.dumps(rec), flush=True)
    return rec
