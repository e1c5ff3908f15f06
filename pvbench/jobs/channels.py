"""One meeting's microphone array a job: a (C, T) recording, channels
first, through phase_vocoder_tpu_torch.pipeline.time_stretch (stretch.py's
entry) in one call; the input stays on the card and so does the output.

Channel c is the pooled recording delayed by d_c whole samples, the delay
of a far-field source from a seeded direction at microphone c of a
circular array, plus the channel's own seeded noise at the recording's
noise floor (pvbench/configs/meeting_array.json, "assumed").
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import signals
from .stretch import entry, stretch_work  # noqa: F401  (entry: the call under test)

RADIUS_M = 0.1
SOUND_M_PER_S = 343.0


def delays(channels: int, sr: int, rng: np.random.Generator) -> list:
    """Whole-sample delays of a far-field source from a direction drawn
    from rng at `channels` microphones evenly spaced on the circle, the
    nearest microphone at 0."""
    theta = rng.uniform(0.0, 2.0 * math.pi)
    return [int(round(sr * RADIUS_M * (1.0 - math.cos(theta - 2.0 * math.pi * c / channels))
                      / SOUND_M_PER_S))
            for c in range(channels)]


def array(seconds: float, channels: int, seed: int, device, sr: int) -> torch.Tensor:
    """(channels, T) float32 on `device`, from `seed`."""
    n = int(round(seconds * sr))
    s = signals.recording(seconds, seed, device, sr)
    # the recording's own floor: recording() draws its plan from this stream
    floor = 10.0 ** (signals._plan(n, sr, np.random.default_rng(signals.stream_seed(seed, 0)))
                     ["noise_dbfs"] / 20.0)
    x = torch.zeros((channels, n), dtype=torch.float32, device=device)
    for c, d in enumerate(delays(channels, sr, np.random.default_rng(signals.stream_seed(seed, 2)))):
        x[c, d:] = s[: n - d]
        g = torch.Generator(device=device).manual_seed(signals.stream_seed(seed, 3, c))
        x[c] += floor * torch.randn(n, generator=g, dtype=torch.float32, device=device)
    return x


def make_pool(cell, seed, device):
    c, t = cell["config"], cell["parameters"]
    return [{"x": array(c["seconds"], c["channels"], signals.stream_seed(seed, 100, i), device,
                        c["sample_rate"]),
             "ratio": float(t["ratio"])}
            for i in range(t["pool"])]


def audio_seconds(cell, item):
    """The meeting's duration, not channel-seconds."""
    return item["x"].shape[-1] / cell["config"]["sample_rate"]


def work(cell, item):
    one = stretch_work(cell, item["x"].shape[-1], item["ratio"])
    return tuple(item["x"].shape[0] * v for v in one)


def inputs(cell, item):
    return [(x, item["ratio"]) for x in item["x"]]


def outputs(cell, output):
    """The output's rows, as views of it."""
    return list(output.unbind(0))
