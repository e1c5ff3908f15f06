"""The benchmark's seeded signal: speech- and music-like mono audio.

A recording is a run of notes and pauses. Each note has a fundamental
drawn log-uniformly from 80-400 Hz, a glide of up to 3 semitones over its
length, a slow vibrato (4-7 Hz, up to 40 cents), an attack and a release,
a loudness and a spectral tilt over up to 24 harmonic partials, all below
7 kHz. Pauses of 50-600 ms follow a quarter of the notes. A white noise
floor at -60 to -45 dBFS (rms) runs through notes and pauses alike.

Every parameter comes from the seed. The note plan is drawn on the host
(numpy), the samples are made on `device` in a few large calls, so an hour
takes tens of milliseconds on a card. The same seed gives the same samples
on the same kind of device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F0_HZ = (80.0, 400.0)
NOTE_S = (0.08, 0.8)
PAUSE_S = (0.05, 0.6)
PAUSE_SHARE = 0.25
GLIDE_ST = 3.0
VIBRATO_HZ = (4.0, 7.0)
VIBRATO_CENTS = 40.0
ATTACK_S = (0.005, 0.03)
RELEASE_S = (0.01, 0.08)
LOUDNESS = (0.2, 0.8)
TILT = (0.6, 1.6)  # partial h has amplitude h**-tilt before normalization
PARTIALS = 24
PARTIAL_TOP_HZ = 7000.0
NOISE_DBFS = (-60.0, -45.0)


def stream_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream `path` of `seed` (any whole number)."""
    state = np.random.SeedSequence([seed % (1 << 64), *path]).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def _plan(n: int, sr: int, rng: np.random.Generator) -> dict:
    """The note plan of n samples: per segment (a note or a pause) its
    length in samples and its parameters; pauses have loudness 0."""
    lens, notes = [], []
    total = 0
    while total < n:
        d = int(rng.uniform(*NOTE_S) * sr)
        lens.append(d)
        notes.append(True)
        total += d
        if rng.random() < PAUSE_SHARE:
            d = int(rng.uniform(*PAUSE_S) * sr)
            lens.append(d)
            notes.append(False)
            total += d
    k = len(lens)
    note = np.array(notes)
    return {
        "len": np.array(lens, dtype=np.int64),
        "f0": np.exp(rng.uniform(math.log(F0_HZ[0]), math.log(F0_HZ[1]), k)),
        "glide": rng.uniform(-GLIDE_ST, GLIDE_ST, k),
        "vib_hz": rng.uniform(*VIBRATO_HZ, k),
        "vib_cents": rng.uniform(0.0, VIBRATO_CENTS, k),
        "vib_phase": rng.uniform(0.0, 2 * math.pi, k),
        "attack": rng.uniform(*ATTACK_S, k),
        "release": rng.uniform(*RELEASE_S, k),
        "loud": np.where(note, rng.uniform(*LOUDNESS, k), 0.0),
        "tilt": rng.uniform(*TILT, k),
        "partial_phase": rng.uniform(0.0, 2 * math.pi, PARTIALS),
        "noise_dbfs": rng.uniform(*NOISE_DBFS),
    }


def recording(seconds: float, seed: int, device, sr: int = 16000) -> torch.Tensor:
    """`seconds` of the signal as float32 on `device`, from `seed`."""
    n = int(round(seconds * sr))
    rng = np.random.default_rng(stream_seed(seed, 0))
    plan = _plan(n, sr, rng)
    lens = torch.as_tensor(plan["len"], device=device)

    def per_sample(key):
        v = torch.as_tensor(plan[key], dtype=torch.float64, device=device)
        return torch.repeat_interleave(v, lens)[:n]

    starts = torch.cumsum(lens, 0) - lens
    local = (torch.arange(n, device=device) - torch.repeat_interleave(starts, lens)[:n]).double() / sr
    dur = per_sample("len") / sr
    vib = per_sample("vib_cents") / 1200.0 * torch.sin(2 * math.pi * per_sample("vib_hz") * local
                                                        + per_sample("vib_phase"))
    f = per_sample("f0") * torch.exp2(per_sample("glide") / 12.0 * local / dur + vib)
    theta = torch.remainder(torch.cumsum(2 * math.pi / sr * f, 0), 2 * math.pi).float()
    del vib, starts
    env = (per_sample("loud") * torch.clamp(local / per_sample("attack"), max=1.0)
           * torch.clamp((dur - local) / per_sample("release"), min=0.0, max=1.0)).float()
    tilt = per_sample("tilt").float()
    f = f.float()
    del local, dur
    x = torch.zeros(n, dtype=torch.float32, device=device)
    norm = torch.zeros(n, dtype=torch.float32, device=device)
    for h in range(1, PARTIALS + 1):
        # a partial fades out over the 500 Hz below PARTIAL_TOP_HZ
        amp = torch.exp(-tilt * math.log(h)) * torch.clamp((PARTIAL_TOP_HZ - h * f) / 500.0, 0.0, 1.0)
        x += amp * torch.sin(h * theta + float(plan["partial_phase"][h - 1]))
        norm += amp
    x = x * env / torch.clamp(norm, min=1e-6)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    noise = torch.randn(n, generator=g, dtype=torch.float32, device=device)
    return x + 10.0 ** (plan["noise_dbfs"] / 20.0) * noise

