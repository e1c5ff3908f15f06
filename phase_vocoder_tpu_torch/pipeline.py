"""Single-device phase-vocoder pipeline (counterpart of phase_vocoder_tpu/pipeline.py).

time_stretch runs the fused TSM kernel (ops/fused.py); pitch_shift runs it
and then the linear resampler (ops/resample.py). Routing follows the JAX
package: the routes that land on executors this package does not have yet
raise NotImplementedError, naming the ROADMAP item, before any compute.

Tensors stay on the device they came on. Anything else (numpy arrays,
lists) is converted to float32 on `device`, which defaults to "cuda" and
is never silently the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import PvocConfig
from .ops import framing
from .ops.fused import _rational_k, fused_time_stretch, phasor_supported
from .ops.resample import resample_linear

__all__ = [
    "time_stretch",
    "pitch_shift",
    "stretch_output_length",
    "fused_ok",
    "BRANCH_FAITHFUL_FRAMES",
]

# Frame count above which branch_policy="auto" sends q >= 2 hop ratios to
# the JAX package's branch-faithful polar streaming executor (~600 s at
# 16 kHz / 256 hop; pipeline.py there records why).
BRANCH_FAITHFUL_FRAMES = 37_500

_BRANCH_POLICIES = ("auto", "fast", "faithful")


def stretch_output_length(in_len: int, cfg: PvocConfig, stretch: float) -> int:
    nf = framing.num_frames(in_len, cfg.n_fft, cfg.hop)
    return framing.output_length(nf, cfg.n_fft, cfg.synthesis_hop(stretch))


def fused_ok(cfg: PvocConfig, rs: int) -> bool:
    """True when the fused kernel covers (cfg, Rs)."""
    return cfg.fft_backend == "fused" and phasor_supported(cfg.n_fft, cfg.hop, rs)


def _reduced_q(cfg: PvocConfig, rs: int) -> int:
    return _rational_k(rs, cfg.hop)[1]


def _as_signal(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _check_route(cfg: PvocConfig, rs: int, nf: int, branch_policy: str) -> None:
    """Raise for every route whose executor is not ported yet."""
    if branch_policy not in _BRANCH_POLICIES:
        raise ValueError(f"unknown branch_policy {branch_policy!r}")
    if _reduced_q(cfg, rs) > 1 and (
        branch_policy == "faithful"
        or (branch_policy == "auto" and nf > BRANCH_FAITHFUL_FRAMES)
    ):
        raise NotImplementedError(
            f"branch_policy={branch_policy!r} with a q >= 2 hop ratio over "
            f"{nf} frames routes to the branch-faithful polar streaming "
            "executor, not ported yet (ROADMAP queue 1 items 6-7); "
            "branch_policy='fast' keeps the fused kernel"
        )
    if not fused_ok(cfg, rs):
        raise NotImplementedError(
            f"n_fft={cfg.n_fft}, hop={cfg.hop}, Rs={rs} is outside the fused "
            "kernel (needs n_fft a power of two, hop | n_fft and Rs <= "
            "n_fft/2); the JAX package "
            "routes it to phasor_general_stretch or the streaming executor, "
            "not ported yet (ROADMAP queue 1 items 4 and 7)"
        )


def time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    branch_policy: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Time-scale-modify a 1-D waveform by `stretch` (duration multiplier).

    Pitch is preserved; output length (nf-1)*Rs + n_fft with Rs =
    round(hop * stretch). branch_policy as in the JAX package: "auto"
    routes q >= 2 inputs longer than BRANCH_FAITHFUL_FRAMES to the
    branch-faithful executor, "faithful" always, "fast" never.
    """
    x = _as_signal(x, device)
    rs = cfg.synthesis_hop(stretch)
    nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
    if nf <= 0:
        return x.new_zeros((0,))
    _check_route(cfg, rs, nf, branch_policy)
    return fused_time_stretch(x, cfg.n_fft, cfg.hop, rs)


def pitch_shift(
    x,
    semitones: float,
    cfg: PvocConfig = PvocConfig(),
    branch_policy: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Pitch-shift by `semitones`: time-stretch by 2^(semitones/12), then
    resample by the inverse factor. Duration is preserved."""
    x = _as_signal(x, device)
    factor = 2.0 ** (semitones / 12.0)
    rs = cfg.synthesis_hop(factor)
    stretched_len = stretch_output_length(x.shape[-1], cfg, factor)
    if stretched_len <= 0:
        return x.new_zeros((0,))
    out_len = int(round(stretched_len / factor))
    nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
    _check_route(cfg, rs, nf, branch_policy)
    y = fused_time_stretch(x, cfg.n_fft, cfg.hop, rs)
    return resample_linear(y, 1.0 / factor, out_len)
