"""Framing and overlap-add (counterpart of phase_vocoder_tpu/ops/framing.py).

Plain torch. The plain versions of the kernels use these; the CUDA kernel
of ops/fused.py does its own framing and a gather-form overlap-add that
sums in the same order as `overlap_add` here.
"""

from __future__ import annotations

import torch


def num_frames(length: int, n_fft: int, hop: int) -> int:
    if length < n_fft:
        return 0
    return 1 + (length - n_fft) // hop


def output_length(nf: int, n_fft: int, hop: int) -> int:
    if nf <= 0:
        return 0
    return (nf - 1) * hop + n_fft


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Overlapping frames of a 1-D signal: frames[i] = x[i*hop : i*hop+n_fft].

    Returns an (nf, n_fft) view (no copy).
    """
    nf = num_frames(x.shape[-1], n_fft, hop)
    if nf <= 0:
        return x.new_zeros((0, n_fft))
    return x.unfold(0, n_fft, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Deterministic fold overlap-add of (nf, n_fft) frames at any `hop`.

    Frames are zero-padded to m = ceil(n_fft/hop) segments of `hop`
    samples; segment s of frame i lands in output block i+s. Each output
    sample sums its frames in increasing frame order (segments from m-1
    down to 0), the order the CUDA gather kernel uses.
    """
    nf, n_fft = frames.shape
    if nf == 0:
        return frames.new_zeros((0,))
    m = -(-n_fft // hop)
    if m * hop != n_fft:
        frames = torch.nn.functional.pad(frames, (0, m * hop - n_fft))
    seg = frames.reshape(nf, m, hop)
    out = frames.new_zeros((nf + m - 1, hop))
    for s in reversed(range(m)):
        out[s : s + nf] += seg[:, s, :]
    return out.reshape(-1)[: output_length(nf, n_fft, hop)]


def ola_window_norm(
    window: torch.Tensor, nf: int, hop: int, eps: float = 1e-8
) -> torch.Tensor:
    """Overlap-added window-squared normalization, clamped at >= eps."""
    n_fft = window.shape[0]
    w2 = (window * window).expand(nf, n_fft)
    return overlap_add(w2, hop).clamp_min(eps)
