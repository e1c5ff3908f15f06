"""Framing and overlap-add (counterpart of phase_vocoder_tpu/ops/framing.py).

Plain torch. The plain versions of the kernels use these; the CUDA kernels
of ops/fused.py and ops/stft.py do their own framing and a gather-form
overlap-add that sums in the same order as the "fold" `overlap_add` here.
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


def _overlap_add_fold(frames: torch.Tensor, hop: int) -> torch.Tensor:
    nf, n_fft = frames.shape
    m = -(-n_fft // hop)
    if m * hop != n_fft:
        frames = torch.nn.functional.pad(frames, (0, m * hop - n_fft))
    seg = frames.reshape(nf, m, hop)
    out = frames.new_zeros((nf + m - 1, hop))
    for s in reversed(range(m)):
        out[s : s + nf] += seg[:, s, :]
    return out.reshape(-1)[: output_length(nf, n_fft, hop)]


def _overlap_add_scatter(frames: torch.Tensor, hop: int) -> torch.Tensor:
    nf, n_fft = frames.shape
    m = -(-n_fft // hop)
    out = frames.new_zeros((output_length(nf, n_fft, hop),))
    t = torch.arange(n_fft, device=frames.device)
    for r in range(min(m, nf)):
        j = torch.arange(r, nf, m, device=frames.device)
        idx = (j[:, None] * hop + t[None, :]).reshape(-1)
        out.index_put_((idx,), out[idx] + frames[r::m].reshape(-1))
    return out


def overlap_add(frames: torch.Tensor, hop: int, method: str = "auto") -> torch.Tensor:
    """Deterministic overlap-add of (nf, n_fft) frames at any `hop`.

    "fold" (and "auto"): frames are zero-padded to m = ceil(n_fft/hop)
    segments of `hop` samples; segment s of frame i lands in output block
    i+s. Each output sample sums its frames in increasing frame order
    (segments from m-1 down to 0), the order the CUDA gather kernels use.

    "scatter": frames written to their sample indices, the reference's
    formulation, kept as an independent check of "fold". It runs in m
    rounds without atomics: in round r the frames i = r (mod m) cover
    disjoint samples, so every index of the round is written once (a plain
    indexed store of out[idx] + frame); a sample receives its frames in the
    fixed order of the rounds, so reruns are bitwise equal on any device.
    """
    nf = frames.shape[0]
    if nf == 0:
        return frames.new_zeros((0,))
    if method in ("auto", "fold"):
        return _overlap_add_fold(frames, hop)
    if method == "scatter":
        return _overlap_add_scatter(frames, hop)
    raise ValueError(f"unknown OLA method {method!r}")


def ola_window_norm(
    window: torch.Tensor,
    nf: int,
    hop: int,
    eps: float = 1e-8,
    method: str = "auto",
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Overlap-added window-squared normalization, clamped at >= eps.

    frame_mask: optional (nf,) 0/1 weights; masked (padding) frames add no
    window energy, so a padded run normalizes like the unpadded one.
    """
    n_fft = window.shape[0]
    w2 = (window * window).expand(nf, n_fft)
    if frame_mask is not None:
        w2 = w2 * frame_mask[:, None].to(window.dtype)
    return overlap_add(w2, hop, method=method).clamp_min(eps)
