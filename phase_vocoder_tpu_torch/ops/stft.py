"""STFT analysis in polar or cartesian form, polar iSTFT + overlap-add,
and the windowed inverse-DFT frames of a polar or cartesian spectrum
(counterpart of phase_vocoder_tpu/ops/pallas/stft.py: stft_polar,
stft_fused, istft_ola, istft_frames and istft_frames_cart).

Each runs a CUDA kernel of csrc/stft.cu for a CUDA tensor, counting one
launch as launches.<wrapper> (_build.launch), and its plain torch version
(`*_reference`) for a CPU tensor. A CUDA tensor launches the kernel or raises; nothing falls
back.

The kernels take any even n_fft up to 4096: a power of two from 256 to
4096 goes through an n_fft/2-point FFT with one warp per frame at
n_fft = 1024 (csrc/fft_real.cuh), any other even size through the FFT of
csrc/fft_common.cuh (radix 2 or mixed radix, a block per frame);
istft_ola keeps the JAX contract rs | n_fft with
overlap n_fft/rs >= 2. istft_frames(_cart) do no overlap-add, so the
caller's fold serves any synthesis hop.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import _build
from .framing import frame_signal, num_frames, overlap_add
from .fused import _FFT_LIMIT, _device_fft_table, fft_size_supported
from .window import hann_window

__all__ = [
    "stft_supported",
    "istft_ola_supported",
    "stft_polar",
    "stft_polar_reference",
    "stft_fused",
    "stft_fused_reference",
    "istft_ola",
    "istft_ola_reference",
    "istft_frames",
    "istft_frames_reference",
    "istft_frames_cart",
    "istft_frames_cart_reference",
]


def stft_supported(n_fft: int, hop: int) -> bool:
    """True when the stft_polar kernel covers (n_fft, hop): the FFT's
    n_fft and hop | n_fft, the JAX kernel's framing."""
    return fft_size_supported(n_fft) and 0 < hop <= n_fft and n_fft % hop == 0


def istft_ola_supported(n_fft: int, rs: int) -> bool:
    """True when the istft_ola kernel covers (n_fft, rs): the FFT's n_fft,
    and rs | n_fft with overlap >= 2, as the JAX kernel requires."""
    return fft_size_supported(n_fft) and 0 < rs and n_fft % rs == 0 and n_fft // rs >= 2


# ---------------------------------------------------------------- analysis


def _windowed_rfft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    return torch.fft.rfft(frame_signal(x, n_fft, hop) * hann_window(n_fft, x.device), dim=-1)


def stft_polar_reference(x: torch.Tensor, n_fft: int, hop: int):
    """Plain torch windowed STFT -> (mag, phi), each (nf, n_fft//2+1), on
    x's device: torch.fft.rfft of the Hann-windowed frames, then
    sqrt(re^2+im^2) and atan2(im, re)."""
    spec = _windowed_rfft(x, n_fft, hop)
    re, im = spec.real, spec.imag
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def stft_fused_reference(x: torch.Tensor, n_fft: int, hop: int):
    """Plain torch windowed STFT -> (re, im), each (nf, n_fft//2+1):
    torch.fft.rfft of the Hann-windowed frames, split."""
    spec = _windowed_rfft(x, n_fft, hop)
    return spec.real.contiguous(), spec.imag.contiguous()


def _analysis(x: torch.Tensor, n_fft: int, hop: int, wrapper):
    """The analysis kernel for `wrapper` (stft_polar: (mag, phi),
    stft_fused: (re, im)), counting its launches."""
    what = wrapper.__name__
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not stft_supported(n_fft, hop):
        raise ValueError(
            f"{what} requires {_FFT_LIMIT} and "
            f"hop | n_fft (got n_fft={n_fft}, hop={hop})"
        )
    nf = num_frames(x.shape[-1], n_fft, hop)
    nb = n_fft // 2 + 1
    if nf <= 0:
        return x.new_zeros((0, nb)), x.new_zeros((0, nb))
    if x.device.type == "cpu":
        ref = stft_polar_reference if wrapper is stft_polar else stft_fused_reference
        return ref(x, n_fft, hop)
    with profiling.span("pv.prepare"):
        _build.check_cuda(what, x, dtype=torch.float32)
        a = torch.empty((nf, nb), dtype=torch.float32, device=x.device)
        b = torch.empty_like(a)
        table = _device_fft_table(n_fft, str(x.device))
    _build.launch(
        what, what, x.get_device(),
        x.data_ptr(), table.data_ptr(), a.data_ptr(), b.data_ptr(), nf, n_fft, hop,
    )
    return a, b


def stft_polar(x: torch.Tensor, n_fft: int, hop: int):
    """Windowed STFT of 1-D float32 x -> (mag, phi), each (nf, n_fft//2+1).

    A CUDA tensor goes through the analysis kernel (csrc/stft.cu, polar
    form; x may start at any element) and counts one launch as
    launches.stft_polar; a CPU tensor goes through stft_polar_reference.
    """
    return _analysis(x, n_fft, hop, stft_polar)


def stft_fused(x: torch.Tensor, n_fft: int, hop: int):
    """Windowed STFT of 1-D float32 x -> (re, im), each (nf, n_fft//2+1):
    framing + Hann window + DFT, the cartesian twin of stft_polar.

    A CUDA tensor goes through the analysis kernel (csrc/stft.cu,
    cartesian form) and counts one launch as launches.stft_fused; a CPU
    tensor goes through stft_fused_reference.
    """
    return _analysis(x, n_fft, hop, stft_fused)


# --------------------------------------------------------------- synthesis


def _mask(frame_mask, nf: int, like: torch.Tensor) -> torch.Tensor:
    if frame_mask is None:
        return like.new_ones((nf,))
    if frame_mask.shape != (nf,):
        raise ValueError(f"frame_mask must be ({nf},), got {tuple(frame_mask.shape)}")
    return frame_mask.to(device=like.device, dtype=like.dtype).contiguous()


def _windowed_irfft(re: torch.Tensor, im: torch.Tensor, n_fft: int) -> torch.Tensor:
    """w * irfft(re + i im) per frame, the imaginary parts of DC and
    Nyquist dropped (as the kernels' Hermitian fill does; im, a fresh
    tensor of the caller's, is zeroed there in place)."""
    im[:, 0] = 0.0
    im[:, -1] = 0.0
    frames = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1)
    return frames * hann_window(n_fft, re.device)


def istft_frames_reference(
    mag: torch.Tensor, psi: torch.Tensor, n_fft: int,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch polar frames: Y = mask*mag*e^{i psi} with the imaginary
    parts of DC and Nyquist set to zero, torch.fft.irfft, Hann window.
    Returns (nf, n_fft)."""
    m = mag * _mask(frame_mask, mag.shape[0], mag)[:, None]
    return _windowed_irfft(m * torch.cos(psi), m * torch.sin(psi), n_fft)


def istft_frames_cart_reference(
    y_re: torch.Tensor, y_im: torch.Tensor, n_fft: int,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch cartesian frames: Y = mask*(y_re + i y_im), then as
    istft_frames_reference. Returns (nf, n_fft)."""
    mask = _mask(frame_mask, y_re.shape[0], y_re)[:, None]
    return _windowed_irfft(y_re * mask, y_im * mask, n_fft)


def istft_ola_reference(
    mag: torch.Tensor, psi: torch.Tensor, n_fft: int, rs: int,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch polar synthesis: istft_frames_reference, then fold
    overlap-add. Un-normalized, (nf-1)*rs + n_fft samples."""
    return overlap_add(istft_frames_reference(mag, psi, n_fft, frame_mask), rs)


def istft_ola(
    mag: torch.Tensor, psi: torch.Tensor, n_fft: int, rs: int,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Polar -> waveform: Y = mag*e^{i psi} -> irfft -> window -> OLA.

    mag, psi: (nf, n_fft//2+1) float32; frame_mask: optional (nf,) 0/1
    weights (masked frames contribute nothing). Returns the un-normalized
    overlap-add of length (nf-1)*rs + n_fft (divide by ola_window_norm).
    A CUDA tensor goes through the istft_ola kernel (csrc/stft.cu) and
    counts one launch as launches.istft_ola; a CPU tensor goes through
    istft_ola_reference.
    """
    if not istft_ola_supported(n_fft, rs):
        raise ValueError(
            f"istft_ola requires {_FFT_LIMIT}, rs | n_fft "
            f"and n_fft // rs >= 2 (got n_fft={n_fft}, rs={rs})"
        )
    nb = n_fft // 2 + 1
    if mag.dim() != 2 or mag.shape[1] != nb or psi.shape != mag.shape:
        raise ValueError(f"mag and psi must be (nf, {nb}), got {tuple(mag.shape)} {tuple(psi.shape)}")
    nf = mag.shape[0]
    if nf == 0:
        return mag.new_zeros((0,))
    if mag.device.type == "cpu":
        return istft_ola_reference(mag, psi, n_fft, rs, frame_mask)
    with profiling.span("pv.prepare"):
        _build.check_cuda("istft_ola", mag, psi, dtype=torch.float32)
        mask = _mask(frame_mask, nf, mag)
        frames = torch.empty((nf, n_fft), dtype=torch.float32, device=mag.device)
        out = torch.empty((nf - 1) * rs + n_fft, dtype=torch.float32, device=mag.device)
        table = _device_fft_table(n_fft, str(mag.device))
    _build.launch(
        "istft_ola", "istft_ola", mag.get_device(),
        mag.data_ptr(), psi.data_ptr(), mask.data_ptr(), table.data_ptr(),
        frames.data_ptr(), out.data_ptr(), nf, n_fft, rs,
    )
    return out


def _istft_frames(a, b, n_fft: int, frame_mask, wrapper) -> torch.Tensor:
    """The istft_frames kernel for `wrapper` (istft_frames: polar form,
    istft_frames_cart: cartesian), counting its launches."""
    polar = wrapper is istft_frames
    what = wrapper.__name__
    if not fft_size_supported(n_fft):
        raise ValueError(f"{what} requires {_FFT_LIMIT} (got {n_fft})")
    nb = n_fft // 2 + 1
    if a.dim() != 2 or a.shape[1] != nb or b.shape != a.shape:
        raise ValueError(f"{what}: inputs must be (nf, {nb}), got {tuple(a.shape)} {tuple(b.shape)}")
    nf = a.shape[0]
    if nf == 0:
        return a.new_zeros((0, n_fft))
    if a.device.type == "cpu":
        ref = istft_frames_reference if polar else istft_frames_cart_reference
        return ref(a, b, n_fft, frame_mask)
    with profiling.span("pv.prepare"):
        _build.check_cuda(what, a, b, dtype=torch.float32)
        mask = _mask(frame_mask, nf, a)
        frames = torch.empty((nf, n_fft), dtype=torch.float32, device=a.device)
        table = _device_fft_table(n_fft, str(a.device))
    _build.launch(
        what, "istft_frames", a.get_device(),
        a.data_ptr(), b.data_ptr(), mask.data_ptr(), table.data_ptr(),
        frames.data_ptr(), nf, n_fft, int(polar),
    )
    return frames


def istft_frames(
    mag: torch.Tensor, psi: torch.Tensor, n_fft: int,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Polar spectra (nf, n_fft//2+1) -> windowed output frames (nf, n_fft),
    for any synthesis hop: Y = mask*mag*e^{i psi}, inverse DFT, Hann window,
    no overlap-add (the caller folds). A CUDA tensor goes through the
    istft_frames kernel (csrc/stft.cu, polar form) and counts one launch as
    launches.istft_frames; a CPU tensor goes through
    istft_frames_reference."""
    return _istft_frames(mag, psi, n_fft, frame_mask, istft_frames)


def istft_frames_cart(
    y_re: torch.Tensor, y_im: torch.Tensor, n_fft: int,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cartesian spectra (nf, n_fft//2+1) -> windowed output frames (nf,
    n_fft): the cartesian twin of istft_frames, for the general-hop phasor
    route where Y = mag * P arrives as (re, im). A CUDA tensor goes through
    the istft_frames kernel (csrc/stft.cu, cartesian form) and counts one
    launch as launches.istft_frames_cart; a CPU tensor goes through
    istft_frames_cart_reference."""
    return _istft_frames(y_re, y_im, n_fft, frame_mask, istft_frames_cart)
