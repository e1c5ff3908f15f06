"""Single-device phase-vocoder pipeline (counterpart of phase_vocoder_tpu/pipeline.py).

Routes of time_stretch, in the JAX package's order:
  1. a q >= 2 hop ratio with branch_policy "faithful", or "auto" past
     BRANCH_FAITHFUL_FRAMES frames: the branch-faithful polar streaming
     executor (streaming.py; kernels of ops/stft.py on the "fused" backend);
  2. the fused TSM kernel (ops/fused.py) where it covers the geometry
     (0 < Rs <= N/2);
  3. on the "fused" backend past that (Rs > N/2: stretch above 2, pitch
     above +12 st), the general-hop phasor route phasor_general_stretch:
     the stft_phasor_terms kernel, Y = mag * P, the istft_frames_cart
     kernel, then fold overlap-add and the window-energy normalization in
     plain torch; the streaming executor past both max_monolithic_frames
     and max_phasor_general_frames;
  4. on the "matmul"/"xla" backends, the monolithic polar path (analyze ->
     stretch_polar -> synthesize_polar) up to max_monolithic_frames, the
     streaming executor beyond.
pitch_shift takes the same stretch routes (no length cut-over, as in the
JAX package) and then the linear resampler (ops/resample.py).
synthesize_polar runs the istft_ola kernel for Rs | N and the istft_frames
kernel plus fold overlap-add for any other Rs on the "fused" backend.
The "fused" backend takes every even N up to 4096. Where the hop does not
divide N, no analysis kernel frames the signal, and analyze falls back to
the matmul DFT, as the JAX package does under "pallas"; the synthesis
kernels do not depend on the analysis hop and stay. N above 4096 on the
"fused" backend raises NotImplementedError before any compute.

Tensors stay on the device they came on. Anything else (numpy arrays,
lists) is converted to float32 on `device`, which defaults to "cuda" and
is never silently the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import PvocConfig
from .ops import fft as fft_ops
from .ops import framing, phase
from .ops.fused import (
    MAX_N_FFT,
    _rational_k,
    fft_size_supported,
    fused_time_stretch,
    phasor_supported,
    phasor_terms_supported,
    stft_phasor_terms,
)
from .ops.resample import resample_linear
from .ops.stft import (
    istft_frames,
    istft_frames_cart,
    istft_ola,
    istft_ola_supported,
    stft_polar,
    stft_supported,
)
from .ops.window import hann_window
from .utils import profiling

__all__ = [
    "analyze",
    "synthesize",
    "synthesize_polar",
    "stretch_frames",
    "stretch_polar",
    "time_stretch",
    "pitch_shift",
    "stretch_output_length",
    "fused_ok",
    "fused_analysis_ok",
    "fused_synthesis_ok",
    "phasor_general_ok",
    "phasor_general_stretch",
    "BRANCH_FAITHFUL_FRAMES",
]

# Frame count above which branch_policy="auto" sends q >= 2 hop ratios to
# the branch-faithful polar streaming executor (~600 s at 16 kHz / 256
# hop): the phasor-form kernels resolve princarg branches in another
# rounding pattern than the float64 golden model, which on branch-dense
# content drifts past the 1e-4 gate beyond ~10 min, while the polar
# formula follows the golden model's branch choices op for op.
BRANCH_FAITHFUL_FRAMES = 37_500

_BRANCH_POLICIES = ("auto", "fast", "faithful")


def stretch_output_length(in_len: int, cfg: PvocConfig, stretch: float) -> int:
    nf = framing.num_frames(in_len, cfg.n_fft, cfg.hop)
    return framing.output_length(nf, cfg.n_fft, cfg.synthesis_hop(stretch))


def fused_ok(cfg: PvocConfig, rs: int) -> bool:
    """True when the fused kernel covers (cfg, Rs)."""
    return cfg.fft_backend == "fused" and phasor_supported(cfg.n_fft, cfg.hop, rs)


def phasor_general_ok(cfg: PvocConfig, rs: int) -> bool:
    """True when the general-hop phasor route applies: the fused backend,
    a geometry the fused kernel does not take (Rs > N/2), and one the
    stft_phasor_terms kernel does."""
    return (
        cfg.fft_backend == "fused"
        and not fused_ok(cfg, rs)
        and phasor_terms_supported(cfg.n_fft, cfg.hop, rs)
    )


def phasor_general_stretch(x: torch.Tensor, cfg: PvocConfig, rs: int) -> torch.Tensor:
    """TSM for general synthesis hops (see phasor_general_ok): phasor terms
    with the prefix product, Y = mag * P, windowed inverse-DFT frames, fold
    overlap-add, window-energy normalization."""
    n = cfg.n_fft
    mag, pre, pim, nf = stft_phasor_terms(x, n, cfg.hop, rs, scan=True)
    with profiling.span("pv.stage.products"):
        y_re, y_im = mag * pre, mag * pim
    y_frames = istft_frames_cart(y_re, y_im, n)
    del y_re, y_im  # freed before the fold allocates, as when passed inline
    with profiling.span("pv.stage.overlap_add"):
        out = framing.overlap_add(y_frames, rs, method="fold")
    with profiling.span("pv.stage.window_norm"):
        norm = framing.ola_window_norm(hann_window(n, x.device), nf, rs, method="fold")
    with profiling.span("pv.stage.normalize"):
        return out / norm


def fused_analysis_ok(cfg: PvocConfig) -> bool:
    """True when analyze() runs the stft_polar kernel."""
    return cfg.fft_backend == "fused" and stft_supported(cfg.n_fft, cfg.hop)


def fused_synthesis_ok(cfg: PvocConfig, rs: int) -> bool:
    """True when polar synthesis runs the istft_ola kernel (rs | n_fft,
    overlap >= 2)."""
    return cfg.fft_backend == "fused" and istft_ola_supported(cfg.n_fft, rs)


def _reduced_q(cfg: PvocConfig, rs: int) -> int:
    return _rational_k(rs, cfg.hop)[1]


def _as_signal(x, device) -> torch.Tensor:
    """A tensor as float32, contiguous, on its device; anything else copied
    to `device` as float32 (the span pv.to_device)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous()
    with profiling.span("pv.to_device"):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _as_tensor(a, device):
    """A tensor as it is; anything else (numpy, lists) as float32 on
    `device`. None stays None."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    return _as_signal(a, device)


# ------------------------------------------------------------ polar stages


def analyze(x, cfg: PvocConfig, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed STFT -> (mag, phi), each (nf, n_bins). A tensor stays on
    its device; anything else goes to `device` as float32."""
    x = _as_tensor(x, device)
    if fused_analysis_ok(cfg):
        return stft_polar(x, cfg.n_fft, cfg.hop)
    frames = framing.frame_signal(x, cfg.n_fft, cfg.hop)
    if cfg.fft_backend == "xla":
        re, im = fft_ops.rfft(frames * hann_window(cfg.n_fft, x.device), backend="xla")
    else:  # "matmul", and geometries the stft_polar kernel does not take
        re, im = fft_ops.rfft(frames, backend="matmul", fused_window=True)
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def stretch_polar(
    mag: torch.Tensor, phi: torch.Tensor, cfg: PvocConfig, rs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frequency-domain TSM in polar form: (mag, accumulated synthesis phase)."""
    dphi = phase.heterodyne_increment(phi, cfg.hop, cfg.n_fft)
    psi = phase.accumulate_phase(phi, dphi, cfg.hop, rs, cfg.n_fft, method=cfg.phase_method)
    return mag, psi


def stretch_frames(
    mag: torch.Tensor, phi: torch.Tensor, cfg: PvocConfig, rs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Frequency-domain TSM: (re, im) with the accumulated synthesis phase."""
    mag, psi = stretch_polar(mag, phi, cfg, rs)
    return mag * torch.cos(psi), mag * torch.sin(psi)


def synthesize_polar(
    mag: torch.Tensor,
    psi: torch.Tensor,
    cfg: PvocConfig,
    rs: int,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Polar-form synthesis plus the window-energy normalization: the
    istft_ola kernel where it applies, else on the fused backend the
    istft_frames kernel and fold overlap-add (any Rs), else the (re, im)
    path of synthesize."""
    if cfg.fft_backend == "fused":
        if fused_synthesis_ok(cfg, rs):
            out = istft_ola(mag, psi, cfg.n_fft, rs, frame_mask=frame_mask)
        else:
            frames = istft_frames(mag, psi, cfg.n_fft, frame_mask=frame_mask)
            out = framing.overlap_add(frames, rs, method="fold")
        w = hann_window(cfg.n_fft, mag.device)
        norm = framing.ola_window_norm(
            w, mag.shape[0], rs, method="fold", frame_mask=frame_mask
        )
        return out / norm
    return synthesize(
        mag * torch.cos(psi), mag * torch.sin(psi), cfg, rs, frame_mask=frame_mask
    )


def synthesize(
    re,
    im,
    cfg: PvocConfig,
    rs: int,
    frame_mask=None,
    device="cuda",
) -> torch.Tensor:
    """Inverse FFT, synthesis window, overlap-add, COLA normalization.

    frame_mask: optional (nf,) 0/1 weights marking valid frames; masked
    frames are zeroed in both the signal and the normalization. Tensors
    stay on their device; anything else goes to `device` as float32.
    """
    re, im, frame_mask = (_as_tensor(a, device) for a in (re, im, frame_mask))
    w = hann_window(cfg.n_fft, re.device)
    if cfg.fft_backend == "xla":
        y_frames = fft_ops.irfft(re, im, cfg.n_fft, backend="xla") * w
    else:  # "matmul", and the fused backend's cartesian fallback
        y_frames = fft_ops.irfft(re, im, cfg.n_fft, backend="matmul", fused_window=True)
    if frame_mask is not None:
        y_frames = y_frames * frame_mask[:, None].to(y_frames.dtype)
    out = framing.overlap_add(y_frames, rs, method=cfg.ola_method)
    norm = framing.ola_window_norm(
        w, y_frames.shape[0], rs, method=cfg.ola_method, frame_mask=frame_mask
    )
    return out / norm


def _polar_stretch(x: torch.Tensor, cfg: PvocConfig, rs: int) -> torch.Tensor:
    mag, phi = analyze(x, cfg)
    mag, psi = stretch_polar(mag, phi, cfg, rs)
    return synthesize_polar(mag, psi, cfg, rs)


def _stretch(route: str, x: torch.Tensor, stretch: float, cfg: PvocConfig, rs: int) -> torch.Tensor:
    """The time stretch of `x` on the route _route chose."""
    if route == "stream":
        from . import streaming

        return streaming.stream_time_stretch(x, stretch, cfg)
    if route == "fused":
        return fused_time_stretch(x, cfg.n_fft, cfg.hop, rs)
    if route == "general":
        return phasor_general_stretch(x, cfg, rs)
    return _polar_stretch(x, cfg, rs)


# ----------------------------------------------------------------- routing


def _route(
    cfg: PvocConfig,
    rs: int,
    nf: int,
    branch_policy: str,
    max_monolithic_frames: int | None = None,
    max_phasor_general_frames: int | None = None,
) -> str:
    """"stream", "fused", "general" or "polar", in the JAX package's order;
    raises for an n_fft the fused backend's kernels do not take. The max_* limits are time_stretch's
    (None: no length cut-over, as pitch_shift)."""
    if branch_policy not in _BRANCH_POLICIES:
        raise ValueError(f"unknown branch_policy {branch_policy!r}")
    if cfg.fft_backend == "fused" and not fft_size_supported(cfg.n_fft):
        raise NotImplementedError(
            f"n_fft={cfg.n_fft} is outside the fused backend's kernels (they "
            f"take n_fft even and 2 <= n_fft <= {MAX_N_FFT}); "
            "fft_backend='matmul' serves it"
        )
    if _reduced_q(cfg, rs) > 1 and (
        branch_policy == "faithful"
        or (branch_policy == "auto" and nf > BRANCH_FAITHFUL_FRAMES)
    ):
        return "stream"
    if fused_ok(cfg, rs):
        return "fused"
    general = phasor_general_ok(cfg, rs)
    if max_monolithic_frames is not None and nf > max_monolithic_frames:
        if not (general and nf <= max_phasor_general_frames):
            return "stream"
    return "general" if general else "polar"


def time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    max_monolithic_frames: int = 4096,
    max_phasor_general_frames: int = 1 << 18,
    branch_policy: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Time-scale-modify a 1-D waveform by `stretch` (duration multiplier).

    Pitch is preserved; output length (nf-1)*Rs + n_fft with Rs =
    round(hop * stretch). branch_policy governs q >= 2 hop ratios (stretch
    0.5, 1.5, every non-octave pitch hop): "auto" routes inputs longer than
    BRANCH_FAITHFUL_FRAMES to the branch-faithful polar streaming executor,
    "faithful" routes every such input there, "fast" never reroutes (the
    phasor kernel at full speed). Integer k never reroutes: its closed form
    has no branch cuts. The max_* limits select the streaming executor for
    long inputs on the routes without a fused kernel, as in the JAX package.
    """
    with profiling.span("pv.time_stretch"):
        x = _as_signal(x, device)
        with profiling.span("pv.route"):
            rs = cfg.synthesis_hop(stretch)
            nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
            if nf <= 0:
                return x.new_zeros((0,))
            route = _route(
                cfg, rs, nf, branch_policy, max_monolithic_frames, max_phasor_general_frames
            )
        return _stretch(route, x, stretch, cfg, rs)


def pitch_shift(
    x,
    semitones: float,
    cfg: PvocConfig = PvocConfig(),
    branch_policy: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Pitch-shift by `semitones`: time-stretch by 2^(semitones/12), then
    resample by the inverse factor. Duration is preserved. branch_policy as
    in time_stretch: long q >= 2 inputs run the stretch stage on the
    branch-faithful polar streaming executor."""
    with profiling.span("pv.pitch_shift"):
        x = _as_signal(x, device)
        factor = 2.0 ** (semitones / 12.0)
        rs = cfg.synthesis_hop(factor)
        stretched_len = stretch_output_length(x.shape[-1], cfg, factor)
        if stretched_len <= 0:
            return x.new_zeros((0,))
        out_len = int(round(stretched_len / factor))
        with profiling.span("pv.route"):
            nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
            route = _route(cfg, rs, nf, branch_policy)
        y = _stretch(route, x, factor, cfg, rs)
        return resample_linear(y, 1.0 / factor, out_len)
