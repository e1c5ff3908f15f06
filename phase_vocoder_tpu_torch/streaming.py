"""Streaming segmented execution of the polar path (counterpart of
phase_vocoder_tpu/streaming.py, its polar executor): a recording of any
length as a loop over fixed-size segments of F frames, with bounded state.

Exactness: the cross-segment state is the sequence-parallel carry of the
JAX package's parallel/chunked.py, applied serially:

  * phi_prev: the previous segment's last analysis-phase row, so the
    boundary heterodyne increment is exact;
  * psi_carry / psi_carry_lo: the wrapped running sum of the (Rs/Ra)*dphi
    terms as a compensated (hi, lo) float32 pair (ops/phase.py TwoSum/
    Dekker arithmetic; addition mod 2 pi is associative, so the segment-wise
    pair accumulation equals the monolithic compensated scan, where plain
    f32 would drift linearly with length on tonal audio);
  * phi0: the first frame's phase (the absolute phase anchor);
  * ola_tail / norm_tail: the last N-Rs overlap-add samples and their
    window energy, added into the next segment's head before normalization;
  * started, frame_offset: whether a segment ran, and the global index of
    the next frame.

Where the JAX package runs a lax.scan inside one jitted program, this
package runs a Python loop over segments on the tensors' device. The sizes
the loop needs (valid frames, frame offsets, the row of phi_prev) are
Python ints kept on the host beside the state, so the loop never reads a
device value back. The analysis carries no state, so it runs once over the
whole padded signal and each segment takes its rows: per frame the same
arithmetic as analysing segment by segment, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from . import pipeline
from .config import PvocConfig
from .ops import fft as fft_ops
from .ops import framing, phase
from .ops.stft import istft_ola
from .ops.window import hann_window

__all__ = [
    "DEFAULT_SEGMENT_FRAMES",
    "StreamState",
    "init_state",
    "segment_step",
    "plan_segments",
    "pad_for_segments",
    "flush_tail",
    "stream_time_stretch",
]

_EPS = 1e-8

# Default segment size in frames: ~16 s of 16 kHz audio at hop 256.
DEFAULT_SEGMENT_FRAMES = 1024


@dataclasses.dataclass
class StreamState:
    """Carried state between segments (see module docstring); tensors on
    the device the stream runs on."""

    phi_prev: torch.Tensor  # (n_bins,)
    psi_carry: torch.Tensor  # (n_bins,) hi word of the compensated pair
    psi_carry_lo: torch.Tensor  # (n_bins,) lo word of the compensated pair
    phi0: torch.Tensor  # (n_bins,)
    ola_tail: torch.Tensor  # (n_fft - rs,)
    norm_tail: torch.Tensor  # (n_fft - rs,)
    started: torch.Tensor  # () bool, false only before the first segment
    frame_offset: torch.Tensor  # () int64, global index of the next frame


def init_state(cfg: PvocConfig, rs: int, dtype=torch.float32, device=None) -> StreamState:
    nb = cfg.n_bins
    tail = cfg.n_fft - rs
    if tail < 0:
        raise ValueError(f"synthesis hop {rs} exceeds n_fft {cfg.n_fft}")

    def z(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return StreamState(
        phi_prev=z(nb),
        psi_carry=z(nb),
        psi_carry_lo=z(nb),
        phi0=z(nb),
        ola_tail=z(tail),
        norm_tail=z(tail),
        started=torch.zeros((), dtype=torch.bool, device=device),
        frame_offset=torch.zeros((), dtype=torch.int64, device=device),
    )


def segment_step(
    x_seg: torch.Tensor | None,
    n_valid: int,
    state: StreamState,
    cfg: PvocConfig,
    rs: int,
    *,
    spec: tuple[torch.Tensor, torch.Tensor] | None = None,
    frame_offset: int | None = None,
    started: bool | None = None,
) -> tuple[torch.Tensor, StreamState]:
    """Process one fixed-shape segment of F frames.

    x_seg: (F*Ra + N - Ra,) samples covering frames [offset, offset+F) plus
    the right halo, or None when `spec` = (mag, phi), each (F, n_bins),
    holds the segment's analysis already. n_valid: number of real
    (non-padding) frames. frame_offset and started mirror state.frame_offset
    and state.started as host values; when omitted they are read from the
    state (a device read). Returns (main output (F*rs,), new state); the
    caller flushes the final ola_tail/norm_tail after the last segment.
    """
    n, ra = cfg.n_fft, cfg.hop
    mag, phi = pipeline.analyze(x_seg, cfg) if spec is None else spec
    F = mag.shape[0]
    dtype, dev = mag.dtype, mag.device
    g = int(state.frame_offset) if frame_offset is None else frame_offset
    started = bool(state.started) if started is None else started

    # Terms T[j]: the step into frame g+j. T[0] crosses the segment boundary
    # (uses phi_prev); it is zero for the first frame of the recording, as
    # are the terms of padding frames (the pair identity).
    phi_ext = torch.cat([state.phi_prev[None, :], phi])  # (F+1, nb)
    th, tl = phase.residual_terms_c(phi_ext, ra, rs, n)
    j = torch.arange(F, device=dev)
    valid_term = ((j < n_valid) & ((g + j) > 0))[:, None].to(dtype)
    th, tl = th * valid_term, tl * valid_term

    incl = phase.blocked_scan(phase.wrap_add_c, (th, tl))
    res_h, res_l = phase.wrap_add_c(
        (state.psi_carry[None, :], state.psi_carry_lo[None, :]), incl
    )
    residual = res_h + res_l

    phi0 = state.phi0 if started else phi[0]
    psi = phase.finalize_phase(phi0, residual, rs, n, frame_offset=g)
    psi = phase.pin_real_bins(psi, phi, rs, n, frame_offset=g)

    mask = (j < n_valid).to(dtype)
    w = hann_window(n, dev, dtype)
    if pipeline.fused_synthesis_ok(cfg, rs):
        ola = istft_ola(mag, psi, n, rs, frame_mask=mask)
    else:
        y_re = mag * torch.cos(psi)
        y_im = mag * torch.sin(psi)
        if cfg.fft_backend == "xla":
            y_frames = fft_ops.irfft(y_re, y_im, n, backend="xla") * w
        else:  # "matmul", and the fused backend when rs does not divide n
            y_frames = fft_ops.irfft(y_re, y_im, n, backend="matmul", fused_window=True)
        ola = framing.overlap_add(y_frames * mask[:, None], rs, method=cfg.ola_method)
    norm = framing.ola_window_norm(
        w, F, rs, eps=0.0, method=cfg.ola_method, frame_mask=mask
    )

    pad = (0, F * rs - (n - rs))
    main = ola[: F * rs] + torch.nn.functional.pad(state.ola_tail, pad)
    main_norm = norm[: F * rs] + torch.nn.functional.pad(state.norm_tail, pad)
    main_out = main / torch.clamp_min(main_norm, _EPS)

    advance = min(n_valid, F)
    new_state = StreamState(
        phi_prev=phi[advance - 1],
        psi_carry=res_h[-1],
        psi_carry_lo=res_l[-1],
        phi0=phi0,
        ola_tail=ola[F * rs :],
        norm_tail=norm[F * rs :],
        started=torch.ones_like(state.started),
        frame_offset=state.frame_offset + advance,
    )
    return main_out, new_state


def _stream_scan_from(
    x_pad: torch.Tensor, state0: StreamState, nf: int, cfg: PvocConfig, rs: int,
    F: int, s_count: int,
) -> tuple[torch.Tensor, StreamState]:
    """Loop over `s_count` F-frame segments starting from `state0`.

    The first segment is state0.frame_offset // F, so the same loop serves
    a resumed run as well as the whole recording. The state's frame offset
    and started flag are read once, before the loop; inside it they advance
    on the host. Returns (outputs (s_count*F*rs,), final state).
    """
    n, ra = cfg.n_fft, cfg.hop
    g = int(state0.frame_offset)
    started = bool(state0.started)
    s0 = g // F
    span = x_pad[s0 * F * ra : (s0 + s_count) * F * ra + n - ra]
    mag_all, phi_all = pipeline.analyze(span, cfg)  # (s_count*F, n_bins)
    state, outs = state0, []
    for j in range(s_count):
        n_valid = min(max(nf - (s0 + j) * F, 0), F)
        rows = slice(j * F, (j + 1) * F)
        out, state = segment_step(
            None, n_valid, state, cfg, rs,
            spec=(mag_all[rows], phi_all[rows]), frame_offset=g, started=started,
        )
        outs.append(out)
        g += n_valid
        started = True
    return torch.cat(outs), state


def flush_tail(state: StreamState) -> torch.Tensor:
    """Normalized final OLA tail: emit after the last segment."""
    return state.ola_tail / torch.clamp_min(state.norm_tail, _EPS)


def plan_segments(nf: int, cfg: PvocConfig, rs: int, segment_frames: int) -> tuple[int, int]:
    """(frames per segment F, number of segments S) for a recording of nf
    frames. F is the requested size clamped so the OLA/framing tails stay
    within one segment's span."""
    n, ra = cfg.n_fft, cfg.hop
    F = max(min(segment_frames, nf), -(-(n - rs) // rs), -(-(n - ra) // ra), 1)
    return F, -(-nf // F)


def pad_for_segments(x: torch.Tensor, cfg: PvocConfig, F: int, S: int) -> torch.Tensor:
    n, ra = cfg.n_fft, cfg.hop
    span = S * F * ra + (n - ra)
    return torch.nn.functional.pad(x, (0, max(0, span - x.shape[-1])))[:span]


def stream_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    segment_frames: int = DEFAULT_SEGMENT_FRAMES,
    device="cuda",
) -> torch.Tensor:
    """Time-stretch of arbitrary length in bounded memory per segment.

    Numerically the polar pipeline (same per-frame math, segment-wise
    compensated carry); the route of time_stretch for branch-faithful q >= 2
    inputs and for long inputs on the polar backends. Tensors stay on their
    device; anything else goes to `device` as float32.
    """
    x = pipeline._as_signal(x, device)
    rs = cfg.synthesis_hop(stretch)
    nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
    if nf <= 0:
        return x.new_zeros((0,))
    F, S = plan_segments(nf, cfg, rs, segment_frames)
    x_pad = pad_for_segments(x, cfg, F, S)
    state0 = init_state(cfg, rs, dtype=x.dtype, device=x.device)
    main, state = _stream_scan_from(x_pad, state0, nf, cfg, rs, F, S)
    out = torch.cat([main, flush_tail(state)])
    return out[: framing.output_length(nf, cfg.n_fft, rs)]
