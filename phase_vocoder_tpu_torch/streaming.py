"""Streaming segmented execution (counterpart of
phase_vocoder_tpu/streaming.py): a recording of any length as a loop over
fixed-size segments of F frames, with bounded state. Two executors: the
polar one (stream_time_stretch, the branch-faithful route) and the fused
one (fused_stream_time_stretch, the pvoc_fused_segment kernel, bitwise
equal to the single-recording fused kernel; see the section below).

The polar executor:

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
arithmetic as analysing segment by segment, bit for bit. A segment's
phase chain (terms, compensated scan, carry, finalize, pin) is one call
of ops/phase.py segment_phase, one kernel launch on the card, and a
whole segment's frame mask and window norm come from a cache.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import pipeline
from .config import PvocConfig
from .ops import fft as fft_ops
from .ops import framing
from .ops.fused import SCAN_CHUNK, fused_stream_segment, init_carry, segment_workspace
from .ops.phase import segment_phase
from .ops.stft import istft_ola
from .ops.window import hann_window
from .utils import profiling

__all__ = [
    "DEFAULT_SEGMENT_FRAMES",
    "StreamState",
    "init_state",
    "segment_step",
    "plan_segments",
    "pad_for_segments",
    "flush_tail",
    "stream_time_stretch",
    "DEFAULT_FUSED_SEGMENT_FRAMES",
    "FusedStreamState",
    "fused_init_state",
    "fused_plan_segments",
    "fused_stream_time_stretch",
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

    # The synthesis phase (ops/phase.py segment_phase: the segment_phase
    # kernel on the card). Term j is the step into frame g+j; T[0] crosses
    # the segment boundary (from phi_prev); it is zero for the first frame
    # of the recording, as are the terms of padding frames.
    psi, carry_hi, carry_lo = segment_phase(
        phi, state.phi_prev, state.psi_carry, state.psi_carry_lo, state.phi0,
        ra=ra, rs=rs, n_fft=n, frame_offset=g, n_valid=n_valid, started=started,
    )
    phi0 = state.phi0 if started else phi[0]

    mask, norm = _mask_and_norm(F, n_valid, n, rs, cfg.ola_method, dtype, dev)
    if pipeline.fused_synthesis_ok(cfg, rs):
        ola = istft_ola(mag, psi, n, rs, frame_mask=mask)
    else:
        y_re = mag * torch.cos(psi)
        y_im = mag * torch.sin(psi)
        if cfg.fft_backend == "xla":
            y_frames = fft_ops.irfft(y_re, y_im, n, backend="xla") * hann_window(n, dev, dtype)
        else:  # "matmul", and the fused backend when rs does not divide n
            y_frames = fft_ops.irfft(y_re, y_im, n, backend="matmul", fused_window=True)
        ola = framing.overlap_add(y_frames * mask[:, None], rs, method=cfg.ola_method)

    pad = (0, F * rs - (n - rs))
    main = ola[: F * rs] + torch.nn.functional.pad(state.ola_tail, pad)
    main_norm = norm[: F * rs] + torch.nn.functional.pad(state.norm_tail, pad)
    main_out = main / torch.clamp_min(main_norm, _EPS)

    advance = min(n_valid, F)
    new_state = StreamState(
        phi_prev=phi[advance - 1],
        psi_carry=carry_hi,
        psi_carry_lo=carry_lo,
        phi0=phi0,
        ola_tail=ola[F * rs :],
        norm_tail=norm[F * rs :],
        started=torch.ones_like(state.started),
        frame_offset=state.frame_offset + advance,
    )
    return main_out, new_state


def _with_norm(mask: torch.Tensor, n_fft: int, rs: int, method: str):
    w = hann_window(n_fft, mask.device, mask.dtype)
    return mask, framing.ola_window_norm(w, mask.shape[0], rs, eps=0.0, method=method, frame_mask=mask)


@functools.lru_cache(maxsize=16)
def _full_mask_and_norm(F: int, n_fft: int, rs: int, method: str, dtype, device: str):
    return _with_norm(torch.ones((F,), dtype=dtype, device=device), n_fft, rs, method)


def _mask_and_norm(F: int, n_valid: int, n_fft: int, rs: int, method: str, dtype, device):
    """The segment's frame mask (F,) and its overlap-added window energy
    (unclamped). A whole segment's depend only on (F, n_fft, rs, method,
    dtype, device) and come from a cache, so a stream computes them once;
    a partial segment's are computed as before. Callers must not modify
    either in place."""
    if n_valid >= F:
        return _full_mask_and_norm(F, n_fft, rs, method, dtype, str(torch.device(device)))
    return _with_norm((torch.arange(F, device=device) < n_valid).to(dtype), n_fft, rs, method)


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
        with profiling.span("pv.segment"):
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
    with profiling.span("pv.stream_time_stretch"):
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


# ---------------------------------------------------------------------------
# Fused streaming: a loop over segments of the pvoc_fused_segment kernel.
#
# The single-recording fused TSM carries, from frame to frame, only the
# anchor or previous unit phasor, the running phasor P and the OLA sums of
# the next m-1 output rows. fused_stream_segment takes exactly that state
# in and gives it out, so the loop reproduces the single-recording result
# bit for bit while its memory is one segment's scratch, and a run can be
# checkpointed between segments (utils/checkpoint.py). The segment reads
# its frames straight from the unpadded signal at its frame offset, so the
# JAX package's padded rows view (fused_stream_rows) has no counterpart.
# ---------------------------------------------------------------------------

# Fused segment size in frames: ~131 s of 16 kHz audio at hop 256.
DEFAULT_FUSED_SEGMENT_FRAMES = 8192


@dataclasses.dataclass
class FusedStreamState:
    """Cross-segment state of the fused streaming executor (a few KB)."""

    carry: torch.Tensor  # (4, n_fft/2-1): rows 0-1 anchor/previous phasor, 2-3 P
    tail: torch.Tensor  # (m-1, rs) un-normalized OLA sums of the next rows
    started: int  # 0 only before the first segment
    frame_offset: int  # global index of the next segment's first frame


def fused_init_state(n_fft: int, rs: int, device=None) -> FusedStreamState:
    m = -(-n_fft // rs)
    return FusedStreamState(
        carry=init_carry(n_fft, device),
        tail=torch.zeros((m - 1, rs), dtype=torch.float32, device=device),
        started=0,
        frame_offset=0,
    )


def fused_plan_segments(nf: int, n_fft: int, rs: int, segment_frames: int) -> tuple[int, int]:
    """(F, S): F the requested size rounded down to a multiple of SCAN_CHUNK
    (at least one chunk, and at least m-1 so a tail never spans two
    segments); S*F >= nf + m - 1, so the last OLA sums drain into ordinary
    output rows."""
    m = -(-n_fft // rs)
    F = max(SCAN_CHUNK, (segment_frames // SCAN_CHUNK) * SCAN_CHUNK,
            -(-(m - 1) // SCAN_CHUNK) * SCAN_CHUNK)
    return F, -(-(nf + m - 1) // F)


def _fused_scan_from(
    x: torch.Tensor, state0: FusedStreamState, nf: int, n_fft: int, hop: int,
    rs: int, F: int, s_count: int,
) -> tuple[torch.Tensor, FusedStreamState]:
    """Loop over `s_count` F-frame segments of x starting from `state0` (any
    state: the resume point). The frame offset and the started flag are
    host ints, so the loop never reads the device; the segments' scratch is
    allocated once. Returns (outputs (s_count*F*rs,), final state)."""
    work = segment_workspace(F, n_fft, hop, rs, x.device) if x.device.type == "cuda" else None
    out = torch.empty(s_count * F * rs, dtype=torch.float32, device=x.device)
    carry, tail = state0.carry, state0.tail
    g, started = state0.frame_offset, state0.started
    for j in range(s_count):
        with profiling.span("pv.segment"):
            _, carry, tail = fused_stream_segment(
                x, carry, tail, started, g, nf, n_fft, hop, rs, F,
                out=out[j * F * rs : (j + 1) * F * rs], work=work,
            )
        g += F
        started = 1
    return out, FusedStreamState(carry=carry, tail=tail, started=started, frame_offset=g)


def fused_stream_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    segment_frames: int = DEFAULT_FUSED_SEGMENT_FRAMES,
    device="cuda",
) -> torch.Tensor:
    """Segmented fused TSM: the state flow of the single-recording fused
    kernel, bitwise equal to it, in memory bounded by one segment.

    Requires pipeline.fused_ok geometry (raises ValueError otherwise).
    Tensors stay on their device; anything else goes to `device`.
    """
    with profiling.span("pv.fused_stream_time_stretch"):
        x = pipeline._as_signal(x, device)
        rs = cfg.synthesis_hop(stretch)
        if not pipeline.fused_ok(cfg, rs):
            raise ValueError(
                "fused_stream_time_stretch requires the fused-kernel geometry "
                "(fused backend, n_fft even and <= 4096, hop | n_fft, rs <= n_fft/2)"
            )
        nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
        if nf <= 0:
            return x.new_zeros((0,))
        F, S = fused_plan_segments(nf, cfg.n_fft, rs, segment_frames)
        out, _ = _fused_scan_from(
            x, fused_init_state(cfg.n_fft, rs, x.device), nf, cfg.n_fft, cfg.hop, rs, F, S
        )
        return out[: framing.output_length(nf, cfg.n_fft, rs)]
