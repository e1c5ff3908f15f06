"""Fused phasor-form TSM (counterpart of phase_vocoder_tpu/ops/pallas/fused.py).

For a synthesis/analysis hop ratio k = Rs/Ra = p/q the phase propagation
is phasor algebra on the unit analysis phasors u_i = X_i/|X_i|:

  integer k (q = 1): P_i = u_0 (u_i conj u_0)^k           (closed form)
  q >= 2:            P_i = prod_{j<=i} term_j, renormalized, with
                     term_0 = u_0 and
                     term_i = c (u_i conj u_{i-1} h)^k,
                     h = e^{-i Ra w_b}, c = e^{+i Rs w_b}
  Y_i = |X_i| P_i; DC passes through, Nyquist times (-1)^(Rs i).

Three wrappers of csrc/pvoc_fused.cu, each with its plain torch version
(`*_reference`) beside it; a CUDA tensor launches the kernel (counting one
launch in `.launches`) or raises, a CPU tensor runs the plain version:

  fused_time_stretch    the whole TSM of one recording (framing, windowed
                        DFT, phasors, inverse DFT, overlap-add, COLA
                        normalization);
  fused_stream_segment  the same TSM on one F-frame segment, with the
                        cross-segment state in and out (streaming.py's
                        fused executor);
  stft_phasor_terms     framing, windowed DFT, |X|, unit phasors and the
                        step terms of every bin, optionally scanned (the
                        general-hop route of pipeline.py).

The static tables (window and FFT twiddles, phasor constants,
normalization rows) are built in float64 numpy with the JAX package's
formulas and cast to float32 once.

A stream segment equals the matching rows of the whole-recording run bit
for bit, on the card and in the plain versions: the segment's frames are
analysed from the same samples, its first frame's previous phasor (or the
anchor) and the running phasor P come from the carry exactly as the
whole-recording pass would compute them, the chunks of the prefix product
line up (segments are a multiple of SCAN_CHUNK frames), and every output
sample sums its frames oldest first from the un-normalized tail before it
is normalized by its global row.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _build
from .framing import frame_signal, num_frames, overlap_add
from .window import _hann_f64, hann_window

__all__ = [
    "phasor_supported",
    "phasor_terms_supported",
    "fused_time_stretch",
    "fused_time_stretch_reference",
    "fused_stream_segment",
    "fused_stream_segment_reference",
    "stream_norm_tables",
    "stft_phasor_terms",
    "stft_phasor_terms_reference",
]

_TINY = 1e-30
# Frames per chunk of the q >= 2 prefix product (kernel and plain version).
SCAN_CHUNK = 64


# Largest N whose two FFT buffers fit the kernel's default shared memory.
MAX_N_FFT = 4096


def fft_size_supported(n_fft: int) -> bool:
    """True when the kernels' radix-2 FFT (csrc/fft_common.cuh) takes
    n_fft: a power of two up to MAX_N_FFT."""
    return 2 <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0


def phasor_supported(n_fft: int, ra: int, rs: int) -> bool:
    """True when the fused kernel covers this geometry: fft_size_supported,
    Ra | N and overlap >= 2 (0 < Rs <= N/2)."""
    return fft_size_supported(n_fft) and n_fft % ra == 0 and 0 < rs and 2 * rs <= n_fft


def phasor_terms_supported(n_fft: int, ra: int, rs: int) -> bool:
    """True when the pvoc_terms kernel covers this geometry: the FFT's
    n_fft, Ra | N and any Rs > 0 (the JAX function puts no bound on Rs)."""
    return fft_size_supported(n_fft) and n_fft % ra == 0 and rs > 0


def _rational_k(rs: int, ra: int) -> tuple[int, int]:
    """Reduced (p, q) with k = Rs/Ra = p/q."""
    g = math.gcd(rs, ra)
    return rs // g, ra // g


# ------------------------------------------------------------ host tables


@functools.lru_cache(maxsize=16)
def _fft_tables(n_fft: int) -> np.ndarray:
    """(2 n_fft,) f32: the periodic Hann window (n_fft), then cos and sin
    of 2 pi k / n_fft for k < n_fft/2 (the FFT twiddles), built in f64."""
    k = np.arange(n_fft // 2, dtype=np.float64)
    ang = 2.0 * np.pi * k / n_fft
    return np.concatenate([_hann_f64(n_fft), np.cos(ang), np.sin(ang)]).astype(
        np.float32
    )


@functools.lru_cache(maxsize=16)
def _phasor_consts(n_fft: int, ra: int, rs: int) -> np.ndarray:
    """(4, n_fft//2) f32: hre, him, cre, cim per bin.

    h = e^{-i Ra w_b} (heterodyne), c = e^{+i Rs w_b} (synthesis rotation),
    from exact integer angle reduction mod N; the formula of
    _phasor_consts_packed (bin 0 is unused).
    """
    k = np.arange(n_fft // 2, dtype=np.int64)
    ang_h = -2.0 * np.pi * ((k * ra) % n_fft) / n_fft
    ang_c = 2.0 * np.pi * ((k * rs) % n_fft) / n_fft
    return np.stack(
        [np.cos(ang_h), np.sin(ang_h), np.cos(ang_c), np.sin(ang_c)]
    ).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _ola_norm_rows(n_fft: int, rs: int, nf: int, eps: float = 1e-8) -> np.ndarray:
    """(2m-1, rs) f32 inverse window energies, m = ceil(n_fft/rs).

    Rows 0..m-2 normalize output rows 0..m-2 (head), rows m-1..2m-3 the
    spill rows nf..nf+m-2 (tail), row 2m-2 every interior row. Output
    position t of row r receives the energy of the frames that cover it,
    sum_s w^2[t + s*rs] over their segments s (zero-padded to m*rs). For
    nf >= m-1 the rows are fused.py _ola_norm_tables' head rows, tail_inv
    and interior row, bit for bit; shorter inputs, where a row is head and
    tail at once, get their exact energy. Callers pass nf capped at m-1.
    """
    m = -(-n_fft // rs)
    t = np.arange(n_fft, dtype=np.float64)
    w2 = (0.5 - 0.5 * np.cos(2.0 * np.pi * t / n_fft)) ** 2
    w2p = np.zeros(m * rs, np.float64)
    w2p[:n_fft] = w2
    seg = w2p.reshape(m, rs)

    def inv_energy(r: int) -> np.ndarray:
        s_lo = r - min(r, nf - 1)  # segment of the last frame covering r
        s_hi = min(r, m - 1)  # segment of the first
        return 1.0 / np.maximum(seg[s_lo : s_hi + 1].sum(axis=0), eps)

    rows = [inv_energy(r) for r in range(m - 1)]
    rows += [inv_energy(nf + j) for j in range(m - 1)]
    rows.append(1.0 / np.maximum(seg.sum(axis=0), eps))
    return np.stack(rows).astype(np.float32)


def _norm_rows(n_fft: int, rs: int, nf: int) -> np.ndarray:
    m = -(-n_fft // rs)
    return _ola_norm_rows(n_fft, rs, min(nf, m - 1))


@functools.lru_cache(maxsize=16)
def _device_tables(n_fft: int, ra: int, rs: int, device: str) -> dict:
    """The kernel's float32 tables on `device`, built once per geometry."""
    return {
        "fft": torch.as_tensor(_fft_tables(n_fft), device=device),
        "consts": torch.as_tensor(_phasor_consts(n_fft, ra, rs), device=device),
    }


@functools.lru_cache(maxsize=64)
def _device_norm_rows(n_fft: int, rs: int, nf_key: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_ola_norm_rows(n_fft, rs, nf_key), device=device)


# ------------------------------------------- phasor algebra (plain torch)


def _int_pow(zre, zim, k: int):
    """z^k for non-negative integer k by repeated squaring."""
    rre = torch.ones_like(zre)
    rim = torch.zeros_like(zim)
    base_re, base_im = zre, zim
    e = k
    while e > 0:
        if e & 1:
            rre, rim = (
                rre * base_re - rim * base_im,
                rre * base_im + rim * base_re,
            )
        e >>= 1
        if e:
            base_re, base_im = (
                base_re * base_re - base_im * base_im,
                2.0 * base_re * base_im,
            )
    return rre, rim


def _principal_sqrt(zre, zim):
    """Principal square root (Re >= 0) of unit-modulus z, elementwise.

    Branches on sign(zre) so neither square root suffers cancellation; at
    zre = -1 the zim >= 0 branch picks +i (princarg(pi) = pi -> pi/2).
    """
    re_pos = torch.sqrt(torch.clamp_min(0.5 * (1.0 + zre), 0.25))
    im_pos = zim / (2.0 * re_pos)
    t_neg = torch.sqrt(torch.clamp_min(0.5 * (1.0 - zre), 0.25))
    im_neg = torch.where(zim >= 0, t_neg, -t_neg)
    re_neg = torch.abs(zim) / (2.0 * t_neg)
    pos = zre >= 0
    return torch.where(pos, re_pos, re_neg), torch.where(pos, im_pos, im_neg)


def _pow_alg(p: int, q: int) -> bool:
    """True: principal roots + integer power; False: angle domain."""
    return q in (1, 2, 4) and p <= 8


def _pow_k(zre, zim, rs: int, ra: int):
    """z^k for rational k = rs/ra and unit z: e^{i k princarg(arg z)}.

    q in {1, 2, 4} with p <= 8: nested principal square roots, then the
    integer power (pure algebra). Otherwise the angle domain: atan2, times
    k, cos/sin. A zim of -0 counts as +0, so the branch point maps to +pi
    as the golden model's princarg does.
    """
    p, q = _rational_k(rs, ra)
    if _pow_alg(p, q):
        wre, wim = zre, zim
        for _ in range(q.bit_length() - 1):
            wre, wim = _principal_sqrt(wre, wim)
        if p == 1:
            return wre, wim
        return _int_pow(wre, wim, p)
    k = float(np.float32(p / q))
    if zre.device.type != "cpu" or zre.dim() < 2:
        return _angle_pow(zre, zim, k)
    # On the CPU torch evaluates atan2 and cos in SIMD lanes but the last
    # elements of each thread's range in scalar code, which rounds
    # differently. Evaluating every SCAN_CHUNK block of frames (dim 0) as a
    # call of its own makes each result depend only on the frame's place
    # in its chunk, so a stream segment computes what the whole recording
    # does.
    parts = [
        _angle_pow(zre[i : i + SCAN_CHUNK], zim[i : i + SCAN_CHUNK], k)
        for i in range(0, zre.shape[0], SCAN_CHUNK)
    ]
    return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])


def _angle_pow(zre, zim, k: float):
    ang = torch.atan2(torch.where(zim == 0, 0.0, zim), zre) * k
    return torch.cos(ang), torch.sin(ang)


def _unit(re, im):
    """(|X|, u_re, u_im) with u = 1 where |X|^2 <= 1e-30."""
    n2 = re * re + im * im
    mag = torch.sqrt(n2)
    safe = n2 > _TINY
    return mag, torch.where(safe, re / mag, 1.0), torch.where(safe, im / mag, 0.0)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _normalize(re, im):
    r = torch.sqrt(torch.clamp_min(re * re + im * im, _TINY))
    return re / r, im / r


def _chunked_prefix_product(tre, tim, chunk: int = SCAN_CHUNK, carry=None):
    """Renormalized prefix product over frames (dim 0), in the kernel's
    three passes: in-chunk inclusive products, a serial scan of the chunk
    carries from `carry` (re, im; default 1), then carry * in-chunk
    product, renormalized. Returns (P_re, P_im, running carry after the
    last chunk)."""
    nf = tre.shape[0]
    nch = -(-nf // chunk)
    pad = nch * chunk - nf
    tre = torch.nn.functional.pad(tre, (0, 0, 0, pad), value=1.0)
    tim = torch.nn.functional.pad(tim, (0, 0, 0, pad))
    lre = tre.reshape(nch, chunk, -1).clone()
    lim = tim.reshape(nch, chunk, -1).clone()
    for i in range(1, chunk):
        lre[:, i], lim[:, i] = _cmul(lre[:, i - 1], lim[:, i - 1], lre[:, i], lim[:, i])
    cre = torch.empty_like(lre[:, 0])
    cim = torch.empty_like(lim[:, 0])
    if carry is None:
        c_re, c_im = torch.ones_like(cre[0]), torch.zeros_like(cim[0])
    else:
        c_re, c_im = carry
    for c in range(nch):
        cre[c], cim[c] = c_re, c_im
        c_re, c_im = _normalize(*_cmul(c_re, c_im, lre[c, -1], lim[c, -1]))
    pre, pim = _normalize(*_cmul(cre[:, None], cim[:, None], lre, lim))
    return pre.reshape(nch * chunk, -1)[:nf], pim.reshape(nch * chunk, -1)[:nf], (c_re, c_im)


def _step_terms(ure, uim, pre, pim, consts, rs: int, hop: int):
    """c (u conj(u_prev) h)^k of the general bins; consts (4, nbins) are
    hre, him, cre, cim of the same bins."""
    dre = ure * pre + uim * pim
    dim = uim * pre - ure * pim
    zre, zim = _cmul(dre, dim, consts[0], consts[1])
    wre, wim = _pow_k(zre, zim, rs, hop)
    return _cmul(wre, wim, consts[2], consts[3])


# -------------------------------------------------------- the fused TSM


def _check_args(x: torch.Tensor, n_fft: int, hop: int, rs: int) -> int:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not phasor_supported(n_fft, hop, rs):
        raise ValueError(
            f"fused path requires n_fft a power of two <= {MAX_N_FFT}, "
            f"hop | n_fft and 0 < rs <= n_fft/2 "
            f"(got n_fft={n_fft}, hop={hop}, rs={rs})"
        )
    nf = num_frames(x.shape[-1], n_fft, hop)
    if nf <= 0:
        raise ValueError("input shorter than one frame")
    return nf


def init_carry(n_fft: int, device=None) -> torch.Tensor:
    """(4, n_fft/2 - 1) carry of a stream before its first segment: rows
    0-1 the anchor / previous unit phasor, rows 2-3 the running phasor P,
    all the identity phasor 1 (the general bins 1..n_fft/2-1)."""
    carry = torch.zeros((4, n_fft // 2 - 1), dtype=torch.float32, device=device)
    carry[0] = 1.0
    carry[2] = 1.0
    return carry


def _tsm_frames_reference(
    x: torch.Tensor, goff: int, n_valid: int, n_fft: int, hop: int, rs: int,
    carry: torch.Tensor, started: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain analysis, phase and synthesis of frames goff..goff+n_valid-1
    of x, from `carry`. Returns (windowed frames (n_valid, n_fft), the carry
    after them)."""
    nh = n_fft // 2
    w = hann_window(n_fft, device=x.device)
    xs = x[goff * hop : (goff + n_valid - 1) * hop + n_fft]
    spec = torch.fft.rfft(frame_signal(xs, n_fft, hop) * w, dim=-1)
    re, im = spec.real, spec.imag  # (n_valid, nh + 1)
    mag, ure, uim = _unit(re[:, 1:nh], im[:, 1:nh])  # general bins
    p, q = _rational_k(rs, hop)
    if q == 1:
        if started:
            u0re, u0im = carry[0:1], carry[1:2]
        else:
            u0re, u0im = ure[0:1], uim[0:1]
        zre = ure * u0re + uim * u0im
        zim = uim * u0re - ure * u0im
        wre, wim = _pow_k(zre, zim, rs, hop)
        pre, pim = _cmul(wre, wim, u0re, u0im)
        new_carry = torch.cat([u0re, u0im, carry[2:]])
    else:
        c = torch.as_tensor(_phasor_consts(n_fft, hop, rs)[:, 1:], device=x.device)
        prev_re = torch.cat([carry[0:1], ure[:-1]])
        prev_im = torch.cat([carry[1:2], uim[:-1]])
        tre, tim = _step_terms(ure, uim, prev_re, prev_im, c, rs, hop)
        if not started:  # the recording's first frame: the anchor u_0
            tre[0], tim[0] = ure[0], uim[0]
        pre, pim, (cre, cim) = _chunked_prefix_product(tre, tim, carry=(carry[2], carry[3]))
        new_carry = torch.stack([ure[-1], uim[-1], cre, cim])
    sign = torch.ones(n_valid, device=x.device)
    if rs % 2:
        sign[(goff + torch.arange(n_valid, device=x.device)) % 2 == 1] = -1.0
    y_re = torch.cat([re[:, :1], mag * pre, (re[:, nh] * sign)[:, None]], dim=1)
    y_im = torch.cat([torch.zeros_like(re[:, :1]), mag * pim, torch.zeros_like(re[:, :1])], dim=1)
    frames = torch.fft.irfft(torch.complex(y_re, y_im), n=n_fft, dim=-1) * w
    return frames, new_carry


def _ola_rows_reference(
    frames: torch.Tensor, rows: int, rs: int, tail: torch.Tensor | None
) -> torch.Tensor:
    """(rows + m - 1, rs) fold overlap-add of frames (n_valid <= rows, N):
    rows < m-1 start from `tail`, then each row adds its frames oldest
    first (the order of the kernel's gather and of framing.overlap_add)."""
    n_valid, n_fft = frames.shape
    m = -(-n_fft // rs)
    out = frames.new_zeros((rows + m - 1, rs))
    if tail is not None:
        out[: m - 1] = tail
    if n_valid:
        seg = torch.nn.functional.pad(frames, (0, m * rs - n_fft)).reshape(n_valid, m, rs)
        for s in reversed(range(m)):
            out[s : s + n_valid] += seg[:, s, :]
    return out


def _normalize_rows(ola: torch.Tensor, goff: int, nf: int, n_fft: int, rs: int) -> torch.Tensor:
    """ola (R, rs) rows of global output rows goff.. times their inverse
    window energy (head, interior or tail row of stream_norm_tables); rows
    past the recording's output become 0."""
    m = -(-n_fft // rs)
    table = torch.as_tensor(stream_norm_tables(n_fft, rs, nf), device=ola.device)
    r = torch.arange(goff, goff + ola.shape[0], device=ola.device)
    idx = torch.full_like(r, 2 * m - 2)
    idx = torch.where(r < m - 1, r, idx)
    idx = torch.where(r >= nf, m - 1 + (r - nf), idx)
    keep = r < nf + m - 1
    norm = table[torch.where(keep, idx, 0)] * keep[:, None]
    return ola * norm


def stream_norm_tables(n_fft: int, rs: int, nf: int) -> np.ndarray:
    """(2m-1, rs) float32 inverse window energies of a recording of nf
    frames: head rows 0..m-2, tail rows (output rows nf..nf+m-2), then the
    interior row. Every fused route normalizes an output row after its
    full sum, by the row its global index selects."""
    return _norm_rows(n_fft, rs, nf)


def fused_time_stretch_reference(
    x: torch.Tensor, n_fft: int, hop: int, rs: int
) -> torch.Tensor:
    """Plain torch version of the fused TSM, on x's device.

    torch.fft in float32 for the DFTs, the phasor algebra above, the
    chunked prefix product for q >= 2, and fold overlap-add. Returns
    (nf-1)*rs + n_fft samples.
    """
    nf = _check_args(x, n_fft, hop, rs)
    frames, _ = _tsm_frames_reference(x, 0, nf, n_fft, hop, rs, init_carry(n_fft, x.device), False)
    ola = _normalize_rows(_ola_rows_reference(frames, nf, rs, None), 0, nf, n_fft, rs)
    return ola.reshape(-1)[: (nf - 1) * rs + n_fft]


def fused_time_stretch(x: torch.Tensor, n_fft: int, hop: int, rs: int) -> torch.Tensor:
    """Full fused TSM of a 1-D float32 tensor, on x's device.

    A CUDA tensor goes through the hand-written kernel (csrc/pvoc_fused.cu)
    and counts one launch in `fused_time_stretch.launches`; a CPU tensor
    goes through fused_time_stretch_reference. Returns (nf-1)*rs + n_fft
    samples.
    """
    nf = _check_args(x, n_fft, hop, rs)
    if x.device.type == "cpu":
        return fused_time_stretch_reference(x, n_fft, hop, rs)
    _check_cuda(x, "fused_time_stretch")
    dev = str(x.device)
    tables = _device_tables(n_fft, hop, rs, dev)
    norm = _device_norm_rows(n_fft, rs, min(nf, -(-n_fft // rs) - 1), dev)
    p, q = _rational_k(rs, hop)
    out = torch.empty((nf - 1) * rs + n_fft, dtype=torch.float32, device=x.device)
    work = _workspace(nf, n_fft, q, x.device)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        rc = lib.pvoc_fused(
            x.data_ptr(), out.data_ptr(), *_ptrs(work),
            tables["fft"].data_ptr(), tables["consts"].data_ptr(),
            norm.data_ptr(), nf, n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pvoc_fused")
    fused_time_stretch.launches += 1
    return out


fused_time_stretch.launches = 0


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")


def _workspace(frames: int, n_fft: int, q: int, device) -> dict:
    """Scratch of the TSM passes for `frames` frames: spectra, Y, windowed
    frames, and the chunk totals and carries of the q >= 2 scan."""
    f32 = dict(dtype=torch.float32, device=device)
    work = {
        "spec": torch.empty((frames, n_fft + 2), **f32),
        "y": torch.empty((frames, n_fft + 2), **f32),
        "frames": torch.empty((frames, n_fft), **f32),
        "tot": None,
        "carry": None,
    }
    if q > 1:
        nch = -(-frames // SCAN_CHUNK)
        work["tot"] = torch.empty((nch, n_fft // 2 - 1, 2), **f32)
        work["carry"] = torch.empty_like(work["tot"])
    return work


def _ptrs(work: dict) -> list:
    return [
        None if work[k] is None else work[k].data_ptr()
        for k in ("spec", "y", "frames", "tot", "carry")
    ]


# ------------------------------------------------------ one stream segment


def _check_segment(x, carry, tail, frame_offset: int, n_fft: int, hop: int, rs: int, seg_frames: int):
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not phasor_supported(n_fft, hop, rs):
        raise ValueError(
            f"fused stream requires n_fft a power of two <= {MAX_N_FFT}, hop | n_fft "
            f"and 0 < rs <= n_fft/2 (got n_fft={n_fft}, hop={hop}, rs={rs})"
        )
    m = -(-n_fft // rs)
    if seg_frames <= 0 or seg_frames % SCAN_CHUNK or seg_frames < m - 1:
        raise ValueError(
            f"segment of {seg_frames} frames: needs a positive multiple of "
            f"{SCAN_CHUNK} and at least m-1 = {m - 1}"
        )
    if frame_offset % SCAN_CHUNK:
        raise ValueError(f"frame offset {frame_offset} is not a multiple of {SCAN_CHUNK}")
    if carry.shape != (4, n_fft // 2 - 1) or tail.shape != (m - 1, rs):
        raise ValueError(
            f"carry {tuple(carry.shape)} / tail {tuple(tail.shape)} do not fit "
            f"n_fft={n_fft}, rs={rs}"
        )


def fused_stream_segment_reference(
    x: torch.Tensor, carry: torch.Tensor, tail: torch.Tensor, started: bool,
    frame_offset: int, nf: int, n_fft: int, hop: int, rs: int, seg_frames: int,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of fused_stream_segment, on x's device."""
    _check_segment(x, carry, tail, frame_offset, n_fft, hop, rs, seg_frames)
    n_valid = min(max(nf - frame_offset, 0), seg_frames)
    if n_valid:
        frames, new_carry = _tsm_frames_reference(
            x, frame_offset, n_valid, n_fft, hop, rs, carry, started
        )
    else:
        frames, new_carry = x.new_zeros((0, n_fft)), carry
    ola = _ola_rows_reference(frames, seg_frames, rs, tail)
    main = _normalize_rows(ola[:seg_frames], frame_offset, nf, n_fft, rs).reshape(-1)
    if out is not None:
        out.copy_(main)
        main = out
    return main, new_carry, ola[seg_frames:].contiguous()


def fused_stream_segment(
    x: torch.Tensor, carry: torch.Tensor, tail: torch.Tensor, started: bool,
    frame_offset: int, nf: int, n_fft: int, hop: int, rs: int, seg_frames: int,
    out: torch.Tensor | None = None, work: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One F-frame segment of the streaming fused TSM.

    x: the whole 1-D float32 signal (nf frames); the segment covers frames
    frame_offset .. frame_offset+F-1, of which those below nf are real.
    carry (4, n_fft/2-1): rows 0-1 the anchor u_0 (integer k) or the unit
    phasor of the previous frame (q >= 2), rows 2-3 the running phasor P;
    tail (m-1, rs): un-normalized partial sums of the segment's first m-1
    output rows; started: False only for the recording's first segment.
    F must be a multiple of SCAN_CHUNK and at least m-1; frame_offset a
    multiple of SCAN_CHUNK. Returns (out (F*rs,): output rows frame_offset..
    frame_offset+F-1, normalized, 0 past the output's end; carry'; tail').
    `out` may be given (a contiguous (F*rs,) view); `work` is the scratch of
    segment_workspace, reused across the segments of a call.

    A CUDA tensor launches the pvoc_fused_segment kernel and counts one
    launch in `fused_stream_segment.launches`; a CPU tensor runs
    fused_stream_segment_reference.
    """
    if x.device.type == "cpu":
        return fused_stream_segment_reference(
            x, carry, tail, started, frame_offset, nf, n_fft, hop, rs, seg_frames, out
        )
    _check_segment(x, carry, tail, frame_offset, n_fft, hop, rs, seg_frames)
    for t, what in ((x, "x"), (carry, "carry"), (tail, "tail")):
        _check_cuda(t, f"fused_stream_segment ({what})")
    n_valid = min(max(nf - frame_offset, 0), seg_frames)
    m = -(-n_fft // rs)
    dev = str(x.device)
    tables = _device_tables(n_fft, hop, rs, dev)
    norm = _device_norm_rows(n_fft, rs, min(nf, m - 1), dev)
    p, q = _rational_k(rs, hop)
    if out is None:
        out = torch.empty(seg_frames * rs, dtype=torch.float32, device=x.device)
    elif out.shape != (seg_frames * rs,) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous ({seg_frames * rs},) tensor")
    work = segment_workspace(seg_frames, n_fft, hop, rs, x.device) if work is None else work
    tail_out = torch.empty_like(tail)
    carry_out = torch.empty_like(carry)
    x_seg = x.data_ptr() + (frame_offset * hop * 4 if n_valid else 0)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        rc = lib.pvoc_fused_segment(
            x_seg, out.data_ptr(), tail_out.data_ptr(), carry_out.data_ptr(),
            *_ptrs(work), tables["fft"].data_ptr(), tables["consts"].data_ptr(),
            norm.data_ptr(), carry.data_ptr(), tail.data_ptr(),
            n_valid, seg_frames, frame_offset, nf, int(bool(started)),
            n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pvoc_fused_segment")
    fused_stream_segment.launches += 1
    return out, carry_out, tail_out


fused_stream_segment.launches = 0


def segment_workspace(seg_frames: int, n_fft: int, hop: int, rs: int, device) -> dict:
    """Scratch of pvoc_fused_segment for F-frame segments, allocated once
    per stream call and reused by every segment."""
    return _workspace(seg_frames, n_fft, _rational_k(rs, hop)[1], device)


# ------------------------------------------------------------ phasor terms


def _check_terms(x: torch.Tensor, n_fft: int, hop: int, rs: int) -> int:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not phasor_terms_supported(n_fft, hop, rs):
        raise ValueError(
            f"stft_phasor_terms requires n_fft a power of two <= {MAX_N_FFT}, "
            f"hop | n_fft and rs > 0 (got n_fft={n_fft}, hop={hop}, rs={rs})"
        )
    nf = num_frames(x.shape[-1], n_fft, hop)
    if nf <= 0:
        raise ValueError("input shorter than one frame")
    return nf


def stft_phasor_terms_reference(
    x: torch.Tensor, n_fft: int, hop: int, rs: int, scan: bool = True,
    return_u: bool = False,
) -> tuple:
    """Plain torch version of stft_phasor_terms, on x's device."""
    nf = _check_terms(x, n_fft, hop, rs)
    nh = n_fft // 2
    w = hann_window(n_fft, device=x.device)
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * w, dim=-1)
    mag, ure, uim = _unit(spec.real, spec.imag)  # (nf, nh + 1)
    pre = torch.cat([torch.ones_like(ure[:1]), ure[:-1]])
    pim = torch.cat([torch.zeros_like(uim[:1]), uim[:-1]])
    c = torch.as_tensor(_phasor_consts(n_fft, hop, rs)[:, 1:], device=x.device)
    gre, gim = _step_terms(ure[:, 1:nh], uim[:, 1:nh], pre[:, 1:nh], pim[:, 1:nh], c, rs, hop)
    spin = torch.ones(nh + 1, device=x.device)
    if rs % 2:
        spin[nh] = -1.0
    dre = (ure * pre + uim * pim) * spin  # the forced-real bins
    dim = (uim * pre - ure * pim) * spin
    tre = torch.cat([dre[:, :1], gre, dre[:, nh:]], dim=1)
    tim = torch.cat([dim[:, :1], gim, dim[:, nh:]], dim=1)
    tre[0], tim[0] = ure[0], uim[0]  # the first frame: the anchor u_0
    if scan:
        tre, tim, _ = _chunked_prefix_product(tre, tim)
    if return_u:
        return mag, tre, tim, ure, uim, nf
    return mag, tre, tim, nf


def stft_phasor_terms(
    x: torch.Tensor, n_fft: int, hop: int, rs: int, scan: bool = True,
    return_u: bool = False,
) -> tuple:
    """Framing + windowed DFT + phasor terms (+ the renormalized prefix
    product) of a 1-D float32 signal, for any Rs > 0.

    With scan=True (default) (pre, pim) are the synthesis phasors
    P = e^{i psi}; with scan=False the step terms: u_0 for the first
    frame, c (u_i conj(u_{i-1}) h)^k for the general bins, u_i conj(u_{i-1})
    times (-1)^Rs at Nyquist and times 1 at DC. Returns (mag, pre, pim, nf),
    or (mag, pre, pim, ure, uim, nf) with return_u=True, each (nf,
    n_fft//2+1) at the true bin count (the JAX function's are lane-padded).

    A CUDA tensor launches the pvoc_terms kernel and counts one launch in
    `stft_phasor_terms.launches`; a CPU tensor runs
    stft_phasor_terms_reference.
    """
    nf = _check_terms(x, n_fft, hop, rs)
    if x.device.type == "cpu":
        return stft_phasor_terms_reference(x, n_fft, hop, rs, scan, return_u)
    _check_cuda(x, "stft_phasor_terms")
    nb = n_fft // 2 + 1
    f32 = dict(dtype=torch.float32, device=x.device)
    spec = torch.empty((nf, 2 * nb), **f32)
    mag = torch.empty((nf, nb), **f32)
    t = torch.empty((2, nf, nb), **f32)
    u = torch.empty((2, nf, nb), **f32) if return_u else None
    tot = carry = None
    if scan:
        tot = torch.empty((-(-nf // SCAN_CHUNK), nb, 2), **f32)
        carry = torch.empty_like(tot)
    tables = _device_tables(n_fft, hop, rs, str(x.device))
    p, q = _rational_k(rs, hop)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        rc = lib.pvoc_terms(
            x.data_ptr(), spec.data_ptr(), mag.data_ptr(), t.data_ptr(),
            None if u is None else u.data_ptr(),
            None if tot is None else tot.data_ptr(),
            None if carry is None else carry.data_ptr(),
            tables["fft"].data_ptr(), tables["consts"].data_ptr(),
            nf, n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), int(scan), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pvoc_terms")
    stft_phasor_terms.launches += 1
    if return_u:
        return mag, t[0], t[1], u[0], u[1], nf
    return mag, t[0], t[1], nf


stft_phasor_terms.launches = 0
