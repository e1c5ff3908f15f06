"""Fused phasor-form TSM (counterpart of phase_vocoder_tpu/ops/pallas/fused.py).

For a synthesis/analysis hop ratio k = Rs/Ra = p/q the phase propagation
is phasor algebra on the unit analysis phasors u_i = X_i/|X_i|:

  integer k (q = 1): P_i = u_0 (u_i conj u_0)^k           (closed form)
  q >= 2:            P_i = prod_{j<=i} term_j, renormalized, with
                     term_0 = u_0 and
                     term_i = c (u_i conj u_{i-1} h)^k,
                     h = e^{-i Ra w_b}, c = e^{+i Rs w_b}
  Y_i = |X_i| P_i; DC passes through, Nyquist times (-1)^(Rs i).

Six wrappers of csrc/pvoc_fused.cu, each with its plain torch version
(`*_reference`) beside it; a CUDA tensor launches the kernel (counting one
launch as launches.<wrapper> in utils/profiling's registry, through
_build.launch) or raises, a CPU tensor runs the plain version:

  fused_time_stretch       the whole TSM of one recording (framing,
                           windowed DFT, phasors, inverse DFT, overlap-add,
                           COLA normalization); with zrev=True the analysis
                           runs the fold pass (a half-length transform of
                           the frame's packed even and odd samples), a
                           measurement variant kept for parity with the JAX
                           package, not a user option;
  fused_time_stretch_batch the same TSM over the rows of a (B, T) batch,
                           each row with its own frame count
                           (parallel/batch.py);
  fused_stream_segment     the same TSM on one F-frame segment, with the
                           cross-segment state in and out (streaming.py's
                           fused executor, parallel/chunked.py's
                           integer-k body);
  stft_phasor_terms(_batch) framing, windowed DFT, |X|, unit phasors and
                           the step terms of every bin, optionally scanned
                           (the general-hop route of pipeline.py, the
                           chunked bodies), of one recording or a batch;
  phasor_istft_ola(_batch) Y = mask |X| P from given phasors, inverse
                           DFT and overlap-add, normalized without a mask
                           (the chunked bodies' synthesis).

Which kernel body does the transforms: for n_fft a power of two from 256
to 4096 (real_body), every entry above runs its analysis and its
synthesis on csrc/fft_real.cuh's n_fft/2-point body (N/32 threads a
frame, several frames a block): the analysis in analysis_real (a group of
frames read as one span, the packed real frame transformed and split;
the fold pass of zrev=True is this same kernel there), the synthesis in
synth_real, which phasor_istft_ola(_batch) feed straight from the
magnitude and phasor planes, and which at integer k forms the closed form
itself from the spectra and a per-row anchor table (closed_in_synth: no
phase pass, no packed Y). For any other even n_fft, a block a frame on
csrc/fft_common.cuh's FFT: fft_analysis (fft_analysis_fold for zrev=True)
and fft_synthesis, after a pass that packs Y. The overlap-add of every
entry is one gather (ola_rows) that gives each output row to a warp.

The plain helpers of the chunked bodies (phasor_scan,
phasor_prefix_exclusive, boundary_step_term) sit beside them.

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

from ..utils import profiling
from . import _build, phase
from .framing import frame_signal, num_frames
from .window import _hann_f64, hann_window

__all__ = [
    "phasor_supported",
    "phasor_terms_supported",
    "synth_supported",
    "real_body",
    "fused_time_stretch",
    "fused_time_stretch_reference",
    "fused_time_stretch_zrev",
    "fold_analysis_applies",
    "fused_time_stretch_batch",
    "fused_time_stretch_batch_reference",
    "fused_stream_segment",
    "fused_stream_segment_reference",
    "stream_norm_tables",
    "anchor_table_reference",
    "stft_phasor_terms",
    "stft_phasor_terms_reference",
    "stft_phasor_terms_batch",
    "stft_phasor_terms_batch_reference",
    "phasor_istft_ola",
    "phasor_istft_ola_reference",
    "phasor_istft_ola_batch",
    "phasor_istft_ola_batch_reference",
    "phasor_scan",
    "phasor_prefix_exclusive",
    "boundary_step_term",
    "set_q_algebraic",
]

_TINY = 1e-30
# Frames per chunk of the q >= 2 prefix product (kernel and plain version).
SCAN_CHUNK = 64


# Largest N whose two FFT buffers fit the kernel's default shared memory.
MAX_N_FFT = 4096


def fft_size_supported(n_fft: int) -> bool:
    """True when the kernels' FFT (csrc/fft_common.cuh) takes n_fft: even,
    2 <= n_fft <= MAX_N_FFT (radix 2 for a power of two, mixed radix for
    any other even size). Even, because bin n_fft/2 goes through the
    forced-real Nyquist pass-through, as in the JAX package."""
    return 2 <= n_fft <= MAX_N_FFT and n_fft % 2 == 0


# The limit on n_fft, for error texts.
_FFT_LIMIT = f"n_fft even and 2 <= n_fft <= {MAX_N_FFT}"


def fold_analysis_applies(n_fft: int, hop: int) -> bool:
    """True when fused_time_stretch(zrev=True) runs the fold analysis: an
    even overlap n_fft/hop, the JAX package's rule for its pre-reversed
    view, and n_fft a multiple of 4, what the fold pass needs for its
    n_fft/2-point transform. Otherwise zrev changes nothing.

    On the card, where real_body(n_fft) the fold analysis and the default
    analysis are one kernel (analysis_real: the real-input transform is
    the fold), so the pvoc_fused_zrev entry returns pvoc_fused's output
    bit for bit; it stays an entry with its own launch count, for parity
    with the JAX package's _pvoc_kernel_z. At the other multiples of 4
    it runs its own kernel (fft_analysis_fold). The plain version of
    zrev=True is _rfft_fold at every n_fft."""
    return n_fft % hop == 0 and (n_fft // hop) % 2 == 0 and n_fft % 4 == 0


def phasor_supported(n_fft: int, ra: int, rs: int) -> bool:
    """True when the fused kernel covers this geometry: fft_size_supported,
    Ra | N and overlap >= 2 (0 < Rs <= N/2)."""
    return fft_size_supported(n_fft) and n_fft % ra == 0 and 0 < rs and 2 * rs <= n_fft


def phasor_terms_supported(n_fft: int, ra: int, rs: int) -> bool:
    """True when the pvoc_terms kernel covers this geometry: the FFT's
    n_fft, Ra | N and any Rs > 0 (the JAX function puts no bound on Rs)."""
    return fft_size_supported(n_fft) and n_fft % ra == 0 and rs > 0


def real_body(n_fft: int) -> bool:
    """True when csrc/fft_real.cuh's n_fft/2-point body serves n_fft (a
    power of two from 256 to 4096, real_fft::real_log2 in C): there every
    entry's analysis runs analysis_real (for zrev=True too) and its
    synthesis synth_real, and pvoc_phasor_synth needs no packed-Y scratch;
    at every other even n_fft, fft_analysis / fft_analysis_fold and
    fft_synthesis, a block a frame."""
    return 256 <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0


def synth_supported(n_fft: int, rs: int) -> bool:
    """True when phasor_istft_ola(_batch) take this geometry: the FFT's
    n_fft and the JAX function's exact-fold layout, Rs | N and N/Rs >= 2."""
    return fft_size_supported(n_fft) and 0 < rs and n_fft % rs == 0 and n_fft // rs >= 2


def _rational_k(rs: int, ra: int) -> tuple[int, int]:
    """Reduced (p, q) with k = Rs/Ra = p/q."""
    g = math.gcd(rs, ra)
    return rs // g, ra // g


# ------------------------------------------------------------ host tables


@functools.lru_cache(maxsize=16)
def _fft_tables(n_fft: int) -> np.ndarray:
    """(2 n_fft,) f32: the periodic Hann window (n_fft), then cos and sin
    of 2 pi k / n_fft for k < n_fft/2 (the FFT twiddles), built in f64."""
    with profiling.setup("tables"):
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
    with profiling.setup("tables"):
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
    with profiling.setup("tables"):
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
def _device_fft_table(n_fft: int, device: str) -> torch.Tensor:
    """[Hann window | cos | sin] of _fft_tables, float32 on `device`."""
    with profiling.setup("tables"):
        return torch.as_tensor(_fft_tables(n_fft), device=device)


@functools.lru_cache(maxsize=16)
def _device_tables(n_fft: int, ra: int, rs: int, device: str) -> dict:
    """The kernel's float32 tables on `device`, built once per geometry."""
    with profiling.setup("tables"):
        return {
            "fft": _device_fft_table(n_fft, device),
            "consts": torch.as_tensor(_phasor_consts(n_fft, ra, rs), device=device),
        }


@functools.lru_cache(maxsize=64)
def _device_norm_rows(n_fft: int, rs: int, nf_key: int, device: str) -> torch.Tensor:
    with profiling.setup("tables"):
        return torch.as_tensor(_ola_norm_rows(n_fft, rs, nf_key), device=device)


@functools.lru_cache(maxsize=16)
def _device_norm_stack(n_fft: int, rs: int, device: str) -> torch.Tensor:
    """(m-1, 2m-1, rs): the normalization rows of every frame count
    1..m-1 (a count of m-1 or more shares the last), for a ragged batch."""
    with profiling.setup("tables"):
        m = -(-n_fft // rs)
        return torch.as_tensor(
            np.stack([_ola_norm_rows(n_fft, rs, key) for key in range(1, m)]), device=device
        )


@functools.lru_cache(maxsize=16)
def _device_unit_rows(n_fft: int, rs: int, device: str) -> torch.Tensor:
    """(2m-1, rs) ones: the gather's table for an un-normalized sum."""
    with profiling.setup("tables"):
        return torch.ones((2 * (-(-n_fft // rs)) - 1, rs), dtype=torch.float32, device=device)


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


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernels' sqrtf (IEEE, no
    fast math) gives it. On the CPU, numpy's (the processor's square root
    instruction): torch.sqrt of a CPU tensor goes through the math
    library's vector routine, which is not correctly rounded (about 0.7%
    of float32 results one ulp off, torch 2.13) and, now and then under
    load, returns a few results far less accurate (a float64 call once
    gave 2 of 32,832 values 2.4e-10 off, right again when recomputed). In
    the phasor algebra such a value can flip a branch choice of q >= 2 in
    a quiet bin. On a card, torch.sqrt is the IEEE square root."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _principal_sqrt(zre, zim):
    """Principal square root (Re >= 0) of unit-modulus z, elementwise.

    Branches on sign(zre) so neither square root suffers cancellation; at
    zre = -1 the zim >= 0 branch picks +i (princarg(pi) = pi -> pi/2).
    """
    re_pos = _sqrt_rn(torch.clamp_min(0.5 * (1.0 + zre), 0.25))
    im_pos = zim / (2.0 * re_pos)
    t_neg = _sqrt_rn(torch.clamp_min(0.5 * (1.0 - zre), 0.25))
    im_neg = torch.where(zim >= 0, t_neg, -t_neg)
    re_neg = torch.abs(zim) / (2.0 * t_neg)
    pos = zre >= 0
    return torch.where(pos, re_pos, re_neg), torch.where(pos, im_pos, im_neg)


# The q in {2, 4} term path: True (the default) forms z^k by principal
# square roots and the integer power (no transcendentals), False by the
# angle domain (atan2, times k, cos/sin) that the other q take. The A/B
# knob of the JAX package's set_q_algebraic, for its branch-tracking
# accuracy experiment: the two differ only in rounding near the princarg
# branch point. q = 1 always stays algebraic. No cache holds anything that
# depends on it (the tables and workspaces depend on the geometry only),
# so the setter clears nothing.
_Q_ALGEBRAIC = True


def set_q_algebraic(enabled: bool) -> None:
    """Choose the q in {2, 4} term path for every later call, plain
    version and kernels alike: True principal roots + integer power,
    False the angle domain."""
    global _Q_ALGEBRAIC
    _Q_ALGEBRAIC = bool(enabled)


def _pow_alg(p: int, q: int) -> bool:
    """True: principal roots + integer power; False: angle domain. The
    JAX package's condition in its _pow_k, letter for letter."""
    return q in (1, 2, 4) and p <= 8 and (q == 1 or _Q_ALGEBRAIC)


def _pow_k(zre, zim, rs: int, ra: int):
    """z^k for rational k = rs/ra and unit z: e^{i k princarg(arg z)}.

    q in {1, 2, 4} with p <= 8: nested principal square roots, then the
    integer power (pure algebra); q in {2, 4} only under
    set_q_algebraic(True), the default. Otherwise the angle domain: atan2,
    times k, cos/sin. A zim of -0 counts as +0, so the branch point maps to +pi
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
    return _angle_pow(zre, zim, float(np.float32(p / q)))


def _f64_rn(fn, *args: torch.Tensor) -> torch.Tensor:
    """fn (a numpy function) of float32 CPU tensors, evaluated in float64
    and rounded once to float32: the correctly rounded float32 result but
    for a value within float64's error of a rounding boundary."""
    return torch.from_numpy(fn(*(a.numpy().astype(np.float64) for a in args)).astype(np.float32))


def _angle_pow(zre, zim, k: float):
    """e^{i k atan2(zim, zre)} (zim = -0 counts as +0). On the CPU the
    transcendentals come from _f64_rn, so that a result depends on its
    input alone, as _sqrt_rn does for the square root: torch's CPU atan2,
    cos and sin are vector routines of the host's instruction set that
    round 2-5% of float32 results otherwise (torch 2.13, AVX512) and the
    last elements of a thread's range in scalar code; one plain call at
    k = 1/2 on 60 s gave two outputs in two runs on one kind of host (a
    branch of a quiet bin: 1.8e-4 and 2.7e-6 from golden). On a card,
    torch's (CUDA's atan2f, cosf, sinf)."""
    zim = torch.where(zim == 0, 0.0, zim)
    if zre.device.type == "cpu":
        ang = _f64_rn(np.arctan2, zim, zre) * k
        return _f64_rn(np.cos, ang), _f64_rn(np.sin, ang)
    ang = torch.atan2(zim, zre) * k
    return torch.cos(ang), torch.sin(ang)


def _unit(re, im):
    """(|X|, u_re, u_im) with u = 1 where |X|^2 <= 1e-30."""
    n2 = re * re + im * im
    mag = _sqrt_rn(n2)
    safe = n2 > _TINY
    return mag, torch.where(safe, re / mag, 1.0), torch.where(safe, im / mag, 0.0)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _normalize(re, im):
    r = _sqrt_rn(torch.clamp_min(re * re + im * im, _TINY))
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
            f"fused path requires {_FFT_LIMIT}, "
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


def _rfft_fold(g: torch.Tensor) -> torch.Tensor:
    """Bins 0..N/2 of the DFT of real frames g (nf, N), N a multiple of 4,
    from a transform of half the length (the fold analysis of the kernel):
    z[n] = g[2n] + i g[2n+1], Z = FFT_{N/2}(z), and with M[k] =
    conj Z[(N/2-k) mod N/2] (a flip), X[k] = (Z[k] + M[k])/2 -
    i W^k (Z[k] - M[k])/2, W = e^{-2 pi i / N} built in float64."""
    n_fft = g.shape[-1]
    half = n_fft // 2
    z = torch.fft.fft(torch.complex(g[:, 0::2], g[:, 1::2]), dim=-1)
    zk = torch.cat([z, z[:, :1]], dim=1)  # Z[k mod N/2], k = 0..N/2
    zm = torch.conj(torch.flip(zk, dims=[1]))
    ang = -2.0 * np.pi * np.arange(half + 1, dtype=np.float64) / n_fft
    w = torch.as_tensor((np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64), device=g.device)
    w[half] = -1.0
    return 0.5 * (zk + zm) + w * (-0.5j * (zk - zm))


def anchor_table_reference(
    re0: torch.Tensor, im0: torch.Tensor, carry: torch.Tensor | None = None,
    started: bool = False,
) -> torch.Tensor:
    """The anchor table of the integer-k closed form, (..., 2, n_fft/2-1) =
    [re | im] of u_0 over the general bins 1..n_fft/2-1: the unit phasor
    (u = 1 where |X|^2 <= 1e-30) of the recording's frame 0, whose bins
    0..n_fft/2 are re0, im0 (..., n_fft/2+1), until the recording has
    started; after that, rows 0-1 of a stream's carry (4, n_fft/2-1). The
    plain version of csrc/pvoc_fused.cu's phase_anchor (one table per batch
    row) and of the integer-k rows 0-1 that carry_phasor leaves in a
    segment's carry, which synth_real's closed-form load reads."""
    if started:
        return carry[:2]
    nh = re0.shape[-1] - 1
    _, ure, uim = _unit(re0[..., 1:nh], im0[..., 1:nh])
    return torch.stack([ure, uim], dim=-2)


def _tsm_frames_reference(
    x: torch.Tensor, goff: int, n_valid: int, n_fft: int, hop: int, rs: int,
    carry: torch.Tensor, started: bool, x_frame0: int = 0, fold: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain analysis, phase and synthesis of frames goff..goff+n_valid-1
    of the recording, whose frame x_frame0 starts at x[0], from `carry`;
    fold: the analysis through _rfft_fold. Returns (windowed frames
    (n_valid, n_fft), the carry after them)."""
    nh = n_fft // 2
    w = hann_window(n_fft, device=x.device)
    start = (goff - x_frame0) * hop
    xs = x[start : start + (n_valid - 1) * hop + n_fft]
    windowed = frame_signal(xs, n_fft, hop) * w
    spec = _rfft_fold(windowed) if fold else torch.fft.rfft(windowed, dim=-1)
    re, im = spec.real, spec.imag  # (n_valid, nh + 1)
    mag, ure, uim = _unit(re[:, 1:nh], im[:, 1:nh])  # general bins
    p, q = _rational_k(rs, hop)
    if q == 1:
        anchor = anchor_table_reference(re[0], im[0], carry, started)
        u0re, u0im = anchor[0:1], anchor[1:2]
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
    x: torch.Tensor, n_fft: int, hop: int, rs: int, zrev: bool = False
) -> torch.Tensor:
    """Plain torch version of the fused TSM, on x's device.

    torch.fft in float32 for the DFTs, the phasor algebra above, the
    chunked prefix product for q >= 2, and fold overlap-add. With zrev
    (where fold_analysis_applies) the analysis is _rfft_fold, the algebra
    of the kernel's fold pass. Returns (nf-1)*rs + n_fft samples.
    """
    nf = _check_args(x, n_fft, hop, rs)
    fold = zrev and fold_analysis_applies(n_fft, hop)
    frames, _ = _tsm_frames_reference(
        x, 0, nf, n_fft, hop, rs, init_carry(n_fft, x.device), False, fold=fold
    )
    ola = _normalize_rows(_ola_rows_reference(frames, nf, rs, None), 0, nf, n_fft, rs)
    return ola.reshape(-1)[: (nf - 1) * rs + n_fft]


def fused_time_stretch(
    x: torch.Tensor, n_fft: int, hop: int, rs: int, zrev: bool = False
) -> torch.Tensor:
    """Full fused TSM of a 1-D float32 tensor, on x's device.

    A CUDA tensor goes through the hand-written kernel (csrc/pvoc_fused.cu)
    and counts one launch as launches.fused_time_stretch; a CPU tensor
    goes through fused_time_stretch_reference. Returns (nf-1)*rs + n_fft
    samples.

    zrev=True (the JAX function's argument of that name, a measurement
    variant) runs the analysis as the fold pass, the pvoc_fused_zrev entry,
    counted as launches.fused_time_stretch_zrev. As in the JAX package
    the geometry decides: it applies when fold_analysis_applies(n_fft, hop)
    (an even overlap n_fft/hop, and n_fft a multiple of 4) and is otherwise
    the same call as zrev=False. On the card, where real_body(n_fft), the
    kernel's analysis is the fold pass for zrev=False as well, so the two
    outputs are equal bit for bit; at the other N, and in the plain
    versions (_rfft_fold against torch.fft.rfft), zrev=True is within
    ~1e-5 interior relative of zrev=False (another rounding of the forward
    transform). Its reruns are bitwise equal.
    """
    nf = _check_args(x, n_fft, hop, rs)
    if zrev and fold_analysis_applies(n_fft, hop):
        return fused_time_stretch_zrev(x, n_fft, hop, rs)
    if x.device.type == "cpu":
        return fused_time_stretch_reference(x, n_fft, hop, rs)
    return _fused_launch(x, nf, n_fft, hop, rs, fused_time_stretch)


def fused_time_stretch_zrev(x: torch.Tensor, n_fft: int, hop: int, rs: int) -> torch.Tensor:
    """fused_time_stretch(zrev=True) where the fold analysis applies (raises
    ValueError elsewhere). A CUDA tensor launches the pvoc_fused_zrev kernel
    and counts one launch as launches.fused_time_stretch_zrev; a CPU
    tensor runs fused_time_stretch_reference(zrev=True)."""
    nf = _check_args(x, n_fft, hop, rs)
    if not fold_analysis_applies(n_fft, hop):
        raise ValueError(
            f"the fold analysis needs an even n_fft/hop and n_fft a multiple of 4 "
            f"(got n_fft={n_fft}, hop={hop})"
        )
    if x.device.type == "cpu":
        return fused_time_stretch_reference(x, n_fft, hop, rs, zrev=True)
    return _fused_launch(x, nf, n_fft, hop, rs, fused_time_stretch_zrev)


def _fused_launch(x: torch.Tensor, nf: int, n_fft: int, hop: int, rs: int, wrapper) -> torch.Tensor:
    """The pvoc_fused kernel for `wrapper` (fused_time_stretch), or the
    pvoc_fused_zrev kernel (fused_time_stretch_zrev), counting its launch."""
    fold = wrapper is fused_time_stretch_zrev
    with profiling.span("pv.prepare"):
        _check_cuda(x, wrapper.__name__)
        dev = str(x.device)
        tables = _device_tables(n_fft, hop, rs, dev)
        norm = _device_norm_rows(n_fft, rs, min(nf, -(-n_fft // rs) - 1), dev)
        p, q = _rational_k(rs, hop)
        out = torch.empty((nf - 1) * rs + n_fft, dtype=torch.float32, device=x.device)
        work = _workspace(nf, n_fft, q, x.device)
        lib = _build.kernels()
        half = [_device_fft_table(n_fft // 2, dev).data_ptr()] if fold else []
    with torch.cuda.device(x.device):
        _build.launch(
            wrapper.__name__, lib.pvoc_fused_zrev if fold else lib.pvoc_fused,
            x.data_ptr(), out.data_ptr(), *_ptrs(work),
            tables["fft"].data_ptr(), *half, tables["consts"].data_ptr(),
            norm.data_ptr(), nf, n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), torch.cuda.current_stream().cuda_stream,
        )
    return out


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")


def closed_in_synth(n_fft: int, q: int) -> bool:
    """True where the kernels run the integer-k phase in the synthesis's
    load (csrc/pvoc_fused.cu closed_in_synth): q = 1 and real_body(n_fft).
    There synth_real forms Y = |X| u_0 (u conj u_0)^k from the spectra and
    an anchor table as it loads them, so the TSM entries need no packed-Y
    scratch; everywhere else phase_closed or the q >= 2 passes write Y."""
    return q == 1 and real_body(n_fft)


def _workspace(frames: int, n_fft: int, q: int, device, batch: int = 1,
               segment: bool = False) -> dict:
    """Scratch of the TSM passes for `batch` rows of `frames` frames:
    spectra, windowed frames, and either the packed Y or, where
    closed_in_synth, the (batch, 2, n_fft/2-1) anchor table (none for a
    stream segment, whose carry holds its anchor); and the chunk totals and
    carries of the q >= 2 scan."""
    f32 = dict(dtype=torch.float32, device=device)
    closed = closed_in_synth(n_fft, q)
    work = {
        "spec": torch.empty((batch * frames, n_fft + 2), **f32),
        "y": None if closed else torch.empty((batch * frames, n_fft + 2), **f32),
        "anchor": (torch.empty((batch, 2, n_fft // 2 - 1), **f32)
                   if closed and not segment else None),
        "frames": torch.empty((batch * frames, n_fft), **f32),
        "tot": None,
        "carry": None,
    }
    if q > 1:
        nch = batch * -(-frames // SCAN_CHUNK)
        work["tot"] = torch.empty((nch, n_fft // 2 - 1, 2), **f32)
        work["carry"] = torch.empty_like(work["tot"])
    return work


def _ptrs(work: dict) -> list:
    return [
        None if work[k] is None else work[k].data_ptr()
        for k in ("spec", "y", "anchor", "frames", "tot", "carry")
    ]


# ------------------------------------------------------ one stream segment


def _check_segment(x, carry, tail, frame_offset: int, n_fft: int, hop: int, rs: int, seg_frames: int):
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not phasor_supported(n_fft, hop, rs):
        raise ValueError(
            f"fused stream requires {_FFT_LIMIT}, hop | n_fft "
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
    out: torch.Tensor | None = None, x_frame0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of fused_stream_segment, on x's device."""
    _check_segment(x, carry, tail, frame_offset, n_fft, hop, rs, seg_frames)
    n_valid = min(max(nf - frame_offset, 0), seg_frames)
    if n_valid:
        frames, new_carry = _tsm_frames_reference(
            x, frame_offset, n_valid, n_fft, hop, rs, carry, started, x_frame0
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
    out: torch.Tensor | None = None, work: dict | None = None, x_frame0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One F-frame segment of the streaming fused TSM.

    x: the 1-D float32 signal of the recording (nf frames) from the start
    of its frame x_frame0 on (0: the whole signal); the segment covers
    frames frame_offset .. frame_offset+F-1, of which those below nf are
    real.
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
    launch as launches.fused_stream_segment; a CPU tensor runs
    fused_stream_segment_reference.
    """
    if x.device.type == "cpu":
        return fused_stream_segment_reference(
            x, carry, tail, started, frame_offset, nf, n_fft, hop, rs, seg_frames, out,
            x_frame0,
        )
    with profiling.span("pv.prepare"):
        _check_segment(x, carry, tail, frame_offset, n_fft, hop, rs, seg_frames)
        for t, what in ((x, "x"), (carry, "carry"), (tail, "tail")):
            _check_cuda(t, f"fused_stream_segment ({what})")
        n_valid = min(max(nf - frame_offset, 0), seg_frames)
        if n_valid and not (
            x_frame0 <= frame_offset
            and (frame_offset - x_frame0 + n_valid - 1) * hop + n_fft <= x.shape[0]
        ):
            raise ValueError(
                f"x ({x.shape[0]} samples from frame {x_frame0}) does not hold frames "
                f"{frame_offset}..{frame_offset + n_valid - 1}"
            )
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
        x_seg = x.data_ptr() + ((frame_offset - x_frame0) * hop * 4 if n_valid else 0)
        lib = _build.kernels()
    with torch.cuda.device(x.device):
        _build.launch(
            "fused_stream_segment", lib.pvoc_fused_segment,
            x_seg, out.data_ptr(), tail_out.data_ptr(), carry_out.data_ptr(),
            *_ptrs(work), tables["fft"].data_ptr(), tables["consts"].data_ptr(),
            norm.data_ptr(), carry.data_ptr(), tail.data_ptr(),
            n_valid, seg_frames, frame_offset, nf, int(bool(started)),
            n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), torch.cuda.current_stream().cuda_stream,
        )
    return out, carry_out, tail_out


def segment_workspace(seg_frames: int, n_fft: int, hop: int, rs: int, device) -> dict:
    """Scratch of pvoc_fused_segment for F-frame segments, allocated once
    per stream call and reused by every segment."""
    return _workspace(seg_frames, n_fft, _rational_k(rs, hop)[1], device, segment=True)


# ------------------------------------------------------------ phasor terms


def _check_terms(x: torch.Tensor, n_fft: int, hop: int, rs: int, dim: int = 1) -> int:
    if x.dtype != torch.float32 or x.dim() != dim:
        raise ValueError(f"expected a {dim}-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not phasor_terms_supported(n_fft, hop, rs):
        raise ValueError(
            f"stft_phasor_terms requires {_FFT_LIMIT}, "
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


def _terms_launch(xs: torch.Tensor, nf: int, n_fft: int, hop: int, rs: int, scan: bool,
                  return_u: bool, what: str) -> tuple:
    """The pvoc_terms kernel over the rows of xs (B, T): planes (B, nf, nb);
    `what` is the launching wrapper's name."""
    with profiling.span("pv.prepare"):
        _check_cuda(xs, what)
        B, nb = xs.shape[0], n_fft // 2 + 1
        f32 = dict(dtype=torch.float32, device=xs.device)
        spec = torch.empty((B * nf, 2 * nb), **f32)
        mag = torch.empty((B, nf, nb), **f32)
        t = torch.empty((2, B, nf, nb), **f32)
        u = torch.empty((2, B, nf, nb), **f32) if return_u else None
        tot = carry = None
        if scan:
            tot = torch.empty((B * -(-nf // SCAN_CHUNK), nb, 2), **f32)
            carry = torch.empty_like(tot)
        tables = _device_tables(n_fft, hop, rs, str(xs.device))
        p, q = _rational_k(rs, hop)
        lib = _build.kernels()
    with torch.cuda.device(xs.device):
        _build.launch(
            what, lib.pvoc_terms,
            xs.data_ptr(), spec.data_ptr(), mag.data_ptr(), t.data_ptr(),
            None if u is None else u.data_ptr(),
            None if tot is None else tot.data_ptr(),
            None if carry is None else carry.data_ptr(),
            tables["fft"].data_ptr(), tables["consts"].data_ptr(),
            nf, n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), int(scan), B, xs.shape[-1],
            torch.cuda.current_stream().cuda_stream,
        )
    if return_u:
        return mag, t[0], t[1], u[0], u[1]
    return mag, t[0], t[1]


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

    A CUDA tensor launches the pvoc_terms kernel and counts one launch as
    launches.stft_phasor_terms; a CPU tensor runs
    stft_phasor_terms_reference.
    """
    nf = _check_terms(x, n_fft, hop, rs)
    if x.device.type == "cpu":
        return stft_phasor_terms_reference(x, n_fft, hop, rs, scan, return_u)
    planes = _terms_launch(x[None], nf, n_fft, hop, rs, scan, return_u, "stft_phasor_terms")
    return (*(p[0] for p in planes), nf)


def stft_phasor_terms_batch_reference(
    xs: torch.Tensor, n_fft: int, hop: int, rs: int, scan: bool = True,
    return_u: bool = False,
) -> tuple:
    """Plain torch version of stft_phasor_terms_batch: the single-recording
    plain version row by row, stacked."""
    nf = _check_terms(xs, n_fft, hop, rs, dim=2)
    rows = [stft_phasor_terms_reference(x, n_fft, hop, rs, scan, return_u) for x in xs]
    return (*(torch.stack(planes) for planes in zip(*(r[:-1] for r in rows))), nf)


def stft_phasor_terms_batch(
    xs: torch.Tensor, n_fft: int, hop: int, rs: int, scan: bool = True,
    return_u: bool = False,
) -> tuple:
    """stft_phasor_terms of every row of a (B, T) float32 batch, in one
    launch: the same contract per row, planes (B, nf, n_fft//2+1). The JAX
    function's (batch, tile) grid reset its carry at each row's first tile;
    the kernel's passes take the batch row as gridDim.y.

    A CUDA tensor launches the pvoc_terms kernel over the batch and counts
    one launch as launches.stft_phasor_terms_batch; a CPU tensor runs
    stft_phasor_terms_batch_reference.
    """
    nf = _check_terms(xs, n_fft, hop, rs, dim=2)
    if xs.device.type == "cpu":
        return stft_phasor_terms_batch_reference(xs, n_fft, hop, rs, scan, return_u)
    planes = _terms_launch(xs, nf, n_fft, hop, rs, scan, return_u, "stft_phasor_terms_batch")
    return (*planes, nf)


# ------------------------------------------------------ batched fused TSM


def _check_batch(xs: torch.Tensor, n_fft: int, hop: int, rs: int, n_valid_frames) -> tuple[int, list]:
    """(frames of the padded rows, each row's own frame count)."""
    if xs.dtype != torch.float32 or xs.dim() != 2:
        raise ValueError(f"expected a (B, T) float32 tensor, got {xs.dtype} {tuple(xs.shape)}")
    if not phasor_supported(n_fft, hop, rs):
        raise ValueError(
            f"fused path requires {_FFT_LIMIT}, "
            f"hop | n_fft and 0 < rs <= n_fft/2 "
            f"(got n_fft={n_fft}, hop={hop}, rs={rs})"
        )
    nf = num_frames(xs.shape[-1], n_fft, hop)
    if nf <= 0:
        raise ValueError("input shorter than one frame")
    if n_valid_frames is None:
        return nf, [nf] * xs.shape[0]
    if isinstance(n_valid_frames, torch.Tensor):
        n_valid_frames = n_valid_frames.tolist()
    nfs = [int(v) for v in n_valid_frames]
    if len(nfs) != xs.shape[0] or not all(0 <= v <= nf for v in nfs):
        raise ValueError(f"n_valid_frames must be {xs.shape[0]} counts in 0..{nf}, got {nfs}")
    return nf, nfs


def fused_time_stretch_batch_reference(
    xs: torch.Tensor, n_fft: int, hop: int, rs: int, n_valid_frames=None
) -> torch.Tensor:
    """Plain torch version of fused_time_stretch_batch: the single-recording
    plain version on each row's own frames, zeros after."""
    nf, nfs = _check_batch(xs, n_fft, hop, rs, n_valid_frames)
    out = xs.new_zeros((xs.shape[0], (nf + -(-n_fft // rs) - 1) * rs))
    for b, nf_b in enumerate(nfs):
        if nf_b:
            y = fused_time_stretch_reference(xs[b, : (nf_b - 1) * hop + n_fft], n_fft, hop, rs)
            out[b, : y.shape[0]] = y
    return out


def fused_time_stretch_batch(
    xs: torch.Tensor, n_fft: int, hop: int, rs: int, n_valid_frames=None
) -> torch.Tensor:
    """The fused TSM of every row of a (B, T) float32 batch in one launch.

    Rows are zero-padded to T; row b has n_valid_frames[b] frames (a list,
    array or tensor of B counts, default all nf = num_frames(T)), its own
    anchor, scan and normalization. Returns (B, (nf+m-1)*rs), m =
    ceil(n_fft/rs): row b's stretched waveform in its first
    (n_b-1)*rs + n_fft samples, normalized at its own frame count, zeros
    after (the JAX function fixes each row's tail rows after its kernel).

    A CUDA tensor launches the pvoc_fused_batch kernel (the passes of
    fused_time_stretch with the batch row as gridDim.y and a device array
    of frame counts) and counts one launch as
    launches.fused_time_stretch_batch; a CPU tensor runs
    fused_time_stretch_batch_reference.
    """
    nf, nfs = _check_batch(xs, n_fft, hop, rs, n_valid_frames)
    if xs.device.type == "cpu":
        return fused_time_stretch_batch_reference(xs, n_fft, hop, rs, nfs)
    with profiling.span("pv.prepare"):
        _check_cuda(xs, "fused_time_stretch_batch")
        B, m = xs.shape[0], -(-n_fft // rs)
        dev = str(xs.device)
        tables = _device_tables(n_fft, hop, rs, dev)
        norm = _device_norm_stack(n_fft, rs, dev)
        counts = torch.tensor(nfs, dtype=torch.int32, device=xs.device)
        p, q = _rational_k(rs, hop)
        out = torch.empty((B, (nf + m - 1) * rs), dtype=torch.float32, device=xs.device)
        work = _workspace(nf, n_fft, q, xs.device, batch=B)
        lib = _build.kernels()
    with torch.cuda.device(xs.device):
        _build.launch(
            "fused_time_stretch_batch", lib.pvoc_fused_batch,
            xs.data_ptr(), counts.data_ptr(), out.data_ptr(), *_ptrs(work),
            tables["fft"].data_ptr(), tables["consts"].data_ptr(), norm.data_ptr(),
            B, xs.shape[1], nf, n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), torch.cuda.current_stream().cuda_stream,
        )
    return out


# ------------------------------------------- synthesis from given phasors


def _check_synth(mag, pre, pim, n_fft: int, rs: int, nf: int, dim: int) -> None:
    if not synth_supported(n_fft, rs):
        raise ValueError(
            f"phasor_istft_ola requires {_FFT_LIMIT}, "
            f"rs | n_fft and n_fft // rs >= 2 (got n_fft={n_fft}, rs={rs})"
        )
    nb = n_fft // 2 + 1
    if any(t.dtype != torch.float32 for t in (mag, pre, pim)):
        raise ValueError("mag, pre, pim must be float32")
    if mag.dim() != dim or mag.shape[-1] != nb or pre.shape != mag.shape or pim.shape != mag.shape:
        raise ValueError(
            f"mag, pre, pim must be {dim}-D with {nb} bins, got "
            f"{tuple(mag.shape)} {tuple(pre.shape)} {tuple(pim.shape)}"
        )
    if not 0 < nf <= mag.shape[-2]:
        raise ValueError(f"nf={nf} must be in 1..{mag.shape[-2]} (the frames given)")


def _full_mask(frame_mask, lead: tuple, nf: int, like: torch.Tensor) -> torch.Tensor:
    """The (*lead, nf) mask of frame_mask (*lead, F): its first min(F, nf)
    frames, zeros after, as the JAX function pads or cuts it."""
    mask = like.new_zeros(lead + (nf,))
    keep = min(frame_mask.shape[-1], nf)
    mask[..., :keep] = frame_mask[..., :keep].to(device=like.device, dtype=like.dtype)
    return mask


def _synth_reference(mag, pre, pim, n_fft: int, rs: int, nf: int, mask) -> torch.Tensor:
    """One recording: Y = mask |X| P (imaginary DC and Nyquist dropped),
    windowed irfft, fold overlap-add, normalized when mask is None."""
    y_re = mag[:nf] * pre[:nf]
    y_im = mag[:nf] * pim[:nf]
    y_im[:, 0] = 0.0
    y_im[:, -1] = 0.0
    if mask is not None:
        y_re = y_re * mask[:, None]
        y_im = y_im * mask[:, None]
    frames = torch.fft.irfft(torch.complex(y_re, y_im), n=n_fft, dim=-1)
    ola = _ola_rows_reference(frames * hann_window(n_fft, mag.device), nf, rs, None)
    if mask is None:
        ola = _normalize_rows(ola, 0, nf, n_fft, rs)
    return ola.reshape(-1)[: (nf - 1) * rs + n_fft]


def _synth_launch(mag, pre, pim, n_fft: int, rs: int, nf: int, mask, what: str) -> torch.Tensor:
    """The pvoc_phasor_synth kernel over (B, >= nf, nb) planes; mask (B, nf)
    or None. Returns (B, (nf-1)*rs + n_fft). Where real_body(n_fft), the
    kernel forms Y from the planes as it loads them (two launches:
    synth_real and the gather); elsewhere a first launch packs Y into a
    (B*nf, 2*nb) scratch, allocated only then, for fft_synthesis. `what`
    is the launching wrapper's name."""
    with profiling.span("pv.prepare"):
        for t in (mag, pre, pim):
            if t.device.type != "cuda":
                raise ValueError(f"{what}: unsupported device {t.device}")
        mag, pre, pim = (t[:, :nf].contiguous() for t in (mag, pre, pim))
        B, nb = mag.shape[0], n_fft // 2 + 1
        dev = str(mag.device)
        f32 = dict(dtype=torch.float32, device=mag.device)
        y = None if real_body(n_fft) else torch.empty((B * nf, 2 * nb), **f32)
        frames = torch.empty((B * nf, n_fft), **f32)
        out = torch.empty((B, (nf - 1) * rs + n_fft), **f32)
        if mask is None:
            norm = _device_norm_rows(n_fft, rs, min(nf, n_fft // rs - 1), dev)
        else:
            norm = _device_unit_rows(n_fft, rs, dev)
        lib = _build.kernels()
    with torch.cuda.device(mag.device):
        _build.launch(
            what, lib.pvoc_phasor_synth,
            mag.data_ptr(), pre.data_ptr(), pim.data_ptr(),
            None if mask is None else mask.data_ptr(), None if y is None else y.data_ptr(),
            frames.data_ptr(),
            out.data_ptr(), _device_fft_table(n_fft, dev).data_ptr(), norm.data_ptr(),
            B, nf, n_fft, rs, torch.cuda.current_stream().cuda_stream,
        )
    return out


def phasor_istft_ola_reference(
    mag: torch.Tensor, pre: torch.Tensor, pim: torch.Tensor, n_fft: int, rs: int,
    nf: int, frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of phasor_istft_ola, on mag's device."""
    _check_synth(mag, pre, pim, n_fft, rs, nf, 2)
    mask = None if frame_mask is None else _full_mask(frame_mask, (), nf, mag)
    return _synth_reference(mag, pre, pim, n_fft, rs, nf, mask)


def phasor_istft_ola(
    mag: torch.Tensor, pre: torch.Tensor, pim: torch.Tensor, n_fft: int, rs: int,
    nf: int, frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Waveform from magnitudes and synthesis phasors (R >= nf, n_fft//2+1)
    float32, of which the first nf frames count: Y = mask |X| P, the
    Hann-windowed inverse DFT and the fold overlap-add. Without frame_mask
    the sum is normalized (head, interior and tail rows, as the fused TSM);
    with a frame_mask (F,) (its first nf entries, zeros past F) it is
    not, and the caller normalizes. Returns (nf-1)*rs + n_fft samples.
    Needs rs | n_fft and n_fft/rs >= 2, as the JAX function.

    A CUDA tensor launches the pvoc_phasor_synth kernel and counts one
    launch as launches.phasor_istft_ola; a CPU tensor runs
    phasor_istft_ola_reference.
    """
    _check_synth(mag, pre, pim, n_fft, rs, nf, 2)
    if mag.device.type == "cpu":
        return phasor_istft_ola_reference(mag, pre, pim, n_fft, rs, nf, frame_mask)
    mask = None if frame_mask is None else _full_mask(frame_mask, (1,), nf, mag)
    out = _synth_launch(mag[None], pre[None], pim[None], n_fft, rs, nf, mask, "phasor_istft_ola")
    return out[0]


def phasor_istft_ola_batch_reference(
    mag: torch.Tensor, pre: torch.Tensor, pim: torch.Tensor, n_fft: int, rs: int,
    nf: int, frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of phasor_istft_ola_batch: the single-recording
    plain version row by row."""
    _check_synth(mag, pre, pim, n_fft, rs, nf, 3)
    mask = None if frame_mask is None else _full_mask(frame_mask, (mag.shape[0],), nf, mag)
    return torch.stack([
        _synth_reference(mag[b], pre[b], pim[b], n_fft, rs, nf, None if mask is None else mask[b])
        for b in range(mag.shape[0])
    ])


def phasor_istft_ola_batch(
    mag: torch.Tensor, pre: torch.Tensor, pim: torch.Tensor, n_fft: int, rs: int,
    nf: int, frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """phasor_istft_ola of every row of (B, R >= nf, n_fft//2+1) planes in
    one launch, with an optional (B, F) frame mask (then un-normalized).
    Returns (B, (nf-1)*rs + n_fft).

    A CUDA tensor launches the pvoc_phasor_synth kernel over the batch and
    counts one launch as launches.phasor_istft_ola_batch; a CPU tensor
    runs phasor_istft_ola_batch_reference.
    """
    _check_synth(mag, pre, pim, n_fft, rs, nf, 3)
    if mag.device.type == "cpu":
        return phasor_istft_ola_batch_reference(mag, pre, pim, n_fft, rs, nf, frame_mask)
    mask = None if frame_mask is None else _full_mask(frame_mask, (mag.shape[0],), nf, mag)
    return _synth_launch(mag, pre, pim, n_fft, rs, nf, mask, "phasor_istft_ola_batch")


# ------------------------------------ phasor helpers of the chunked bodies


def _cmul_norm(a: tuple, b: tuple) -> tuple:
    """Renormalized complex product of (re, im) pairs: associative in exact
    arithmetic (the projective U(1) product), so scan-safe; the rsqrt
    renormalization, as the JAX helper's, stops magnitude drift."""
    re = a[0] * b[0] - a[1] * b[1]
    im = a[0] * b[1] + a[1] * b[0]
    inv = torch.rsqrt(torch.clamp_min(re * re + im * im, _TINY))
    return re * inv, im * inv


def phasor_scan(tre: torch.Tensor, tim: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P = renormalized inclusive prefix product of the step phasors over
    dim 0, in the JAX package's blocked tree (ops/phase.blocked_scan) with
    the phasor 1 as the identity. (The JAX helper pads and seeds its block
    prefix with zeros, which annihilate under the product: past 1024 rows
    its first block comes out 0.)"""
    return phase.blocked_scan(_cmul_norm, (tre, tim), identity=(1.0, 0.0))


def phasor_prefix_exclusive(
    tre: torch.Tensor, tim: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive renormalized prefix product over dim 0 (the identity
    first): row d is the product of the per-rank phasor totals of rows < d,
    the carry of the chunked bodies."""
    pre, pim = phasor_scan(tre, tim)
    return (torch.cat([torch.ones_like(tre[:1]), pre[:-1]]),
            torch.cat([torch.zeros_like(tim[:1]), pim[:-1]]))


def boundary_step_term(
    u0re: torch.Tensor, u0im: torch.Tensor, upre: torch.Tensor, upim: torch.Tensor,
    n_fft: int, ra: int, rs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The step phasor crossing a chunk boundary: u0 a chunk's first unit
    analysis phasor, uprev the previous chunk's last, each (..., n_fft//2+1).
    General bins take c (u0 conj(uprev) h)^k (for integer k, where c h^k is
    1, (u0 conj(uprev))^k, as the JAX helper), the forced-real bins
    u0 conj(uprev) times (-1)^Rs at Nyquist."""
    nh = n_fft // 2
    dre = u0re * upre + u0im * upim
    dim = u0im * upre - u0re * upim
    if rs % ra == 0:
        gre, gim = _pow_k(dre[..., 1:nh], dim[..., 1:nh], rs, ra)
    else:
        c = torch.as_tensor(_phasor_consts(n_fft, ra, rs)[:, 1:], device=u0re.device)
        gre, gim = _step_terms(u0re[..., 1:nh], u0im[..., 1:nh], upre[..., 1:nh],
                               upim[..., 1:nh], c, rs, ra)
    spin = -1.0 if rs % 2 else 1.0
    return (torch.cat([dre[..., :1], gre, dre[..., nh:] * spin], dim=-1),
            torch.cat([dim[..., :1], gim, dim[..., nh:] * spin], dim=-1))
