"""Fused phasor-form TSM (counterpart of phase_vocoder_tpu/ops/pallas/fused.py).

For a synthesis/analysis hop ratio k = Rs/Ra = p/q the phase propagation
is phasor algebra on the unit analysis phasors u_i = X_i/|X_i|:

  integer k (q = 1): P_i = u_0 (u_i conj u_0)^k           (closed form)
  q >= 2:            P_i = prod_{j<=i} term_j, renormalized, with
                     term_0 = u_0 and
                     term_i = c (u_i conj u_{i-1} h)^k,
                     h = e^{-i Ra w_b}, c = e^{+i Rs w_b}
  Y_i = |X_i| P_i; DC passes through, Nyquist times (-1)^(Rs i).

`fused_time_stretch` runs the whole TSM (framing, windowed DFT, phasors,
inverse DFT, overlap-add, COLA normalization) in the CUDA kernel of
csrc/pvoc_fused.cu for a CUDA tensor, and in its plain torch version
`fused_time_stretch_reference` for a CPU tensor. The static tables
(window and FFT twiddles, phasor constants, normalization rows) are built
in float64 numpy with the JAX package's formulas and cast to float32 once.
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
    "fused_time_stretch",
    "fused_time_stretch_reference",
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


def _chunked_prefix_product(tre, tim, chunk: int = SCAN_CHUNK):
    """Renormalized prefix product over frames (dim 0), in the kernel's
    three passes: in-chunk inclusive products, a serial scan of the chunk
    carries, then carry * in-chunk product, renormalized."""
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
    c_re = torch.ones_like(cre[0])
    c_im = torch.zeros_like(cim[0])
    for c in range(nch):
        cre[c], cim[c] = c_re, c_im
        c_re, c_im = _normalize(*_cmul(c_re, c_im, lre[c, -1], lim[c, -1]))
    pre, pim = _normalize(*_cmul(cre[:, None], cim[:, None], lre, lim))
    return pre.reshape(nch * chunk, -1)[:nf], pim.reshape(nch * chunk, -1)[:nf]


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


def fused_time_stretch_reference(
    x: torch.Tensor, n_fft: int, hop: int, rs: int
) -> torch.Tensor:
    """Plain torch version of the fused TSM, on x's device.

    torch.fft in float32 for the DFTs, the phasor algebra above, the
    chunked prefix product for q >= 2, and fold overlap-add. Returns
    (nf-1)*rs + n_fft samples.
    """
    nf = _check_args(x, n_fft, hop, rs)
    nh = n_fft // 2
    w = hann_window(n_fft, device=x.device)
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * w, dim=-1)
    re, im = spec.real, spec.imag  # (nf, nh + 1)
    gre, gim = re[:, 1:nh], im[:, 1:nh]  # general bins
    mag, ure, uim = _unit(gre, gim)
    p, q = _rational_k(rs, hop)
    if q == 1:
        u0re, u0im = ure[0:1], uim[0:1]
        zre = ure * u0re + uim * u0im
        zim = uim * u0re - ure * u0im
        wre, wim = _pow_k(zre, zim, rs, hop)
        pre, pim = _cmul(wre, wim, u0re, u0im)
    else:
        c = torch.as_tensor(_phasor_consts(n_fft, hop, rs)[:, 1:], device=x.device)
        dre = ure[1:] * ure[:-1] + uim[1:] * uim[:-1]
        dim = uim[1:] * ure[:-1] - ure[1:] * uim[:-1]
        zre, zim = _cmul(dre, dim, c[0], c[1])
        wre, wim = _pow_k(zre, zim, rs, hop)
        tre, tim = _cmul(wre, wim, c[2], c[3])
        tre = torch.cat([ure[:1], tre])
        tim = torch.cat([uim[:1], tim])
        pre, pim = _chunked_prefix_product(tre, tim)
    sign = torch.ones(nf, device=x.device)
    if rs % 2:
        sign[1::2] = -1.0
    y_re = torch.cat([re[:, :1], mag * pre, (re[:, nh] * sign)[:, None]], dim=1)
    y_im = torch.cat([torch.zeros_like(re[:, :1]), mag * pim, torch.zeros_like(re[:, :1])], dim=1)
    frames = torch.fft.irfft(torch.complex(y_re, y_im), n=n_fft, dim=-1) * w
    ola = overlap_add(frames, rs)
    m = -(-n_fft // rs)
    rows = torch.as_tensor(_norm_rows(n_fft, rs, nf), device=x.device)
    row_idx = torch.full((nf + m - 1,), 2 * m - 2, dtype=torch.long, device=x.device)
    row_idx[: min(m - 1, nf)] = torch.arange(min(m - 1, nf), device=x.device)
    row_idx[nf:] = torch.arange(m - 1, 2 * m - 2, device=x.device)
    norm = rows[row_idx].reshape(-1)[: ola.shape[0]]
    return ola * norm


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
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_time_stretch needs a contiguous tensor")
    dev = str(x.device)
    tables = _device_tables(n_fft, hop, rs, dev)
    norm = _device_norm_rows(n_fft, rs, min(nf, -(-n_fft // rs) - 1), dev)
    p, q = _rational_k(rs, hop)
    nch = -(-nf // SCAN_CHUNK)
    out = torch.empty((nf - 1) * rs + n_fft, dtype=torch.float32, device=x.device)
    spec = torch.empty((nf, n_fft + 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(spec)
    frames = torch.empty((nf, n_fft), dtype=torch.float32, device=x.device)
    if q > 1:
        tot = torch.empty((nch, n_fft // 2 - 1, 2), dtype=torch.float32, device=x.device)
        carry = torch.empty_like(tot)
    else:
        tot = carry = None
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        rc = lib.pvoc_fused(
            x.data_ptr(), out.data_ptr(), spec.data_ptr(), y.data_ptr(),
            frames.data_ptr(),
            None if tot is None else tot.data_ptr(),
            None if carry is None else carry.data_ptr(),
            tables["fft"].data_ptr(), tables["consts"].data_ptr(),
            norm.data_ptr(), nf, n_fft, hop, rs, p, q, int(_pow_alg(p, q)), SCAN_CHUNK,
            float(np.float32(p / q)), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pvoc_fused")
    fused_time_stretch.launches += 1
    return out


fused_time_stretch.launches = 0
