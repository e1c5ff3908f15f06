"""Phase unwrapping and synthesis-phase accumulation (counterpart of
phase_vocoder_tpu/ops/phase.py).

Plain torch, op for op the JAX module's arithmetic, so that the same
float32 inputs give the same bits: every function here is additions,
subtractions, multiplications and ceil in float32, each its own torch op
(eager torch fuses nothing, so no a*b+c is contracted into an FMA, which
would break TwoSum/Dekker). Python float constants round to float32 as
JAX's weakly typed scalars do.

Two accumulation methods:

  * "cumsum": the literal prefix sum psi = phi_0 + cumsum(Rs * IF). The
    running phase grows linearly with length, so float32 loses absolute
    precision beyond ~1e5 frames.

  * "wrapped_scan": exact for any length. Only psi mod 2 pi matters, and
    addition mod 2 pi is associative, so
      psi_i mod 2pi = wrap( phi_0
                          + 2pi * ((i * (Rs*k mod N)) mod N) / N   (exact int)
                          + wrap(sum_{j<i} (Rs/Ra) * dphi_j) )
    with the residual sum carried as a compensated (hi, lo) float32 pair
    (TwoSum/Dekker, ~2^-48 effective precision) through blocked_scan, which
    mirrors jax.lax.associative_scan's odd/even tree.

segment_phase is one streaming segment's whole chain (terms, mask, scan,
carry, finalize, pin): for a CUDA tensor one launch of the segment_phase
kernel (csrc/phase_scan.cu), bitwise segment_phase_reference, the same
chain in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import profiling
from . import _build

TWO_PI = 6.283185307179586

# Split representation of 2*pi for exact wrapping in f32: f32(2*pi) sits
# 1.748e-7 above the true value, a bias every wrap would inject; wrapping
# with the (hi, lo) pair applies the 2*pi multiple to ~f64 accuracy.
_TWO_PI_HI = 6.2831854820251465  # == float(np.float32(2*pi))
_TWO_PI_LO = TWO_PI - _TWO_PI_HI  # ~ -1.7484556e-7

# f32(2*pi) split into two 11-bit-mantissa halves so n * _HI12A/_HI12B are
# exact for |n| up to ~2^11 (wrap multiples here are tiny integers).
_HI12A = float(np.float32(np.trunc(_TWO_PI_HI * 2048.0) / 2048.0))
_HI12B = float(np.float32(_TWO_PI_HI - _HI12A))


def princarg(x: torch.Tensor) -> torch.Tensor:
    """Principal argument: wrap phase to (-pi, pi]. Matches golden princarg.

    x - 2*pi*n with the multiple applied as the split constant (see
    _TWO_PI_HI); n = ceil(x/2pi - 1/2) puts the result in (-pi, pi].
    """
    n = torch.ceil(x * (1.0 / TWO_PI) - 0.5)
    return (x - n * _TWO_PI_HI) - n * _TWO_PI_LO


def wrap_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Associative addition modulo 2*pi, result in (-pi, pi]."""
    return princarg(a + b)


@functools.lru_cache(maxsize=64)
def _het_split_cached(ra: int, n_fft: int, n_bins: int, device: str):
    m = (np.arange(n_bins) * ra) % n_fft
    het = (TWO_PI / n_fft) * m  # f64
    hi = het.astype(np.float32)
    lo = (het - hi.astype(np.float64)).astype(np.float32)
    return torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device)


def _het_split(ra: int, n_fft: int, n_bins: int, device=None):
    """Heterodyne constants Ra*omega_k mod 2*pi as an (hi, lo) f32 pair:
    hi the f32 constant, lo the f64 remainder, re-applied after the wrap
    (the f32 rounding alone would bias every frame's increment alike).
    Cached per device, so the streaming loop copies them once."""
    return _het_split_cached(ra, n_fft, n_bins, str(torch.device(device or "cpu")))


def heterodyne_increment(phi: torch.Tensor, ra: int, n_fft: int) -> torch.Tensor:
    """Wrapped heterodyned phase increment dphi (nf-1, n_bins):
    princarg(phi[i+1] - phi[i] - Ra*omega_k) with the split constant."""
    hi, lo = _het_split(ra, n_fft, phi.shape[-1], phi.device)
    return princarg(phi[1:] - phi[:-1] - hi) - lo


def instantaneous_frequency(dphi: torch.Tensor, ra: int, n_fft: int) -> torch.Tensor:
    """IF[i,k] = omega_k + dphi[i,k]/Ra, rad/sample."""
    k = torch.arange(dphi.shape[-1], dtype=dphi.dtype, device=dphi.device)
    omega = (TWO_PI / n_fft) * k
    return omega + dphi / ra


def accumulate_phase(
    phi: torch.Tensor,
    dphi: torch.Tensor,
    ra: int,
    rs: int,
    n_fft: int,
    method: str = "wrapped_scan",
    frame_offset: int = 0,
) -> torch.Tensor:
    """Synthesis phase psi (nf, n_bins) for the rebuild Y = mag*e^{i psi}.

    psi[0] = phi[0]; psi[i] = psi[i-1] + Rs*(omega + dphi[i-1]/Ra); wrapped
    to (-pi, pi] for "wrapped_scan", unwrapped for "cumsum". frame_offset is
    the global index of frame 0 (keeps the exact linear term consistent
    across segments).
    """
    nf, n_bins = phi.shape
    if method == "cumsum":
        k = torch.arange(n_bins, dtype=phi.dtype, device=phi.device)
        omega = (TWO_PI / n_fft) * k
        steps = rs * (omega + dphi / ra)
        zero = phi.new_zeros((1, n_bins))
        psi = phi[0] + torch.cat([zero, torch.cumsum(steps, dim=0)])
    elif method == "wrapped_scan":
        # Pairs straight from phi; dphi is not read (its f32 rounding is
        # the bias the pairs exist to avoid).
        th, tl = residual_terms_c(phi, ra, rs, n_fft)
        rh, rl = blocked_scan(wrap_add_c, (th, tl))
        zero = phi.new_zeros((1, n_bins))
        residual = torch.cat([zero, rh + rl])
        psi = finalize_phase(phi[0], residual, rs, n_fft, frame_offset)
    else:
        raise ValueError(f"unknown phase method {method!r}")
    return pin_real_bins(psi, phi, rs, n_fft, frame_offset)


def pin_real_bins(
    psi: torch.Tensor, phi: torch.Tensor, rs: int, n_fft: int, frame_offset: int = 0
) -> torch.Tensor:
    """Forced-real DC/Nyquist bins: analysis-phase pass-through plus the
    exact integer-arithmetic rotation i*Rs*omega_k (a multiple of pi there),
    as golden/pv_ref.py does. Returns a new tensor."""
    nf, n_bins = psi.shape
    psi = psi.clone()
    psi[:, 0] = phi[:, 0]
    if n_fft % 2 == 0 and n_bins == n_fft // 2 + 1:
        i = (torch.arange(nf, device=psi.device) + frame_offset % n_fft) % n_fft
        kr = (rs * (n_fft // 2)) % n_fft
        lin = (TWO_PI / n_fft) * ((i * kr) % n_fft).to(psi.dtype)
        psi[:, -1] = phi[:, -1] + lin
    return psi


# ------------------------------------------------ compensated pair arithmetic


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _wrap_pair(h, l):
    """Wrap an (h, l) pair to (-pi, pi] exactly: subtracts n*2pi with the
    multiple applied in three exact pieces, then renormalizes."""
    n = torch.ceil(h * (1.0 / TWO_PI) - 0.5)
    s, e1 = _two_sum(h, -n * _HI12A)
    s, e2 = _two_sum(s, -n * _HI12B)
    l = l + (e1 + e2) - n * _TWO_PI_LO
    return _two_sum(s, l)


def wrap_add_c(a, b):
    """Pair-compensated associative addition mod 2*pi: a, b = (hi, lo)."""
    ah, al = a
    bh, bl = b
    s, e = _two_sum(ah, bh)
    return _wrap_pair(s, al + bl + e)


def _scale_consts(rs: int, ra: int) -> tuple[float, float, float, float]:
    """The host constants of _scale_pair, each a float32 value: the scale
    k32 = fl(rs/ra), its 12+12 mantissa-bit halves, and the f64 residue
    rs/ra - k32 rounded to f32."""
    k64 = rs / ra
    k32 = np.float32(k64)
    kc = np.float32(np.float32(4097.0) * k32)
    k_hi = np.float32(kc - np.float32(kc - k32))
    k_lo = np.float32(k32 - k_hi)
    return float(k32), float(k_hi), float(k_lo), float(np.float32(k64 - float(k32)))


def _scale_pair(rs: int, ra: int, h, l):
    """(rs/ra) * (h + l) as a compensated pair, exact for any rs, ra.

    Dekker two-product: the f32 scale k32 = fl(rs/ra) is split into 12+12
    mantissa-bit halves on the host and h is split here, so every partial
    product is exact; the f64 residue rs/ra - k32 (nonzero when ra is not a
    power of two) is folded into the lo word.
    """
    k, kh, kl, k_err = _scale_consts(rs, ra)
    p = k * h
    c = 4097.0 * h
    h_hi = c - (c - h)
    h_lo = h - h_hi
    err = ((kh * h_hi - p) + kh * h_lo + kl * h_hi) + kl * h_lo
    return p, k * l + err + k_err * h


def residual_terms_c(phi_ext: torch.Tensor, ra: int, rs: int, n_fft: int):
    """Compensated scan terms ((F, nb) hi, lo) from phases (F+1, nb):
    term[j] = wrap((rs/ra) * wrap(phi[j+1] - phi[j] - Ra*omega_k)) as an
    exact pair; only the f32 rounding inside phi is left, and it telescopes
    across the residual sum."""
    hi, lo = _het_split(ra, n_fft, phi_ext.shape[-1], phi_ext.device)
    d, e1 = _two_sum(phi_ext[1:], -phi_ext[:-1])
    d, e2 = _two_sum(d, -hi)
    h, l = _wrap_pair(d, (e1 + e2) - lo)
    return _wrap_pair(*_scale_pair(rs, ra, h, l))


def zero_pair(n_bins: int, dtype=torch.float32, device=None):
    """Identity element for wrap_add_c (the carry's initial value)."""
    z = torch.zeros((n_bins,), dtype=dtype, device=device)
    return z, z


def pair_value(pair):
    """Collapse an (hi, lo) pair to plain f32 (for e^{i psi} consumption)."""
    return pair[0] + pair[1]


# ------------------------------------------------------------------ scans


def _associative_scan(fn, elems: tuple) -> tuple:
    """Inclusive scan over dim 0 of a tuple of tensors, in the odd/even
    tree of jax.lax.associative_scan: combine adjacent pairs, scan those
    recursively (the odd outputs), then combine each odd output with the
    next element (the even outputs). Same tree, same elementwise ops, so
    the same bits as the JAX scan."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _associative_scan(fn, tuple(reduced))
    if n % 2 == 0:
        even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = e.new_empty(e.shape)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return tuple(out)


# Rows of one tree scan in blocked_scan's two-level structure.
_SCAN_BLOCK = 1024


def blocked_scan(fn, terms: tuple, block: int = _SCAN_BLOCK, identity: tuple | None = None) -> tuple:
    """Inclusive associative scan over dim 0 in the JAX package's two-level
    block structure.

    Up to `block` rows: pad with the identity to the next power of two and
    scan. Beyond: pad to B full blocks, scan within blocks, scan the B
    block totals, and combine the exclusive block prefix (the identity
    first) with each block's inclusive scan. `fn` must be associative;
    `identity` holds its identity element, one scalar per term (default
    zeros: wrap_add, wrap_add_c and plain add). `terms` is a tuple of
    tensors sharing the leading dim (e.g. the (hi, lo) pair).
    """
    single = not isinstance(terms, tuple)
    if single:
        terms = (terms,)
        fn_t = lambda a, b: (fn(a[0], b[0]),)  # noqa: E731
    else:
        fn_t = fn
    if identity is None:
        identity = (0.0,) * len(terms)
    nf = terms[0].shape[0]

    def pad_to(ts, rows):
        return tuple(
            torch.cat([t, t.new_full((rows - nf,) + t.shape[1:], v)]) if rows > nf else t
            for t, v in zip(ts, identity)
        )

    if nf <= block:
        p = 1
        while p < nf:
            p *= 2
        out = _associative_scan(fn_t, pad_to(terms, p))
        out = tuple(t[:nf] for t in out)
    else:
        nb = -(-nf // block)
        tp = tuple(t.reshape((nb, block) + t.shape[1:]) for t in pad_to(terms, nb * block))
        incl = _associative_scan(fn_t, tuple(t.transpose(0, 1) for t in tp))
        incl = tuple(t.transpose(0, 1) for t in incl)  # (nb, block, ...)
        totals = tuple(t[:, -1] for t in incl)
        prefix = _associative_scan(fn_t, totals)
        excl = tuple(
            torch.cat([torch.full_like(t[:1], v), t[:-1]]) for t, v in zip(prefix, identity)
        )
        out = fn_t(tuple(t.unsqueeze(1) for t in excl), incl)
        out = tuple(t.reshape((nb * block,) + t.shape[2:])[:nf] for t in out)
    return out[0] if single else out


def accumulate_phase_residual(dphi: torch.Tensor, ra: int, rs: int) -> torch.Tensor:
    """Wrapped exclusive prefix sum of the residual terms (Rs/Ra)*dphi:
    residual[i] = wrap(sum_{j<i} (Rs/Ra)*dphi[j]), (nf, n_bins)."""
    terms = princarg((rs / ra) * dphi)
    zero = terms.new_zeros((1, terms.shape[-1]))
    return torch.cat([zero, blocked_scan(wrap_add, terms)])


def linear_phase_term(
    nf: int, n_bins: int, rs: int, n_fft: int, frame_offset: int = 0,
    dtype=torch.float32, device=None,
) -> torch.Tensor:
    """Exact (mod 2*pi) linear phase i*Rs*omega_k via integer arithmetic:
    2pi * ((i mod N) * ((Rs*k) mod N) mod N) / N."""
    i = (torch.arange(nf, device=device) + frame_offset % n_fft) % n_fft
    kr = (torch.arange(n_bins, device=device) * (rs % n_fft)) % n_fft
    grid = (i[:, None] * kr[None, :]) % n_fft
    return (TWO_PI / n_fft) * grid.to(dtype)


def finalize_phase(
    phi0: torch.Tensor, residual: torch.Tensor, rs: int, n_fft: int, frame_offset: int = 0
) -> torch.Tensor:
    """psi (wrapped) = wrap(phi0 + exact linear term + wrapped residual)."""
    nf, n_bins = residual.shape
    linear = linear_phase_term(
        nf, n_bins, rs, n_fft, frame_offset, dtype=residual.dtype, device=residual.device
    )
    return princarg(phi0[None, :] + linear + residual)


# ------------------------------------------------- one streaming segment


def segment_phase_reference(
    phi: torch.Tensor,
    phi_prev: torch.Tensor,
    carry_hi: torch.Tensor,
    carry_lo: torch.Tensor,
    phi0: torch.Tensor,
    *,
    ra: int,
    rs: int,
    n_fft: int,
    frame_offset: int,
    n_valid: int,
    started: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Synthesis phase of one streaming segment (counterpart of
    phase_vocoder_tpu/streaming.py:115-128, which XLA compiles into the
    segment step's scan): plain torch, op for op.

    phi: (F, nb) analysis phases of the segment's frames; phi_prev (nb,)
    the previous segment's last valid row; (carry_hi, carry_lo) the
    compensated residual carried in; phi0 the recording's first-frame
    phase, used when `started` (else phi[0] is). frame_offset is the global
    index of frame 0 and n_valid the count of real frames. Term j is the
    step into frame g+j, zero (the pair identity) for the recording's
    first frame and for padding frames; the 0/1 mask is a multiply, so a
    negative term becomes -0.0. Returns psi (F, nb) and the carry out, row
    F-1 of the compensated residual.
    """
    F = phi.shape[0]
    g = frame_offset
    phi_ext = torch.cat([phi_prev[None, :], phi])  # (F+1, nb)
    th, tl = residual_terms_c(phi_ext, ra, rs, n_fft)
    j = torch.arange(F, device=phi.device)
    valid_term = ((j < n_valid) & ((g + j) > 0))[:, None].to(phi.dtype)
    th, tl = th * valid_term, tl * valid_term

    incl = blocked_scan(wrap_add_c, (th, tl))
    res_h, res_l = wrap_add_c((carry_hi[None, :], carry_lo[None, :]), incl)
    residual = res_h + res_l

    phi0 = phi0 if started else phi[0]
    psi = finalize_phase(phi0, residual, rs, n_fft, frame_offset=g)
    psi = pin_real_bins(psi, phi, rs, n_fft, frame_offset=g)
    return psi, res_h[-1], res_l[-1]


@functools.lru_cache(maxsize=64)
def _segment_consts(ra: int, rs: int, n_fft: int):
    """The float32 constants of segment_phase_reference's arithmetic, in
    the order of csrc/phase_scan.cu's PhaseConsts, as a ctypes array: each
    Python double rounded to float32 as torch rounds a scalar operand."""
    vals = [1.0 / TWO_PI, _TWO_PI_HI, _TWO_PI_LO, _HI12A, _HI12B, TWO_PI / n_fft,
            *_scale_consts(rs, ra)]
    return (ctypes.c_float * len(vals))(*(float(np.float32(v)) for v in vals))



def segment_phase(
    phi: torch.Tensor,
    phi_prev: torch.Tensor,
    carry_hi: torch.Tensor,
    carry_lo: torch.Tensor,
    phi0: torch.Tensor,
    *,
    ra: int,
    rs: int,
    n_fft: int,
    frame_offset: int,
    n_valid: int,
    started: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """segment_phase_reference in one launch: for a CUDA tensor the
    segment_phase kernel of csrc/phase_scan.cu (the residual terms, the
    compensated pair scan in blocked_scan's tree, the carry, finalize and
    pin, bitwise the plain version's), counting one launch as
    launches.segment_phase; for a CPU tensor segment_phase_reference.
    A CUDA tensor launches the kernel for every F or raises. The wrapper
    is on the faithful route's per-segment path, so it spends little host
    time: no Stream object (_build.current_stream), no device guard when
    the device is current, one unbind for the carry's two words."""
    if phi.dim() != 2 or phi.shape[0] == 0 or phi.shape[1] != n_fft // 2 + 1 or n_fft % 2:
        raise ValueError(f"segment_phase: phi must be (F >= 1, {n_fft // 2 + 1}), got {tuple(phi.shape)}")
    args = dict(ra=ra, rs=rs, n_fft=n_fft, frame_offset=frame_offset, n_valid=n_valid, started=started)
    if phi.device.type == "cpu":
        return segment_phase_reference(phi, phi_prev, carry_hi, carry_lo, phi0, **args)
    from .stft import _check_cuda  # not at the top: ops/stft.py imports this module (via ops/fused.py)

    with profiling.span("pv.prepare"):
        F, nb = phi.shape
        for t in (phi, phi_prev, carry_hi, carry_lo, phi0):
            _check_cuda(t, "segment_phase")
        for t in (phi_prev, carry_hi, carry_lo, phi0):
            if t.shape != (nb,):
                raise ValueError(f"segment_phase: state vectors must be ({nb},), got {tuple(t.shape)}")
        psi = torch.empty_like(phi)
        carry = phi.new_empty((2, nb))
        # Block totals of the two-level scan (F > 1024 only).
        blocks = -(-F // _SCAN_BLOCK) if F > _SCAN_BLOCK else 0
        totals = torch.empty((2, blocks, nb), dtype=torch.float32, device=phi.device) if blocks else None
        dev = phi.get_device()
        het_hi, het_lo = _het_split(ra, n_fft, nb, phi.device)
        lib = _build.kernels()
    with _build.device_guard(dev):
        _build.launch(
            "segment_phase", lib.segment_phase,
            phi.data_ptr(), phi_prev.data_ptr(), carry_hi.data_ptr(), carry_lo.data_ptr(),
            (phi0 if started else phi).data_ptr(), het_hi.data_ptr(), het_lo.data_ptr(),
            psi.data_ptr(), carry.data_ptr(), totals.data_ptr() if blocks else None,
            F, nb, n_fft, rs % n_fft, frame_offset, frame_offset % n_fft,
            min(max(n_valid, 0), F), _segment_consts(ra, rs, n_fft), _build.current_stream(dev),
        )
    return (psi, *carry.unbind(0))
