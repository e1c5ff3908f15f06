"""Linear-interpolation resampler (counterpart of phase_vocoder_tpu/ops/resample.py).

out[j] = x[j / factor] with linear interpolation, clamped at both edges —
golden/pv_ref.py resample_linear. Three wrappers of csrc/resample.cu, each
with its plain torch version (`*_reference`) beside it; a CUDA tensor
launches the kernel (counting one launch as launches.<wrapper>) or raises, a CPU
tensor runs the plain version:

  resample_linear   float64 positions j / factor inside the kernel: exact
                    for the rational (octave) steps (the JAX package's
                    _resample_rational), ~1e-16 relative for the others
                    (its default "mxu" select, _select_body_v4, and its
                    _select_body for steps below 0.5);
  resample_blocked  the JAX package's own blocked position arithmetic
                    (_positions) made inside the kernel from per-block
                    exact float64-split scalars (its "fused" select,
                    _select_body_v3);
  select_lerp and   select and lerp from index and weight tensors made
  select_lerp_two_level
                    outside the kernel, one level (its "matmul" and "roll"
                    selects, _select_mm_body and _select_body) or two
                    (per-128-lane chunk bases plus chunk-local residuals:
                    its "roll2" select, _select_body_v2).

`_SEL_IMPL` names the select of the irrational steps as in the JAX package
("mxu" by default; the others are measurement variants kept for parity,
not user options), and `_resample_strided_select` routes by it.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from ..utils import profiling
from . import _build

__all__ = [
    "resample_linear",
    "resample_linear_reference",
    "resample_blocked",
    "resample_blocked_reference",
    "select_lerp",
    "select_lerp_two_level",
    "select_lerp_reference",
]

# Output samples per block of the blocked paths (the JAX _SEL_BLOCK) and
# per chunk of the two-level select (its _V2_CHUNK).
_SEL_BLOCK = 512
_SEL_CHUNK = 128
# Block of the f64 position split of _positions (the JAX _BLOCK).
_POS_BLOCK = 1024
# Which select serves the irrational steps: "mxu" (resample_linear),
# "fused" (resample_blocked), "roll2" (select_lerp_two_level), "roll" and
# "matmul" (select_lerp). Steps outside [0.5, 2) go to select_lerp under
# every setting, as in the JAX package.
_SEL_IMPL = "mxu"
_SEL_IMPLS = ("mxu", "fused", "roll2", "roll", "matmul")


def _check_args(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")


def _lerp_at(x: torch.Tensor, lo: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """x[lo] (1 - frac) + x[min(lo + 1, n - 1)] frac for lo in [0, n-1]."""
    hi = torch.clamp(lo + 1, max=x.shape[-1] - 1)
    return x[lo] * (1.0 - frac) + x[hi] * frac


# ------------------------------------------------- float64 positions ("mxu")


def resample_linear_reference(x: torch.Tensor, factor: float, out_len: int) -> torch.Tensor:
    """Plain torch version of resample_linear, on x's device."""
    _check_args(x)
    n = x.shape[-1]
    if out_len <= 0:
        return x.new_zeros((0,))
    if n == 0:
        return x.new_zeros((out_len,))
    pos = torch.arange(out_len, dtype=torch.float64, device=x.device) / factor
    pos = pos.clamp(0.0, n - 1.0)
    lo = torch.floor(pos).long()
    return _lerp_at(x, lo, (pos - lo).float())


def resample_linear(x: torch.Tensor, factor: float, out_len: int) -> torch.Tensor:
    """Resample 1-D float32 x by `factor` (>1 = more samples) to `out_len`.

    A CUDA tensor goes through the resample_lerp kernel of csrc/resample.cu
    and counts one launch as launches.resample_linear; a CPU tensor goes
    through resample_linear_reference. Under a `_SEL_IMPL` other than the
    default "mxu", the irrational steps go through
    _resample_strided_select instead (and count in that select's wrapper).
    """
    _check_args(x)
    n = x.shape[-1]
    if out_len <= 0:
        return x.new_zeros((0,))
    if n == 0:
        return x.new_zeros((out_len,))
    if _SEL_IMPL != "mxu" and not _is_rational_step(factor):
        return _resample_strided_select(x, factor, out_len)
    return _resample_f64(x, factor, out_len)


def _is_rational_step(factor: float, max_q: int = 4, max_p: int = 8) -> bool:
    """True when 1/factor is exactly a small fraction p/q in float64 (the
    JAX _as_rational_step): every octave step. The JAX package serves these
    without a kernel; here resample_lerp's float64 positions are exact."""
    if factor <= 0:
        return False
    step = 1.0 / factor
    fr = Fraction(step).limit_denominator(max_q)
    return 0 < fr.numerator <= max_p and float(fr) == step


def _resample_f64(x: torch.Tensor, factor: float, out_len: int) -> torch.Tensor:
    """resample_linear's own path, for a non-empty x and out_len > 0."""
    n = x.shape[-1]
    if x.device.type == "cpu":
        return resample_linear_reference(x, factor, out_len)
    with profiling.span("pv.prepare"):
        _check_cuda(x, "resample_linear")
        if not factor > 0:
            raise ValueError(f"factor must be positive, got {factor}")
        out = torch.empty(out_len, dtype=torch.float32, device=x.device)
        lib = _build.kernels()
    with torch.cuda.device(x.device):
        _build.launch(
            "resample_linear", lib.resample_lerp,
            x.data_ptr(), out.data_ptr(), n, out_len, float(factor),
            torch.cuda.current_stream().cuda_stream,
        )
    return out


# ------------------------------------- blocked positions in the kernel ("fused")


@functools.lru_cache(maxsize=32)
def _block_tables(factor: float, nb: int, block: int):
    """The exact float64 split of the blocked positions (the host
    arithmetic of the JAX _fused_sel_consts and _positions): per block
    q < nb, start_int[q] (int64) and start_frac[q] (f32) of q*block/factor;
    per lane j < block, jo_int[j] (int32) and jo_frac[j] (f32) of j/factor."""
    starts = np.arange(nb, dtype=np.float64) * (block / factor)
    start_int = np.floor(starts).astype(np.int64)
    start_frac = (starts - np.floor(starts)).astype(np.float32)
    jo = np.arange(block, dtype=np.float64) / factor
    jo_int = np.floor(jo).astype(np.int32)
    jo_frac = (jo - np.floor(jo)).astype(np.float32)
    return start_int, start_frac, jo_int, jo_frac


def block_tables(factor: float, out_len: int, device=None) -> tuple:
    """(start_int (nb,) int64, start_frac (nb,) f32, jo_int (B,) int32,
    jo_frac (B,) f32) of resample_blocked on `device`, nb = ceil(out_len/B),
    B = 512."""
    nb = -(-out_len // _SEL_BLOCK)
    return tuple(
        torch.as_tensor(t, device=device) for t in _block_tables(float(factor), nb, _SEL_BLOCK)
    )


def _check_blocked(x, start_int, start_frac, jo_int, jo_frac, out_len: int) -> None:
    _check_args(x)
    nb = -(-out_len // _SEL_BLOCK)
    want = (
        (start_int, torch.int64, (nb,)), (start_frac, torch.float32, (nb,)),
        (jo_int, torch.int32, (_SEL_BLOCK,)), (jo_frac, torch.float32, (_SEL_BLOCK,)),
    )
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"resample_blocked tables: expected {dtype} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if x.shape[-1] == 0 or out_len <= 0:
        raise ValueError("resample_blocked needs a non-empty input and output")


def resample_blocked_reference(
    x: torch.Tensor, start_int: torch.Tensor, start_frac: torch.Tensor,
    jo_int: torch.Tensor, jo_frac: torch.Tensor, out_len: int,
) -> torch.Tensor:
    """Plain torch version of resample_blocked, on x's device."""
    _check_blocked(x, start_int, start_frac, jo_int, jo_frac, out_len)
    n = x.shape[-1]
    u = start_frac[:, None] + jo_frac[None, :]  # f32, in [0, 2)
    e = torch.floor(u)
    lo = (start_int[:, None] + jo_int[None, :].long() + e.long()).reshape(-1)[:out_len]
    frac = (u - e).reshape(-1)[:out_len]
    return _lerp_at(x, lo.clamp(0, n - 1), frac)


def resample_blocked(
    x: torch.Tensor, start_int: torch.Tensor, start_frac: torch.Tensor,
    jo_int: torch.Tensor, jo_frac: torch.Tensor, out_len: int,
) -> torch.Tensor:
    """Blocked lerp with the positions made inside the kernel: output j of
    block q (B = 512) reads u = start_frac[q] + jo_frac[j] in float32,
    e = floor(u), index start_int[q] + jo_int[j] + e clamped to [0, n-1],
    its neighbour clamped to n-1, and weight u - e; the tables are
    block_tables(factor, out_len). The arithmetic of the JAX _positions, so
    the result equals its gather oracle up to the rounding of the lerp.

    A CUDA tensor launches the resample_blocked kernel and counts one
    launch as launches.resample_blocked; a CPU tensor runs
    resample_blocked_reference.
    """
    _check_blocked(x, start_int, start_frac, jo_int, jo_frac, out_len)
    if x.device.type == "cpu":
        return resample_blocked_reference(x, start_int, start_frac, jo_int, jo_frac, out_len)
    with profiling.span("pv.prepare"):
        for t in (x, start_int, start_frac, jo_int, jo_frac):
            _check_cuda(t, "resample_blocked")
        out = torch.empty(out_len, dtype=torch.float32, device=x.device)
        lib = _build.kernels()
    with torch.cuda.device(x.device):
        _build.launch(
            "resample_blocked", lib.resample_blocked,
            x.data_ptr(), start_int.data_ptr(), start_frac.data_ptr(),
            jo_int.data_ptr(), jo_frac.data_ptr(), out.data_ptr(),
            x.shape[-1], out_len, torch.cuda.current_stream().cuda_stream,
        )
    return out


# ------------------------- select from index and weight tensors ("roll2", "roll", "matmul")


def _check_select(x, origin, k, fr, c: int, bases) -> tuple[int, int]:
    _check_args(x)
    if k.dim() != 2 or k.dtype != torch.int32 or fr.dtype != torch.float32 or fr.shape != k.shape:
        raise ValueError(
            f"select_lerp: k (nb, B) int32 and fr (nb, B) float32, got "
            f"{k.dtype} {tuple(k.shape)} and {fr.dtype} {tuple(fr.shape)}"
        )
    nb, B = k.shape
    if origin.dtype != torch.int64 or tuple(origin.shape) != (nb,):
        raise ValueError(f"select_lerp: origin must be ({nb},) int64, got {origin.dtype} {tuple(origin.shape)}")
    if c < 0:
        raise ValueError(f"select_lerp: c must be >= 0, got {c}")
    if bases is not None and (
        B % _SEL_CHUNK or bases.dtype != torch.int32 or tuple(bases.shape) != (nb, B // _SEL_CHUNK)
    ):
        raise ValueError(
            f"select_lerp: bases must be ({nb}, {B // _SEL_CHUNK}) int32 with B a multiple "
            f"of {_SEL_CHUNK}, got {bases.dtype} {tuple(bases.shape)}"
        )
    if x.shape[-1] == 0 or nb == 0:
        raise ValueError("select_lerp needs a non-empty input and at least one block")
    return nb, B


def select_lerp_reference(
    x: torch.Tensor, origin: torch.Tensor, k: torch.Tensor, fr: torch.Tensor, c: int,
    bases: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch version of select_lerp (bases None) and of
    select_lerp_two_level, on x's device."""
    nb, B = _check_select(x, origin, k, fr, c, bases)
    n = x.shape[-1]
    j = torch.arange(B, device=x.device)
    idx = origin[:, None] + c * j[None, :] + k.long()
    if bases is not None:
        idx = idx + bases.long().repeat_interleave(_SEL_CHUNK, dim=1)
    lo = idx.clamp(0, n - 1)
    hi = (idx + 1).clamp(0, n - 1)
    return x[lo] * (1.0 - fr) + x[hi] * fr


# Outputs per table row that the select kernel takes: a block of B/4
# threads serves a row.
_SEL_MAX_B = 4096


def _select_launch(x, origin, k, fr, c: int, bases, what: str) -> torch.Tensor:
    """The select_lerp kernel; `what` is the launching wrapper's name."""
    with profiling.span("pv.prepare"):
        nb, B = _check_select(x, origin, k, fr, c, bases)
        for t in (x, origin, k, fr) + (() if bases is None else (bases,)):
            _check_cuda(t, what)
        if B > _SEL_MAX_B:
            raise ValueError(f"{what}: the kernel takes rows of at most {_SEL_MAX_B} outputs, got {B}")
        out = torch.empty((nb, B), dtype=torch.float32, device=x.device)
        lib = _build.kernels()
    with torch.cuda.device(x.device):
        _build.launch(
            what, lib.select_lerp,
            x.data_ptr(), origin.data_ptr(), None if bases is None else bases.data_ptr(),
            k.data_ptr(), fr.data_ptr(), out.data_ptr(), x.shape[-1], nb, B, c,
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def select_lerp(
    x: torch.Tensor, origin: torch.Tensor, k: torch.Tensor, fr: torch.Tensor, c: int
) -> torch.Tensor:
    """One-level select and lerp: out[q, j] = lerp(x[i], x[i + 1], fr[q, j])
    with i = origin[q] + c*j + k[q, j], both taps clamped to [0, n-1].
    origin (nb,) int64 is each block's span start in x's coordinates (it
    may be negative or past the end), k (nb, B) int32, fr (nb, B) float32,
    c >= 0 the span's stride per lane. Returns (nb, B).

    A CUDA tensor launches the select_lerp kernel and counts one launch as
    launches.select_lerp; a CPU tensor runs select_lerp_reference.
    """
    if x.device.type == "cpu":
        return select_lerp_reference(x, origin, k, fr, c)
    return _select_launch(x, origin, k, fr, c, None, "select_lerp")


def select_lerp_two_level(
    x: torch.Tensor, origin: torch.Tensor, bases: torch.Tensor, k2: torch.Tensor,
    fr: torch.Tensor, c: int,
) -> torch.Tensor:
    """Two-level select and lerp: as select_lerp with
    i = origin[q] + c*j + bases[q, j // 128] + k2[q, j], bases (nb, B/128)
    int32 the per-chunk alignment and k2 the chunk-local residual.

    A CUDA tensor launches the select_lerp kernel with the bases and counts
    one launch as launches.select_lerp_two_level; a CPU tensor runs
    select_lerp_reference.
    """
    if bases is None:
        raise ValueError("select_lerp_two_level needs the chunk bases")
    if x.device.type == "cpu":
        return select_lerp_reference(x, origin, k2, fr, c, bases)
    return _select_launch(x, origin, k2, fr, c, bases, "select_lerp_two_level")


# -------------------------------------------------- the JAX package's routing


def _positions(factor: float, out_len: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo int64 clamped to [0, n-1], frac f32): the JAX _positions, blocks
    of 1024 with the exact float64 split per block and per lane."""
    start_int, start_frac, jo_int, jo_frac = (
        torch.as_tensor(t, device=device)
        for t in _block_tables(float(factor), -(-out_len // _POS_BLOCK), _POS_BLOCK)
    )
    local = start_frac[:, None] + jo_frac[None, :]
    local_int = torch.floor(local)
    lo = (start_int[:, None] + jo_int[None, :].long() + local_int.long()).reshape(-1)[:out_len]
    frac = (local - local_int).reshape(-1)[:out_len]
    return lo.clamp(0, n - 1), frac


def select_tables(factor: float, out_len: int, n: int, impl: str, device=None) -> dict:
    """The index and weight tensors of the explicit selects, made by plain
    torch ops from _positions as the JAX _resample_strided_select and
    _select_kernel_call make theirs: origin (nb,) int64 (the span start in
    x's coordinates), k (nb, B) int32, fr (nb, B) f32, c, last (nb, B) bool
    (lanes whose position clipped to the last sample) and, for "roll2" with
    steps in [0.5, 2), bases (nb, B/128) int32 with k then chunk-local."""
    step = 1.0 / factor
    B = _SEL_BLOCK
    lo, frac = _positions(factor, out_len, n, device)
    nb = -(-out_len // B)
    pad = nb * B - out_len
    lo_b = torch.cat([lo, lo[-1:].expand(pad)]).reshape(nb, B)
    fr = torch.nn.functional.pad(frac, (0, pad)).reshape(nb, B)
    starts = lo_b[:, 0].contiguous()
    ramp = torch.arange(B, device=lo.device)
    if step >= 2.0:
        # Spans start at each block's first position; k carries what the
        # stride c = floor(step) leaves.
        c = int(np.floor(step))
        K = int(np.ceil(B * (step - c))) + 3
        k = (lo_b - starts[:, None] - c * ramp[None, :]).clamp(0, K - 1)
        return {"origin": starts, "k": k.int(), "fr": fr, "c": c,
                "last": torch.zeros_like(lo_b, dtype=torch.bool)}
    if step >= 1.0:
        c, off = 1, 0
        K = int(np.ceil(B * (step - 1.0))) + 3
    elif step >= 0.5:
        c = 1
        off = int(np.ceil(B * (1.0 - step))) + 3
        K = off + 3
    else:
        c, off = 0, 0
        K = int(np.ceil(B * step)) + 3
    # Superblocks of G blocks share one anchor; within one, block spans
    # start a fixed stride apart and the drift goes into k (K -> K + G).
    G = 64
    stride = max(1, int(np.floor(B * step)))
    Kp = K + G
    n_super = -(-nb // G)
    starts_p = torch.cat([starts, starts[-1:].expand(n_super * G - nb)])
    anchors = starts_p.reshape(n_super, G)[:, 0]
    used = (anchors[:, None] + stride * torch.arange(G, device=lo.device)[None, :]).reshape(-1)[:nb]
    k = (lo_b - used[:, None] + off - c * ramp[None, :]).clamp(0, Kp - 1)
    tables = {"origin": used - off, "k": k.int(), "fr": fr, "c": c, "last": lo_b == n - 1}
    if impl == "roll2":
        nch = B // _SEL_CHUNK
        in_range = torch.arange(nb * B, device=lo.device).reshape(nb, B) < out_len
        valid = (lo_b < n - 1) & in_range
        k3 = k.reshape(nb, nch, _SEL_CHUNK)
        k_for_base = torch.where(valid.reshape(nb, nch, _SEL_CHUNK), k3, 1 << 20)
        bases = k_for_base.min(dim=2).values.clamp(max=Kp - 1)
        K2 = int(np.ceil(_SEL_CHUNK * abs(step - c))) + 4
        tables["k"] = (k3 - bases[:, :, None]).clamp(0, K2 - 1).reshape(nb, B).int()
        tables["bases"] = bases.int()
    return tables


def _resample_strided_select(x: torch.Tensor, factor: float, out_len: int) -> torch.Tensor:
    """The irrational steps under `_SEL_IMPL`, routed as the JAX function
    of the same name: "mxu" and "fused" serve steps in [0.5, 2) with
    resample_linear and resample_blocked; every other case goes through the
    explicit index and weight tensors of select_tables to select_lerp, or
    to select_lerp_two_level under "roll2" for steps below 2."""
    _check_args(x)
    if _SEL_IMPL not in _SEL_IMPLS:
        raise ValueError(f"unknown _SEL_IMPL {_SEL_IMPL!r}")
    n = x.shape[-1]
    step = 1.0 / factor
    if _SEL_IMPL in ("fused", "mxu") and 0.5 <= step < 2.0:
        if _SEL_IMPL == "mxu":
            return _resample_f64(x, factor, out_len)
        return resample_blocked(x, *block_tables(factor, out_len, x.device), out_len)
    t = select_tables(factor, out_len, n, _SEL_IMPL, x.device)
    if "bases" in t:
        out = select_lerp_two_level(x, t["origin"], t["bases"], t["k"], t["fr"], t["c"])
    else:
        out = select_lerp(x, t["origin"], t["k"], t["fr"], t["c"])
    out = torch.where(t["last"], x[n - 1], out)
    return out.reshape(-1)[:out_len]
