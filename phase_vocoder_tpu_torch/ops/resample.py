"""Linear-interpolation resampler (counterpart of phase_vocoder_tpu/ops/resample.py).

out[j] = x[j / factor] with linear interpolation, clamped at both edges —
golden/pv_ref.py resample_linear. Positions are computed in float64, which
makes them exact for the rational (octave) steps and keeps them to ~1e-16
relative for the irrational ones at any length.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["resample_linear", "resample_linear_reference"]


def _check_args(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected a 1-D float32 tensor, got {x.dtype} {tuple(x.shape)}")


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
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = (pos - lo).float()
    return x[lo] * (1.0 - frac) + x[hi] * frac


def resample_linear(x: torch.Tensor, factor: float, out_len: int) -> torch.Tensor:
    """Resample 1-D float32 x by `factor` (>1 = more samples) to `out_len`.

    A CUDA tensor goes through the kernel of csrc/resample.cu and counts
    one launch in `resample_linear.launches`; a CPU tensor goes through
    resample_linear_reference.
    """
    _check_args(x)
    n = x.shape[-1]
    if out_len <= 0:
        return x.new_zeros((0,))
    if n == 0:
        return x.new_zeros((out_len,))
    if x.device.type == "cpu":
        return resample_linear_reference(x, factor, out_len)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("resample_linear needs a contiguous tensor")
    if not factor > 0:
        raise ValueError(f"factor must be positive, got {factor}")
    out = torch.empty(out_len, dtype=torch.float32, device=x.device)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        rc = lib.resample_lerp(
            x.data_ptr(), out.data_ptr(), n, out_len, float(factor),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "resample_lerp")
    resample_linear.launches += 1
    return out


resample_linear.launches = 0
