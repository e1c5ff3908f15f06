"""The plain reference: golden/pv_ref.py's phase vocoder, frozen here.

The classic Dolson/Laroche time-scale modification, in float64 PyTorch
on whatever device the input is on:
  1. frames x[i Ra : i Ra + N] under a periodic Hann window, rfft;
  2. dphi_i = princarg(phi_i - phi_{i-1} - Ra omega), the instantaneous
     frequency omega + dphi_i / Ra;
  3. psi_0 = phi_0, psi_i = psi_{i-1} + Rs IF_{i-1}; the DC and Nyquist
     bins take phi_i plus the exact rotation i Rs omega_k instead;
  4. Y = |X| exp(j psi), irfft, the window again, overlap-add at Rs, and
     division by the overlap-added squared window (floor 1e-8).

Frames go through in blocks that carry the last analysis phase and the
running synthesis phase across block edges, so an hour fits in a few
hundred MB beside the output. The running sum is a float64 prefix sum
per block, not the golden file's serial loop: the two differ by float64
round-off.

`transform="tf32"` is the control: the same algorithm with both
transforms as FP32 matrix products whose operands are rounded to TF32
(10 mantissa bits, what a tensor core takes), the phase arithmetic left
in float64.

Imports only torch: nothing of the program under test.
"""

from __future__ import annotations

import functools
import math

import torch

EPS = 1e-8
BLOCK_FRAMES = 16384


def hann(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n)


def princarg(p: torch.Tensor) -> torch.Tensor:
    return math.pi - torch.remainder(math.pi - p, 2.0 * math.pi)


def num_frames(length: int, n_fft: int, hop: int) -> int:
    return 0 if length < n_fft else 1 + (length - n_fft) // hop


def synthesis_hop(hop: int, stretch: float) -> int:
    rs = int(round(hop * stretch))
    if rs <= 0:
        raise ValueError(f"stretch {stretch} gives non-positive synthesis hop")
    return rs


def output_length(nf: int, n_fft: int, rs: int) -> int:
    return 0 if nf <= 0 else (nf - 1) * rs + n_fft


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest to TF32's 10 mantissa bits."""
    bits = a.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@functools.lru_cache(maxsize=4)
def _dft(n: int, device: str):
    """(analysis (n, 2 nb), synthesis (2 nb, n)) real DFT matrices, TF32."""
    nb = n // 2 + 1
    t = torch.arange(n, dtype=torch.float64, device=device)
    k = torch.arange(nb, dtype=torch.float64, device=device)
    ang = 2.0 * math.pi * torch.outer(t, k) / n
    fwd = torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1)
    c = torch.full((nb,), 2.0, dtype=torch.float64, device=device)
    c[0] = 1.0
    if n % 2 == 0:
        c[-1] = 1.0
    inv = torch.cat([c[:, None] * torch.cos(ang.T), -c[:, None] * torch.sin(ang.T)], dim=0) / n
    return tf32(fwd), tf32(inv)


def _rfft(frames: torch.Tensor, transform: str) -> torch.Tensor:
    if transform == "float64":
        return torch.fft.rfft(frames, dim=-1)
    fwd, _ = _dft(frames.shape[-1], str(frames.device))
    nb = fwd.shape[1] // 2
    out = (tf32(frames) @ fwd).double()
    return torch.complex(out[:, :nb], out[:, nb:])


def _irfft(spec: torch.Tensor, n: int, transform: str) -> torch.Tensor:
    if transform == "float64":
        return torch.fft.irfft(spec, n=n, dim=-1)
    _, inv = _dft(n, str(spec.device))
    return (tf32(torch.cat([spec.real, spec.imag], dim=1)) @ inv).double()


def _overlap_add(out: torch.Tensor, frames: torch.Tensor, first: int, rs: int) -> None:
    """out[(first + i) rs + t] += frames[i, t], for out a multiple of rs long."""
    rows = out.view(-1, rs)
    n = frames.shape[1]
    for j in range(-(-n // rs)):
        part = frames[:, j * rs : (j + 1) * rs]
        if part.shape[1] < rs:
            part = torch.nn.functional.pad(part, (0, rs - part.shape[1]))
        rows[first + j : first + j + frames.shape[0]] += part


def time_stretch(x: torch.Tensor, stretch: float, n_fft: int = 1024, hop: int = 256,
                 transform: str = "float64", block: int = BLOCK_FRAMES) -> torch.Tensor:
    """The stretched waveform of x (float64, on x's device)."""
    if transform not in ("float64", "tf32"):
        raise ValueError(f"unknown transform {transform!r}")
    dev = x.device
    x = x.to(torch.float64)
    n, ra = n_fft, hop
    rs = synthesis_hop(ra, stretch)
    nf = num_frames(x.shape[0], n, ra)
    if nf == 0:
        return x.new_zeros(0)
    w = hann(n, dev)
    omega = 2.0 * math.pi * torch.arange(n // 2 + 1, dtype=torch.float64, device=dev) / n
    real_bins = [0, n // 2]
    length = output_length(nf, n, rs)
    rows = -(-length // rs) + 1
    out = torch.zeros(rows * rs, dtype=torch.float64, device=dev)
    norm = torch.zeros(rows * rs, dtype=torch.float64, device=dev)
    framed = x.unfold(0, n, ra)
    phi_prev = psi_prev = None
    for f0 in range(0, nf, block):
        f1 = min(nf, f0 + block)
        spec = _rfft(framed[f0:f1] * w, transform)
        mag, phi = spec.abs(), spec.angle()
        if phi_prev is None:
            steps = rs * (omega + princarg(phi[1:] - phi[:-1] - ra * omega) / ra)
            psi = torch.cat([phi[:1], phi[:1] + torch.cumsum(steps, 0)])
        else:
            prev = torch.cat([phi_prev[None], phi[:-1]])
            steps = rs * (omega + princarg(phi - prev - ra * omega) / ra)
            psi = psi_prev + torch.cumsum(steps, 0)
        phi_prev, psi_prev = phi[-1], psi[-1]
        idx = torch.arange(f0, f1, dtype=torch.int64, device=dev)
        for kb in real_bins:
            lin = 2.0 * math.pi * ((idx * ((rs * kb) % n)) % n).double() / n
            psi[:, kb] = phi[:, kb] + lin
        y = _irfft(torch.polar(mag, psi), n, transform) * w
        _overlap_add(out, y, f0, rs)
        _overlap_add(norm, (w * w).expand(f1 - f0, n), f0, rs)
    return out[:length] / torch.clamp_min(norm[:length], EPS)


def max_rel_err(ours: torch.Tensor, ref: torch.Tensor, skip: int) -> float:
    """Interior max |ours - ref| over max |ref|, `skip` samples left out at
    each edge; infinite where the lengths differ or a value is not finite."""
    if ours.shape != ref.shape:
        return math.inf
    sl = slice(skip, ref.shape[0] - skip)
    a, b = ours[sl].to(torch.float64), ref[sl]
    if a.numel() == 0:
        return 0.0
    diff = float((a - b).abs().max())
    if not math.isfinite(diff):
        return math.inf
    return diff / float(b.abs().max())
