"""The analysis body of csrc/fft_real.cuh (analysis_groups), which
csrc/pvoc_fused.cu runs as analysis_real (packed rows) and csrc/stft.cu as
stft_real_kernel (two arrays), written out in float64 torch on the CPU: a CUDA kernel has no interpret mode, so its index
arithmetic and formulas are held here and the kernel itself against its
plain version on the card (chip_smoke.py).

What the twin follows, as the source orders it: the frame groups of every
batch row flattened (group gi is row gi // per_row, frames
(gi % per_row) F + slot, F = 8192 / N), a group wholly past its row's
frames skipped by the block, its span x[b x_stride + i0 hop :][: (fg - 1)
hop + N] (fg the group's live frames, so the last group's span ends at its
last frame), frame slot at span[slot hop :]; the pack z[n] = g[2n] +
i g[2n+1], g = x w; fft_real.cuh's forward stages; the split of bins k and
M - k by one thread (k = t + T u) and of bin M/2 by thread 0; then the
write: straight into the frame's row where a frame has a warp or more
(N >= 1024), else into the frame's buffer (index i at i + i/32) and out in
one block-wide sweep of the group's contiguous rows: packed rows
[re(nb) | im(nb)] at stride 2 nb (analysis_real), or two arrays at stride
nb (stft_real_kernel's cartesian form).

Bounds: <= 1e-12 of the largest |X| from torch.fft.rfft(x w) per frame
(float64 throughout); frames the kernel does not write stay NaN.
"""

import math
import re

import numpy as np
import pytest
import torch

from phase_vocoder_tpu_torch.ops import fused
from phase_vocoder_tpu_torch.ops.window import hann_window
from tests.test_torch_stft import _real_fft_m

CSRC = fused._build.CSRC


def _pad(i: int) -> int:
    return i + (i >> 5)


def _analysis_twin(x: torch.Tensor, x_stride: int, nf: int, nfs: list, hop: int, n_fft: int,
                   packed: bool) -> tuple:
    """analysis_groups over len(nfs) batch rows of the flat float64 signal x
    (row b from x[b x_stride]), nf frames a row in the output buffers, row
    b's first nfs[b] written. Returns the packed (B nf, 2 nb) buffer, or the
    two (B nf, nb) arrays (re, im); NaN where the kernel writes nothing.
    Every span read is checked to lie inside x."""
    log2n = n_fft.bit_length() - 1
    M, F = n_fft // 2, 8192 // n_fft
    T = M // 16
    nb = M + 1
    FS = M + M // 32 + 2
    k_tab = torch.arange(M, dtype=torch.float64)
    tc, ts = torch.cos(2 * math.pi * k_tab / n_fft), torch.sin(2 * math.pi * k_tab / n_fft)
    w = hann_window(n_fft).double()
    B = len(nfs)
    if packed:
        oa = torch.full((B * nf * 2 * nb,), math.nan, dtype=torch.float64)
        ob = None
    else:
        oa = torch.full((B * nf * nb,), math.nan, dtype=torch.float64)
        ob = torch.full((B * nf * nb,), math.nan, dtype=torch.float64)
    row_len = 2 * nb if packed else nb
    per_row = -(-nf // F)
    for gi in range(per_row * B):
        b = gi // per_row
        i0 = (gi - b * per_row) * F
        left = nfs[b] - i0
        if left <= 0:  # next_live skips the group
            continue
        fg = min(left, F)
        start = b * x_stride + i0 * hop
        length = (fg - 1) * hop + n_fft
        assert 0 <= start and start + length <= len(x), "span read outside x"
        span = x[start : start + length]
        bufs = torch.zeros((F, 2, FS), dtype=torch.float64)
        row0 = b * nf + i0
        for slot in range(fg):  # past fg: stale span data, not stored
            g = span[slot * hop : slot * hop + n_fft] * w
            Z = _real_fft_m(torch.complex(g[0::2], g[1::2]), log2n, True, tc, ts)

            def split(k, zr, zi, mr, mi):
                wr = tc[k] if k < M else -1.0
                wi = -ts[k] if k < M else 0.0
                er, ei = 0.5 * (zr + mr), 0.5 * (zi + mi)
                pr, pi = 0.5 * (zi - mi), -0.5 * (zr - mr)
                return er + (pr * wr - pi * wi), ei + (pr * wi + pi * wr)

            bins = {}
            for t in range(T):
                for u in range(8):
                    k = t + T * u
                    m = 0 if k == 0 else M - k
                    zr, zi, yr, yi = Z.real[k], Z.imag[k], Z.real[m], Z.imag[m]
                    bins[k] = split(k, zr, zi, yr, -yi)
                    if k == 0:
                        bins[M] = split(M, zr, zi, zr, -zi)
                    else:
                        bins[m] = split(m, yr, yi, zr, -zi)
            zr, zi = Z.real[M // 2], Z.imag[M // 2]
            bins[M // 2] = split(M // 2, zr, zi, zr, -zi)
            assert sorted(bins) == list(range(nb))
            arow = (row0 + slot) * row_len
            for k, (re_, im_) in bins.items():
                if T < 32:  # staged: back into the frame's buffer
                    bufs[slot, 0, _pad(k)] = re_
                    bufs[slot, 1, _pad(k)] = im_
                elif packed:
                    oa[arow + k] = re_
                    oa[arow + nb + k] = im_
                else:
                    oa[arow + k] = re_
                    ob[arow + k] = im_
        if T < 32:  # the block-wide sweep of rows row0 .. row0 + fg - 1
            flat = bufs.reshape(-1)
            ga = row0 * row_len
            for e in range(fg * row_len):
                f = e // row_len
                r = e - f * row_len
                if packed:
                    q = f * 2 * FS + (_pad(r) if r <= M else FS + _pad(r - nb))
                    oa[ga + e] = flat[q]
                else:
                    q = f * 2 * FS + _pad(r)
                    oa[ga + e] = flat[q]
                    ob[ga + e] = flat[q + FS]
    if packed:
        return (oa.reshape(B * nf, 2 * nb),)
    return oa.reshape(B * nf, nb), ob.reshape(B * nf, nb)


def _rfft_rows(x: torch.Tensor, start: int, n: int, hop: int, n_fft: int) -> torch.Tensor:
    """torch.fft.rfft of n windowed frames of x from sample start."""
    frames = torch.stack([x[start + i * hop : start + i * hop + n_fft] for i in range(n)])
    return torch.fft.rfft(frames * hann_window(n_fft).double(), dim=-1)


def _check_rows(out: tuple, packed: bool, x, x_stride, nf, nfs, hop, n_fft):
    nb = n_fft // 2 + 1
    re, im = (out[0][:, :nb], out[0][:, nb:]) if packed else out
    for b, n_b in enumerate(nfs):
        live = slice(b * nf, b * nf + n_b)
        dead = slice(b * nf + n_b, (b + 1) * nf)
        if n_b:
            ref = _rfft_rows(x, b * x_stride, n_b, hop, n_fft)
            top = float(ref.abs().max())
            got = torch.complex(re[live], im[live])
            assert float((got - ref).abs().max()) <= 1e-12 * top
            assert bool((im[live][:, 0] == 0).all()) and bool((im[live][:, -1] == 0).all())
        assert bool(re[dead].isnan().all()) and bool(im[dead].isnan().all())


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "cartesian"])
@pytest.mark.parametrize("hop_div", [4, 8])
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_analysis_real_ragged_batch_float64(n_fft, hop_div, packed):
    """A ragged batch of three rows at an odd row stride: one row of two
    full groups and a partial one, one shorter than a group, one with no
    frames; every live frame equals rfft(x w), dead frames unwritten."""
    hop = n_fft // hop_div
    F = 8192 // n_fft
    nf = 2 * F + 3
    nfs = [nf, F - 1, 0]
    x_stride = (nf - 1) * hop + n_fft + 1  # odd
    assert x_stride % 2 == 1
    g = np.random.default_rng(n_fft + hop_div)
    x = torch.as_tensor(g.standard_normal(len(nfs) * x_stride))
    out = _analysis_twin(x, x_stride, nf, nfs, hop, n_fft, packed)
    _check_rows(out, packed, x, x_stride, nf, nfs, hop, n_fft)


@pytest.mark.parametrize("hop_div", [4, 8])
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_analysis_real_segment_float64(n_fft, hop_div):
    """pvoc_fused_segment's analysis: n_valid frames of x_seg, the signal
    from sample goff hop of a recording, holding exactly (n_valid - 1) hop
    + N samples. The last group's span is clipped to its own frames (the
    twin asserts that no read passes x_seg's end), and each frame equals
    the recording's frame goff + i."""
    hop = n_fft // hop_div
    F = 8192 // n_fft
    n_valid, goff = F + 3, 5
    g = np.random.default_rng(7 * n_fft + hop_div)
    rec = torch.as_tensor(g.standard_normal((goff + n_valid + 4) * hop + n_fft))
    x_seg = rec[goff * hop : goff * hop + (n_valid - 1) * hop + n_fft]
    seg_frames = n_valid + 2  # the segment's buffers hold more rows than it fills
    (out,) = _analysis_twin(x_seg, 0, seg_frames, [n_valid], hop, n_fft, True)
    nb = n_fft // 2 + 1
    ref = _rfft_rows(rec, goff * hop, n_valid, hop, n_fft)
    got = torch.complex(out[:n_valid, :nb], out[:n_valid, nb:])
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    assert bool(out[n_valid:].isnan().all())
    with pytest.raises(AssertionError, match="outside"):
        _analysis_twin(x_seg[:-1], 0, seg_frames, [n_valid], hop, n_fft, True)


def test_analysis_real_serves_the_powers_of_two():
    """Which analysis serves which N: real_body(N), the powers of two from
    256 to 4096 (real_fft::real_log2), where launch_analysis sends the full
    and the fold request alike to analysis_real before any one-block-a-frame
    kernel; every other even N (128 included) keeps fft_analysis and
    fft_analysis_fold. analysis_real and stft.cu's analysis run one body
    (analysis_groups) in two output forms."""
    assert [n for n in range(2, 8194, 2) if fused.real_body(n)] == [256, 512, 1024, 2048, 4096]
    assert not fused.real_body(128) and not fused.real_body(768)
    src = (CSRC / "pvoc_fused.cu").read_text()
    body = src[src.index("cudaError_t launch_analysis("):]
    body = body[: body.index("\n}\n")]
    cases = re.findall(r"case (\d+): return launch_analysis_real<(\d+)>", body)
    assert [(int(a), int(b)) for a, b in cases] == [(l, l) for l in range(8, 13)]
    assert body.index("real_fft::real_log2(g.n_fft)") < body.index("fft_analysis_fold<")
    assert body.index("launch_analysis_real<12>") < body.index("fft_analysis<")
    switch = body[body.index("switch (") : body.index("default: break;")]
    assert "fft_half" not in switch  # no fold-only route at the powers of two
    assert "real_fft::analysis_groups<real_fft::Plan<LOG2N>, real_fft::kPacked>(" in src
    stft_src = (CSRC / "stft.cu").read_text()
    assert "real_fft::analysis_groups<real_fft::Plan<LOG2N>, POLAR ? real_fft::kPolar : real_fft::kCart>(" in stft_src


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_analysis_real_smem_fits_the_card(n_fft):
    """analysis_smem at N and its main-path hop N/4, at the smallest hop the
    chip checks (N/8) and at hop N (the largest span): within the H100's
    227 KB a block may opt into (real_fft::grid_for raises the limit past
    48 KB), counted as the header lays it out."""
    M, F = n_fft // 2, 8192 // n_fft
    FS = M + M // 32 + 2

    def smem(hop):
        span = ((F - 1) * hop + n_fft + 7) & ~3
        return 4 * (2 * M + F * 2 * FS + 2 * span)

    for hop in (n_fft // 8, n_fft // 4, n_fft):
        assert smem(hop) <= 227 * 1024
    src = (CSRC / "fft_real.cuh").read_text()
    assert "return ((P::F - 1) * hop + P::N + 7) & ~3;" in src
    assert "2 * P::M + P::F * 2 * P::FS + 2 * (size_t)span_floats<P>(hop)" in src
