"""The overlap-add in synth_real's epilogue (csrc/pvoc_fused.cu), as a
plain torch model of its sum order, held bit for bit (torch.equal: equal
values, where a row past the recording's output is +0 here and -0 or +0
in the plain version, which multiplies by a zero row) to the
plain fold overlap-add and normalization of the fused routes
(ops/fused.py _ola_rows_reference, then _normalize_rows), which
tests/test_torch_closed_gather.py holds ola_rows' twin to.

The model follows the kernel's indices: ola_groups groups of F frames a
batch row, each block of a grid on a contiguous share of the rows' groups
cut into runs at batch rows; a run starts from the partial sums of the
m-1 rows before its first group (tail_in or 0), first takes the m-1
frames before that group (its halo, which the kernel transforms again),
then group by group adds the group's frames oldest first to the rows they
end and carries the sums of the m-1 rows after it to the next group;
rows a run ends before its own first group are written nowhere. A
row is written once, to out times its inverse-energy row (row_dst: head,
interior, tail, the ragged table of its count, zeros past the output), or
un-normalized to tail_out past n_main.

No JAX here: a CUDA kernel has no CPU form, so the kernel itself is held
to its parent's bits on the card (chip_smoke.py --ab, the card tests of
tests/test_torch_general_synth.py).
"""

import numpy as np
import pytest
import torch

from phase_vocoder_tpu_torch.ops import fused

N = 1024
F = 8192 // N  # frames a group (fft_real.cuh's Plan<10>::F)
RS = [1024, 512, 768, 256, 128, 171]  # m = 1, 2, 2, 4, 8, 6


def ola_groups(rows: int, m: int) -> int:
    lead = rows - (m - 1)
    return -(-lead // F) if lead > F else 1


def row_dst(r, n_row, rs, m, n_main, norm, goff, nf_total, ragged):
    """(where, normalization row or None, zero) of output row r, as
    csrc/pvoc_fused.cu row_dst: "tail" at and past n_main, else "out"."""
    if r * rs >= n_main:
        return "tail", None, False
    total, table = nf_total, norm
    if ragged:
        total = n_row
        table = norm[(max(n_row, 1) if n_row < m - 1 else m - 1) - 1]
    gr = goff + r
    if gr >= total:
        nrow = m - 1 + (gr - total)
        if nrow > 2 * m - 3:
            return "out", None, True
    elif gr < m - 1:
        nrow = gr
    else:
        nrow = 2 * m - 2
    return "out", table[nrow], False


def blocked_ola_twin(frames, n_rows, rs, n_out, n_main, norm, grid, tail_in=None, goff=0,
                     nf_total=None, ragged=False):
    """synth_real's overlap-add over float32 frames (B, nf, N), of which
    batch row b's first n_rows[b] count, on `grid` blocks. Returns (out
    (B, n_out), tail_out (n_out - n_main,)) and how often each sample was
    written."""
    B, _, n_fft = frames.shape
    m = -(-n_fft // rs)
    out = torch.full((B, n_out), float("nan"))
    tail_out = torch.full((max(n_out - n_main, 0),), float("nan"))
    seen_out = torch.zeros((B, n_out), dtype=torch.int32)
    seen_tail = torch.zeros(tail_out.shape, dtype=torch.int32)
    rows = -(-n_out // rs)
    per_row = ola_groups(rows, m)
    total = per_row * B
    t = torch.arange(rs)
    for blk in range(grid):
        first, last = total * blk // grid, total * (blk + 1) // grid
        run = first
        while run < last:
            bat = run // per_row
            j0 = run - bat * per_row
            j1 = min(last - bat * per_row, per_row)
            run = bat * per_row + j1
            n_row = n_rows[bat]
            hb = max(j0 * F - (m - 1), 0)  # the run's first frame
            cur = torch.zeros((max(m - 1, 0), rs))
            for e in range(m - 1):
                r = hb // F * F + e
                if tail_in is not None and r < m - 1:
                    cur[e] = tail_in[r]
            for j in range(hb // F, j1):
                i0 = j * F
                k_lo = max(hb, i0) - i0
                k_hi = max(min(n_row, i0 + F) - i0, k_lo)  # live frames i0 + [k_lo, k_hi)
                tail_rows = j == per_row - 1
                e_all = rows - i0 if tail_rows else F + m - 1
                e_end = e_all if tail_rows else F
                nxt = torch.full((max(m - 1, 0), rs), float("nan"))
                for e in range(e_all):
                    v = cur[e].clone() if e < m - 1 else torch.zeros(rs)
                    for k in range(max(e - (m - 1), k_lo), min(e, k_hi - 1) + 1):  # oldest first
                        s = (e - k) * rs + t
                        keep = s < n_fft
                        v[keep] = v[keep] + frames[bat, i0 + k, s[keep]]
                    if e >= e_end:
                        nxt[e - F] = v
                        continue
                    if j < j0:  # ended before the run's first group
                        continue
                    r = i0 + e
                    n0 = r * rs
                    length = min(rs, n_out - n0)
                    if length <= 0:
                        continue
                    where, nrm, zero = row_dst(r, n_row, rs, m, n_main, norm, goff, nf_total, ragged)
                    if where == "tail":
                        tail_out[n0 - n_main : n0 - n_main + length] = v[:length]
                        seen_tail[n0 - n_main : n0 - n_main + length] += 1
                    else:
                        val = torch.zeros(rs) if zero else v * torch.as_tensor(nrm)
                        out[bat, n0 : n0 + length] = val[:length]
                        seen_out[bat, n0 : n0 + length] += 1
                cur = nxt
    return out, tail_out, seen_out, seen_tail


def _frames(b, n, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((b, n, N)).astype(np.float32))


def _grids(total):
    """One group a block (a run starts at every group boundary), one block
    for everything, and a few shares that cut runs mid-row."""
    return sorted({total, 1, 3, 5, max(total // 2, 1)})


def _whole(rs, seed):
    nf = 37
    frames = _frames(1, nf, seed)
    n_out = (nf - 1) * rs + N
    norm = fused.stream_norm_tables(N, rs, nf)
    want = fused._normalize_rows(fused._ola_rows_reference(frames[0], nf, rs, None), 0, nf, N, rs)
    want = want.reshape(-1)[:n_out]
    m = -(-N // rs)
    total = ola_groups(-(-n_out // rs), m)
    for grid in _grids(total):
        out, _, seen, _ = blocked_ola_twin(frames, [nf], rs, n_out, n_out, norm, grid, nf_total=nf)
        assert (seen == 1).all(), grid
        assert torch.equal(out[0], want), grid


def _ragged(rs, seed):
    m = -(-N // rs)
    counts = [max(m - 2, 1), 29, 0, m + 3, 1]  # one shorter than m-1 frames, one empty
    nf = max(counts)
    frames = _frames(len(counts), nf, seed)
    n_out = (nf + m - 1) * rs
    stack = np.stack([fused._ola_norm_rows(N, rs, key) for key in range(1, m)])
    total = ola_groups(-(-n_out // rs), m) * len(counts)
    for grid in _grids(total):
        out, _, seen, _ = blocked_ola_twin(frames, counts, rs, n_out, n_out, stack, grid, ragged=True)
        assert (seen == 1).all(), grid
        for b, nf_b in enumerate(counts):
            want = torch.zeros(n_out)
            if nf_b:
                ola = fused._normalize_rows(fused._ola_rows_reference(frames[b, :nf_b], nf_b, rs, None),
                                            0, nf_b, N, rs)
                want[: (nf_b - 1) * rs + N] = ola.reshape(-1)[: (nf_b - 1) * rs + N]
            assert torch.equal(out[b], want), (grid, b)


def _segment(rs, seed):
    m = -(-N // rs)
    seg = 64
    rng = np.random.default_rng(seed)
    for n_valid, goff, nf_total in ((64, 64, 300), (40, 256, 296), (0, 320, 300), (64, 0, 64), (3, 0, 3)):
        frames = _frames(1, max(n_valid, 1), seed + goff)[:, :n_valid]
        tail = torch.as_tensor(rng.standard_normal((m - 1, rs)).astype(np.float32))
        n_main = seg * rs
        n_out = n_main + (m - 1) * rs
        norm = fused.stream_norm_tables(N, rs, nf_total)
        ola = fused._ola_rows_reference(frames[0], seg, rs, tail)
        main = fused._normalize_rows(ola[:seg], goff, nf_total, N, rs).reshape(-1)
        full = torch.zeros((1, max(n_valid, 1), N))
        full[:, :n_valid] = frames
        total = ola_groups(-(-n_out // rs), m)
        for grid in _grids(total):
            out, tail_out, seen, seen_tail = blocked_ola_twin(
                full, [n_valid], rs, n_out, n_main, norm, grid, tail_in=tail, goff=goff,
                nf_total=nf_total)
            assert (seen[0, :n_main] == 1).all() and (seen_tail == 1).all(), (grid, n_valid)
            assert torch.equal(out[0, :n_main], main), (grid, n_valid)
            assert torch.equal(tail_out, ola[seg:].reshape(-1)), grid


# The ragged batch is the fused route's (pvoc_fused_batch, Rs <= N/2): m >= 2.
CASES = [(kind, rs) for kind in ("whole", "ragged", "segment") for rs in RS
         if not (kind == "ragged" and rs > N // 2)]


@pytest.mark.parametrize("kind,rs", CASES)
def test_blocked_sum_is_the_plain_fold_bit_for_bit(kind, rs):
    """A whole recording (pvoc_fused, pvoc_phasor_synth), a ragged batch
    (pvoc_fused_batch: a row shorter than m-1 frames, an empty row) and
    stream segments (pvoc_fused_segment: tail_in and tail_out, a segment
    part past and one wholly past the recording), at m = 1, 2, 4, 6, 8 and
    on grids whose runs start at every group boundary, at none, and in
    between."""
    {"whole": _whole, "ragged": _ragged, "segment": _segment}[kind](rs, seed=rs)


def test_groups_cover_every_row():
    """ola_groups: the last group ends the rows after it, so the groups'
    rows cover a batch row's frames + m - 1 rows for any count."""
    for rs in RS:
        m = -(-N // rs)
        for frames in range(1, 40):
            rows = frames + m - 1
            g = ola_groups(rows, m)
            assert (g - 1) * F < max(rows - (m - 1), 1) and rows - (g - 1) * F <= F + m - 1
