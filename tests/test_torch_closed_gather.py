"""The integer-k phase in the synthesis's load and the row-owning overlap-add
gather of csrc/pvoc_fused.cu, through their plain versions on the CPU (the
kernels run only on the card, where chip_smoke.py holds them to these
plain versions and to the parent's output hashes):

  * anchor_table_reference, the plain phase_anchor (the anchor table u_0
    that synth_real's closed-form load reads), against the JAX package's
    frame-0 unit phasor and against the anchor a stream carries: the JAX
    package's fused stream (converted) and the port's own, bitwise;
  * _workspace: no packed-Y scratch where closed_in_synth (q = 1, N =
    256-4096 a power of two), a (batch, 2, N/2-1) anchor table instead
    (none for a stream segment, whose carry holds its anchor); the packed
    Y kept at q >= 2 and at N = 768;
  * ola_rows_twin, the twin of the kernel ola_rows (a warp owns an output
    row, its lanes walk the row W samples at a time, the frames covering a
    sample summed oldest first after the tail, the normalization row and
    the ragged table chosen once a row), bitwise equal to the plain fold
    overlap-add of the fused routes (_ola_rows_reference, then
    _normalize_rows) for Rs | N, Rs not dividing N, stream tails and
    ragged counts 1..m-1.

Bounds: bitwise where the arithmetic is the same (torch.equal); the JAX
comparison as tests/test_torch_general_hop.py holds unit phasors: weighted
by |X| / max |X|, <= 1e-4 (two f32 analyses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phase_vocoder_tpu import streaming as jstreaming
from phase_vocoder_tpu.ops.pallas import fused as jfused
from phase_vocoder_tpu.utils.checkpoint import _fused_state_to_tree
from phase_vocoder_tpu_torch import streaming
from phase_vocoder_tpu_torch.ops import fused
from phase_vocoder_tpu_torch.ops.window import hann_window
from phase_vocoder_tpu_torch.utils.checkpoint import fused_stream_state_from_jax_tree
from tests.conftest import make_test_signal

N, RA = 1024, 256
NH = N // 2


@pytest.fixture(scope="module")
def x4():
    return torch.as_tensor(make_test_signal(4.0).astype(np.float32))


def _frame0(x, n_fft=N):
    """Bins 0..n_fft/2 of the port's plain analysis of frame 0 (re, im)."""
    spec = torch.fft.rfft(x[:n_fft] * hann_window(n_fft), dim=-1)
    return spec.real, spec.imag


def _weighted(a, b, weight):
    return float((np.abs((a[0] + 1j * a[1]) - (b[0] + 1j * b[1])) * weight).max())


# ------------------------------------------------------------ anchor table


def test_anchor_table_vs_jax_frame0_unit_phasor(x4):
    """The table of a recording that has not started is frame 0's unit
    phasor over the general bins; JAX's, from its phasor-terms kernel."""
    j = jfused.stft_phasor_terms(jnp.asarray(x4.numpy()), N, RA, 512, scan=False, return_u=True)
    jm, jure, juim = (np.asarray(a)[0, 1:NH] for a in (j[0], j[3], j[4]))
    re0, im0 = _frame0(x4)
    table = fused.anchor_table_reference(re0, im0)
    assert table.shape == (2, NH - 1) and table.dtype == torch.float32
    assert np.abs(np.hypot(*table.numpy()) - 1).max() < 1e-6
    assert _weighted(table.numpy(), (jure, juim), jm / jm.max()) <= 1e-4


def test_anchor_table_of_a_batch_is_each_rows():
    """(B, N/2+1) frame-0 bins give (B, 2, N/2-1): one table per batch row,
    each the single row's, bitwise; a silent bin takes u = 1."""
    xs = torch.stack([torch.as_tensor(make_test_signal(0.2, seed=s).astype(np.float32))
                      for s in range(3)])
    xs[2] = 0.0
    spec = torch.fft.rfft(xs[:, :N] * hann_window(N), dim=-1)
    table = fused.anchor_table_reference(spec.real, spec.imag)
    assert table.shape == (3, 2, NH - 1)
    for b in range(3):
        assert torch.equal(table[b], fused.anchor_table_reference(spec.real[b], spec.imag[b]))
    assert torch.equal(table[2, 0], torch.ones(NH - 1)) and torch.equal(table[2, 1], torch.zeros(NH - 1))


def test_anchor_table_once_started_is_the_carry():
    carry = torch.as_tensor(np.random.default_rng(3).standard_normal((4, NH - 1)).astype(np.float32))
    junk = torch.full((NH + 1,), float("nan"))
    assert torch.equal(fused.anchor_table_reference(junk, junk, carry, started=True), carry[:2])


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_anchor_table_is_the_ports_carried_anchor(n_fft):
    """After its first segment the port's integer-k stream carries u_0 in
    rows 0-1 of its carry: bit for bit the table of frame 0, and it keeps
    it through the next segment."""
    hop, rs = n_fft // 4, n_fft // 2
    x = torch.as_tensor(make_test_signal(200 * hop / 16000, seed=5).astype(np.float32))
    nf = fused.num_frames(len(x), n_fft, hop)
    F, S = streaming.fused_plan_segments(nf, n_fft, rs, 64)
    assert S >= 3
    re0, im0 = _frame0(x, n_fft)
    table = fused.anchor_table_reference(re0, im0)
    st = streaming.fused_init_state(n_fft, rs, "cpu")
    for k in (1, 2):
        _, st_k = streaming._fused_scan_from(x, st, nf, n_fft, hop, rs, F, k)
        assert torch.equal(st_k.carry[:2], table)


def test_anchor_table_vs_jax_stream_carry(x4):
    """The JAX package's fused stream after one segment at 2.0x carries its
    u_0 (converted by fused_stream_state_from_jax_tree); within the unit
    phasor bound of the port's table."""
    rs = 512
    nf = fused.num_frames(len(x4), N, RA)
    tile = jfused._pick_tile(N, rs, nf)
    F, S = jstreaming.fused_plan_segments(nf, N, rs, 64, tile)
    rows = jstreaming.fused_stream_rows(jnp.asarray(x4.numpy()), N, RA, F, S, tile)
    _, jstate = jstreaming._fused_scan_from(rows, jstreaming.fused_init_state(N, rs), nf, N, RA, rs, F, 1)
    tree = {name: np.asarray(v) for name, v in _fused_state_to_tree(jstate).items()}
    state = fused_stream_state_from_jax_tree(tree, N, rs)
    re0, im0 = _frame0(x4)
    mag = np.hypot(re0.numpy(), im0.numpy())[1:NH]
    table = fused.anchor_table_reference(re0, im0).numpy()
    assert _weighted(table, state.carry[:2].numpy(), mag / mag.max()) <= 1e-4


# --------------------------------------------------------------- workspace


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("batch", [1, 3])
def test_workspace_has_no_y_on_the_closed_route(n_fft, batch):
    assert fused.closed_in_synth(n_fft, 1)
    work = fused._workspace(40, n_fft, 1, "cpu", batch=batch)
    assert work["y"] is None and work["tot"] is None and work["carry"] is None
    assert work["anchor"].shape == (batch, 2, n_fft // 2 - 1)
    assert work["spec"].shape == (batch * 40, n_fft + 2)
    seg = fused.segment_workspace(64, n_fft, n_fft // 4, n_fft // 2, "cpu")
    assert seg["y"] is None and seg["anchor"] is None
    # the six pointers each TSM entry takes: y null, the table where needed
    assert fused._ptrs(work)[1] is None and fused._ptrs(work)[2] is not None
    assert fused._ptrs(seg)[1:3] == [None, None]


@pytest.mark.parametrize("n_fft,q", [(1024, 2), (256, 4), (4096, 2), (768, 1), (768, 2), (128, 1)])
def test_workspace_keeps_y_elsewhere(n_fft, q):
    """q >= 2 (phase_terms, the scan, phase_apply) and the N outside
    fft_real.cuh's body (phase_closed + fft_synthesis) keep the packed Y."""
    assert not fused.closed_in_synth(n_fft, q)
    for work in (fused._workspace(40, n_fft, q, "cpu", batch=2),
                 fused._workspace(64, n_fft, q, "cpu", segment=True)):
        assert work["y"].shape == work["spec"].shape
        assert work["anchor"] is None
        assert (work["tot"] is None) == (q == 1)


# ---------------------------------------------------------- the row gather


def ola_rows_twin(frames, n_rows, rs, n_out, n_main, norm, tail_in=None, goff=0,
                  nf_total=None, ragged=False, lanes_w=4):
    """Twin of csrc/pvoc_fused.cu ola_rows over float32 numpy arrays.

    frames (B, nf, N) of which row b's first n_rows[b] count; out (B, n_out)
    normalized and, for samples at or past n_main (one batch row), the
    un-normalized partial sums into tail_out. norm: (2m-1, rs), or with
    ragged the (m-1, 2m-1, rs) stack picked by each row's count. A warp
    owns output row r; lane l takes samples l W + 32 W i of the row, W =
    lanes_w; every value is summed in the kernel's order: the tail (rows <
    m-1), then frames r-d for d = d_hi .. d_lo, then times the inverse
    energy of the row's normalization row."""
    B, _, n_fft = frames.shape
    m = -(-n_fft // rs)
    out = np.zeros((B, n_out), np.float32)
    tail_out = np.zeros(max(n_out - n_main, 0), np.float32)
    rows = -(-n_out // rs)
    for b in range(B):
        n_row = n_rows[b]
        for r in range(rows):
            n0 = r * rs
            length = min(rs, n_out - n0)
            d_hi, d_lo = min(r, m - 1), max(r - (n_row - 1), 0)
            tin = tail_in is not None and r < m - 1
            if n0 >= n_main:
                nrm, zero = None, False
            else:
                total = n_row if ragged else nf_total
                table = norm
                if ragged:
                    key = (max(n_row, 1) if n_row < m - 1 else m - 1)
                    table = norm[key - 1]
                gr, zero = goff + r, False
                if gr >= total:
                    nrow = m - 1 + (gr - total)
                    zero = nrow > 2 * m - 3  # past the recording's output
                elif gr < m - 1:
                    nrow = gr
                else:
                    nrow = 2 * m - 2
                nrm = None if zero else table[nrow]
            seen = np.zeros(length, np.int32)
            for lane in range(32):
                for t0 in range(lane * lanes_w, length, 32 * lanes_w):
                    t = np.arange(t0, min(t0 + lanes_w, length))
                    seen[t] += 1
                    acc = np.zeros(len(t), np.float32)
                    if not zero:
                        if tin:
                            acc = tail_in[n0 + t].astype(np.float32)
                        for d in range(d_hi, d_lo - 1, -1):
                            off = d * rs + t
                            keep = off < n_fft
                            acc[keep] = acc[keep] + frames[b, r - d, off[keep]]
                        if nrm is not None:
                            acc = acc * nrm[t]
                    if n0 >= n_main:
                        tail_out[n0 - n_main + t] = acc
                    else:
                        out[b, n0 + t] = acc
            assert (seen == 1).all()
    return out, tail_out


def _frames(n, n_fft, seed):
    return np.random.default_rng(seed).standard_normal((n, n_fft)).astype(np.float32)


@pytest.mark.parametrize("n_fft,rs", [(1024, 512), (1024, 256), (1024, 128), (256, 64),
                                      (1024, 384), (1024, 171), (768, 96), (1000, 250)])
@pytest.mark.parametrize("nf", [1, 5, 23])
def test_gather_twin_is_the_plain_fold_ola(n_fft, rs, nf):
    """A whole recording (pvoc_fused, pvoc_phasor_synth): rows over
    (nf-1) Rs + N samples, the last cut short where Rs does not divide N."""
    frames = _frames(nf, n_fft, nf + rs)
    n_out = (nf - 1) * rs + n_fft
    norm = fused.stream_norm_tables(n_fft, rs, nf)
    got, _ = ola_rows_twin(frames[None], [nf], rs, n_out, n_out, norm, nf_total=nf,
                           lanes_w=4 if rs % 4 == 0 else 1)
    t = torch.as_tensor(frames)
    want = fused._normalize_rows(fused._ola_rows_reference(t, nf, rs, None), 0, nf, n_fft, rs)
    assert torch.equal(torch.as_tensor(got[0]), want.reshape(-1)[:n_out])


@pytest.mark.parametrize("n_fft,rs", [(1024, 512), (1024, 128), (1024, 171), (256, 64)])
@pytest.mark.parametrize("seg,n_valid,goff,nf_total", [
    (64, 64, 64, 300), (64, 40, 256, 296), (64, 0, 320, 300), (64, 64, 0, 64), (64, 3, 0, 3)])
def test_gather_twin_is_the_plain_stream_ola(n_fft, rs, seg, n_valid, goff, nf_total):
    """A stream segment: rows from the previous segment's tail, n_main =
    F Rs normalized by the global row, the m-1 rows after into tail_out;
    a segment with fewer or no frames of the recording."""
    m = -(-n_fft // rs)
    frames = _frames(max(n_valid, 1), n_fft, 7 + goff)[:n_valid]
    tail = np.random.default_rng(goff + 1).standard_normal((m - 1) * rs).astype(np.float32)
    n_main = seg * rs
    n_out = n_main + (m - 1) * rs
    norm = fused.stream_norm_tables(n_fft, rs, nf_total)
    full = np.zeros((1, max(n_valid, 1), n_fft), np.float32)
    full[0, :n_valid] = frames
    got, got_tail = ola_rows_twin(full, [n_valid], rs, n_out, n_main, norm, tail_in=tail,
                                  goff=goff, nf_total=nf_total, lanes_w=4 if rs % 4 == 0 else 1)
    ola = fused._ola_rows_reference(torch.as_tensor(frames).reshape(n_valid, n_fft), seg, rs,
                                    torch.as_tensor(tail).reshape(m - 1, rs))
    main = fused._normalize_rows(ola[:seg], goff, nf_total, n_fft, rs).reshape(-1)
    assert torch.equal(torch.as_tensor(got[0, :n_main]), main)
    assert torch.equal(torch.as_tensor(got_tail), ola[seg:].reshape(-1))


@pytest.mark.parametrize("n_fft,rs", [(1024, 128), (1024, 512), (1024, 171), (2048, 683)])
def test_gather_twin_is_the_plain_ragged_batch_ola(n_fft, rs):
    """A ragged batch: every count 1..m-1 (rows shorter than the overlap,
    each normalized by its own table of the stack), a longer row and an
    empty one; out (B, (nf+m-1) Rs), zeros past each row's output."""
    m = -(-n_fft // rs)
    counts = list(range(1, m)) + [m + 4, 0]
    nf = max(counts)
    frames = np.stack([_frames(nf, n_fft, 11 + b) for b in range(len(counts))])
    n_out = (nf + m - 1) * rs
    stack = np.stack([fused._ola_norm_rows(n_fft, rs, key) for key in range(1, m)])
    got, _ = ola_rows_twin(frames, counts, rs, n_out, n_out, stack, ragged=True,
                           lanes_w=4 if rs % 4 == 0 else 1)
    for b, nf_b in enumerate(counts):
        want = torch.zeros(n_out)
        if nf_b:
            t = torch.as_tensor(frames[b, :nf_b])
            ola = fused._normalize_rows(fused._ola_rows_reference(t, nf_b, rs, None), 0, nf_b,
                                        n_fft, rs)
            want[: (nf_b - 1) * rs + n_fft] = ola.reshape(-1)[: (nf_b - 1) * rs + n_fft]
        assert torch.equal(torch.as_tensor(got[b]), want), (b, nf_b)
