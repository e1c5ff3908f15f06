"""The integer-k closed form's analysis inside synth_real (csrc/pvoc_fused.cu
synth_real<LOG2N, kSignal>): where closed_in_synth (q = 1, N a power of
two from 256 to 4096) each block transforms its own frames from the
signal, so no spectrum of the frames goes through device memory and the
separate analysis covers frame 0 of each batch row alone (the anchor's
source).

On the CPU:
  * _workspace gives `spec` one row a batch row there (none of the packed
    Y), and every frame's spectra and the packed Y where q >= 2 or N lies
    outside real_body, for whole batches and stream segments;
  * through a stub library (tests/test_torch_spans.py's), with meta
    tensors standing in for the card's, each wrapper whose geometry takes
    the path counts the frames it sends through it as
    frames_in_synth.<wrapper> (batch x frames a call: a ragged batch its
    rows' own counts, a segment its valid frames), and a q >= 2 call or an
    N outside real_body counts none.

Marked `card` (skipped without a CUDA card): the kernel against the plain
version fused_time_stretch_reference at N = 256-4096 on chip_smoke.py's
signal under its gates (interior relative error below 1e-5 at k = 2,
2e-5 at k = 3); a recording shorter than one group of frames, where the
window energy is at least 1e-2 (tests/test_torch_general_synth.py's
measure: such a recording is mostly edge); ragged batch rows of 0, 1,
F - 1 and F + 1 frames, each bitwise its own single call; streams whose
last segment ends inside a group, bitwise the monolithic call; and
pvoc_fused_zrev bitwise pvoc_fused. No JAX here, so that the card tests
run where JAX is absent:

    python -m pytest tests/test_torch_analysis_in_synth.py --noconftest -m card
"""

import contextlib

import numpy as np
import pytest
import torch

from phase_vocoder_tpu_torch import streaming
from phase_vocoder_tpu_torch.bench import utterance
from phase_vocoder_tpu_torch.config import PvocConfig
from phase_vocoder_tpu_torch.ops import _build, framing, fused
from phase_vocoder_tpu_torch.ops.window import hann_window
from phase_vocoder_tpu_torch.utils import profiling

SR = 16000
# Frames a block transforms as one group (fft_real.cuh Plan<LOG2N>::F).
GROUP = {256: 32, 512: 16, 1024: 8, 2048: 4, 4096: 2}


# ------------------------------------------------------------ workspace


@pytest.mark.parametrize("kind", ["batch", "segment"])
@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("n_fft", [128, 256, 1024, 4096])
def test_workspace_spectra_follow_the_path(n_fft, q, kind):
    frames, batch = (64, 1) if kind == "segment" else (40, 3)
    work = fused._workspace(frames, n_fft, q, "cpu", batch=batch, segment=kind == "segment")
    if fused.closed_in_synth(n_fft, q):
        # frame 0 of each row, for the anchor; the kernel analyses the rest
        assert work["spec"].shape == (batch, n_fft + 2)
        assert work["y"] is None
        if kind == "segment":  # its carry holds the anchor
            assert work["anchor"] is None
        else:
            assert work["anchor"].shape == (batch, 2, n_fft // 2 - 1)
    else:
        assert work["spec"].shape == (batch * frames, n_fft + 2)
        assert work["y"].shape == work["spec"].shape
        assert work["anchor"] is None


# -------------------------------------------------- the counter, stubbed


class _Lib:
    @staticmethod
    def pvoc_cuda_error_string(rc):
        return b"an error"


@pytest.fixture
def stub(monkeypatch):
    """_build.launch with no card: a library whose TSM entries return 0,
    no device guard, a stream handle, and check_cuda passing the meta
    tensors that stand in for the card's. An empty registry."""
    monkeypatch.setattr(profiling, "_counters", {})
    for entry in ("pvoc_fused", "pvoc_fused_zrev", "pvoc_fused_batch", "pvoc_fused_segment"):
        monkeypatch.setattr(_Lib, entry, staticmethod(lambda *args: 0), raising=False)
    monkeypatch.setattr(_build, "kernels", lambda: _Lib)
    monkeypatch.setattr(_build, "_device_guard", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(_build, "_current_stream", lambda index: 0x5000)
    monkeypatch.setattr(_build, "check_cuda", lambda what, *tensors, dtype=None: None)


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _segment(n_fft: int, hop: int, rs: int, n_valid: int):
    m = -(-n_fft // rs)
    carry, tail = _meta(4, n_fft // 2 - 1), _meta(m - 1, rs)
    x = _meta(n_fft + 1000 * hop)
    nf = 64 + n_valid  # the segment at frame 64 holds n_valid of them
    fused.fused_stream_segment(x, carry, tail, True, 64, nf, n_fft, hop, rs, 128)


# (wrapper, call(n_fft, hop, rs), frames it sends through synth_real's
# analysis at integer k)
_CALLS = {
    "fused_time_stretch": (lambda n, h, r: fused.fused_time_stretch(_meta(n + 99 * h + 7), n, h, r),
                           100),
    "fused_time_stretch_zrev": (
        lambda n, h, r: fused.fused_time_stretch(_meta(n + 99 * h), n, h, r, zrev=True), 100),
    "fused_time_stretch_batch": (
        lambda n, h, r: fused.fused_time_stretch_batch(_meta(3, n + 49 * h), n, h, r, [50, 0, 9]), 59),
    "fused_stream_segment": (lambda n, h, r: _segment(n, h, r, 37), 37),
}


@pytest.mark.parametrize("wrapper", sorted(_CALLS))
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_each_wrapper_counts_its_frames_in_synth(stub, wrapper, n_fft):
    call, frames = _CALLS[wrapper]
    hop = n_fft // 4
    call(n_fft, hop, n_fft // 2)  # 2.0x: k = 2
    assert profiling.counters() == {f"launches.{wrapper}": 1, f"frames_in_synth.{wrapper}": frames}


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_the_general_closed_route_counts_its_frames(stub, n_fft):
    hop = n_fft // 4
    x = _meta(n_fft + 199 * hop)
    fused.phasor_general_closed(x, n_fft, hop, 3 * hop)  # 3.0x: Rs > N/2, k = 3
    assert profiling.counters() == {"launches.phasor_general_closed": 1,
                                    "frames_in_synth.phasor_general_closed": 200}


@pytest.mark.parametrize("wrapper", sorted(_CALLS))
@pytest.mark.parametrize("n_fft,rs", [(1024, 171), (256, 43), (768, 384), (128, 64)])
def test_no_frame_counts_off_the_path(stub, wrapper, n_fft, rs):
    """q >= 2 (Rs = 171 at N = 1024, 43 at 256), or N outside real_body at
    integer k (768, 128): analysis_real or its kin analyses every frame,
    and nothing counts frames_in_synth."""
    call, _ = _CALLS[wrapper]
    call(n_fft, n_fft // 4, rs)
    assert not fused.closed_in_synth(n_fft, fused._rational_k(rs, n_fft // 4)[1])
    assert profiling.counters() == {f"launches.{wrapper}": 1}


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU form")
    return torch.device("cuda")


def _signal(seconds: float, seed: int = 0) -> np.ndarray:
    """chip_smoke.py's test signal (chirp, tone and noise), float32, made
    on the CPU."""
    return utterance(seconds, seed, SR).astype(np.float32)


def _rel(a: torch.Tensor, b: torch.Tensor, edge: int) -> float:
    """chip_smoke.py's measure: the interior's max |a - b| / max |b|."""
    assert a.shape == b.shape
    a, b = a.double().cpu()[edge:-edge], b.double().cpu()[edge:-edge]
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_kernel_matches_the_plain_version(card, n_fft, k):
    hop = n_fft // 4
    x = torch.as_tensor(_signal(60.0))
    if k == 2:
        got = fused.fused_time_stretch(x.to(card), n_fft, hop, k * hop)
        want = fused.fused_time_stretch_reference(x, n_fft, hop, k * hop)
    else:  # Rs > N/2: the general route's integer-k entry
        got = fused.phasor_general_closed(x.to(card), n_fft, hop, k * hop)
        want = fused.phasor_general_closed_reference(x, n_fft, hop, k * hop)
    assert _rel(got, want, n_fft) < (1e-5 if k == 2 else 2e-5)


@pytest.mark.card
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_a_recording_shorter_than_a_group(card, n_fft):
    """1, 2 and F - 1 frames, where a recording has little interior: held
    as tests/test_torch_general_synth.py holds the synthesis, on the
    samples whose window energy is at least 1e-2, at 1e-5 of the largest
    of them, and silent where no frame reaches."""
    hop, rs = n_fft // 4, n_fft // 2
    w = hann_window(n_fft, "cpu", torch.float64)
    for nf in sorted({1, 2, GROUP[n_fft] - 1}):
        x = torch.as_tensor(_signal(4.0, seed=nf)[: n_fft + (nf - 1) * hop])
        got = fused.fused_time_stretch(x.to(card), n_fft, hop, rs).cpu().double()
        want = fused.fused_time_stretch_reference(x, n_fft, hop, rs).double()
        energy = framing.ola_window_norm(w, nf, rs, eps=0.0, method="fold")
        held = energy >= 1e-2
        assert got.shape == want.shape == energy.shape and bool(torch.isfinite(got).all())
        assert float((got - want)[held].abs().max() / want[held].abs().max()) < 1e-5, nf
        assert not got[energy == 0].any()


@pytest.mark.card
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_ragged_rows_are_each_their_own_single_call(card, n_fft):
    hop, rs, f = n_fft // 4, n_fft // 2, GROUP[n_fft]
    counts = [0, 1, f - 1, f + 1, 3 * f + 2, 1200]
    t = n_fft + (max(counts) - 1) * hop
    sig = torch.as_tensor(_signal(t / SR + 3, seed=n_fft))
    rows = [sig[i * 7 * hop : i * 7 * hop + t] for i in range(len(counts))]
    xs = torch.stack(rows).to(card)
    out = fused.fused_time_stretch_batch(xs, n_fft, hop, rs, counts)
    for b, nf in enumerate(counts):
        if nf == 0:
            assert not out[b].any()
            continue
        single = fused.fused_time_stretch(xs[b, : n_fft + (nf - 1) * hop].contiguous(), n_fft, hop, rs)
        assert torch.equal(out[b, : single.shape[0]], single), (b, nf)
        assert not out[b, single.shape[0]:].any()


@pytest.mark.card
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_a_stream_ending_inside_a_group_is_the_monolithic_call(card, n_fft):
    hop, rs = n_fft // 4, n_fft // 2
    # 64-frame segments; the last holds nf % 64 frames, fewer than a group
    # at N = 256 (32) and 1024 (8), an odd count at 4096 (2 a group), and
    # x ends at its last frame, so a span past them would read past x.
    nf = 64 * 9 + (5 if n_fft < 4096 else 3)
    x = torch.as_tensor(_signal(200.0, seed=7)[: n_fft + (nf - 1) * hop]).to(card)
    stream = streaming.fused_stream_time_stretch(x, 2.0, PvocConfig(n_fft=n_fft, hop=hop),
                                                 segment_frames=64)
    assert torch.equal(stream, fused.fused_time_stretch(x, n_fft, hop, rs))


@pytest.mark.card
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_zrev_is_pvoc_fused_bit_for_bit(card, n_fft):
    hop = n_fft // 4
    x = torch.as_tensor(_signal(30.0, seed=3)).to(card)
    assert torch.equal(fused.fused_time_stretch(x, n_fft, hop, 2 * hop, zrev=True),
                       fused.fused_time_stretch(x, n_fft, hop, 2 * hop))
