"""The port's fused streaming executor (streaming.fused_stream_time_stretch
and ops/fused.py fused_stream_segment) on the CPU, through the plain
versions of its kernels, against the port's own single-recording fused
TSM, the JAX package's fused stream (PvocConfig(fft_backend="pallas"), its
kernels in interpret mode) and the float64 golden model.

Bounds:
  * stream vs the single-recording plain TSM: torch.equal. The segment
    computes every float operation of the whole-recording run in the same
    order (the twin of tests/test_streaming.py's bitwise test);
  * stream vs JAX's fused stream <= 5e-5 interior rel: two f32 fused TSMs
    (torch.fft vs the JAX kernel's matrix DFT), each ~1e-5 from golden, as
    tests/test_torch_fused.py holds the single-recording twins;
  * vs golden < 1e-4, the repository's stretch gate;
  * a run resumed from the JAX package's state after k segments, converted
    by fused_stream_state_from_jax_tree, <= 5e-5 against the port's
    uninterrupted run: the carried phasors and tail come from JAX's f32
    arithmetic, the rest is the port's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import pv_ref
import phase_vocoder_tpu as jpv
from phase_vocoder_tpu import streaming as jstreaming
from phase_vocoder_tpu.ops.pallas import fused as jfused
from phase_vocoder_tpu.utils.checkpoint import _fused_state_to_tree
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import streaming
from phase_vocoder_tpu_torch.ops import fused
from phase_vocoder_tpu_torch.utils.checkpoint import fused_stream_state_from_jax_tree
from tests.conftest import make_test_signal

N, RA = 1024, 256
CFG = tpv.PvocConfig()
JAX_CFG = jpv.PvocConfig(fft_backend="pallas")


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x10():
    return torch.as_tensor(make_test_signal(10.0).astype(np.float32))


@pytest.fixture(scope="module")
def x4():
    return make_test_signal(4.0).astype(np.float32)


@pytest.mark.parametrize("rs", [128, 256, 512, 171])
def test_stream_bitwise_matches_monolithic(rs, x10):
    """Twin of tests/test_streaming.py test_fused_stream_bitwise_matches_monolithic:
    stretch 0.5 / 1.0 / 2.0 and the odd, angle-domain Rs = 171."""
    mono = fused.fused_time_stretch_reference(x10, N, RA, rs)
    strm = streaming.fused_stream_time_stretch(x10, rs / RA, CFG, segment_frames=256)
    assert torch.equal(strm, mono)


@pytest.mark.parametrize("segment_frames", [64, 8192])
def test_stream_bitwise_at_other_segment_sizes(segment_frames, x10):
    """The smallest segment (one scan chunk) and one larger than the
    recording."""
    mono = fused.fused_time_stretch_reference(x10, N, RA, 192)
    strm = streaming.fused_stream_time_stretch(x10, 0.75, CFG, segment_frames=segment_frames)
    assert torch.equal(strm, mono)


@pytest.mark.parametrize("seconds", [0.07, 0.1])
def test_stream_bitwise_shorter_than_the_overlap(seconds):
    """nf < m-1 at Rs = 171 (m = 6): a row is head and tail at once."""
    x = torch.as_tensor(make_test_signal(seconds).astype(np.float32))
    assert fused.num_frames(len(x), N, RA) < 5
    mono = fused.fused_time_stretch_reference(x, N, RA, 171)
    assert torch.equal(streaming.fused_stream_time_stretch(x, 171 / RA, CFG, segment_frames=64), mono)


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_stream_vs_jax_fused_stream(stretch, x4):
    y = streaming.fused_stream_time_stretch(x4, stretch, CFG, segment_frames=256, device="cpu")
    j = np.asarray(jstreaming.fused_stream_time_stretch(x4, stretch, JAX_CFG, segment_frames=256))
    assert rel_err(y.numpy(), j) <= 5e-5


def test_stream_vs_golden():
    """Twin of tests/test_streaming.py test_fused_stream_vs_golden."""
    x = make_test_signal(6.0)
    y = streaming.fused_stream_time_stretch(x, 2.0, CFG, segment_frames=256, device="cpu")
    ref = pv_ref.phase_vocoder(x, 2.0, N, RA)
    assert len(y) == len(ref)
    assert rel_err(y.numpy(), ref) < 1e-4


def test_stream_rejects_polar_geometry():
    """Twin of tests/test_streaming.py test_fused_stream_rejects_polar_geometry."""
    with pytest.raises(ValueError, match="fused"):
        streaming.fused_stream_time_stretch(
            np.zeros(16000, np.float32), 2.0, tpv.PvocConfig(fft_backend="matmul"), device="cpu"
        )
    with pytest.raises(ValueError, match="fused"):
        streaming.fused_stream_time_stretch(np.zeros(16000, np.float32), 2.5, CFG, device="cpu")


@pytest.mark.parametrize("rs", [512, 128])
def test_resume_from_any_state_is_bitwise(rs, x10):
    """_fused_scan_from started from the state after k segments continues
    bitwise where the one-call run goes (the checkpoint granularity)."""
    nf = fused.num_frames(len(x10), N, RA)
    F, S = streaming.fused_plan_segments(nf, N, rs, 128)
    s0 = streaming.fused_init_state(N, rs)
    whole, end = streaming._fused_scan_from(x10, s0, nf, N, RA, rs, F, S)
    head, mid = streaming._fused_scan_from(x10, s0, nf, N, RA, rs, F, 3)
    tail, end2 = streaming._fused_scan_from(x10, mid, nf, N, RA, rs, F, S - 3)
    assert mid.frame_offset == 3 * F and mid.started == 1
    assert torch.equal(torch.cat([head, tail]), whole)
    assert torch.equal(end.carry, end2.carry) and torch.equal(end.tail, end2.tail)


def test_plan_segments():
    """F: a multiple of the scan chunk, at least m-1; S*F covers the
    recording's frames and its OLA spill."""
    assert streaming.fused_plan_segments(1000, N, 512, 8192) == (8192, 1)
    assert streaming.fused_plan_segments(1000, N, 512, 300) == (256, 4)
    assert streaming.fused_plan_segments(1024, N, 512, 256) == (256, 5)
    F, S = streaming.fused_plan_segments(10, N, 4, 1)  # m - 1 = 255
    assert (F, S) == (256, 2)


def test_segment_rejects_misaligned_geometry(x10):
    st = streaming.fused_init_state(N, 512)
    with pytest.raises(ValueError, match="multiple"):
        fused.fused_stream_segment(x10, st.carry, st.tail, 0, 0, 100, N, RA, 512, 100)
    with pytest.raises(ValueError, match="offset"):
        fused.fused_stream_segment(x10, st.carry, st.tail, 1, 32, 100, N, RA, 512, 64)
    with pytest.raises(ValueError, match="fit"):
        fused.fused_stream_segment(x10, st.carry, st.tail, 0, 0, 100, N, RA, 256, 64)


@pytest.mark.parametrize("stretch", [2.0, 0.5])
def test_resume_from_jax_state(stretch, x10):
    """The JAX package's fused stream runs one 256-frame segment (its tile);
    its state, converted, starts the port's loop over the other two, which
    lands within 5e-5 of the port's own uninterrupted run (integer k
    carries u_0; q = 2 carries u_prev and P)."""
    rs = CFG.synthesis_hop(stretch)
    nf = fused.num_frames(len(x10), N, RA)
    tile = jfused._pick_tile(N, rs, nf)
    F, S = jstreaming.fused_plan_segments(nf, N, rs, 256, tile)
    k = 1
    assert S - k >= 2
    rows = jstreaming.fused_stream_rows(jnp.asarray(x10.numpy()), N, RA, F, S, tile)
    _, jstate = jstreaming._fused_scan_from(rows, jstreaming.fused_init_state(N, rs), nf, N, RA, rs, F, k)
    tree = {name: np.asarray(v) for name, v in _fused_state_to_tree(jstate).items()}
    state = fused_stream_state_from_jax_tree(tree, N, rs)
    assert state.frame_offset == k * F and state.started == 1
    assert state.carry.shape == (4, N // 2 - 1) and state.tail.shape == (-(-N // rs) - 1, rs)

    assert streaming.fused_plan_segments(nf, N, rs, F) == (F, S)
    whole, _ = streaming._fused_scan_from(x10, streaming.fused_init_state(N, rs), nf, N, RA, rs, F, S)
    resumed, _ = streaming._fused_scan_from(x10, state, nf, N, RA, rs, F, S - k)
    n_out = (nf - 1) * rs + N - k * F * rs
    a, b = resumed[:n_out].numpy(), whole[k * F * rs :][:n_out].numpy()
    assert rel_err(a, b, edge=64) <= 5e-5


def test_fused_stream_exported_at_top_level():
    assert tpv.fused_stream_time_stretch is streaming.fused_stream_time_stretch
