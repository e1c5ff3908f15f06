"""Checkpoint/resume of the port's streaming executors
(phase_vocoder_tpu_torch/utils/checkpoint.py) on the CPU: the twins of
tests/test_checkpoint.py, the JAX package's states continued by the port,
the CLI's --checkpoint-dir and the facade.

Bounds:
  * fused backend: the checkpointed runs (uninterrupted, resumed after an
    injected failure, rerun) equal the stream, and the fused stream the
    single-recording plain TSM, bit for bit (torch.equal): the loop is the
    same, only the state goes through a file;
  * "matmul" backend: atol 1e-6 on the interior (N samples skipped at
    each end), the JAX package's own bound (tests/test_checkpoint.py): a
    matrix product may take another blocking for another batch size (the
    CPU's sgemm here, cuBLAS on the card), and the last samples, divided
    by window energies near the 1e-8 clamp, magnify its last-bit changes
    to ~1e-3 of values ~5e2;
  * bfloat16 / int16 parts: a resumed run equals the uninterrupted run at
    the same part dtype bit for bit, and both stay within 1e-2 (bf16) /
    1e-4 (int16, where |y| < 1) of the float32 result, the JAX bounds;
  * a polar state saved by the JAX package and continued by the port:
    <= 1e-5 interior rel against the port's uninterrupted stream (the two
    polar streams agree to that bound, tests/test_torch_streaming.py).
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import phase_vocoder_tpu as jpv
from phase_vocoder_tpu import streaming as jstreaming
from phase_vocoder_tpu.utils.checkpoint import _state_to_tree as jax_state_to_tree
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch import cli, streaming
from phase_vocoder_tpu_torch.ops import framing
from phase_vocoder_tpu_torch.ops.fused import fused_time_stretch_reference
from phase_vocoder_tpu_torch.utils import checkpoint as ck
from phase_vocoder_tpu_torch.utils.checkpoint import (
    StreamCheckpointer,
    checkpointed_fused_stream_time_stretch,
    checkpointed_stream_time_stretch,
)
from tests.conftest import make_test_signal

N, RA = 1024, 256
CFG = tpv.PvocConfig()


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x8s():
    return make_test_signal(8.0).astype(np.float32)


def _polar(x, cfg, d, **kw):
    return checkpointed_stream_time_stretch(
        x, 2.0, cfg, checkpoint_dir=str(d), segment_frames=64, batch_segments=3,
        device="cpu", **kw,
    )


def _same(a, b, backend):
    if backend == "fused":
        assert torch.equal(a, b)
    else:
        assert a.shape == b.shape
        np.testing.assert_allclose(a[N:-N].numpy(), b[N:-N].numpy(), atol=1e-6)


@pytest.mark.parametrize("backend", ["fused", "matmul"])
def test_uninterrupted_matches_stream(tmp_path, x8s, backend):
    cfg = tpv.PvocConfig(fft_backend=backend)
    y_ck = _polar(x8s, cfg, tmp_path / "ck")
    y = streaming.stream_time_stretch(x8s, 2.0, cfg, segment_frames=64, device="cpu")
    _same(y_ck, y, backend)


@pytest.mark.parametrize("backend", ["fused", "matmul"])
def test_resume_after_injected_failure(tmp_path, x8s, backend):
    cfg = tpv.PvocConfig(fft_backend=backend)
    ckdir = tmp_path / "ck"
    with pytest.raises(RuntimeError, match="injected failure"):
        _polar(x8s, cfg, ckdir, _fail_after_batches=2)
    done = StreamCheckpointer(str(ckdir)).completed_batches()
    assert done == [1], done  # pruned to the newest committed state
    y_ck = _polar(x8s, cfg, ckdir)
    y = streaming.stream_time_stretch(x8s, 2.0, cfg, segment_frames=64, device="cpu")
    _same(y_ck, y, backend)


def test_completed_run_is_idempotent(tmp_path, x8s):
    y1 = _polar(x8s, CFG, tmp_path / "ck")
    y2 = _polar(x8s, CFG, tmp_path / "ck")
    assert torch.equal(y1, y2)


def test_mismatched_run_rejected(tmp_path, x8s):
    _polar(x8s, CFG, tmp_path / "ck")
    with pytest.raises(ValueError, match="different run"):
        checkpointed_stream_time_stretch(
            x8s, 0.5, CFG, checkpoint_dir=str(tmp_path / "ck"), segment_frames=64,
            batch_segments=3, device="cpu",
        )


def test_fused_checkpoint_resume_bitwise(tmp_path, x8s):
    """Injected failure mid-run, resume completes; the result equals the
    uninterrupted fused stream and the single-recording plain TSM bit for
    bit."""
    ckdir = str(tmp_path / "ck_fused")
    ref = streaming.fused_stream_time_stretch(x8s, 2.0, CFG, segment_frames=256, device="cpu")
    assert torch.equal(ref, fused_time_stretch_reference(torch.as_tensor(x8s), N, RA, 512))
    kw = dict(checkpoint_dir=ckdir, segment_frames=256, batch_segments=1, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        checkpointed_fused_stream_time_stretch(x8s, 2.0, CFG, _fail_after_batches=1, **kw)
    assert StreamCheckpointer(ckdir).completed_batches() == [0]
    assert torch.equal(checkpointed_fused_stream_time_stretch(x8s, 2.0, CFG, **kw), ref)


@pytest.mark.parametrize("stretch", [0.5, 171 / 256])
def test_fused_checkpoint_q2_resume_bitwise(tmp_path, x8s, stretch):
    """q >= 2 (the P carry crosses the file) at two batches of segments."""
    kw = dict(checkpoint_dir=str(tmp_path / "ck"), segment_frames=64, batch_segments=4, device="cpu")
    ref = streaming.fused_stream_time_stretch(x8s, stretch, CFG, segment_frames=64, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        checkpointed_fused_stream_time_stretch(x8s, stretch, CFG, _fail_after_batches=2, **kw)
    assert torch.equal(checkpointed_fused_stream_time_stretch(x8s, stretch, CFG, **kw), ref)


def test_fused_checkpoint_rejects_polar_geometry(tmp_path, x8s):
    with pytest.raises(ValueError, match="fused"):
        checkpointed_fused_stream_time_stretch(
            x8s, 2.5, CFG, checkpoint_dir=str(tmp_path / "ck"), device="cpu"
        )


def test_legacy_checkpoint_missing_pair_lo_restores():
    """A pre-pair-carry state tree (no psi_carry_lo) restores with lo = 0."""
    tree = {
        "phi_prev": np.zeros(513, np.float32),
        "psi_carry": np.ones(513, np.float32),
        "phi0": np.zeros(513, np.float32),
        "ola_tail": np.zeros(1024 - 512, np.float32),
        "norm_tail": np.zeros(1024 - 512, np.float32),
        "started": np.ones((), bool),
        "frame_offset": np.zeros((), np.int32),
    }
    state = ck._tree_to_state(tree)
    assert torch.equal(state.psi_carry_lo, torch.zeros(513))
    assert state.frame_offset.dtype == torch.int64 and bool(state.started)


@pytest.mark.parametrize("part_dtype", ["bfloat16", "int16"])
def test_compact_part_dtypes_resume_consistent(tmp_path, x8s, part_dtype):
    kw = dict(segment_frames=64, batch_segments=2, part_dtype=part_dtype, device="cpu")
    y_full = checkpointed_fused_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=str(tmp_path / "a"), **kw).numpy()
    with pytest.raises(RuntimeError, match="injected"):
        checkpointed_fused_stream_time_stretch(
            x8s, 2.0, CFG, checkpoint_dir=str(tmp_path / "b"), _fail_after_batches=1, **kw)
    y_res = checkpointed_fused_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=str(tmp_path / "b"), **kw).numpy()
    np.testing.assert_array_equal(y_full, y_res)
    y_f32 = checkpointed_fused_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=str(tmp_path / "c"), segment_frames=64,
        batch_segments=2, device="cpu").numpy()
    tol = 1e-2 if part_dtype == "bfloat16" else 1e-4
    sl = slice(1024, len(y_full) - 1024)
    a, b = y_full[sl], y_f32[sl]
    if part_dtype == "int16":  # PCM16 clips legitimate overshoot past +-1
        keep = np.abs(b) < 1.0
        a, b = a[keep], b[keep]
    assert np.max(np.abs(a - b)) < tol


def test_part_encodings_round_trip():
    """bfloat16 parts travel as their uint16 bits and decode to torch's own
    bfloat16 -> float32 values; int16 rounds and clips at +-1."""
    v = torch.tensor([0.1, -0.5, 1.5, 3.0e-3, -2.0])
    bits = ck._part_to_numpy(ck._encode_part_device(v, "bfloat16"))
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(ck._decode_part(bits), v.to(torch.bfloat16).float().numpy())
    pcm = ck._part_to_numpy(ck._encode_part_device(v, "int16"))
    assert pcm.tolist() == [3277, -16384, 32767, 98, -32768]
    np.testing.assert_array_equal(ck._decode_part(pcm), pcm.astype(np.float32) / 32767.0)
    with pytest.raises(ValueError, match="part_dtype"):
        ck._encode_part_device(v, "float16")


def test_state_file_is_the_commit_point(tmp_path, x8s):
    """Each batch leaves a part and an .npz state; only the newest state
    stays, no temporary file survives, and the state holds the host ints."""
    d = tmp_path / "ck"
    checkpointed_fused_stream_time_stretch(
        x8s, 0.5, CFG, checkpoint_dir=str(d), segment_frames=128, batch_segments=2, device="cpu")
    names = sorted(os.listdir(d))
    assert not [n for n in names if "tmp" in n], names
    states = [n for n in names if n.startswith("state_")]
    parts = [n for n in names if n.startswith("part_")]
    assert len(states) == 1 and states[0] == f"state_{len(parts) - 1:06d}.npz"
    batch, tree = StreamCheckpointer(str(d)).latest_tree()
    assert batch == len(parts) - 1 and set(tree) == {"carry", "tail", "started", "frame_offset"}
    assert int(tree["started"]) == 1 and int(tree["frame_offset"]) % 128 == 0


def test_polar_state_from_jax_continues(x8s):
    """The JAX package's polar stream (its kernels in interpret mode) runs
    three segments; the port continues from its state."""
    jcfg = jpv.PvocConfig(fft_backend="pallas")
    rs, F = 128, 64
    nf = framing.num_frames(len(x8s), N, RA)
    S = streaming.plan_segments(nf, CFG, rs, F)[1]
    jpad = jstreaming.pad_for_segments(x8s, jcfg, F, S)
    _, jstate = jstreaming._stream_scan_from(jpad, jstreaming.init_state(jcfg, rs), nf, jcfg, rs, F, 3)
    tree = {k: np.asarray(v) for k, v in jax_state_to_tree(jstate).items()}
    state = ck.stream_state_from_jax_tree(tree)
    assert int(state.frame_offset) == 3 * F and bool(state.started)
    x_pad = streaming.pad_for_segments(torch.as_tensor(x8s), CFG, F, S)
    s0 = streaming.init_state(CFG, rs)
    whole, _ = streaming._stream_scan_from(x_pad, s0, nf, CFG, rs, F, S)
    rest, _ = streaming._stream_scan_from(x_pad, state, nf, CFG, rs, F, S - 3)
    assert rel_err(rest.numpy(), whole[3 * F * rs :].numpy(), edge=64) <= 1e-5


def test_cli_checkpointed_fused_matches_plain(tmp_path):
    """Twin of tests/test_cli.py test_cli_stretch_checkpointed_fused: with
    --checkpoint-dir the fused backend rides the fused segment executor and
    writes the plain fused result bit for bit; a trace is written too."""
    wav = tmp_path / "in8.wav"
    x = make_test_signal(8.0).astype(np.float32)
    wavfile.write(wav, 16000, x)
    out = tmp_path / "out.wav"
    assert cli.main([
        "stretch", str(wav), str(out), "--ratio", "2.0", "--checkpoint-dir",
        str(tmp_path / "ck"), "--segment-frames", "256", "--batch-segments", "2",
        "--float32", "--device", "cpu", "--trace-dir", str(tmp_path / "trace"),
    ]) == 0
    _, y = wavfile.read(out)
    ref = tpv.time_stretch(x, 2.0, CFG, device="cpu").numpy()
    np.testing.assert_array_equal(y, ref)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert StreamCheckpointer(str(tmp_path / "ck")).read_manifest()["kind"] == "fused"


def test_cli_checkpointed_polar_geometry(tmp_path):
    """Rs > N/2 is outside the fused kernel: --checkpoint-dir takes the
    polar checkpointed executor (default segment size)."""
    wav = tmp_path / "in.wav"
    x = make_test_signal(2.0).astype(np.float32)
    wavfile.write(wav, 16000, x)
    out = tmp_path / "out.wav"
    assert cli.main([
        "stretch", str(wav), str(out), "--ratio", "2.5", "--checkpoint-dir",
        str(tmp_path / "ck"), "--float32", "--device", "cpu",
    ]) == 0
    _, y = wavfile.read(out)
    ref = streaming.stream_time_stretch(x, 2.5, CFG, device="cpu").numpy()
    np.testing.assert_array_equal(y, ref)
    assert "kind" not in StreamCheckpointer(str(tmp_path / "ck")).read_manifest()


def test_facade_checkpointed_time_stretch(tmp_path, x8s):
    pv = tpv.PhaseVocoder(device="cpu")
    a = pv.checkpointed_time_stretch(x8s, 2.0, str(tmp_path / "a"), segment_frames=64)
    b = checkpointed_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=str(tmp_path / "b"), segment_frames=64, device="cpu")
    assert torch.equal(a, b)
