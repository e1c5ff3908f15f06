"""The port's bench (phase_vocoder_tpu_torch.bench) on the CPU: every mode
at 2 s of audio through the kernels' plain versions, the red golden gate
that refuses to time, the H100 rooflines of utils/metrics.py, and the CLI's
bench subcommand against the JAX package's."""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from golden import pv_ref
from phase_vocoder_tpu_torch import bench, pipeline
from phase_vocoder_tpu_torch.utils import metrics, profiling

# Keys every timed line carries (bench.py's and the port's additions).
KEYS = {"metric", "value", "unit", "vs_baseline", "roofline_audio_s_per_s", "allclose_rel_err",
        "allclose_pass", "path", "iters", "device", "ms_median", "ms_min", "device_busy_ms",
        "device_idle_share", "kernels_per_call", "peak_device_gb", "numpy_input_ms", "card",
        "power_limit_w"}

CPU = ["--device", "cpu", "--iters", "2"]
REPO = pathlib.Path(__file__).resolve().parent.parent


def _line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def _check_line(rec: dict, path: str, limit: float) -> None:
    assert KEYS <= set(rec), KEYS - set(rec)
    assert rec["device"] == "cpu" and rec["card"] is None and rec["path"] == path
    assert rec["allclose_pass"] is True and rec["allclose_rel_err"] < limit
    assert rec["value"] > 0 and rec["ms_min"] <= rec["ms_median"]
    assert rec["value"] == pytest.approx(rec["audio_seconds"] / (rec["ms_median"] / 1e3))
    # A share of the binding roofline: never above 1 (a CPU reads far below).
    assert 0 < rec["vs_baseline"] < 1
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / rec["roofline_audio_s_per_s"])
    assert rec["numpy_input_ms"] > 0
    # No device numbers from a CPU run.
    assert rec["device_busy_ms"] is None and rec["device_idle_share"] is None
    assert rec["kernels_per_call"] is None and rec["peak_device_gb"] is None


@pytest.mark.parametrize("argv, path", [
    ([], "fused"),
    (["--ratio", "3.0"], "general"),
    (["--ratio", "0.5", "--fft-backend", "matmul"], "polar"),
])
def test_stretch_modes(capsys, argv, path):
    assert bench.main(CPU + ["--seconds", "2"] + argv) == 0
    rec = _line(capsys)
    _check_line(rec, path, 1e-4)
    assert rec["gate_seconds"] == 2


def test_faithful_route_is_gated_and_timed(capsys, monkeypatch):
    """Past BRANCH_FAITHFUL_FRAMES a q >= 2 stretch takes the faithful polar
    stream; the gate runs that route on the slice, not the fused kernel."""
    monkeypatch.setattr(pipeline, "BRANCH_FAITHFUL_FRAMES", 10)
    seen = []
    stretch = pipeline._stretch
    monkeypatch.setattr(pipeline, "_stretch", lambda route, *a: seen.append(route) or stretch(route, *a))
    assert bench.main(CPU + ["--seconds", "2", "--ratio", "0.5"]) == 0
    rec = _line(capsys)
    _check_line(rec, "stream", 1e-4)
    assert seen[0] == "stream"


def test_stream_mode_with_checkpoint(capsys):
    assert bench.main(CPU + ["--seconds", "2", "--stream", "--stream-checkpoint"]) == 0
    rec = _line(capsys)
    _check_line(rec, "fused-stream", 1e-4)
    assert rec["bitwise_equals_monolithic_60s"] is True and rec["segment_frames"] == 8192
    assert rec["checkpointed_wall_s"] > 0


def test_pitch_mode_one_shift(capsys):
    assert bench.main(CPU + ["--seconds", "2", "--pitch", "--semitones", "-7"]) == 0
    rec = _line(capsys)
    _check_line(rec, "fused", 1e-3)
    part = rec["semitones"]["-7st"]
    assert part["rs"] == 171 and part["allclose_pass"] is True
    assert 0 <= part["resample_share"] < 1 and part["stretch_only_ms_median"] > 0
    # One shift: its line is the whole record.
    assert rec["value"] == pytest.approx(part["value"]) and rec["vs_baseline"] == pytest.approx(part["vs_baseline"])


def test_pitch_gate_forces_the_faithful_route_where_the_length_reroutes(capsys, monkeypatch):
    monkeypatch.setattr(pipeline, "BRANCH_FAITHFUL_FRAMES", 10)
    policies = []
    shift = pipeline.pitch_shift
    monkeypatch.setattr(pipeline, "pitch_shift",
                        lambda x, s, cfg, branch_policy="auto", device="cuda":
                        policies.append(branch_policy) or shift(x, s, cfg, branch_policy, device))
    assert bench.main(CPU + ["--seconds", "2", "--pitch", "--semitones", "-7", "12"]) == 0
    rec = _line(capsys)
    assert rec["allclose_pass"] is True
    assert rec["semitones"]["-7st"]["path"] == "stream" and rec["semitones"]["+12st"]["path"] == "fused"
    assert policies[:2] == ["faithful", "auto"]
    assert rec["path"] == "fused,stream"


def test_batch_mode(capsys):
    assert bench.main(CPU + ["--seconds", "2", "--batch", "--batch-size", "4"]) == 0
    rec = _line(capsys)
    _check_line(rec, "fused-batch", 1e-4)
    assert rec["batch"] == 4 and rec["audio_seconds"] == pytest.approx(8.0)
    assert rec["utterances_per_s"] == pytest.approx(4 / (rec["ms_median"] / 1e3))


def test_batch_varied_mode(capsys):
    assert bench.main(["--device", "cpu", "--iters", "1", "--batch-varied"]) == 0
    rec = _line(capsys)
    _check_line(rec, "fused-batch-varied", 1e-4)
    assert rec["utterances"] == 64 and rec["ratios"] == [0.5, 0.75, 1.0, 1.25, 1.5, 2.0]


def test_baseline_batch_is_chip_smokes():
    """64 utterances of 5-30 s, ratios in turn, lengths from seed 64."""
    xs, ratios = bench.baseline_batch()
    lengths = np.random.default_rng(64).uniform(5.0, 30.0, 64)
    assert [len(x) for x in xs] == [int(s * 16000) for s in lengths]
    assert ratios[:7] == [0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 0.5]
    assert all(np.max(np.abs(x)) == 1.0 for x in xs)


def test_scaling_mode_over_two_gloo_ranks(capsys):
    """--world 2 on the CPU: W = 1 in this process, then two ranks of the
    module over gloo, rank 0's row read back."""
    assert bench.main(["--device", "cpu", "--iters", "1", "--scaling", "--seconds-per-device", "1",
                       "--world", "2"]) == 0
    rec = _line(capsys)
    assert [r["world"] for r in rec["rows"]] == [1, 2] and rec["world"] == 2 and rec["cards"] == 2
    assert all(r["allclose_pass"] is True and r["allclose_rel_err"] < 1e-4 for r in rec["rows"])
    assert rec["rows"][1]["seconds"] == 2.0 and "scaling_note" not in rec
    assert rec["speedup"] == pytest.approx(2 * rec["efficiency"])
    # Two cards' roofline: the share of twice one card's.
    row = rec["rows"][1]
    assert row["vs_baseline"] == pytest.approx(row["value"] / (2 * row["roofline_audio_s_per_s"]))


def test_scaling_mode_on_one_process(capsys):
    assert bench.main(CPU + ["--scaling", "--seconds-per-device", "2"]) == 0
    rec = _line(capsys)
    _check_line(rec, "chunked-fused1", 1e-4)
    assert rec["world"] == 1 and rec["cards"] == 1 and len(rec["rows"]) == 1
    assert rec["efficiency"] == 1.0 and rec["speedup"] == 1.0
    assert "W = 1" in rec["scaling_note"]


@pytest.mark.parametrize("argv", [
    [],
    ["--stream"],
    ["--pitch", "--semitones", "-7"],
    ["--batch", "--batch-size", "2"],
    ["--scaling", "--seconds-per-device", "2"],
])
def test_red_gate_refuses_to_time(capsys, monkeypatch, argv):
    """A golden model that disagrees: the line says allclose_pass false and
    has no value, main returns 1, and no call is timed."""
    golden = pv_ref.phase_vocoder
    monkeypatch.setattr(pv_ref, "phase_vocoder", lambda *a, **k: golden(*a, **k) * 1.01)

    def timed(*a, **k):
        raise AssertionError("a red gate timed a call")

    monkeypatch.setattr(profiling, "time_calls", timed)
    monkeypatch.setattr(bench, "measure", timed)
    # The headline's timed entry (its signature kept: the bench reads its limits).
    monkeypatch.setattr(pipeline, "time_stretch", functools.wraps(pipeline.time_stretch)(timed))
    assert bench.main(CPU + ["--seconds", "2"] + argv) == 1
    rec = _line(capsys)
    assert rec["allclose_pass"] is False and "value" not in rec and "ms_median" not in rec
    assert rec["allclose_rel_err"] > 1e-3


def test_no_card_no_fallback(monkeypatch):
    """Without --device cpu the bench needs a card: with none it exits."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        bench.main(["--seconds", "2"])


@pytest.mark.parametrize("seconds, stretch, pitch, ms, by", [
    (3600.0, 2.0, False, 0.2063, "bytes"),        # row 1 at 2.0x
    (300.0, 171 / 256, False, 0.0143, "operations"),  # row 1 at Rs = 171
    (300.0, 2 ** (-7 / 12), True, 0.0191, "bytes"),   # pitch -7 st: rows 1 and 2
])
def test_rooflines(seconds, stretch, pitch, ms, by):
    roof = metrics.binding_roofline_audio_s(16000, 1024, 256, stretch, pitch=pitch)
    assert round(seconds / roof["audio_s_per_s"] * 1e3, 4) == ms
    assert roof["binding"] == by
    assert roof["hw_audio_s_per_s"] == roof["audio_s_per_s"] == min(roof["hbm_audio_s_per_s"],
                                                                      roof["fft_audio_s_per_s"])
    # The bench's roofline (roofline_report over parts) and the kernel
    # table's bound count the same work.
    timed = {"value": 1.0e6, "audio_seconds": seconds}
    rec = bench.roofline(timed, [(seconds, stretch)], pitch=pitch)
    assert round(rec["bound_ms"], 4) == ms and rec["roofline_binding"] == by
    assert rec["vs_baseline"] == pytest.approx(1.0e6 / roof["audio_s_per_s"])
    rep = profiling.roofline_report(16000, 1024, 256, stretch, 1.0e6, pitch=pitch)
    assert rep["roofline_audio_s_per_s"] == pytest.approx(roof["audio_s_per_s"])


def test_bound_ms_matches_the_kernel_table():
    """chip_smoke.py's bound of row 1 at 2.0x / 3600 s: the exact lengths'
    bytes and two transforms a frame."""
    n_in = 3600 * 16000
    nf = (n_in - 1024) // 256 + 1
    n_out = (nf - 1) * 512 + 1024
    b = metrics.bound_ms(4 * (n_in + n_out), 2 * nf * metrics.fft_flop(1024))
    assert round(b["bound_ms"], 4) == 0.2063 and b["bound_by"] == "bytes"
    assert metrics.fft_flop(1024) == 2.5 * 1024 * 10


@pytest.mark.parametrize("intervals, busy", [
    ([], 0),
    ([(0, 10), (10, 20), (30, 35)], 25),        # one stream: the summed time
    ([(5, 20), (0, 10), (6, 8), (30, 35)], 25),  # two streams overlapping: the union
    ([(0, 100), (10, 20)], 100),
])
def test_device_busy_is_the_union_of_kernel_intervals(intervals, busy):
    """profile_call's busy time: with NCCL's kernels beside the compute
    (a --scaling rank) the summed time exceeded the span."""
    assert profiling.union_length(intervals) == busy


def test_roofline_report_and_timer():
    rep = profiling.roofline_report(16000, 1024, 256, 2.0, 1.0e6)
    assert rep["fraction_of_roofline"] == pytest.approx(1.0e6 / rep["roofline_audio_s_per_s"])
    # Parts of one factor read as the factor alone. Mixed parts sum their
    # bytes' times and their operations' times apart: 2.0x is bound by
    # bytes and 0.5x by operations, and one second of each is bound by
    # the operations of both (3.2e6 FLOP an audio-second at 67 TFLOP/s).
    same = profiling.roofline_report(16000, 1024, 256, [(3.0, 2.0), (5.0, 2.0)], 1.0e6)
    assert same["roofline_audio_s_per_s"] == pytest.approx(rep["roofline_audio_s_per_s"])
    mixed = profiling.roofline_report(16000, 1024, 256, [(1.0, 2.0), (1.0, 0.5)], 1.0e6)
    assert mixed["roofline_binding"] == "operations"
    assert mixed["roofline_audio_s_per_s"] == pytest.approx(67e12 / 3.2e6)
    with metrics.Timer() as t:
        pass
    assert t.seconds >= 0


def _options(parser: argparse.ArgumentParser) -> set:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {s for a in sub.choices["bench"]._actions for s in a.option_strings} - {"-h", "--help"}


def test_cli_bench_takes_every_option_of_the_jax_cli():
    from phase_vocoder_tpu import cli as jax_cli
    from phase_vocoder_tpu_torch import cli

    jax_opts, port_opts = _options(jax_cli.build_parser()), _options(cli.build_parser())
    assert jax_opts and jax_opts <= port_opts, jax_opts - port_opts
    assert {"--stream", "--stream-checkpoint", "--semitones", "--batch-varied", "--device"} <= port_opts
    args = cli.build_parser().parse_args(
        ["bench", "--seconds", "60", "--ratio", "0.5", "--iters", "3", "--fft-backend", "matmul",
         "--no-check", "--pitch", "--batch", "--batch-size", "8", "--scaling", "--seconds-per-device", "30",
         "--stream", "--stream-checkpoint", "--semitones", "-7", "--batch-varied", "--device", "cpu"])
    assert args.fn.__name__ == "_run_bench" and args.semitones == [-7.0] and args.fft_backend == "matmul"


def test_cli_bench_runs(capsys):
    from phase_vocoder_tpu_torch import cli

    assert cli.main(["bench", "--device", "cpu", "--seconds", "2", "--iters", "1"]) == 0
    _check_line(_line(capsys), "fused", 1e-4)


@pytest.mark.parametrize("module", ["phase_vocoder_tpu_torch.bench", "phase_vocoder_tpu_torch.utils.metrics"])
def test_bench_imports_no_jax(module):
    """The bench runs on the card's machine, which has no JAX: importing
    it pulls in neither jax nor the JAX package (golden is imported only
    when a gate runs)."""
    code = (
        f"import sys, {module}; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'phase_vocoder_tpu', 'golden')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
