"""Throughput bench of the PyTorch/CUDA port (counterpart of bench.py).

    python -m phase_vocoder_tpu_torch.bench                        # 2.0x on 3600 s
    python -m phase_vocoder_tpu_torch.bench --ratio 0.5 --seconds 660
    python -m phase_vocoder_tpu_torch.bench --stream [--stream-checkpoint]
    python -m phase_vocoder_tpu_torch.bench --pitch [--semitones -7 --seconds 300]
    python -m phase_vocoder_tpu_torch.bench --batch [--batch-size 64]
    python -m phase_vocoder_tpu_torch.bench --batch-varied
    python -m phase_vocoder_tpu_torch.bench --scaling [--seconds-per-device 120]
    pvoc-torch bench ...                                           # the same options

Each mode times the package's public entry points as a user calls them,
on a signal already on the card, and prints one JSON line: `value`
(audio-s/s of the median call), `ms_median` and `ms_min` over `--iters`
calls between CUDA events after a warm-up (the warm-up builds the kernels
and fills the cached device tables, so the timed calls exclude both),
`vs_baseline` (the share of the binding H100 roofline of
utils/metrics.py: the bytes any implementation must move at 3.35 TB/s or
the transforms' FP32 operations at 67 TFLOP/s, whichever takes longer;
never above 1), `device_busy_ms`, `device_idle_share` and
`kernels_per_call` from one more call traced by torch.profiler (the timed
calls are not traced), `peak_device_gb`, `numpy_input_ms` (the same call
given a numpy array, as the CLI gives it, host-to-device copy included,
kept apart from `value`), the route the call took (`path`), and the card's
name and power limit from nvidia-smi.

The golden gate comes first: the timed route on max(1, min(seconds, 60))
seconds against the float64 model golden/pv_ref.py, interior max-rel
below 1e-4 for stretches and 1e-3 for pitch shifts. A red gate prints its
record with allclose_pass false and no value and exits 1; nothing is
timed.

Modes (bench.py's, through the port's entry points):
  default        pipeline.time_stretch, branch_policy "auto"; `path` is
                 the route pipeline._route takes for the timed length
                 ("fused", "general", "stream": the branch-faithful polar
                 stream, past 37,500 frames at q >= 2, "polar");
  --stream       streaming.fused_stream_time_stretch, 8192 frames a
                 segment, gated also bitwise against the monolithic call;
                 --stream-checkpoint adds a checkpointed run into a
                 temporary directory (checkpointed_wall_s);
  --pitch        pipeline.pitch_shift at each of --semitones (default
                 +-12, +-7, +-5), each beside its stretch alone;
  --batch        parallel.batch_time_stretch, --batch-size rows of
                 --seconds (default 120) at --ratio;
  --batch-varied parallel.batch_time_stretch_varied on BASELINE config 4:
                 64 utterances of 5-30 s at ratios 0.5-2.0;
  --scaling      parallel.chunked_time_stretch(force=True) on
                 --seconds-per-device x W seconds over W = 1, 2, 4, ...
                 cards, one process a card (NCCL); efficiency t1 / tW and
                 speed-up W t1 / tW.

Runs on "cuda" unless given --device cpu (the kernels' plain torch
versions, timed by time.perf_counter; the tests use it). No fallback: with
no card and no --device cpu it exits non-zero.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import pipeline, streaming
from .config import PvocConfig
from .ops import framing
from .parallel import batch as batch_mod
from .parallel import chunked, distributed
from .utils import checkpoint, profiling
from .utils.metrics import Timer

STRETCH_LIMIT = 1e-4
PITCH_LIMIT = 1e-3
GATE_SECONDS = 60.0
SR = 16000
N_FFT = 1024  # the cells of PERF.md section 4 all run N = 1024, Ra = 256
HOP = 256
# Calls longer than this are not traced: on an H100 the faithful route on
# 3600 s (~2.7 s a call; 5.5 times the 39,172 kernels of its 660 s call)
# left the profiler's trace with no device kernel after minutes of
# processing.
PROFILE_MAX_MS = 1000.0
RANK_TIMEOUT_S = 1200.0  # a W-rank --scaling row, its processes' start included
SEMITONES = (-12.0, -7.0, -5.0, 5.0, 7.0, 12.0)
MODE_SECONDS = {"stretch": 3600.0, "stream": 3600.0, "pitch": 3600.0, "batch": 120.0}

_NOTE = ("timed calls exclude the kernel build and the cached device tables (the warm-up "
         "fills both); numpy_input_ms is the same call given a numpy array and is not in value")


# ------------------------------------------------------------------ inputs


def _signal(seconds: float, device, seed: int = 0) -> torch.Tensor:
    """bench.py's signal, made on `device`: a 440 Hz tone, a chirp
    (200 t + 40 t^2 cycles) and white noise from `seed`, float32."""
    n = int(seconds * SR)
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n, dtype=torch.float64, device=device) / SR
    x = (0.5 * torch.sin(2 * np.pi * 440.0 * t)
         + 0.3 * torch.sin(2 * np.pi * (200.0 * t + 40.0 * t * t))
         + 0.05 * torch.randn(n, generator=g, dtype=torch.float64, device=device))
    return x.float()


def utterance(seconds: float, seed: int = 0, sr: int = SR) -> np.ndarray:
    """tests/conftest.py's signal, float64 in [-1, 1]: a tone, a chirp
    (200 t + 400 t^2 cycles) and noise from `seed`, peak 1. The utterances
    of baseline_batch and chip_smoke.py's inputs."""
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * np.sin(2 * np.pi * (200.0 * t + 400.0 * t * t))
         + 0.05 * g.standard_normal(len(t)))
    return x / np.max(np.abs(x))


def baseline_batch(sr: int = SR) -> tuple[list, list]:
    """BASELINE config 4, the batch of --batch-varied and chip_smoke.py:
    64 utterances of 5-30 s (lengths from seed 64, signal seeds 200 + i)
    and the ratios 0.5, 0.75, 1.0, 1.25, 1.5, 2.0 in turn. Returns
    (float64 arrays, ratios)."""
    rng = np.random.default_rng(64)
    ratios = [(0.5, 0.75, 1.0, 1.25, 1.5, 2.0)[i % 6] for i in range(64)]
    xs = [utterance(float(s), 200 + i, sr) for i, s in enumerate(rng.uniform(5.0, 30.0, 64))]
    return xs, ratios


# ----------------------------------------------------------- measurement


def _pv_ref():
    """golden/pv_ref.py, the float64 oracle at the repository's root."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from golden import pv_ref

    return pv_ref


def _rel_err(ours, ref: np.ndarray, same_length: bool = True) -> float:
    """Interior max-rel error (skipping N_FFT samples at each edge); a
    stretch of the wrong length is infinitely wrong, a pitch shift is
    compared over the shorter of the two (their lengths round apart)."""
    ours = ours.double().cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours, np.float64)
    if same_length and len(ours) != len(ref):
        return float("inf")
    m = min(len(ours), len(ref))
    sl = slice(N_FFT, m - N_FFT)
    return float(np.max(np.abs(ours[sl] - ref[sl])) / np.max(np.abs(ref[sl])))


def _gate_samples(seconds: float) -> int:
    return max(1, int(min(seconds, GATE_SECONDS))) * SR


def _gate(err: float, limit: float, seconds: int) -> dict:
    return {"allclose_rel_err": err, "allclose_pass": bool(err < limit),
            "allclose_limit": limit, "gate_seconds": seconds}


def _unchecked() -> dict:
    return {"allclose_rel_err": None, "allclose_pass": None}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(fn, device, iters: int, audio_seconds: float, fn_numpy=None, before=None) -> dict:
    """Time fn() as the bench reports it: `iters` calls after a warm-up,
    then a traced call (none past PROFILE_MAX_MS), the peak memory of
    one call and the numpy-input call (the host's time to the call's last
    kernel, median of up to 3 after a warm-up). On the CPU the device keys
    are None."""
    times = profiling.time_calls(fn, iters, device, before=before)
    med = statistics.median(times)
    rec = {"value": audio_seconds / (med / 1e3), "ms_median": med, "ms_min": min(times),
           "ms": times, "audio_seconds": audio_seconds, "device_busy_ms": None,
           "device_span_ms": None, "device_idle_share": None, "kernels_per_call": None,
           "peak_device_gb": None}
    if torch.device(device).type == "cuda":
        if med <= PROFILE_MAX_MS:
            prof = profiling.profile_call(fn)
            rec.update(device_busy_ms=prof["device_busy_ms"], device_span_ms=prof["device_span_ms"],
                       device_idle_share=prof["idle_share"], kernels_per_call=prof["kernels"])
        else:
            rec["device_profile"] = f"not measured: calls over {PROFILE_MAX_MS:g} ms are not traced"
        rec["peak_device_gb"] = profiling.peak_gb(fn)
    if fn_numpy is not None:
        rec["numpy_input_ms"] = statistics.median(
            profiling.time_calls(lambda: (fn_numpy(), _sync(device)), min(iters, 3), "cpu"))
    return rec


def roofline(timed: dict, parts, pitch: bool = False, cards: int = 1) -> dict:
    """The timed call against the binding roofline of `cards` H100s
    (utils/profiling.roofline_report) for work made of `parts`, (audio
    seconds, stretch factor) pairs: the rooflines, `vs_baseline` (the
    share of the binding one) and `bound_ms`, the least time of the
    cards."""
    rep = profiling.roofline_report(SR, N_FFT, HOP, parts, timed["value"] / cards, pitch)
    out = {k: v for k, v in rep.items() if k.startswith("roofline_")}
    out.update(vs_baseline=rep["fraction_of_roofline"],
               bound_ms=timed["audio_seconds"] / (cards * rep["roofline_audio_s_per_s"]) * 1e3)
    return out


def card(device) -> dict:
    """The card's name and power limit (W) as nvidia-smi reports them;
    None on the CPU, torch's name and no limit where nvidia-smi fails."""
    if torch.device(device).type != "cuda":
        return {"card": None, "power_limit_w": None}
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()
        idx = torch.cuda.current_device()
        name, limit = (s.strip() for s in lines[idx if idx < len(lines) else 0].rsplit(",", 1))
        return {"card": name, "power_limit_w": float(limit.split()[0])}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"card": torch.cuda.get_device_name(), "power_limit_w": None}


def _finish(rec: dict, timed: dict, parts) -> dict:
    rec.update(timed)
    rec.update(roofline(timed, parts))
    rec["baseline"] = ("binding H100 roofline, %s (HBM 3.35 TB/s, FP32 67 TFLOP/s)"
                       % rec["roofline_binding"])
    return rec


def _time_stretch_route(cfg: PvocConfig, rs: int, nf: int) -> str:
    """The route pipeline.time_stretch takes, with its own length limits."""
    params = inspect.signature(pipeline.time_stretch).parameters
    return pipeline._route(cfg, rs, nf, "auto", params["max_monolithic_frames"].default,
                           params["max_phasor_general_frames"].default)


# ----------------------------------------------------------------- modes


def run_bench(seconds: float = 3600.0, ratio: float = 2.0, iters: int = 5, backend: str = "fused",
              check: bool = True, device="cuda") -> dict:
    """pipeline.time_stretch as users call it (branch_policy "auto"); the
    gate runs the route the timed length takes, on the first 60 s."""
    cfg = PvocConfig(n_fft=N_FFT, hop=HOP, sample_rate=SR, fft_backend=backend)
    rs = cfg.synthesis_hop(ratio)
    x = _signal(seconds, device)
    route = _time_stretch_route(cfg, rs, framing.num_frames(len(x), N_FFT, HOP))
    rec = {"metric": f"audio_seconds_per_second_{ratio:g}x", "unit": "audio-s/s", "path": route,
           "ratio": ratio, "rs": rs, "seconds": seconds, "fft_backend": backend, "n_fft": N_FFT,
           "hop": HOP, "iters": iters, "device": torch.device(device).type, "note": _NOTE}
    if check:
        ng = _gate_samples(seconds)
        ref = _pv_ref().phase_vocoder(x[:ng].double().cpu().numpy(), ratio, N_FFT, HOP)
        rec.update(_gate(_rel_err(pipeline._stretch(route, x[:ng], ratio, cfg, rs), ref),
                         STRETCH_LIMIT, ng // SR))
        if not rec["allclose_pass"]:
            return rec
    else:
        rec.update(_unchecked())
    x_np = x.cpu().numpy()
    timed = measure(lambda: pipeline.time_stretch(x, ratio, cfg, device=device), device, iters,
                    len(x) / SR, fn_numpy=lambda: pipeline.time_stretch(x_np, ratio, cfg, device=device))
    return _finish(rec, timed, [(len(x) / SR, rs / HOP)])


def run_stream_bench(seconds: float = 3600.0, ratio: float = 2.0, iters: int = 5,
                     segment_frames: int = streaming.DEFAULT_FUSED_SEGMENT_FRAMES,
                     checkpoint_run: bool = False, check: bool = True, device="cuda") -> dict:
    """streaming.fused_stream_time_stretch; the gate holds a 2048-frame
    stream of the first 60 s bitwise to the monolithic fused call and to
    the golden model. checkpoint_run adds one checkpointed run (state saves
    and part writes every 8 segments, into a temporary directory), which
    must equal the stream bit for bit."""
    cfg = PvocConfig(n_fft=N_FFT, hop=HOP, sample_rate=SR)
    rs = cfg.synthesis_hop(ratio)
    x = _signal(seconds, device)
    rec = {"metric": "streaming_fused_audio_seconds_per_second", "unit": "audio-s/s",
           "path": "fused-stream", "ratio": ratio, "rs": rs, "seconds": seconds,
           "segment_frames": segment_frames, "n_fft": N_FFT, "hop": HOP, "iters": iters,
           "device": torch.device(device).type, "note": _NOTE}
    if check:
        ng = _gate_samples(seconds)
        mono = pipeline._stretch("fused", x[:ng], ratio, cfg, rs)
        strm = streaming.fused_stream_time_stretch(x[:ng], ratio, cfg, segment_frames=2048)
        ref = _pv_ref().phase_vocoder(x[:ng].double().cpu().numpy(), ratio, N_FFT, HOP)
        rec.update(_gate(_rel_err(strm, ref), STRETCH_LIMIT, ng // SR))
        rec["bitwise_equals_monolithic_60s"] = bool(torch.equal(mono, strm))
        rec["allclose_pass"] = rec["allclose_pass"] and rec["bitwise_equals_monolithic_60s"]
        if not rec["allclose_pass"]:
            return rec
    else:
        rec.update(_unchecked())
    x_np = x.cpu().numpy()

    def run(a):
        return streaming.fused_stream_time_stretch(a, ratio, cfg, segment_frames=segment_frames,
                                                   device=device)

    timed = measure(lambda: run(x), device, iters, len(x) / SR, fn_numpy=lambda: run(x_np))
    _finish(rec, timed, [(len(x) / SR, rs / HOP)])
    if checkpoint_run:
        ckdir = tempfile.mkdtemp(prefix="pvoc_bench_ck_")
        try:
            _sync(device)
            with Timer() as wall:
                out = checkpoint.checkpointed_fused_stream_time_stretch(
                    x_np, ratio, cfg, checkpoint_dir=ckdir, segment_frames=segment_frames,
                    batch_segments=8, device=device).cpu()
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        if not torch.equal(out, run(x).cpu()):
            raise RuntimeError("the checkpointed stream differs from the stream")
        rec.update(checkpointed_wall_s=wall.seconds, checkpointed_audio_s_per_s=len(x) / SR / wall.seconds,
                   checkpointed_note="one run from numpy input to a host tensor: state saves "
                                     "and part writes every 8 segments included")
    return rec


def _aggregate(rec: dict, parts: dict) -> dict:
    """Top-level keys of several timed shifts run one after another: sums
    of times, the worst gate, the binding roofline of all their work."""
    p = list(parts.values())

    def total(key):
        vals = [q[key] for q in p]
        return None if None in vals else sum(vals)

    busy, span = total("device_busy_ms"), total("device_span_ms")
    audio, med, bound = total("audio_seconds"), total("ms_median"), total("bound_ms")
    rec.update(value=audio / (med / 1e3), ms_median=med, ms_min=total("ms_min"), audio_seconds=audio,
               bound_ms=bound, roofline_audio_s_per_s=audio / (bound / 1e3), vs_baseline=bound / med,
               device_busy_ms=busy, device_span_ms=span,
               device_idle_share=None if busy is None else 1.0 - busy / span,
               kernels_per_call=total("kernels_per_call"),
               peak_device_gb=max((q["peak_device_gb"] for q in p if q["peak_device_gb"] is not None),
                                  default=None),
               numpy_input_ms=total("numpy_input_ms"))
    rec["roofline_binding"] = ",".join(sorted({q["roofline_binding"] for q in p}))
    rec["path"] = ",".join(sorted({q["path"] for q in p}))
    return rec


def run_pitch_bench(seconds: float = 3600.0, iters: int = 3, backend: str = "fused",
                    semitones=SEMITONES, check: bool = True, device="cuda") -> dict:
    """pipeline.pitch_shift at each shift (branch_policy "auto"), beside its
    stretch alone (the route's stretch without the resampler). Every
    shift's gate runs before any is timed: where the timed length reroutes
    to the branch-faithful stream, the slice runs with branch_policy
    "faithful"."""
    cfg = PvocConfig(n_fft=N_FFT, hop=HOP, sample_rate=SR, fft_backend=backend)
    x = _signal(seconds, device)
    nf = framing.num_frames(len(x), N_FFT, HOP)
    rec = {"metric": "pitch_shift_audio_seconds_per_second", "unit": "audio-s/s", "seconds": seconds,
           "fft_backend": backend, "n_fft": N_FFT, "hop": HOP, "iters": iters,
           "device": torch.device(device).type, "note": _NOTE}
    parts = {}
    for s in semitones:
        factor = 2.0 ** (s / 12.0)
        rs = cfg.synthesis_hop(factor)
        parts[f"{s:+g}st"] = {"semitones": s, "rs": rs, "path": pipeline._route(cfg, rs, nf, "auto")}
    if check:
        ng = _gate_samples(seconds)
        xs64 = x[:ng].double().cpu().numpy()
        for part in parts.values():
            policy = "faithful" if part["path"] == "stream" else "auto"
            ours = pipeline.pitch_shift(x[:ng], part["semitones"], cfg, branch_policy=policy, device=device)
            ref = _pv_ref().pitch_shift(xs64, part["semitones"], N_FFT, HOP)
            part.update(_gate(_rel_err(ours, ref, same_length=False), PITCH_LIMIT, ng // SR))
        rec["allclose_rel_err"] = max(q["allclose_rel_err"] for q in parts.values())
        rec["allclose_pass"] = all(q["allclose_pass"] for q in parts.values())
        if not rec["allclose_pass"]:
            rec["semitones"] = parts
            return rec
    else:
        rec.update(_unchecked())
    x_np = x.cpu().numpy()
    for part in parts.values():
        s, rs, route = part["semitones"], part["rs"], part["path"]
        factor = 2.0 ** (s / 12.0)
        part.update(measure(lambda: pipeline.pitch_shift(x, s, cfg, device=device), device, iters,
                            len(x) / SR,
                            fn_numpy=lambda: pipeline.pitch_shift(x_np, s, cfg, device=device)))
        alone = statistics.median(profiling.time_calls(
            lambda: pipeline._stretch(route, x, factor, cfg, rs), iters, device))
        part.update(stretch_only_ms_median=alone,
                    resample_share=max(0.0, part["ms_median"] - alone) / part["ms_median"],
                    **roofline(part, [(len(x) / SR, rs / HOP)], pitch=True))
    rec["semitones"] = parts
    return _aggregate(rec, parts)


def run_batch_bench(batch: int = 64, seconds_each: float = 120.0, ratio: float = 2.0,
                    iters: int = 5, backend: str = "fused", check: bool = True, device="cuda") -> dict:
    """parallel.batch_time_stretch on `batch` equal-length rows (the
    signal of the other modes, row i's noise from seed i); the gate runs
    row 0's first 60 s through the same entry point."""
    cfg = PvocConfig(n_fft=N_FFT, hop=HOP, sample_rate=SR, fft_backend=backend)
    rs = cfg.synthesis_hop(ratio)
    xs = torch.stack([_signal(seconds_each, device, seed=i) for i in range(batch)])
    n = xs.shape[1]
    rec = {"metric": f"batched_tsm_throughput_{ratio:g}x", "unit": "audio-s/s",
           "path": "fused-batch" if pipeline.fused_ok(cfg, rs) else "polar-batch", "batch": batch,
           "seconds_each": seconds_each, "ratio": ratio, "rs": rs, "fft_backend": backend,
           "n_fft": N_FFT, "hop": HOP, "iters": iters, "device": torch.device(device).type,
           "note": _NOTE}
    if check:
        ng = _gate_samples(seconds_each)
        ref = _pv_ref().phase_vocoder(xs[0, :ng].double().cpu().numpy(), ratio, N_FFT, HOP)
        ours = batch_mod.batch_time_stretch(xs[:1, :ng], ratio, cfg)[0]
        rec.update(_gate(_rel_err(ours, ref), STRETCH_LIMIT, ng // SR))
        if not rec["allclose_pass"]:
            return rec
    else:
        rec.update(_unchecked())
    xs_np = xs.cpu().numpy()
    timed = measure(lambda: batch_mod.batch_time_stretch(xs, ratio, cfg, device=device), device,
                    iters, batch * n / SR,
                    fn_numpy=lambda: batch_mod.batch_time_stretch(xs_np, ratio, cfg, device=device))
    timed["utterances_per_s"] = batch / (timed["ms_median"] / 1e3)
    return _finish(rec, timed, [(batch * n / SR, rs / HOP)])


def run_batch_varied_bench(iters: int = 5, backend: str = "fused", check: bool = True,
                           device="cuda") -> dict:
    """parallel.batch_time_stretch_varied on BASELINE config 4 (64
    utterances of 5-30 s, six ratios: one batch a synthesis hop); the gate
    runs the first utterance of each ratio, whole, through the same
    entry point."""
    cfg = PvocConfig(n_fft=N_FFT, hop=HOP, sample_rate=SR, fft_backend=backend)
    xs_np, ratios = baseline_batch()
    xs = [torch.as_tensor(x, dtype=torch.float32, device=device) for x in xs_np]
    audio = sum(len(x) for x in xs) / SR
    rec = {"metric": "batched_varied_tsm_throughput", "unit": "audio-s/s", "path": "fused-batch-varied",
           "utterances": len(xs), "ratios": sorted(set(ratios)), "fft_backend": backend,
           "n_fft": N_FFT, "hop": HOP, "iters": iters, "device": torch.device(device).type,
           "note": _NOTE}
    if check:
        first = [ratios.index(r) for r in sorted(set(ratios))]
        ys = batch_mod.batch_time_stretch_varied([xs[i] for i in first], [ratios[i] for i in first], cfg)
        err = max(_rel_err(y, _pv_ref().phase_vocoder(xs[i].double().cpu().numpy(), ratios[i], N_FFT, HOP))
                  for i, y in zip(first, ys))
        rec.update(_gate(err, STRETCH_LIMIT, max(len(xs[i]) for i in first) // SR))
        if not rec["allclose_pass"]:
            return rec
    else:
        rec.update(_unchecked())
    host = [x.cpu().numpy() for x in xs]
    timed = measure(lambda: batch_mod.batch_time_stretch_varied(xs, ratios, cfg, device=device), device,
                    iters, audio,
                    fn_numpy=lambda: batch_mod.batch_time_stretch_varied(host, ratios, cfg, device=device))
    timed["utterances_per_s"] = len(xs) / (timed["ms_median"] / 1e3)
    return _finish(rec, timed, [(len(x) / SR, cfg.synthesis_hop(r) / HOP) for x, r in zip(xs, ratios)])


# --------------------------------------------------------------- scaling


def _chunked_path(cfg: PvocConfig, rs: int) -> str:
    if chunked._fused1_ok(cfg, rs):
        return "chunked-fused1"
    return "chunked-split" if chunked._fused_chunk_ok(cfg, rs) else "chunked-polar"


def _chunked_row(world: int, seconds_per_device: float, ratio: float, iters: int, check: bool,
                 device, mesh=None, before=None, is_root: bool = True) -> dict:
    """chunked_time_stretch(force=True) over `mesh` (None: this process
    alone) on seconds_per_device x world seconds: gate (the first 60 s,
    judged on the root and shared with every rank), then timing. Every
    rank makes the same calls in the same order."""
    cfg = PvocConfig(n_fft=N_FFT, hop=HOP, sample_rate=SR)
    rs = cfg.synthesis_hop(ratio)
    x = _signal(seconds_per_device * world, device)
    row = {"world": world, "seconds": len(x) / SR}
    if check:
        ng = _gate_samples(len(x) / SR)
        ours = chunked.chunked_time_stretch(x[:ng], ratio, cfg, mesh=mesh, force=True)
        gate = None
        if is_root:
            ref = _pv_ref().phase_vocoder(x[:ng].double().cpu().numpy(), ratio, N_FFT, HOP)
            gate = _gate(_rel_err(ours, ref), STRETCH_LIMIT, ng // SR)
        if world > 1:
            import torch.distributed as dist

            box = [gate]
            dist.broadcast_object_list(box, src=0)
            gate = box[0]
        row.update(gate)
        if not row["allclose_pass"]:
            return row
    else:
        row.update(_unchecked())
    x_np = x.cpu().numpy()
    row.update(measure(lambda: chunked.chunked_time_stretch(x, ratio, cfg, mesh=mesh, force=True),
                       device, iters, len(x) / SR, before=before,
                       fn_numpy=lambda: chunked.chunked_time_stretch(x_np, ratio, cfg, mesh=mesh,
                                                                     force=True, device=device)))
    return row


def _scaling_rank(args) -> int:
    """One rank of a W-card --scaling row: joins the process group
    (NCCL between cards, gloo on the CPU) and runs _chunked_row over a "seq"
    mesh of every rank; rank 0 prints the row as one JSON line."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh

    rank, world, port = args.scaling_rank
    cuda = torch.device(args.device).type == "cuda"
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="nccl" if cuda else "gloo",
                           timeout_s=RANK_TIMEOUT_S)
    try:
        device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")

        def barrier():
            _sync(device)
            dist.barrier()

        row = _chunked_row(world, args.seconds_per_device, args.ratio, args.iters, not args.no_check,
                           device, mesh=make_mesh(axis="seq"), before=barrier, is_root=rank == 0)
        if rank == 0:
            profiling.emit(row)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _spawn_row(args, world: int) -> dict:
    """Run a W-rank row as W processes of this module; rank 0's line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    port = distributed.free_port()
    base = [sys.executable, "-m", "phase_vocoder_tpu_torch.bench", "--scaling",
            "--seconds-per-device", repr(args.seconds_per_device), "--ratio", repr(args.ratio),
            "--iters", str(args.iters), "--device", args.device]
    if args.no_check:
        base.append("--no-check")
    with tempfile.TemporaryFile("w+") as out:
        procs = [subprocess.Popen(base + ["--scaling-rank", str(r), str(world), str(port)], env=env,
                                  stdout=out if r == 0 else subprocess.DEVNULL)
                 for r in range(world)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"--scaling over {world} ranks: ranks {failed} failed or timed out")
        out.seek(0)
        return json.loads(out.read().strip().splitlines()[-1])


def run_scaling_bench(args) -> dict:
    """Weak scaling of chunked_time_stretch: W cards each take
    --seconds-per-device of one recording (W = 1: this process, force=True;
    W > 1: one process a card). Efficiency t1 / tW, speed-up W t1 / tW."""
    cuda = torch.device(args.device).type == "cuda"
    cards = args.world or (torch.cuda.device_count() if cuda else 1)
    if cuda and cards > torch.cuda.device_count():
        raise SystemExit(f"bench: --world {cards} needs {cards} cards; "
                         f"{torch.cuda.device_count()} are present (NCCL takes one process a card)")
    worlds = [1] + [w for w in (2, 4, 8, 16, 32, 64) if w < cards] + ([cards] if cards > 1 else [])
    cfg = PvocConfig(n_fft=N_FFT, hop=HOP, sample_rate=SR)
    rs = cfg.synthesis_hop(args.ratio)
    rec = {"metric": "chunked_scaling_efficiency", "unit": "audio-s/s", "path": _chunked_path(cfg, rs),
           "ratio": args.ratio, "rs": rs, "seconds_per_device": args.seconds_per_device,
           "cards": cards, "n_fft": N_FFT, "hop": HOP, "iters": args.iters,
           "device": torch.device(args.device).type, "note": _NOTE}
    rows = []
    for w in worlds:
        if w == 1:
            row = _chunked_row(1, args.seconds_per_device, args.ratio, args.iters, not args.no_check,
                               args.device)
        else:
            row = _spawn_row(args, w)
        rows.append(row)
        if row["allclose_pass"] is False:
            rec.update(rows=rows, allclose_rel_err=row["allclose_rel_err"], allclose_pass=False)
            return rec
        row.update(roofline(row, [(row["seconds"], rs / HOP)], cards=w))
        row["efficiency"] = rows[0]["ms_median"] / row["ms_median"]
        row["speedup"] = w * row["efficiency"]
    top = rows[-1]
    rec.update({k: v for k, v in top.items() if k not in ("world", "seconds")})
    rec.update(world=top["world"], rows=rows,
               allclose_rel_err=max((r["allclose_rel_err"] for r in rows if r["allclose_rel_err"] is not None),
                                    default=None))
    if cards == 1:
        rec["scaling_note"] = "one card present: W = 1 only (efficiency 1 by definition)"
    return rec


# ------------------------------------------------------------------- CLI


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The bench's options (also those of `pvoc-torch bench`)."""
    ap.add_argument("--seconds", type=float, default=None,
                    help="audio seconds of the timed input (default 3600; --batch: seconds a row, 120)")
    ap.add_argument("--ratio", type=float, default=2.0, help="stretch ratio (default 2.0)")
    ap.add_argument("--iters", type=int, default=5, help="timed calls (default 5)")
    ap.add_argument("--fft-backend", "--backend", dest="fft_backend", choices=["fused", "matmul", "xla"],
                    default="fused", help="PvocConfig.fft_backend (default fused: the CUDA kernels)")
    ap.add_argument("--no-check", action="store_true", help="skip the golden-model gate")
    ap.add_argument("--pitch", action="store_true", help="the pitch-shift bench (pipeline.pitch_shift)")
    ap.add_argument("--semitones", type=float, nargs="+", default=list(SEMITONES),
                    help="--pitch: the shifts (default -12 -7 -5 5 7 12)")
    ap.add_argument("--batch", action="store_true", help="the equal-length batch bench")
    ap.add_argument("--batch-size", type=int, default=64, help="--batch: rows (default 64)")
    ap.add_argument("--batch-varied", action="store_true",
                    help="BASELINE config 4: 64 utterances of 5-30 s at ratios 0.5-2.0")
    ap.add_argument("--stream", action="store_true", help="the fused streaming executor's bench")
    ap.add_argument("--stream-checkpoint", action="store_true",
                    help="with --stream: also time a checkpointed run")
    ap.add_argument("--scaling", action="store_true",
                    help="weak scaling of chunked_time_stretch over the cards present")
    ap.add_argument("--seconds-per-device", type=float, default=120.0,
                    help="--scaling: audio seconds a card (default 120)")
    ap.add_argument("--world", type=int, default=None,
                    help="--scaling: the largest W (default: the cards present; 1 on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions, timed on the host)")
    ap.add_argument("--scaling-rank", type=int, nargs=3, default=None, metavar=("RANK", "WORLD", "PORT"),
                    help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m phase_vocoder_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(ap)
    return ap


def run(args) -> int:
    """Run the mode `args` selects and print its line; 1 if its gate is
    red."""
    if args.scaling_rank is not None:
        return _scaling_rank(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card (torch.cuda.is_available() is false); "
                         "--device cpu runs the plain versions")
    dsp = {"iters": args.iters, "check": not args.no_check, "device": args.device}
    if args.stream:
        rec = run_stream_bench(args.seconds or MODE_SECONDS["stream"], args.ratio,
                               checkpoint_run=args.stream_checkpoint, **dsp)
    elif args.batch_varied:
        rec = run_batch_varied_bench(backend=args.fft_backend, **dsp)
    elif args.batch:
        rec = run_batch_bench(args.batch_size, args.seconds or MODE_SECONDS["batch"], args.ratio,
                              backend=args.fft_backend, **dsp)
    elif args.pitch:
        rec = run_pitch_bench(args.seconds or MODE_SECONDS["pitch"], backend=args.fft_backend,
                              semitones=tuple(args.semitones), **dsp)
    elif args.scaling:
        rec = run_scaling_bench(args)
    else:
        rec = run_bench(args.seconds or MODE_SECONDS["stretch"], args.ratio,
                        backend=args.fft_backend, **dsp)
    rec.update(card(args.device))
    profiling.emit(rec)
    return 1 if rec.get("allclose_pass") is False else 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
