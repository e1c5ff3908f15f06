#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (the kernels build
from phase_vocoder_tpu_torch/csrc at first use). Phases, one output line
each; any failure raises and the script exits non-zero:

  1. the card, its power limit, torch/CUDA versions, kernel build seconds;
  2. each kernel against its plain torch version on the card (60 s input):
     2a. pvoc_fused and resample_lerp;
     2b. stft_polar, and istft_ola at Rs 128/256/512 with a frame mask
         whose last 100 frames are 0;
  3. the golden gate through the public API (60 s input):
     3a. the fused route; 3b. the branch-faithful route
         (branch_policy="faithful": stretch 0.5/1.5, pitch -7/-5 st);
  4. the main paths at real size, each timed with CUDA events, with the
     launch counts set to 0 just before it and read just after:
     4a. the fused route: time_stretch 2.0x on 3600 s and pitch_shift
         -7 st on 300 s of 16 kHz audio;
     4b. the kernels of 4a against their plain versions at those shapes;
     4c. the branch-faithful route through branch_policy="auto" on 660 s
         (41,247 frames, past the 37,500-frame reroute): time_stretch 0.5x
         and pitch_shift -7 st on the chirp+tone+noise signal, timed, with
         kernel launches per call and per segment; istft_ola checked inside
         the route (plain synthesis swapped in); the golden error on that
         signal recorded and the golden gate run at 660 s on stationary
         tones; then stft_polar and istft_ola against their plain versions
         at those shapes;
  5. determinism: two 2.0x runs, and two faithful 0.5x runs, are bitwise
     equal.

The line before the last holds the per-kernel JSON record; the last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FFT, HOP, SR = 1024, 256, 16000


def _signal(seconds: float, seed: int = 0) -> np.ndarray:
    """Chirp + tone + noise, float64 in [-1, 1] (tests/conftest.py's signal)."""
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.3 * np.sin(2 * np.pi * (200.0 * t + 400.0 * t * t))
        + 0.05 * g.standard_normal(len(t))
    )
    return x / np.max(np.abs(x))


def _tones(seconds: float) -> np.ndarray:
    """Three stationary tones, float64 in [-1, 1]: a long input on which
    the float32 q >= 2 routes can follow the golden model's branch
    choices (no bin crosses from near-silence to loudness)."""
    t = np.arange(int(seconds * SR)) / SR
    x = (
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.3 * np.sin(2 * np.pi * 1234.5 * t)
        + 0.2 * np.sin(2 * np.pi * 3111.0 * t)
    )
    return x / np.max(np.abs(x))


def _interior(a, edge=N_FFT):
    a = torch.as_tensor(a).double().cpu()
    return a[edge : len(a) - edge]


def _rel(a, b, edge=N_FFT) -> float:
    if len(a) != len(b):
        raise RuntimeError(f"length mismatch {len(a)} != {len(b)}")
    a, b = _interior(a, edge), _interior(b, edge)
    return float((a - b).abs().max() / b.abs().max())


def _max_abs(a, b, edge=N_FFT) -> float:
    if len(a) != len(b):
        raise RuntimeError(f"length mismatch {len(a)} != {len(b)}")
    return float((_interior(a, edge) - _interior(b, edge)).abs().max())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _time_calls(fn, reps: int) -> list[float]:
    """Device time of each of `reps` calls of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _profile_call(fn) -> dict:
    """One call of fn() under torch.profiler: its device kernels, their
    summed time, and the span from the first kernel's start to the last
    one's end (one stream, so the kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    _check(len(kern) > 0, "torch.profiler recorded no device kernel")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)) / 1e3
    return {"kernels": len(kern), "device_busy_ms": busy, "device_span_ms": span,
            "idle_share": 1.0 - busy / span}


def _syncs_per_call(fn) -> int:
    """Host-device synchronizations one call of fn() makes, counted by
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in seen)


def _spec_errors(kernel, plain) -> dict:
    """stft_polar against its plain version: magnitude, and the complex
    spectrum mag*e^{i phi} (phi compared only through e^{i phi}, since a
    phase near +-pi may land on either side), both relative to max |X|."""
    (mk, pk), (mp, pp) = kernel, plain
    mk, pk, mp, pp = (t.double() for t in (mk, pk, mp, pp))
    top = float(mp.abs().max())
    mag_abs = float((mk - mp).abs().max())
    spec = torch.polar(mk, pk) - torch.polar(mp, pp)
    return {"mag_rel": mag_abs / top, "mag_max_abs": mag_abs,
            "spec_rel": float(spec.abs().max()) / top}


def _emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")

    from golden import pv_ref
    import phase_vocoder_tpu_torch as pv
    from phase_vocoder_tpu_torch.ops import _build
    from phase_vocoder_tpu_torch.ops.fused import (
        fused_time_stretch,
        fused_time_stretch_reference,
    )
    from phase_vocoder_tpu_torch.ops.resample import (
        resample_linear,
        resample_linear_reference,
    )
    from phase_vocoder_tpu_torch.ops.stft import (
        istft_ola,
        istft_ola_reference,
        stft_polar,
        stft_polar_reference,
    )
    from phase_vocoder_tpu_torch import streaming

    dev = torch.device("cuda")
    cfg = pv.PvocConfig()

    # ---- 1. card, versions, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    _emit("1_setup", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), build_seconds=build_s)

    # ---- 2. kernels vs plain versions, 60 s
    x60_np = _signal(60.0)
    x60 = torch.as_tensor(x60_np, dtype=torch.float32, device=dev)
    fused_rel = {}
    for rs in (128, 256, 384, 512, 171):
        a = fused_time_stretch(x60, N_FFT, HOP, rs)
        b = fused_time_stretch_reference(x60, N_FFT, HOP, rs)
        torch.cuda.synchronize()
        bound = 1e-5 if rs % HOP == 0 else 5e-5
        fused_rel[rs] = _rel(a, b)
        _check(fused_rel[rs] < bound, f"pvoc_fused vs plain at Rs={rs}: {fused_rel[rs]:.3e} >= {bound}")
    # Other geometries: k = 4 at N=512, the largest N, odd Rs with N=2048,
    # and inputs shorter than the overlap (nf < m-1; edges skipped: 64).
    for n_fft, hop, rs, seconds, edge in (
        (512, 64, 256, 60.0, 512), (2048, 512, 1024, 60.0, 2048),
        (2048, 512, 683, 60.0, 2048), (4096, 1024, 2048, 60.0, 4096),
        (1024, 256, 128, 0.1, 64), (1024, 256, 171, 0.1, 64),
    ):
        x = x60[: int(seconds * SR)]
        a = fused_time_stretch(x, n_fft, hop, rs)
        b = fused_time_stretch_reference(x, n_fft, hop, rs)
        bound = 1e-5 if rs % hop == 0 else 5e-5
        key = f"{n_fft}/{hop}/{rs}@{seconds}s"
        fused_rel[key] = _rel(a, b, edge)
        _check(fused_rel[key] < bound, f"pvoc_fused vs plain at {key}: {fused_rel[key]:.3e} >= {bound}")
    resample_abs = {}
    for st in (-13, -12, -7, -5, 5, 7, 12):
        factor = 2.0 ** (st / 12.0)
        out_len = int(round(len(x60) / factor))
        a = resample_linear(x60, 1.0 / factor, out_len)
        b = resample_linear_reference(x60, 1.0 / factor, out_len)
        resample_abs[st] = float((a - b).abs().max())
        _check(resample_abs[st] < 1e-6, f"resample_lerp vs plain at {st} st: {resample_abs[st]:.3e}")
    _emit("2_kernel_vs_plain", seconds=60, pvoc_fused_rel=fused_rel,
          pvoc_bounds={"integer_k": 1e-5, "q_ge_2": 5e-5},
          resample_max_abs=resample_abs, resample_bound=1e-6)

    # ---- 2b. stft_polar and istft_ola vs their plain versions, 60 s
    mag_p, phi_p = stft_polar_reference(x60, N_FFT, HOP)
    stft_err = _spec_errors(stft_polar(x60, N_FFT, HOP), (mag_p, phi_p))
    _check(stft_err["spec_rel"] < 1e-5 and stft_err["mag_rel"] < 1e-5,
           f"stft_polar vs plain: {stft_err}")
    mask = torch.ones(mag_p.shape[0], device=dev)
    mask[-100:] = 0.0
    istft_rel = {}
    for rs in (128, 256, 512):
        a = istft_ola(mag_p, phi_p, N_FFT, rs, frame_mask=mask)
        b = istft_ola_reference(mag_p, phi_p, N_FFT, rs, frame_mask=mask)
        istft_rel[rs] = _rel(a, b)
        _check(istft_rel[rs] < 1e-5, f"istft_ola vs plain at Rs={rs}: {istft_rel[rs]:.3e}")
        tail = (mag_p.shape[0] - 100 - 1) * rs + N_FFT  # past the last unmasked frame
        _check(bool((a[tail:] == 0).all()), f"istft_ola: masked frames leak at Rs={rs}")
    _emit("2b_stft_kernels_vs_plain", seconds=60, stft_polar=stft_err,
          istft_ola_rel=istft_rel, masked_frames=100, bound=1e-5)

    # ---- 3. golden gate through the public API, 60 s
    gate = {}
    for s in (0.5, 1.0, 2.0):
        y = pv.time_stretch(x60_np, s, cfg)
        ref = pv_ref.phase_vocoder(x60_np, s, N_FFT, HOP)
        gate[f"stretch_{s}"] = _rel(y, ref)
        _check(gate[f"stretch_{s}"] < 1e-4, f"time_stretch {s} vs golden: {gate[f'stretch_{s}']:.3e}")
    for st in (-12, -7, -5, 7, 12):
        y = pv.pitch_shift(x60_np, st, cfg)
        ref = pv_ref.pitch_shift(x60_np, st, N_FFT, HOP)
        _check(abs(len(y) - len(ref)) <= 1, f"pitch {st} length {len(y)} vs {len(ref)}")
        n = min(len(y), len(ref))
        gate[f"pitch_{st}"] = _rel(y[:n], torch.as_tensor(ref[:n]))
        _check(gate[f"pitch_{st}"] < 1e-3, f"pitch_shift {st} vs golden: {gate[f'pitch_{st}']:.3e}")
    _emit("3_golden_gate", seconds=60, rel_err=gate,
          bounds={"stretch": 1e-4, "pitch": 1e-3})

    # ---- 3b. golden gate of the branch-faithful route, 60 s
    fgate = {}
    for s in (0.5, 1.5):
        y = pv.time_stretch(x60_np, s, cfg, branch_policy="faithful")
        ref = pv_ref.phase_vocoder(x60_np, s, N_FFT, HOP)
        fgate[f"stretch_{s}"] = _rel(y, ref)
        _check(fgate[f"stretch_{s}"] < 1e-4, f"faithful time_stretch {s} vs golden: {fgate[f'stretch_{s}']:.3e}")
    for st in (-7, -5):
        y = pv.pitch_shift(x60_np, st, cfg, branch_policy="faithful")
        ref = pv_ref.pitch_shift(x60_np, st, N_FFT, HOP)
        n = min(len(y), len(ref))
        _check(abs(len(y) - len(ref)) <= 1, f"faithful pitch {st} length {len(y)} vs {len(ref)}")
        fgate[f"pitch_{st}"] = _rel(y[:n], torch.as_tensor(ref[:n]))
        _check(fgate[f"pitch_{st}"] < 1e-3, f"faithful pitch_shift {st} vs golden: {fgate[f'pitch_{st}']:.3e}")
    _emit("3b_faithful_golden_gate", seconds=60, rel_err=fgate,
          bounds={"stretch": 1e-4, "pitch": 1e-3})

    # ---- 4. main path at real size
    x_long = torch.as_tensor(_signal(3600.0), dtype=torch.float32, device=dev)
    x_pitch = torch.as_tensor(_signal(300.0, seed=1), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    fused_time_stretch.launches = 0
    resample_linear.launches = 0
    stretch_ms = _time_ms(lambda: pv.time_stretch(x_long, 2.0, cfg), reps=3)
    pitch_ms = _time_ms(lambda: pv.pitch_shift(x_pitch, -7.0, cfg), reps=3)
    launches = {
        "pvoc_fused": fused_time_stretch.launches,
        "resample_lerp": resample_linear.launches,
    }
    _check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    y_long = pv.time_stretch(x_long, 2.0, cfg)
    y_pitch = pv.pitch_shift(x_pitch, -7.0, cfg)
    _check(len(y_long) == pv.stretch_output_length(len(x_long), cfg, 2.0), "stretch length")
    f_m7 = 2.0 ** (-7 / 12)
    _check(len(y_pitch) == round(pv.stretch_output_length(len(x_pitch), cfg, f_m7) / f_m7),
           "pitch length")
    _check(bool(torch.isfinite(y_long).all() and torch.isfinite(y_pitch).all()), "finite outputs")
    main = {
        "stretch_2x_3600s": {"ms": stretch_ms, "audio_s_per_s": 3600.0 / (stretch_ms / 1e3)},
        "pitch_m7_300s": {"ms": pitch_ms, "audio_s_per_s": 300.0 / (pitch_ms / 1e3)},
    }
    _emit("4a_main_path", card=smi, launches=launches, **main)
    del y_long

    # Kernels against their plain versions at the main path's shapes
    # (these launches are not counted above).
    rs_pitch = cfg.synthesis_hop(2.0 ** (-7 / 12))
    shapes = {}
    for name, x, rs in (("stretch_2x_3600s", x_long, 512), ("pitch_m7_300s", x_pitch, rs_pitch)):
        a = fused_time_stretch(x, N_FFT, HOP, rs)
        b = fused_time_stretch_reference(x, N_FFT, HOP, rs)
        bound = 1e-5 if rs % HOP == 0 else 5e-5
        rel = _rel(a, b)
        _check(rel < bound, f"pvoc_fused vs plain, {name}: {rel:.3e} >= {bound}")
        shapes[name] = {
            "rel": rel, "max_abs": _max_abs(a, b),
            "ms": _time_ms(lambda: fused_time_stretch(x, N_FFT, HOP, rs), reps=3),
            "plain_ms": _time_ms(lambda: fused_time_stretch_reference(x, N_FFT, HOP, rs), reps=1),
        }
        del a, b
    factor = 2.0 ** (-7 / 12)
    y_st = fused_time_stretch(x_pitch, N_FFT, HOP, rs_pitch)
    out_len = int(round(len(y_st) / factor))
    a = resample_linear(y_st, 1.0 / factor, out_len)
    b = resample_linear_reference(y_st, 1.0 / factor, out_len)
    # Interior only: the stretched signal's first and last samples divide
    # by near-zero window energy and reach ~1e3, where 1e-6 is below f32
    # resolution.
    res_abs = _max_abs(a, b)
    _check(res_abs < 1e-6, f"resample_lerp vs plain at the -7 st shape: {res_abs:.3e}")
    res_ms = _time_ms(lambda: resample_linear(y_st, 1.0 / factor, out_len), reps=20)
    res_plain_ms = _time_ms(lambda: resample_linear_reference(y_st, 1.0 / factor, out_len), reps=5)
    _emit("4b_kernel_vs_plain_main_shapes", card=smi, pvoc_fused=shapes,
          resample_m7_300s={"max_abs": res_abs, "ms": res_ms, "plain_ms": res_plain_ms,
                            "n_in": len(y_st), "n_out": out_len})

    del x_long, y_st, a, b
    torch.cuda.empty_cache()

    # ---- 4c. the branch-faithful route at real size, through "auto"
    ff_sec = 660.0
    x_ff_np = _signal(ff_sec, seed=2)
    x_ff = torch.as_tensor(x_ff_np, dtype=torch.float32, device=dev)
    nf_ff = (len(x_ff) - N_FFT) // HOP + 1
    _check(nf_ff > pv.pipeline.BRANCH_FAITHFUL_FRAMES, f"{nf_ff} frames do not reroute")
    torch.cuda.synchronize()
    for fn in (stft_polar, istft_ola, resample_linear, fused_time_stretch):
        fn.launches = 0
    ff_runs = {
        "stretch_0.5x_660s": lambda: pv.time_stretch(x_ff, 0.5, cfg),
        "pitch_m7_660s": lambda: pv.pitch_shift(x_ff, -7.0, cfg),
    }
    ff = {name: {"ms": _time_calls(fn, reps=3)} for name, fn in ff_runs.items()}
    ff_launches = {
        "stft_polar": stft_polar.launches, "istft_ola": istft_ola.launches,
        "resample_lerp": resample_linear.launches, "pvoc_fused": fused_time_stretch.launches,
    }
    _check(ff_launches["stft_polar"] > 0 and ff_launches["istft_ola"] > 0
           and ff_launches["resample_lerp"] > 0,
           f"a kernel of the faithful route never launched: {ff_launches}")
    _check(ff_launches["pvoc_fused"] == 0, f"auto did not reroute: {ff_launches}")
    for name, rec in ff.items():
        rec["audio_s_per_s"] = [ff_sec / (ms / 1e3) for ms in rec["ms"]]
    for name, fn in ff_runs.items():
        y = fn()
        _check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        ff[name]["length"] = len(y)
    _check(ff["stretch_0.5x_660s"]["length"] == pv.stretch_output_length(len(x_ff), cfg, 0.5),
           "faithful stretch length")
    # istft_ola inside the route at full size: the same run with the plain
    # synthesis swapped in (analysis and phase scan unchanged).
    y = pv.time_stretch(x_ff, 0.5, cfg)
    streaming.istft_ola = istft_ola_reference
    try:
        y_plain_synth = pv.time_stretch(x_ff, 0.5, cfg)
    finally:
        streaming.istft_ola = istft_ola
    ff["stretch_0.5x_660s"]["vs_plain_synthesis_rel"] = _rel(y, y_plain_synth)
    _check(ff["stretch_0.5x_660s"]["vs_plain_synthesis_rel"] < 1e-5,
           f"faithful 0.5x, kernel vs plain synthesis: {ff['stretch_0.5x_660s']['vs_plain_synthesis_rel']:.3e}")
    # Golden error on this signal, recorded: at 660 s its chirp has aliased
    # many times over and q >= 2 branch choices in near-silent bins follow
    # the last bit of any f32 analysis (the JAX package's own polar route
    # reads the same order of error); the gate runs on the tones below.
    ff["stretch_0.5x_660s"]["golden_rel_recorded"] = _rel(
        y, pv_ref.phase_vocoder(x_ff_np, 0.5, N_FFT, HOP))
    del y, y_plain_synth
    # Golden gate at this length, through "auto", on stationary tones.
    x_tones_np = _tones(ff_sec)
    x_tones = torch.as_tensor(x_tones_np, dtype=torch.float32, device=dev)
    tone_gate = {}
    y = pv.time_stretch(x_tones, 0.5, cfg)
    tone_gate["stretch_0.5x"] = _rel(y, pv_ref.phase_vocoder(x_tones_np, 0.5, N_FFT, HOP))
    _check(tone_gate["stretch_0.5x"] < 1e-4, f"faithful 0.5x on 660 s tones vs golden: {tone_gate['stretch_0.5x']:.3e}")
    y = pv.pitch_shift(x_tones, -7.0, cfg)
    ref = pv_ref.pitch_shift(x_tones_np, -7.0, N_FFT, HOP)
    _check(abs(len(y) - len(ref)) <= 1, f"faithful pitch length {len(y)} vs {len(ref)}")
    n = min(len(y), len(ref))
    tone_gate["pitch_m7"] = _rel(y[:n], torch.as_tensor(ref[:n]))
    _check(tone_gate["pitch_m7"] < 1e-3, f"faithful -7 st on 660 s tones vs golden: {tone_gate['pitch_m7']:.3e}")
    ff["golden_gate_tones_660s"] = tone_gate
    del y, ref, x_tones
    # Device kernels per segment and the idle share, from one profiled
    # 0.5x call, and the host-device synchronizations of one call: the two
    # reads of the initial state before the segment loop, none inside it.
    segments = -(-nf_ff // streaming.DEFAULT_SEGMENT_FRAMES)
    prof = _profile_call(ff_runs["stretch_0.5x_660s"])
    ff["profile_0.5x"] = prof
    ff["kernels_per_segment"] = prof["kernels"] / segments
    ff["segments"] = segments
    ff["syncs_per_call"] = _syncs_per_call(ff_runs["stretch_0.5x_660s"])
    _check(ff["syncs_per_call"] <= 2, f"the faithful route synchronizes {ff['syncs_per_call']} times a call")
    _emit("4c_faithful_main_path", card=smi, seconds=ff_sec, frames=nf_ff,
          launches=ff_launches, **ff)

    # stft_polar and istft_ola against their plain versions at the shapes
    # of 4c (these launches are not counted above): stft_polar on the
    # padded 660 s signal, istft_ola on one 1024-frame segment (its call in
    # the route) and on all 41,247 frames at once.
    x_pad = streaming.pad_for_segments(x_ff, cfg, streaming.DEFAULT_SEGMENT_FRAMES, segments)
    mag_k, phi_k = stft_polar(x_pad, N_FFT, HOP)
    mag_p, phi_p = stft_polar_reference(x_pad, N_FFT, HOP)
    stft_main = _spec_errors((mag_k, phi_k), (mag_p, phi_p))
    _check(stft_main["spec_rel"] < 1e-5 and stft_main["mag_rel"] < 1e-5,
           f"stft_polar vs plain at 660 s: {stft_main}")
    stft_main.update(
        frames=mag_k.shape[0],
        ms=_time_ms(lambda: stft_polar(x_pad, N_FFT, HOP), reps=5),
        plain_ms=_time_ms(lambda: stft_polar_reference(x_pad, N_FFT, HOP), reps=5),
    )
    del mag_k, phi_k
    istft_main = {}
    seg = streaming.DEFAULT_SEGMENT_FRAMES
    for name, rows in (("segment_1024", slice(0, seg)), ("all_frames", slice(0, nf_ff))):
        m_, p_ = mag_p[rows], phi_p[rows]
        a = istft_ola(m_, p_, N_FFT, 128)
        b = istft_ola_reference(m_, p_, N_FFT, 128)
        rec = {"frames": m_.shape[0], "rel": _rel(a, b), "max_abs": _max_abs(a, b)}
        _check(rec["rel"] < 1e-5, f"istft_ola vs plain, {name}: {rec['rel']:.3e}")
        rec["ms"] = _time_ms(lambda: istft_ola(m_, p_, N_FFT, 128), reps=10)
        rec["plain_ms"] = _time_ms(lambda: istft_ola_reference(m_, p_, N_FFT, 128), reps=5)
        istft_main[name] = rec
    _emit("4c_stft_kernels_vs_plain_main_shapes", card=smi, stft_polar=stft_main,
          istft_ola_rs128=istft_main)
    del x_pad, mag_p, phi_p, a, b

    # ---- 5. determinism
    a = pv.time_stretch(x60, 2.0, cfg)
    b = pv.time_stretch(x60, 2.0, cfg)
    _check(bool(torch.equal(a, b)), "two 2.0x runs differ")
    a = pv.time_stretch(x60, 0.5, cfg, branch_policy="faithful")
    b = pv.time_stretch(x60, 0.5, cfg, branch_policy="faithful")
    _check(bool(torch.equal(a, b)), "two faithful 0.5x runs differ")
    _emit("5_determinism", bitwise_equal={"fused_2.0x": True, "faithful_0.5x": True})

    kernels = [
        {
            "name": "pvoc_fused", "route": "cuda",
            "source": "phase_vocoder_tpu_torch/csrc/pvoc_fused.cu",
            "replaces": "phase_vocoder_tpu/ops/pallas/fused.py:1526",
            "launches": launches["pvoc_fused"],
            "max_abs_err": shapes["stretch_2x_3600s"]["max_abs"],
            "ms": shapes["stretch_2x_3600s"]["ms"],
            "plain_ms": shapes["stretch_2x_3600s"]["plain_ms"],
        },
        {
            "name": "resample_lerp", "route": "cuda",
            "source": "phase_vocoder_tpu_torch/csrc/resample.cu",
            "replaces": "phase_vocoder_tpu/ops/resample.py:372",
            "launches": launches["resample_lerp"],
            "max_abs_err": res_abs, "ms": res_ms, "plain_ms": res_plain_ms,
        },
        {
            "name": "stft_polar", "route": "cuda",
            "source": "phase_vocoder_tpu_torch/csrc/stft.cu",
            "replaces": "phase_vocoder_tpu/ops/pallas/stft.py:117",
            "launches": ff_launches["stft_polar"],
            "max_abs_err": stft_main["mag_max_abs"],
            "ms": stft_main["ms"], "plain_ms": stft_main["plain_ms"],
        },
        {
            "name": "istft_ola", "route": "cuda",
            "source": "phase_vocoder_tpu_torch/csrc/stft.cu",
            "replaces": "phase_vocoder_tpu/ops/pallas/stft.py:207",
            "launches": ff_launches["istft_ola"],
            "max_abs_err": istft_main["segment_1024"]["max_abs"],
            "ms": istft_main["segment_1024"]["ms"],
            "plain_ms": istft_main["segment_1024"]["plain_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
