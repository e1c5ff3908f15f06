#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (the kernels build
from phase_vocoder_tpu_torch/csrc at first use). Phases, one output line
each; any failure raises and the script exits non-zero:

  1. the card, its power limit, torch/CUDA versions, kernel build seconds;
  2. each kernel against its plain torch version on the card (60 s input);
  3. the golden gate through the public API (60 s input);
  4. the main path at real size: time_stretch 2.0x on 3600 s and
     pitch_shift -7 st on 300 s of 16 kHz audio, timed with CUDA events,
     launch counts read around that run, then each kernel against its
     plain version at those shapes;
  5. determinism: two 2.0x runs are bitwise equal.

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

    # ---- 5. determinism
    a = pv.time_stretch(x60, 2.0, cfg)
    b = pv.time_stretch(x60, 2.0, cfg)
    _check(bool(torch.equal(a, b)), "two 2.0x runs differ")
    _emit("5_determinism", bitwise_equal=True)

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
