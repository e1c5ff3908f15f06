#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (the kernels build
from phase_vocoder_tpu_torch/csrc at first use). Phases, one output line
each; any failure raises and the script exits non-zero:

  1. the card, its power limit, torch/CUDA versions, kernel build seconds;
  2. each kernel against its plain torch version on the card (60 s input):
     2a. pvoc_fused and resample_lerp; pvoc_fused at N = 256 and 512 with
         q >= 2 (Rs = 171 N/1024 rounded, and 3N/8) on stationary tones,
         against plain and golden, the chirp's distance recorded;
     2b. stft_polar, and istft_ola at Rs 128/256/512 with a frame mask
         whose last 100 frames are 0; then at N = 256, 512, 1024, 2048,
         4096 (hop N/4; the N/2-point body of csrc/fft_real.cuh) stft_polar,
         stft_fused and istft_ola at Rs = N/4 and N/8 with that mask, and
         bitwise: frames j.. of the whole analysis against an analysis
         from sample j*hop (j = 3, 5), a slice at element offset 1-3
         against its copy;
     2c. pvoc_fused_segment against fused_stream_segment_reference (one
         segment from a mid-stream state, and whole streams) at 2.0x, 0.5x
         and Rs = 171; the kernel stream against the kernel monolithic
         fused_time_stretch bit for bit at segment_frames 256 and 8192 and
         on an input shorter than the overlap (nf < m-1); at N = 256, 1024
         and 4096 (the analysis on csrc/fft_real.cuh's body) zrev=True
         bitwise equal to zrev=False and reruns bitwise equal, and at 256
         and 4096 the stream and a checkpointed stream killed and resumed
         bitwise equal to the monolithic kernel;
     2d. pvoc_terms (stft_phasor_terms: |X| and P, scan on and off) at
         Rs = 640/768/767, at the chunk edges (1, 63, 64, 65, 129 frames;
         Rs = 768 and 640, unit phasors) and over a batch of 3 rows at
         N = 256 and 4096 (rows bitwise the single kernel's), and
         istft_frames / istft_frames_cart with a
         frame mask whose last 100 frames are 0, also at each of those
         five N, with rows r0..r1 alone bitwise equal to the whole call's;
     2f. (run after 2e) segment_phase (csrc/phase_scan.cu, the faithful
         stream's phase chain) against segment_phase_reference bit for bit
         through an int32 view, and rerun bit for bit: N = 256, 1024 and
         4096, Rs = 128/171/384 at N = 1024, F = 1, 1000, 1024, 1025 and
         4096, first segments, mid-stream states and partial last segments
         of a real 120 s signal, phases whose increments sit within an ulp
         of +-pi, and the edges of the kernel's schedule (F = 2, 7, 8, 9,
         33, 65, 257, 513: trees below, at and past a thread's 8 rows and
         a warp's 256; 1030: blocked, not a multiple of 8); timed at 1024
         frames, N = 1024, Rs = 128 (device time, and the wrapper's host
         time as events - device), and at N = 256 and 4096;
  3. the golden gate through the public API (60 s input):
     3a. the fused route; 3b. the branch-faithful route
         (branch_policy="faithful": stretch 0.5/1.5, pitch -7/-5 st);
     3c. fused_stream_time_stretch 2.0x/0.5x, the general-hop route
         (time_stretch 2.5x/3.0x, pitch_shift +19 st) and the polar stages
         (analyze, stretch_polar, synthesize_polar) at Rs = 171;
  4. the main paths at real size, each timed with CUDA events, with every
     kernel's launches (utils/profiling's launches.<wrapper>) counted from
     just before the path to just after, and held to exactly the launches
     that path makes:
     4a. the fused route: time_stretch 2.0x on 3600 s and pitch_shift
         -7 st on 300 s of 16 kHz audio;
     4b. the kernels of 4a against their plain versions at those shapes,
         and pvoc_fused's passes at 2.0x / 3600 s from one torch.profiler
         trace (analysis_real, phase_anchor, synth_real with the integer-k
         phase in its load, ola_rows); the kernels pvoc_fused launches at
         integer k at N = 256-4096 (no phase_closed) and 768 (phase_closed);
         resample_lerp, the three select variants and F.interpolate at the
         -7 st shape as medians of 101 calls each and as device time (one
         torch.profiler trace of 101 calls each, by kernel name); pvoc_fused
         at -7 st (q >= 2) by pass from one trace;
     4c. the branch-faithful route through branch_policy="auto" on 660 s
         (41,247 frames, past the 37,500-frame reroute): time_stretch 0.5x
         and pitch_shift -7 st on the chirp+tone+noise signal, timed, with
         kernel launches per call and per segment (at most 1,000 device
         kernels a 0.5x call) and what launched them (the scan, the mask
         and norm, istft_ola or the matmul synthesis, the epilogue, the
         state updates: _kernel_split); istft_ola checked inside the route
         (plain synthesis swapped in), and segment_phase (the plain phase
         chain swapped in: the same output bit for bit); both routes timed
         and traced once on 3600 s; the golden error on that
         signal recorded and the golden gate run at 660 s on stationary
         tones; then stft_polar and istft_ola against their plain versions
         at those shapes; stft_fused (the cartesian analysis) called on the
         padded 660 s signal as its own counted path, against its plain
         version, timed beside torch.stft;
     4d. the fused stream executor at 2.0x on 3600 s (28 segments of 8192
         frames): timed, bitwise equal to the monolithic kernel, host-device
         syncs per call, peak device memory beside the monolithic one's;
         the checkpointed fused stream at that shape, uninterrupted and
         killed after 2 batches then resumed, bitwise equal, wall split
         into device, host fetch, save and load; the checkpointed polar
         stream at 0.5x on 660 s resumed the same way; the general-hop
         route (time_stretch
         3.0x on 3600 s, pitch_shift +19 st on 300 s) and the polar stages
         at Rs = 171 on 300 s, timed, with their kernels against the plain
         versions at those shapes; one 8192-frame segment of the fused
         stream (pvoc_fused_segment) by device time;
     4e. the parallel layer: the BASELINE batch (64 utterances of 5-30 s,
         ratios 0.5-2.0) through batch_time_stretch_varied, rows against
         the single-recording kernel; chunked_time_stretch(force=True) at
         2.0x and 0.5x on 3600 s against time_stretch, with peak memory;
         batched_chunked_time_stretch on a (1, 1) mesh, 8 x 600 s; two
         ranks on the one card (two processes of this script, gloo) at
         60 s against the single route; the new kernels against their
         plain versions at these shapes;
  2e. (run after 2d) the parallel layer's kernels against their plain
      versions (60 s): pvoc_fused_batch on a ragged batch of 4 at Rs
      128/171/512 with a row shorter than the overlap, pvoc_terms over a
      batch (scan off, u on), phasor_istft_ola with and without a mask at
      Rs 128/256/512, phasor_istft_ola_batch with a (B, F) mask; the
      synthesis on csrc/fft_real.cuh's body at its ends: phasor_istft_ola
      at N = 256 and 4096 (Rs = N/4, masked) against plain and rerun
      bitwise, and a ragged pvoc_fused_batch at N = 2048 (a row of 3
      frames, shorter than the overlap) whose rows are bitwise the single
      kernel's at Rs 256/1024/683; ragged batches at N = 256 and 4096 (a
      row of 4 frames, a row of none, an odd row stride), rows bitwise the
      single kernel's;
  3d. (run after 3c) the golden gate of the parallel entry points (60 s):
      batch_time_stretch_varied at 0.5/1.0/1.5/2.0, chunked_time_stretch
      (force=True) at 0.5x/2.0x, batched_chunked_time_stretch on a (1, 1)
      mesh;
  6. (run after 4e) the select variants of the resampler, the fold
     analysis and the FFT sizes that are not powers of two:
     6a. kernels against their plain versions (60 s): resample_blocked,
         select_lerp and select_lerp_two_level at -13 to +14 st and on an
         output far past the input's end (each also <= 1e-6 from the
         float64 resample_lerp); pvoc_fused_zrev at Rs 512/128/171, against
         zrev=False, reruns bitwise; every FFT kernel at N = 768, 1000,
         1536, 896 (pvoc_fused at 2.0x, 0.5x and the -7 st hop, stft_polar,
         istft_ola, istft_frames, pvoc_terms, phasor_istft_ola); at N = 768
         the stream bitwise equal to the monolithic kernel and the
         64-utterance batch bitwise equal to the single kernel;
     6b. the golden gate (60 s): time_stretch 2.0x / 0.5x and pitch_shift
         -7 st at those four N, fused_time_stretch(zrev=True), pitch_shift
         -7 st under each _SEL_IMPL, and (N, hop) = (1024, 320) through the
         matmul-analysis fallback;
     6c. at real size, with launch counts: pitch_shift -7 st on 300 s
         under "fused", "roll2", "roll" and "matmul" (each against the
         "mxu" result), fused_time_stretch(zrev=True) at 2.0x on 3600 s and
         at Rs = 171 on 300 s, time_stretch 2.0x on 3600 s at N = 1536 and
         the other three sizes beside N = 1024; then the four new kernels
         against their plain versions at those shapes, timed
         (resample_blocked bitwise);
  7. (run after 6c) the q in {2, 4} term algebra's angle domain,
     ops.fused.set_q_algebraic(False), restored after: at Rs = 128, 384,
     64 and 192 (k = 1/2, 3/2, 1/4, 3/4) on 60 s, pvoc_fused,
     pvoc_fused_zrev, pvoc_fused_segment and a ragged pvoc_fused_batch of
     3 rows against their plain versions, zrev, streams (segment_frames
     256 and 8192), batch rows and reruns bitwise, and each output not
     the algebraic one's bits; at Rs = 512 and 256 (q = 1) the algebraic
     bits under both settings; pvoc_terms at Rs = 640 (k = 5/2), scan on
     and off, alone and over a batch of 3 rows (bitwise the single
     kernel); the golden gate (time_stretch 0.5x/1.5x, pitch_shift -5 st,
     branch_policy="fast") on 60 s of tones, the chirp recorded, and one
     0.5x call on the chirp under each setting against golden on the card
     and as the plain version on the CPU; the A/B of ACCURACY_r05.json
     (golden error and correlation at 0.5x/1.5x on 600 s of the chirp,
     device time of one traced 0.5x call on 3600 s, by kernel); the main
     paths at real size under both settings with equal launch counts;
     the six kernels against their plain versions at those shapes, timed
     (the kernels line's "@angle_q2" rows);
  5. determinism: two 2.0x runs, two faithful 0.5x runs, two 3.0x
     general-hop runs, two batch runs, two chunked 0.5x runs, two zrev
     runs, two N = 1000 runs and two runs of each stft.cu kernel at
     N = 256, 1024, 4096 are bitwise equal;
  5_bench. phase_vocoder_tpu_torch.bench.main in this process, 3 timed
     calls a cell, on the cells of PERF.md section 4: 2.0x on 3600 s, the
     checkpointed fused stream at 3600 s, 0.5x on 660 s (the faithful
     route), 3.0x on 3600 s (the general route), pitch -7 st on 300 s, the
     64-utterance batch and --scaling over the cards present at 3600 s a
     card; each bench line printed, each gate green, 0 < vs_baseline <=
     1.05, the card named, the route expected, and the headline's median
     between pvoc_fused's device time of 4b and 1.5 times it.

The bounds, the CUDA-event times of single calls, the profiler's device
time and the peak memory come from phase_vocoder_tpu_torch/utils
(metrics.bound_ms, profiling.time_calls, profile_call, peak_gb), the
definitions the bench uses.

The line before the last holds the per-kernel JSON record (phase 7's
kernels a second time, as "NAME@angle_q2"): each kernel's
launches on its main path, its agreement with its plain version, its time
(for resample_lerp and the three select variants, and for F.interpolate as
their library call, the device time of phase 4b: the mean of 101 calls in
one torch.profiler trace),
the plain version's, one PyTorch call's computing the same function where
there is one (null otherwise), and its bound: the larger of the bytes it
must move over 3.35 TB/s and the FP32 operations its FFTs need (2.5 N
log2 N a real transform) over 67 TFLOP/s. The last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --rank-worker RANK WORLD PORT DIR

is the worker of the two-rank phase (4e).

    python3 chip_smoke.py --ptxas

needs nvcc only: compiles each csrc/*.cu as the build does, with
-Xptxas -v, and prints every kernel's registers, stack frame and spill
bytes as one JSON line; fails if segment_phase_kernel or
resample_blocked_kernel spills.

    python3 chip_smoke.py --ab OTHER_ROOT [--faithful]

compares this checkout's kernels with those of another checkout of the
repository (an earlier commit unpacked at OTHER_ROOT) on one card: four
processes in turn (other, this, this, other), each building its own
checkout's kernels and timing (and for pvoc_fused at 2.0x / 3600 s
reading the peak device memory), at the main paths' shapes, the entries
that run csrc/pvoc_fused.cu's analysis and synthesis passes: pvoc_fused
and pvoc_fused_zrev at 2.0x / 3600 s, pvoc_fused at 2.0x / 3600 s at
every power of two from 256 to 4096 (hop N/4), pvoc_fused_segment (8192
frames), pvoc_fused_batch (the 2.0x group of the 64 utterances),
pvoc_terms at 3.0x / 3600 s and over 8 x 600 s, phasor_istft_ola
(224,997 frames, Rs = 128, masked) and phasor_istft_ola_batch (8 x
37,497, masked) beside torch.istft at the same shapes, phasor_istft_ola
at every power of two from 256 to 4096 (224,997 * 1024 / N random rows,
Rs = N/8) beside torch.istft; then the stft.cu kernels at the main
paths' shapes as a control; and hashing outputs that must not move: the
stft.cu outputs at N = 1024, the sizes that keep the
one-block-a-frame analysis and fft_synthesis (stft/istft and
phasor_istft_ola at N = 768; pvoc_fused at N = 128 with q >= 2),
phasor_istft_ola(_batch) on seeded random planes, the phasor terms
(3.0x / 3600 s scanned, 60 s with unit phasors), q >= 2 at N = 1024 and
Rs = 171 (pvoc_fused, zrev, one stream segment, a ragged batch: the carry
scan of every q >= 2 caller) and select_lerp with and without chunk bases
on seeded tables at strides 0, 1 and 2; every integer-k output
(pvoc_fused, zrev, one stream segment and a ragged batch at N = 256, 1024
and 4096; pvoc_fused at N = 768 and 128), whose closed form is rounded as
written since the phase moved into the synthesis, is hashed as an output
that may move. Also times pvoc_fused and zrev at Rs = 171 on 300 s,
pitch_shift -7 st on 300 s, and select_lerp in both modes beside
F.interpolate (per-call means and profiler device times), and records
pvoc_terms' and the q >= 2 pvoc_fused's passes by name. First of all
it times the branch-faithful route (0.5x and -7 st on 660 s), traces
one call of each (kernels, busy time, idle share, _kernel_split) and
hashes their outputs, which must not move; then times segment_phase at
2f's main shape and resample_blocked at the -7 st / 300 s shape (device
time and per-call events) and hashes their outputs, which must not move;
--faithful stops there.
Prints one JSON line per process and a
summary (speed-ups, hashes, whether this checkout's phasor_istft_ola(_batch)
are ahead of torch.istft); fails if a must-not-move hash differs or a
may-move one differs between this checkout's two runs.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

# One definition of each measurement serves this script and the bench:
# the bound (bytes over 3.35 TB/s or FP32 operations over 67 TFLOP/s,
# whichever is larger), CUDA-event times of single calls, the profiler's
# device time by kernel, and the peak device memory of a call; and the
# inputs: the test signal and the 64-utterance batch of --batch-varied.
from phase_vocoder_tpu_torch.bench import baseline_batch, utterance
from phase_vocoder_tpu_torch.parallel.distributed import free_port
from phase_vocoder_tpu_torch.utils.metrics import bound_ms as _bound
from phase_vocoder_tpu_torch.utils.metrics import fft_flop
from phase_vocoder_tpu_torch.utils import profiling
from phase_vocoder_tpu_torch.utils.profiling import peak_gb as _peak_gb
from phase_vocoder_tpu_torch.utils.profiling import profile_call as _profile_call
from phase_vocoder_tpu_torch.utils.profiling import time_calls as _time_calls

N_FFT, HOP, SR = 1024, 256, 16000
# The FFT sizes that take stft.cu's N/2-point body (csrc/fft_real.cuh).
POW2_SIZES = (256, 512, 1024, 2048, 4096)


def _signal(seconds: float, seed: int = 0) -> np.ndarray:
    """Chirp + tone + noise, float64 in [-1, 1] (tests/conftest.py's signal)."""
    return utterance(seconds, seed, SR)


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


def _plain_stream(x, nf: int, rs: int, F: int, S: int):
    """The fused stream through fused_stream_segment_reference, segment by
    segment, on x's device."""
    from phase_vocoder_tpu_torch import streaming
    from phase_vocoder_tpu_torch.ops.fused import fused_stream_segment_reference

    st = streaming.fused_init_state(N_FFT, rs, x.device)
    carry, tail, outs = st.carry, st.tail, []
    for j in range(S):
        o, carry, tail = fused_stream_segment_reference(
            x, carry, tail, j > 0, j * F, nf, N_FFT, HOP, rs, F)
        outs.append(o)
    return torch.cat(outs)[: (nf - 1) * rs + N_FFT]


def _weighted_phasor_err(k, p) -> dict:
    """stft_phasor_terms against its plain version: |X| relative to max |X|,
    and the phasors P weighted by |X|/max |X| (near-silent bins have an
    ill-conditioned phase in any f32 analysis; the synthesis sees |X| P)."""
    top = float(p[0].abs().max())
    dp = (torch.complex(k[1], k[2]) - torch.complex(p[1], p[2])).abs()
    y_abs = float((torch.complex(k[0] * k[1], k[0] * k[2])
                   - torch.complex(p[0] * p[1], p[0] * p[2])).abs().max())
    return {"mag_rel": float((k[0] - p[0]).abs().max()) / top,
            "p_weighted": float((dp * (p[0] / top)).max()), "y_max_abs": y_abs}


def _terms_errors(k, p) -> dict:
    """Step terms (no scan) and unit phasors of the phasor-terms kernels
    against their plain versions, planes (mag, t_re, t_im, u_re, u_im): |X|
    relative to max |X|; u and the terms weighted by |X|/max |X|. At k = 1/2
    a term whose argument lies within float32 rounding of the principal
    root's branch cut comes out negated in one of two analyses (|difference|
    near 2): those are counted apart (flip_share) and left out of
    t_weighted and of y_max_abs (|X| t, the largest difference left)."""
    top = float(p[0].abs().max())
    w = p[0] / top
    dt = (torch.complex(k[1], k[2]) - torch.complex(p[1], p[2])).abs()
    du = (torch.complex(k[3], k[4]) - torch.complex(p[3], p[4])).abs()
    flip = dt > 1.0
    return {"mag_rel": float((k[0] - p[0]).abs().max()) / top,
            "u_weighted": float((du * w).max()),
            "t_weighted": float(torch.where(flip, 0.0, dt * w).max()),
            "flip_share": float(flip.double().mean()),
            "y_max_abs": float(torch.where(flip, 0.0, dt * p[0]).max())}


def _launches(counters: dict) -> dict:
    """Each kernel's launches so far, by its name in `counters`: the
    registry's launches.<wrapper> (ops/_build.launch)."""
    seen = profiling.counters()
    return {name: seen.get(f"launches.{wrapper.__name__}", 0) for name, wrapper in counters.items()}


def _counted(counters: dict, fn, expect: dict, what: str) -> dict:
    """Run fn() and count every kernel's launches from just before it to
    just after, and check them: exactly `expect` for the kernels it names,
    0 for the others. Returns the counts."""
    torch.cuda.synchronize()
    before = _launches(counters)
    fn()
    got = {name: n - before[name] for name, n in _launches(counters).items()}
    want = {name: expect.get(name, 0) for name in counters}
    _check(got == want, f"{what}: kernel launches {got}, expected {want}")
    return got


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit through an int32 view: signed zeros count."""
    return a.shape == b.shape and bool(torch.equal(a.contiguous().view(torch.int32),
                                                   b.contiguous().view(torch.int32)))


def _tree_combines(n: int) -> int:
    """Combines of ops/phase.py _associative_scan over n rows (its up and
    down sweeps)."""
    up = down = 0
    s = 1
    while n // s >= 2:
        up += n // s // 2
        down += (n // s - 1) // 2
        s *= 2
    return up + down


def _segment_phase_flop(F: int, nb: int) -> float:
    """FP32 operations (additions, subtractions, multiplications, ceil) of
    one segment_phase call, counted from csrc/phase_scan.cu: 87 a term
    (residual_term and the mask), 35 a wrap_add_c combine, 46 a row's
    carry combine, finalize and pin; the tree over F rows padded to a
    power of two (F <= 1024), or over 1024-row blocks, their totals and
    the block prefixes (F > 1024)."""
    if F <= 1024:
        combines = _tree_combines(1 << (F - 1).bit_length())
    else:
        blocks = -(-F // 1024)
        combines = blocks * _tree_combines(1024) + _tree_combines(blocks) + F
    return float(nb * (F * (87 + 46) + 35 * combines))


# What launched a kernel of the branch-faithful step: _kernel_split wraps
# these functions of whichever checkout's package is loaded in profiler
# ranges named "pvoc:<function>" for its traced call, and places each
# kernel's launch in the ranges and torch ops that enclose it in time.
_SPLIT_FUNCS = {
    "streaming": ("stream_time_stretch", "_stream_scan_from", "init_state", "pad_for_segments",
                  "flush_tail", "segment_step", "segment_phase", "istft_ola", "_mask_and_norm"),
    "ops.phase": ("residual_terms_c", "blocked_scan", "wrap_add_c", "finalize_phase", "pin_real_bins"),
    "ops.framing": ("ola_window_norm", "overlap_add"),
    "ops.fft": ("irfft",),
    "pipeline": ("analyze",),
}
# The first rule that matches a function between the launch and
# segment_step names the kernel's category; ops inline in segment_step go
# by their inputs (_inline_category).
_STEP_CALLS = (
    ("mask_and_norm", ("ola_window_norm", "_mask_and_norm")),
    ("istft_ola", ("istft_ola",)),
    ("scan", ("segment_phase", "residual_terms_c", "blocked_scan", "wrap_add_c", "finalize_phase",
              "pin_real_bins")),
    ("synthesis_matmul", ("irfft", "overlap_add")),
)
# The port's kernels by name, for launches outside every range.
_KERNEL_NAMES = (("scan", "segment_phase"), ("istft_ola", "istft"), ("istft_ola", "ola_sum"),
                 ("analysis", "stft"), ("resample", "resample"))


def _by_name(kernel: str) -> str:
    return next((c for c, key in _KERNEL_NAMES if key in kernel), f"unattributed:{kernel[:60]}")


def _inline_category(op, F: int) -> str:
    """An op written in segment_step itself: on 0-dim tensors (started,
    frame_offset; not torch.arange's scalars) the state update; on a 1-D
    tensor longer or shorter than the F frames (the OLA head and tails)
    the epilogue's pads, adds, clamp and division; else (the frames' mask,
    and before segment_phase the valid-term mask and the residual sum;
    cos, sin and the frame mask of the synthesis at Rs = 171)
    "step_inline"."""
    shapes = [sh for sh in (getattr(op, "input_shapes", None) or []) if isinstance(sh, list)]
    if shapes and all(len(sh) == 0 for sh in shapes) and op.name != "aten::arange":
        return "state"
    if any(len(sh) == 1 and sh[0] != F for sh in shapes):
        return "epilogue"
    return "step_inline"


def _call_category(enclosing: list, F: int) -> str | None:
    """The category of a launch from the events that enclose it in time,
    outermost first: "pvoc:" ranges and torch ops. None when no range
    encloses it."""
    funcs, first_op = [], None
    for e in enclosing:
        if e.name.startswith("pvoc:"):
            funcs.append(e.name[5:])
            first_op = None
        elif first_op is None and e.name.startswith("aten::"):
            first_op = e  # the outermost op below the innermost range
    if not funcs:
        return None
    if "segment_step" not in funcs:
        return f"outside_step:{funcs[-1]}"
    inner = funcs[funcs.index("segment_step") + 1:]
    for cat, names in _STEP_CALLS:
        if any(f in names for f in inner):
            return cat
    if inner:
        return f"step_other:{inner[-1]}"
    return _inline_category(first_op, F) if first_op is not None else "step_inline"


def _categorize_launches(events, launches, F: int) -> Counter:
    """Counts by _call_category of `launches`, (CPU time, kernel name)
    pairs, against the intervals of the "pvoc:" ranges and torch's ops in
    `events` (a time sweep: it needs neither the profiler's parent links
    nor its thread ids); a launch outside every range by its name."""
    spans = sorted(((e.time_range.start, e.time_range.end, e) for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith(("pvoc:", "aten::"))),
                   key=lambda t: (t[0], -t[1]))
    counts, stack, i = Counter(), [], 0
    for t, name in sorted(launches, key=lambda x: x[0]):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        cat = _call_category([sp[2] for sp in stack if sp[0] <= t <= sp[1]], F)
        counts[cat or _by_name(name)] += 1
    return counts


def _ranged(fn, label: str):
    def ranged(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return ranged


@contextlib.contextmanager
def _split_ranges():
    """The functions of _SPLIT_FUNCS, in the package loaded now, inside
    "pvoc:<name>" profiler ranges while the block runs."""
    import importlib

    saved = []
    for mod_name, names in _SPLIT_FUNCS.items():
        mod = importlib.import_module(f"phase_vocoder_tpu_torch.{mod_name}")
        for name in names:
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, _ranged(getattr(mod, name), f"pvoc:{name}"))
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def _kernel_split(fn, F: int) -> dict:
    """Device kernels of one traced call of fn() (two calls traced and
    discarded first, as utils/profiling.py profile_call does), counted by
    what launched them. For the traced calls the functions of
    _SPLIT_FUNCS, in the package loaded now, run inside "pvoc:<name>"
    profiler ranges; each kernel's CUDA runtime call (the CPU event of the
    same correlation id) is placed in the ranges and torch ops that
    enclose it (_categorize_launches; F, the segment's frames, tells the
    inline epilogue's 1-D tensors from the frames' mask). Returns the
    counts, their total, the count of device kernels, how many were placed
    by their runtime call, and the kernel names by count."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with _split_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                                  schedule=schedule(wait=0, warmup=2, active=1, repeat=1)) as prof:
        for _ in range(3):
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            prof.step()
    events = prof.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith(("ProfilerStep", "pvoc:"))]
    runtime = {e.id: e for e in events if e.device_type == cpu and e.name.startswith("cu")}
    launches = [(runtime[k.id].time_range.start if k.id in runtime else -1.0, k.name) for k in kernels]
    placed = [x for x in launches if x[0] >= 0]
    split = _categorize_launches(events, placed, F)
    split.update(_by_name(name) for t, name in launches if t < 0)
    return {"by_category": dict(split), "total": sum(split.values()), "device_kernels": len(kernels),
            "placed_by_runtime_call": len(placed),
            "by_name": dict(Counter(k.name[:90] for k in kernels).most_common(12))}


class _Clock:
    """Accumulates the host seconds spent in wrapped functions, and the
    device seconds between CUDA events recorded around others."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.seconds, self.events = {}, []

    def wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed

    def wrap_device(self, fn):
        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*a, **k)
            finally:
                end.record()
                self.events.append((start, end))
        return timed

    def read(self) -> dict:
        torch.cuda.synchronize()
        return {**self.seconds,
                "device_s": sum(s.elapsed_time(e) for s, e in self.events) / 1e3}


def _dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


_START = time.perf_counter()


def _emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - _START, **rec}), flush=True)


# A real N-point FFT: 2.5 N log2 N FP32 operations.
_FFT_FLOP = fft_flop(N_FFT)


def _rank_worker(argv: list) -> int:
    """One of the two ranks of phase 4e: chunked_time_stretch of the 60 s
    signal at 2.0x and 0.5x over a gloo group on the one card; saves the
    output and this process's kernel launches."""
    from phase_vocoder_tpu_torch.ops import fused
    from phase_vocoder_tpu_torch.parallel import chunked, distributed

    rank, world, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=240)
    try:
        x = torch.as_tensor(_signal(60.0), dtype=torch.float32, device="cuda")
        mesh = distributed.global_mesh("seq")
        res = {}
        wrappers = {w.__name__: w for w in (fused.fused_stream_segment, fused.stft_phasor_terms,
                                              fused.phasor_istft_ola)}
        for s in (2.0, 0.5):
            before = _launches(wrappers)
            y = chunked.chunked_time_stretch(x, s, mesh=mesh)
            torch.cuda.synchronize()
            res[f"y{s}"] = y.cpu().numpy()
            res[f"launches{s}"] = np.array([n - before[k] for k, n in _launches(wrappers).items()])
        np.savez(f"{out}/rank{rank}.npz", device=torch.cuda.get_device_name(0), **res)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _run_ranks(world: int, timeout: float) -> list:
    """Run _rank_worker in `world` processes of this script; kill them all
    past `timeout` seconds or on the first failure. Returns their saves."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="pvoc_ranks_") as tmp:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank-worker", str(r), str(world), str(port), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            logs = [p.communicate()[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            _check(p.returncode == 0, f"rank {r} of {world} failed (rc {p.returncode}):\n{log[-3000:]}")
        return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(world)]


def _ab_worker(root: str, faithful_only: bool = False) -> int:
    """Time the kernels of the checkout at `root` that run the analysis and
    the synthesis of csrc/pvoc_fused.cu, the synthesis beside torch.istft,
    and the stft.cu kernels as a control; hash the outputs that must not
    move and those that may. First the branch-faithful route (0.5x and
    -7 st on 660 s): its calls timed, one traced call's kernels, idle
    share and kernel split, its outputs hashed (must not move); with
    `faithful_only` nothing else. One JSON line."""
    import hashlib

    # The timing helpers and input builders brought this checkout's package
    # in; import the other checkout's in its place (the helpers need only
    # torch and numpy).
    for name in [m for m in sys.modules if m.split(".")[0] == "phase_vocoder_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    import phase_vocoder_tpu_torch as pv
    from phase_vocoder_tpu_torch import streaming
    from phase_vocoder_tpu_torch.ops import fused, resample, stft
    from phase_vocoder_tpu_torch.ops import _build

    _check(pv.__file__.startswith(root), f"imported {pv.__file__}, not from {root}")
    _build.kernels()
    dev = torch.device("cuda")
    cfg = pv.PvocConfig()
    rec = {"root": root, "card": torch.cuda.get_device_name(0)}
    digest = lambda *ts: hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()  # noqa: E731
    # The branch-faithful route through "auto" on 660 s (41 segments of
    # 1024 frames): the median of 3 calls between CUDA events, one traced
    # call, what launched its kernels, and the outputs' hashes.
    x_ff = torch.as_tensor(_signal(660.0, seed=2), dtype=torch.float32, device=dev)
    for name, fn in (("faithful_0.5x_660s", lambda: pv.time_stretch(x_ff, 0.5, cfg)),
                     ("faithful_m7_660s", lambda: pv.pitch_shift(x_ff, -7.0, cfg))):
        calls = _time_calls(fn, reps=3)
        rec[f"{name}_ms"] = float(np.median(calls))
        rec[f"{name}_calls"] = calls
        prof = _profile_call(fn)
        rec[f"{name}_profile"] = {k: prof[k] for k in ("kernels", "device_busy_ms", "device_span_ms", "idle_share")}
        rec[f"{name}_split"] = _kernel_split(fn, streaming.DEFAULT_SEGMENT_FRAMES)
        rec[f"hash_{name}"] = digest(fn())
    del x_ff
    # segment_phase at 2f's main shape (1024 frames, N = 1024, Rs = 128, a
    # mid-stream state, seeded phases) and resample_blocked at the -7 st /
    # 300 s shape (the q >= 2 stretch's output, itself a must-not-move
    # hash below): the device time of 101 calls in one trace, the mean of
    # 101 single calls between CUDA events, and the outputs' hashes (must
    # not move).
    from phase_vocoder_tpu_torch.ops import phase as phase_ops

    gp = np.random.default_rng(11)
    nb = N_FFT // 2 + 1
    ph_u = lambda *s: torch.as_tensor(gp.uniform(-np.pi, np.pi, s).astype(np.float32), device=dev)  # noqa: E731
    sp_args = (ph_u(1024, nb), ph_u(nb), ph_u(nb),
               torch.as_tensor((gp.standard_normal(nb) * 1e-7).astype(np.float32), device=dev), ph_u(nb))
    sp_kw = dict(ra=HOP, rs=128, n_fft=N_FFT, frame_offset=2048, n_valid=1024, started=True)
    sp_fn = lambda: phase_ops.segment_phase(*sp_args, **sp_kw)  # noqa: E731
    rec["segment_phase_2f_device_ms"] = _profile_call(sp_fn, reps=101)["device_busy_ms"]
    rec["segment_phase_2f_events_ms"] = _time_ms(sp_fn, reps=101)
    rec["hash_segment_phase_2f"] = digest(*sp_fn())
    x_p = torch.as_tensor(_signal(300.0, seed=1), dtype=torch.float32, device=dev)
    factor = 2.0 ** (-7 / 12)
    y_p = fused.fused_time_stretch(x_p, N_FFT, HOP, cfg.synthesis_hop(factor))
    n_out = int(round(len(y_p) / factor))
    bt = resample.block_tables(1.0 / factor, n_out, dev)
    rb_fn = lambda: resample.resample_blocked(y_p, *bt, n_out)  # noqa: E731
    rec["resample_blocked_m7_device_ms"] = _profile_call(rb_fn, reps=101)["device_busy_ms"]
    rec["resample_blocked_m7_events_ms"] = _time_ms(rb_fn, reps=101)
    rec["hash_resample_blocked_m7"] = digest(rb_fn())
    del sp_args, x_p, y_p, bt
    if faithful_only:
        print(json.dumps(rec), flush=True)
        return 0
    hann = torch.hann_window(N_FFT, device=dev)
    x_long = torch.as_tensor(_signal(3600.0), dtype=torch.float32, device=dev)
    # The entries that run pvoc_fused.cu's analysis and synthesis passes,
    # at the main paths' shapes: pvoc_fused and its zrev variant at 2.0x /
    # 3600 s, one 8192-frame stream segment, the 2.0x group of the
    # 64-utterance batch.
    rec["pvoc_fused_2x_3600s_ms"] = _time_ms(lambda: fused.fused_time_stretch(x_long, N_FFT, HOP, 512), reps=5)
    rec["pvoc_fused_2x_3600s_peak_gb"] = _peak_gb(lambda: fused.fused_time_stretch(x_long, N_FFT, HOP, 512))
    rec["pvoc_fused_zrev_2x_3600s_ms"] = _time_ms(
        lambda: fused.fused_time_stretch(x_long, N_FFT, HOP, 512, zrev=True), reps=5)
    nf_long = (len(x_long) - N_FFT) // HOP + 1
    F_long, _ = streaming.fused_plan_segments(nf_long, N_FFT, 512, streaming.DEFAULT_FUSED_SEGMENT_FRAMES)
    _, st10 = streaming._fused_scan_from(
        x_long, streaming.fused_init_state(N_FFT, 512, dev), nf_long, N_FFT, HOP, 512, F_long, 10)
    seg_args = (x_long, st10.carry, st10.tail, 1, 10 * F_long, nf_long, N_FFT, HOP, 512, F_long)
    rec["pvoc_fused_segment_8192_ms"] = _time_ms(lambda: fused.fused_stream_segment(*seg_args), reps=20)
    del st10, seg_args
    rows = [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in baseline_batch(SR)[0][5::6]]  # the 2.0x utterances of chip_smoke.py's batch
    t_max = max(len(x) for x in rows)
    xb = torch.stack([torch.nn.functional.pad(x, (0, t_max - len(x))) for x in rows])
    nfs_b = [(len(x) - N_FFT) // HOP + 1 for x in rows]
    rec["pvoc_fused_batch_2x_group_ms"] = _time_ms(
        lambda: fused.fused_time_stretch_batch(xb, N_FFT, HOP, 512, nfs_b), reps=20)
    del rows, xb
    # pvoc_fused at 2.0x on 3600 s at every N of fft_real.cuh's body (hop
    # N/4, Rs = N/2), and the phasor terms at the shapes of their main
    # paths: 3.0x / 3600 s scanned (row 6) and 8 x 600 s, unit phasors, no
    # scan (row 7).
    for n in POW2_SIZES:
        rec[f"pvoc_fused_2x_3600s_N{n}_ms"] = _time_ms(
            lambda: fused.fused_time_stretch(x_long, n, n // 4, n // 2), reps=5)
    rec["pvoc_terms_3x_3600s_ms"] = _time_ms(lambda: fused.stft_phasor_terms(x_long, N_FFT, HOP, 768), reps=5)
    xs8 = torch.stack([x_long[i * 428 * SR : (i * 428 + 600) * SR] for i in range(8)])
    rec["pvoc_terms_batch_8x600s_ms"] = _time_ms(
        lambda: fused.stft_phasor_terms_batch(xs8, N_FFT, HOP, 128, scan=False, return_u=True), reps=5)
    rec["pvoc_terms_3x_3600s_passes"] = _profile_call(
        lambda: fused.stft_phasor_terms(x_long, N_FFT, HOP, 768))["by_kernel_ms"]
    rec["pvoc_terms_batch_8x600s_passes"] = _profile_call(
        lambda: fused.stft_phasor_terms_batch(xs8, N_FFT, HOP, 128, scan=False, return_u=True))["by_kernel_ms"]
    # The q >= 2 TSM, whose carry scan is pvoc_terms' (run_scan): pvoc_fused
    # and zrev at -7 st (Rs = 171) on 300 s, by pass from one trace, and
    # pitch_shift -7 st on 300 s through the public API (with its
    # resample_lerp).
    x_pitch = torch.as_tensor(_signal(300.0, seed=1), dtype=torch.float32, device=dev)
    rs_p = cfg.synthesis_hop(2.0 ** (-7 / 12))
    rec["pvoc_fused_rs171_300s_ms"] = _time_ms(lambda: fused.fused_time_stretch(x_pitch, N_FFT, HOP, rs_p), reps=10)
    rec["pvoc_fused_zrev_rs171_300s_ms"] = _time_ms(
        lambda: fused.fused_time_stretch(x_pitch, N_FFT, HOP, rs_p, zrev=True), reps=10)
    rec["pvoc_fused_rs171_300s_passes"] = _profile_call(
        lambda: fused.fused_time_stretch(x_pitch, N_FFT, HOP, rs_p))["by_kernel_ms"]
    rec["pitch_m7_300s_ms"] = _time_ms(lambda: pv.pitch_shift(x_pitch, -7.0, cfg), reps=10)
    # select_lerp with and without chunk bases on the -7 st shape's tables,
    # beside F.interpolate: the mean of 101 calls between CUDA events (host
    # time of the wrappers included) and the device time of 101 calls from
    # one torch.profiler trace.
    factor = 2.0 ** (-7 / 12)
    y_st = fused.fused_time_stretch(x_pitch, N_FFT, HOP, rs_p)
    out_len = int(round(len(y_st) / factor))
    t1 = resample.select_tables(1.0 / factor, out_len, len(y_st), "roll", dev)
    t2 = resample.select_tables(1.0 / factor, out_len, len(y_st), "roll2", dev)
    for name, fn in (
        ("select_lerp", lambda: resample.select_lerp(y_st, t1["origin"], t1["k"], t1["fr"], t1["c"])),
        ("select_lerp_roll2", lambda: resample.select_lerp_two_level(y_st, t2["origin"], t2["bases"], t2["k"],
                                                                     t2["fr"], t2["c"])),
        ("F_interpolate", lambda: torch.nn.functional.interpolate(y_st[None, None], size=out_len, mode="linear",
                                                                  align_corners=True)),
    ):
        rec[f"{name}_m7_300s_ms"] = _time_ms(fn, reps=101)
        rec[f"{name}_m7_300s_device_ms"] = _profile_call(fn, reps=101)["device_busy_ms"]
    del y_st, t1, t2
    # phasor_istft_ola on 224,997 frames of 0.5x phasors, Rs = 128, the
    # mask of one rank (ones); phasor_istft_ola_batch on 8 x 37,497 frames
    # of 600 s pieces; torch.istft at each shape.
    mag, pre, pim, nf = fused.stft_phasor_terms(x_long, N_FFT, HOP, 128)
    ones = torch.ones(nf, device=dev)
    rec["phasor_istft_ola_ms"] = _time_ms(lambda: fused.phasor_istft_ola(mag, pre, pim, N_FFT, 128, nf, ones), reps=10)
    y_c = torch.complex(mag * pre, mag * pim).T.contiguous()
    rec["torch_istft_ms"] = _time_ms(lambda: torch.istft(y_c, N_FFT, 128, window=hann, center=True), reps=10)
    del mag, pre, pim, y_c
    kb = fused.stft_phasor_terms_batch(xs8, N_FFT, HOP, 128)
    ones8 = torch.ones((8, kb[-1]), device=dev)
    rec["phasor_istft_ola_batch_ms"] = _time_ms(
        lambda: fused.phasor_istft_ola_batch(*kb[:3], N_FFT, 128, kb[-1], ones8), reps=10)
    y8 = torch.complex(kb[0] * kb[1], kb[0] * kb[2]).transpose(1, 2).contiguous()
    rec["torch_istft_batch_ms"] = _time_ms(lambda: torch.istft(y8, N_FFT, 128, window=hann, center=True), reps=10)
    del kb, y8, xs8
    # phasor_istft_ola at every N of the new body: 224,997 * 1024 / N rows
    # of random planes, Rs = N/8, masked; torch.istft beside it.
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for n in POW2_SIZES:
        rows_n = 224997 * N_FFT // n
        a = torch.rand((rows_n, n // 2 + 1), device=dev, generator=g)
        ph = torch.rand(a.shape, device=dev, generator=g) * (2 * np.pi)
        c, s_ = torch.cos(ph), torch.sin(ph)
        del ph
        ones_n = torch.ones(rows_n, device=dev)
        rec[f"phasor_istft_ola_N{n}_ms"] = _time_ms(
            lambda: fused.phasor_istft_ola(a, c, s_, n, n // 8, rows_n, ones_n), reps=5)
        y_n = torch.complex(a * c, a * s_).T.contiguous()
        del a, c, s_
        win = torch.hann_window(n, device=dev)
        rec[f"torch_istft_N{n}_ms"] = _time_ms(lambda: torch.istft(y_n, n, n // 8, window=win, center=True), reps=5)
        del y_n
    # Controls: the stft.cu kernels at the main paths' shapes (not changed).
    nf_a = 41984
    x = torch.zeros((nf_a - 1) * HOP + N_FFT, device=dev)
    x[: 660 * SR] = torch.as_tensor(_signal(660.0, seed=2), dtype=torch.float32, device=dev)
    rec["stft_polar_ms"] = _time_ms(lambda: stft.stft_polar(x, N_FFT, HOP), reps=20)
    rec["torch_stft_ms"] = _time_ms(lambda: torch.stft(x, N_FFT, HOP, window=hann, center=False,
                                                       return_complex=True), reps=20)
    rec["stft_fused_ms"] = _time_ms(lambda: stft.stft_fused(x, N_FFT, HOP), reps=20)
    m_a, p_a = stft.stft_polar(x, N_FFT, HOP)
    m_, p_ = m_a[:1024].contiguous(), p_a[:1024].contiguous()
    rec["istft_ola_1024_ms"] = _time_ms(lambda: stft.istft_ola(m_, p_, N_FFT, 128), reps=50)
    kt = fused.stft_phasor_terms(x_long, N_FFT, HOP, 768)
    y_re, y_im = kt[0] * kt[1], kt[0] * kt[2]
    rec["istft_frames_cart_ms"] = _time_ms(lambda: stft.istft_frames_cart(y_re, y_im, N_FFT), reps=10)
    del y_re, y_im
    # Outputs that must not move: the stft.cu kernels at N = 1024 (their
    # analysis keeps its own body; only its span loader moved into
    # fft_real.cuh), and the sizes that
    # keep the one-block-a-frame analysis and fft_synthesis (768: the mixed
    # radix; 128: radix 2, below fft_real.cuh's sizes); the phasor terms
    # (3.0x / 3600 s, scanned; 60 s, terms and unit phasors), whose chunk
    # passes keep the roundings of the passes they replaced.
    x60 = x_long[: 60 * SR]
    rec["hash_terms_3x_3600s"] = digest(*kt[:3])
    rec["hash_terms_unscanned_u_60s"] = digest(*fused.stft_phasor_terms(x60, N_FFT, HOP, 768, scan=False,
                                                                         return_u=True)[:5])
    del kt
    # istft_frames_cart hashed on stft.cu's own spectra (stft_fused), so
    # that the hash reads stft.cu alone, not the phasor terms.
    r_a, i_a = stft.stft_fused(x, N_FFT, HOP)
    rec["hash_stft_cu_1024"] = digest(m_a, p_a, r_a, i_a, stft.istft_ola(m_, p_, N_FFT, 128),
                                      stft.istft_frames(m_, p_, N_FFT), stft.istft_frames_cart(r_a, i_a, N_FFT))
    del x, m_a, p_a, r_a, i_a
    # Integer k at N = 768 and 128 (phase_closed): its closed form is
    # rounded as written since this checkout (closed_bin), so it may move.
    rec["moved_pvoc_fused_768_2x_3600s"] = digest(fused.fused_time_stretch(x_long, 768, 192, 384))
    m768, p768 = stft.stft_polar(x60, 768, 192)
    rec["hash_n768_stft_istft"] = digest(m768, p768, stft.istft_frames(m768, p768, 768),
                                         stft.istft_ola(m768, p768, 768, 96))
    t768 = fused.stft_phasor_terms(x60, 768, 192, 96)
    rec["hash_n768_phasor_istft_ola"] = digest(fused.phasor_istft_ola(*t768[:3], 768, 96, t768[3]),
                                               fused.fused_time_stretch(x60, 768, 192, 128))
    rec["moved_n128_pvoc_fused_int_k"] = digest(fused.fused_time_stretch(x60, 128, 32, 64))
    rec["hash_n128_pvoc_fused_rs21"] = digest(fused.fused_time_stretch(x60, 128, 32, 21))
    # Integer k at N = 256, 1024 and 4096 (2.0x, hop N/4; the closed-form
    # phase in synth_real's load and the row gather, against the parent's
    # phase_closed pass and per-sample gather): pvoc_fused, zrev, one
    # segment from a state two segments in, a ragged batch (may move: the
    # closed form is rounded as written, closed_bin); then
    # phasor_istft_ola(_batch) on seeded random planes, with and without a
    # mask, which must give another checkout's bits (the gather keeps each
    # sample's order).
    for n in (256, 1024, 4096):
        hop, rs = n // 4, n // 2
        nf60 = (len(x60) - n) // hop + 1
        F_n, _ = streaming.fused_plan_segments(nf60, n, rs, 256)
        _, st2 = streaming._fused_scan_from(x60, streaming.fused_init_state(n, rs, dev), nf60, n, hop, rs,
                                            F_n, 2)
        seg = fused.fused_stream_segment(x60, st2.carry, st2.tail, 1, 2 * F_n, nf60, n, hop, rs, F_n)
        rows_n = [x60[: 20 * SR], x60[5 * SR : 12 * SR], x60[: n + 3 * hop]]
        xb_n = torch.stack([torch.nn.functional.pad(r, (0, len(rows_n[0]) - len(r))) for r in rows_n])
        nfs_n = [(len(r) - n) // hop + 1 for r in rows_n]
        rec[f"moved_int_k_N{n}"] = digest(fused.fused_time_stretch(x60, n, hop, rs),
                                         fused.fused_time_stretch(x60, n, hop, rs, zrev=True), *seg,
                                         fused.fused_time_stretch_batch(xb_n, n, hop, rs, nfs_n))
    # q >= 2 at N = 1024, Rs = 171 (the carry scan through run_scan):
    # pvoc_fused, zrev, one segment from a state two segments in, a ragged
    # batch; must give another checkout's bits.
    nf60 = (len(x60) - N_FFT) // HOP + 1
    F_q, _ = streaming.fused_plan_segments(nf60, N_FFT, 171, 256)
    _, st2 = streaming._fused_scan_from(x60, streaming.fused_init_state(N_FFT, 171, dev), nf60, N_FFT, HOP, 171,
                                        F_q, 2)
    seg = fused.fused_stream_segment(x60, st2.carry, st2.tail, 1, 2 * F_q, nf60, N_FFT, HOP, 171, F_q)
    rows_q = [x60[: 20 * SR], x60[5 * SR : 12 * SR], x60[: N_FFT + 3 * HOP]]
    xb_q = torch.stack([torch.nn.functional.pad(r, (0, len(rows_q[0]) - len(r))) for r in rows_q])
    rec["hash_q2_rs171_N1024"] = digest(
        fused.fused_time_stretch(x60, N_FFT, HOP, 171), fused.fused_time_stretch(x60, N_FFT, HOP, 171, zrev=True),
        *seg, fused.fused_time_stretch_batch(xb_q, N_FFT, HOP, 171, [(len(r) - N_FFT) // HOP + 1 for r in rows_q]))
    del st2, seg, xb_q
    # select_lerp with and without chunk bases on seeded random input, at
    # steps of each stride c = 1, 1, 0 and 2 (select_tables' "roll" and
    # "roll2" tables); must give another checkout's bits.
    gs = torch.Generator(device=dev)
    gs.manual_seed(2)
    xs_sel = torch.rand(200_000, device=dev, generator=gs) * 2.0 - 1.0
    sel_outs = []
    for fac in (2.0 ** (7 / 12), 2.0 ** (-7 / 12), 1.0 / 0.3, 1.0 / 2.7):
        n_out = int(len(xs_sel) * fac) + 77
        for impl in ("roll", "roll2"):
            t = resample.select_tables(fac, n_out, len(xs_sel), impl, dev)
            sel_outs.append(resample.select_lerp_two_level(xs_sel, t["origin"], t["bases"], t["k"], t["fr"], t["c"])
                            if "bases" in t else resample.select_lerp(xs_sel, t["origin"], t["k"], t["fr"], t["c"]))
    rec["hash_select_lerp"] = digest(*sel_outs)
    del xs_sel, sel_outs
    g1 = torch.Generator(device=dev)
    g1.manual_seed(1)
    nb = N_FFT // 2 + 1
    a = torch.rand((2, 3000, nb), device=dev, generator=g1)
    ph = torch.rand(a.shape, device=dev, generator=g1) * (2 * np.pi)
    c, s_ = torch.cos(ph), torch.sin(ph)
    mask = (torch.rand((2, 3000), device=dev, generator=g1) > 0.1).float()
    rec["hash_phasor_istft_ola"] = digest(
        fused.phasor_istft_ola(a[0], c[0], s_[0], N_FFT, 128, 3000),
        fused.phasor_istft_ola(a[0], c[0], s_[0], N_FFT, 128, 3000, mask[0]),
        fused.phasor_istft_ola_batch(a, c, s_, N_FFT, 256, 2900, mask))
    print(json.dumps(rec), flush=True)
    return 0


def _ptxas() -> int:
    """Compile each csrc/*.cu as the build does, with -Xptxas -v; print one
    JSON line: every kernel's registers, stack frame and spill bytes."""
    import os
    import re
    import tempfile

    from phase_vocoder_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(_build.CSRC.glob("*.cu")):
            out = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", f"{tmp}/k.o", str(src)],
                                 capture_output=True, text=True, timeout=900)
            _check(out.returncode == 0, f"nvcc {src.name}:\n{out.stderr[-3000:]}")
            cur = None
            for line in (out.stdout + out.stderr).splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    cur = m.group(1)
                    res[cur] = {"source": src.name}
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m and cur:
                    res[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", line)
                if m and cur:
                    res[cur]["registers"] = int(m.group(1))
    if os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(res), capture_output=True, text=True).stdout.splitlines()
        res = {name.replace("(anonymous namespace)::", ""): v for name, v in zip(names, res.values())}
    print(json.dumps({"ptxas": res}), flush=True)
    for name, v in res.items():
        if "segment_phase_kernel" in name or "resample_blocked_kernel" in name:
            _check(v.get("spill_stores", 0) == 0 and v.get("spill_loads", 0) == 0, f"{name} spills: {v}")
    return 0


def _ab(other: str, faithful_only: bool = False) -> int:
    """Run _ab_worker for `other`, this checkout, this, `other`; summarize."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    recs = []
    for root in (other, here, here, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--ab-worker", root]
                             + ["--faithful"] * faithful_only, capture_output=True, text=True, timeout=900)
        _check(out.returncode == 0, f"ab worker for {root} failed:\n{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        recs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(recs[-1]), flush=True)
    hashes = [k for k in recs[0] if k.startswith("hash_")]
    same = {k: len({r[k] for r in recs}) == 1 for k in hashes}
    # Hashes of outputs that this checkout may move: equal within each
    # checkout, and whether they equal the other's.
    moved = {k: {"this_reruns_equal": recs[1].get(k) == recs[2].get(k),
                 "equal_to_other": recs[0].get(k) == recs[1].get(k)}
             for k in recs[1] if k.startswith("moved_")}
    summary = {}
    for k in recs[1]:
        if k.endswith("_ms") and k in recs[0]:
            mine = [recs[1][k], recs[2][k]]
            theirs = [recs[0][k], recs[3][k]]
            summary[k] = {"this": mine, "other": theirs, "speedup": sum(theirs) / sum(mine)}
    ahead = {k: recs[1][k] < recs[1][lib] and recs[2][k] < recs[2][lib]
             for k, lib in (("phasor_istft_ola_ms", "torch_istft_ms"),
                            ("phasor_istft_ola_batch_ms", "torch_istft_batch_ms")) if k in recs[1]}
    peak = {k: {"this": [recs[1][k], recs[2][k]], "other": [recs[0].get(k), recs[3].get(k)]}
            for k in recs[1] if k.endswith("_peak_gb")}
    print(json.dumps({"ab_summary": summary, "bitwise_equal": same, "may_move": moved,
                      "peak_gb": peak, "this_ahead_of_torch_istft": ahead}), flush=True)
    _check(all(same.values()), f"outputs moved: {same}")
    _check(all(v["this_reruns_equal"] for v in moved.values()), f"outputs differ between two runs: {moved}")
    return 0


@contextlib.contextmanager
def _q_algebra(enabled: bool):
    """ops.fused.set_q_algebraic(enabled) inside the block, the switch as
    it was after it."""
    from phase_vocoder_tpu_torch.ops import fused

    before = fused._Q_ALGEBRAIC
    fused.set_q_algebraic(enabled)
    try:
        yield
    finally:
        fused.set_q_algebraic(before)


def _profiled(fn, reps: int = 1, kernels: int | None = None) -> dict:
    """_profile_call(fn, reps), traced again (up to 3 traces) when the
    profiler dropped the step's kernels: it raised for want of any, or
    recorded other than `kernels` a call."""
    for attempt in range(3):
        try:
            prof = _profile_call(fn, reps=reps)
        except RuntimeError as e:
            if "recorded no device kernel" not in str(e) or attempt == 2:
                raise
            continue
        if kernels is None or prof["kernels"] == kernels or attempt == 2:
            return prof


def _corr(a, b, edge=N_FFT) -> float:
    return float(np.corrcoef(_interior(a, edge).numpy(), _interior(b, edge).numpy())[0, 1])


def _q_algebraic_phase(smi: str, counters: dict, cfg, dev) -> list:
    """Phase 7: the q in {2, 4} term algebra's angle domain
    (set_q_algebraic(False)) through every phasor kernel, at N = 1024,
    Ra = 256. Returns the kernels-line rows of the kernels it ran."""
    from golden import pv_ref
    import phase_vocoder_tpu_torch as pv
    from phase_vocoder_tpu_torch import streaming
    from phase_vocoder_tpu_torch.ops.fused import (
        fused_stream_segment,
        fused_stream_segment_reference,
        fused_time_stretch,
        fused_time_stretch_batch,
        fused_time_stretch_batch_reference,
        fused_time_stretch_reference,
        stft_phasor_terms,
        stft_phasor_terms_batch,
        stft_phasor_terms_batch_reference,
        stft_phasor_terms_reference,
    )
    from phase_vocoder_tpu_torch.parallel import chunked
    from phase_vocoder_tpu_torch.parallel.mesh import make_mesh_2d

    x60_np = _signal(60.0)
    x60 = torch.as_tensor(x60_np, dtype=torch.float32, device=dev)
    nf60 = (len(x60) - N_FFT) // HOP + 1
    # A ragged batch of 3 rows: 60 s, 37 s and 3 frames (fewer than the
    # overlap m - 1 at Rs = 64, 128 and 192).
    lens_b = [len(x60), int(37.0 * SR), 1600]
    xs_b = torch.zeros((3, len(x60)), device=dev)
    for i, n in enumerate(lens_b):
        xs_b[i, :n] = torch.as_tensor(_signal(n / SR + 1.0, seed=40 + i)[:n], dtype=torch.float32, device=dev)
    nfs_b = [(n - N_FFT) // HOP + 1 for n in lens_b]

    def contracts(rs: int) -> dict:
        """The kernels at hop rs under the current switch: outputs, and the
        bitwise contracts (rerun, zrev, streams, batch rows)."""
        mono = fused_time_stretch(x60, N_FFT, HOP, rs)
        zrev = fused_time_stretch(x60, N_FFT, HOP, rs, zrev=True)
        batch = fused_time_stretch_batch(xs_b, N_FFT, HOP, rs, nfs_b)
        rec = {"rerun_bitwise": _bits_equal(fused_time_stretch(x60, N_FFT, HOP, rs), mono),
               "zrev_bitwise": _bits_equal(zrev, mono),
               "zrev_rerun_bitwise": _bits_equal(fused_time_stretch(x60, N_FFT, HOP, rs, zrev=True), zrev),
               "batch_rerun_bitwise": _bits_equal(fused_time_stretch_batch(xs_b, N_FFT, HOP, rs, nfs_b), batch)}
        for sf in (256, 8192):
            rec[f"stream{sf}_bitwise"] = _bits_equal(
                streaming.fused_stream_time_stretch(x60, rs / HOP, cfg, segment_frames=sf), mono)
        for b, nf_b in enumerate(nfs_b):
            n_out = (nf_b - 1) * rs + N_FFT
            rec[f"batch_row{b}_bitwise"] = bool(
                _bits_equal(batch[b, :n_out], fused_time_stretch(xs_b[b, : lens_b[b]].contiguous(), N_FFT, HOP, rs))
                and (batch[b, n_out:] == 0).all())
        return rec, mono, batch

    # ---- kernels against their plain versions, 60 s, the switch False;
    # each output also against the same kernel's under True: not the same
    # bits at q >= 2, the same bits at q = 1 (Rs = 512, 256).
    out = {}
    try:
        for rs in (128, 384, 64, 192, 512, 256):
            with _q_algebra(True):
                _, mono_t, batch_t = contracts(rs)
                stream_t = streaming.fused_stream_time_stretch(x60, rs / HOP, cfg, segment_frames=256)
            with _q_algebra(False):
                rec, mono, batch = contracts(rs)
                q1 = rs % HOP == 0
                rec["same_bits_as_algebraic"] = _bits_equal(mono, mono_t)
                rec["batch_same_bits_as_algebraic"] = _bits_equal(batch, batch_t)
                rec["stream_same_bits_as_algebraic"] = _bits_equal(
                    streaming.fused_stream_time_stretch(x60, rs / HOP, cfg, segment_frames=256), stream_t)
                bitwise = [v for k, v in rec.items() if k.endswith("_bitwise")]
                _check(all(bitwise), f"angle domain at Rs={rs}: bitwise contracts {rec}")
                want_same = [rec["same_bits_as_algebraic"], rec["batch_same_bits_as_algebraic"],
                             rec["stream_same_bits_as_algebraic"]]
                _check(all(want_same) if q1 else not any(want_same),
                       f"the switch at Rs={rs} ({'q = 1: must not' if q1 else 'q >= 2: must'} change bits): {rec}")
                if not q1:
                    bound = 5e-5  # 2a, 2c and 2e's bound at q >= 2
                    plain = fused_time_stretch_reference(x60, N_FFT, HOP, rs)
                    rec["rel"] = _rel(mono, plain)
                    rec["zrev_rel"] = _rel(fused_time_stretch(x60, N_FFT, HOP, rs, zrev=True),
                                           fused_time_stretch_reference(x60, N_FFT, HOP, rs, zrev=True))
                    pb = fused_time_stretch_batch_reference(xs_b, N_FFT, HOP, rs, nfs_b)
                    rec["batch_rel"] = max(
                        _rel(batch[b, :n], pb[b, :n], N_FFT if n > 3 * N_FFT else 0)
                        for b, n in enumerate((nf_b - 1) * rs + N_FFT for nf_b in nfs_b))
                    F, _ = streaming.fused_plan_segments(nf60, N_FFT, rs, 1024)
                    _, mid = streaming._fused_scan_from(
                        x60, streaming.fused_init_state(N_FFT, rs, dev), nf60, N_FFT, HOP, rs, F, 2)
                    args = (x60, mid.carry, mid.tail, 1, 2 * F, nf60, N_FFT, HOP, rs, F)
                    ka, _, kt = fused_stream_segment(*args)
                    pa, _, pt = fused_stream_segment_reference(*args)
                    rec["segment_rel"] = max(_rel(ka, pa, 0), _rel(kt.reshape(-1), pt.reshape(-1), 0))
                    worst = max(rec[k] for k in ("rel", "zrev_rel", "batch_rel", "segment_rel"))
                    _check(worst < bound, f"angle domain at Rs={rs} vs the plain versions: {rec}")
                    del plain, pb, ka, pa, kt, pt
            out[rs] = rec
        del mono_t, batch_t, stream_t, mono, batch
        # pvoc_terms at Rs = 640 (k = 5/2), scan on and off (2d's bounds).
        terms = {}
        for scan in (True, False):
            with _q_algebra(True):
                alg = stft_phasor_terms(x60, N_FFT, HOP, 640, scan=scan)
            with _q_algebra(False):
                k_ = stft_phasor_terms(x60, N_FFT, HOP, 640, scan=scan)
                rec = _weighted_phasor_err(k_, stft_phasor_terms_reference(x60, N_FFT, HOP, 640, scan=scan))
                rec["rerun_bitwise"] = all(_bits_equal(a, b) for a, b in zip(
                    k_[:3], stft_phasor_terms(x60, N_FFT, HOP, 640, scan=scan)[:3]))
            rec["differs_from_algebraic"] = not _bits_equal(k_[1], alg[1])
            _check(rec["mag_rel"] < 1e-5 and rec["p_weighted"] < 1e-4 and rec["rerun_bitwise"]
                   and rec["differs_from_algebraic"], f"pvoc_terms, angle domain, Rs=640, scan={scan}: {rec}")
            terms["scan" if scan else "terms"] = rec
        # The same over a batch of 3 rows (row 7's kernel): each row against
        # the plain version and bitwise the single-recording kernel.
        xb3 = torch.stack([x60[: 20 * SR], x60[7 * SR : 27 * SR],
                           torch.as_tensor(_signal(20.0, seed=5), dtype=torch.float32, device=dev)])
        with _q_algebra(False):
            for scan in (True, False):
                kb_ = stft_phasor_terms_batch(xb3, N_FFT, HOP, 640, scan=scan)
                pb_ = stft_phasor_terms_batch_reference(xb3, N_FFT, HOP, 640, scan=scan)
                for b in range(3):
                    rec = _weighted_phasor_err([a[b] for a in kb_[:3]], [a[b] for a in pb_[:3]])
                    one = stft_phasor_terms(xb3[b], N_FFT, HOP, 640, scan=scan)
                    rec["bitwise_vs_single_kernel"] = all(_bits_equal(a[b], o) for a, o in zip(kb_[:3], one[:3]))
                    _check(rec["mag_rel"] < 1e-5 and rec["p_weighted"] < 1e-4 and rec["bitwise_vs_single_kernel"],
                           f"pvoc_terms_batch, angle domain, Rs=640, scan={scan}, row {b}: {rec}")
                    terms[f"batch/{'scan' if scan else 'terms'}/row{b}"] = rec
        del k_, alg, xb3, kb_, pb_
        _emit("7_q_algebraic_kernels_vs_plain", seconds=60, pvoc_fused=out, pvoc_terms_rs640=terms,
              bounds={"vs_plain": 5e-5, "mag_rel": 1e-5, "p_weighted": 1e-4, "contracts": "bitwise",
                      "q_ge_2": "not the algebraic bits", "q_1": "the algebraic bits"})

        # ---- the golden gate through the public API, 60 s, the switch
        # False, branch_policy="fast": held on stationary tones, the chirp's
        # distance recorded (ROADMAP.md section 3, branch decisions). Then
        # one 0.5x call on the chirp under each setting, on the card and as
        # the plain version on the CPU, against golden.
        t60_np = _tones(60.0)
        gate = {}
        with _q_algebra(False):
            for name, x_np in (("tones", t60_np), ("chirp_recorded", x60_np)):
                for s in (0.5, 1.5):
                    gate[f"{name}/stretch_{s}"] = _rel(pv.time_stretch(x_np, s, cfg, branch_policy="fast"),
                                                       pv_ref.phase_vocoder(x_np, s, N_FFT, HOP))
                y = pv.pitch_shift(x_np, -5.0, cfg, branch_policy="fast")
                ref = pv_ref.pitch_shift(x_np, -5.0, N_FFT, HOP)
                _check(abs(len(y) - len(ref)) <= 1, f"pitch -5 length {len(y)} vs {len(ref)}")
                n = min(len(y), len(ref))
                gate[f"{name}/pitch_-5"] = _rel(y[:n], torch.as_tensor(ref[:n]))
        for s in (0.5, 1.5):
            _check(gate[f"tones/stretch_{s}"] < 1e-4, f"angle domain time_stretch {s} vs golden: {gate}")
        _check(gate["tones/pitch_-5"] < 1e-3, f"angle domain pitch_shift -5 vs golden: {gate}")
        gold60 = pv_ref.phase_vocoder(x60_np, 0.5, N_FFT, HOP)
        x60_cpu = x60.cpu()
        card_vs_cpu = {}
        for flag, name in ((True, "algebraic"), (False, "angle")):
            with _q_algebra(flag):
                card_vs_cpu[name] = {
                    "card": _rel(fused_time_stretch(x60, N_FFT, HOP, 128), gold60),
                    "cpu_plain": _rel(fused_time_stretch_reference(x60_cpu, N_FFT, HOP, 128), gold60)}
        _emit("7_q_algebraic_golden_gate", seconds=60, rel_err=gate, bounds={"stretch": 1e-4, "pitch": 1e-3},
              chirp_0_5x_vs_golden_card_and_cpu_plain=card_vs_cpu)

        # ---- the A/B the switch exists for (ACCURACY_r05.json's keys):
        # golden error and correlation on 600 s of the chirp, then the
        # device time of one traced 0.5x call on 3600 s, by kernel.
        x600_np = _signal(600.0)
        x600 = torch.as_tensor(x600_np, dtype=torch.float32, device=dev)
        sweep = {}
        for s in (0.5, 1.5):
            gold = pv_ref.phase_vocoder(x600_np, s, N_FFT, HOP)
            for flag, name in ((True, "algebraic"), (False, "trig")):
                with _q_algebra(flag):
                    y = pv.time_stretch(x600, s, cfg, branch_policy="fast")
                sweep[f"{s}x_fused_{name}"] = [_rel(y, gold), _corr(y, gold)]
            del gold, y
        del x600
        x_long = torch.as_tensor(_signal(3600.0), dtype=torch.float32, device=dev)
        timing = {}
        for flag, name in ((True, "algebraic"), (False, "trig")):
            with _q_algebra(flag):
                run = lambda: pv.time_stretch(x_long, 0.5, cfg, branch_policy="fast")  # noqa: E731
                prof = _profiled(run, kernels=7)
                ms = _time_calls(run, reps=3)
            timing[name] = {"device_busy_ms": prof["device_busy_ms"], "by_kernel_ms": prof["by_kernel_ms"],
                            "kernels": prof["kernels"], "ms": ms, "audio_s_per_s": 3600.0 / (min(ms) / 1e3)}
        timing["trig_over_algebraic_device"] = timing["trig"]["device_busy_ms"] / timing["algebraic"]["device_busy_ms"]
        _emit("7_q_algebraic_ab", card=smi, sweep_600s=sweep, trig_vs_algebraic_timing_3600s_0_5x=timing)

        # ---- the main paths at real size, each under both settings: every
        # launch counter reads the same under False as under True (no
        # fallback hides a kernel). 4 calls a path (one warm-up, 3 timed).
        from phase_vocoder_tpu_torch.bench import baseline_batch as _baseline

        x_pitch = torch.as_tensor(_signal(300.0, seed=1), dtype=torch.float32, device=dev)
        xs64, ratios64 = _baseline(SR)
        xs64 = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs64]
        # 4e's eight 10-minute pieces of the hour-long signal.
        xs8 = torch.stack([x_long[i * 428 * SR : (i * 428 + 600) * SR] for i in range(8)])
        nf_long = (len(x_long) - N_FFT) // HOP + 1
        S_long = streaming.fused_plan_segments(nf_long, N_FFT, 128, streaming.DEFAULT_FUSED_SEGMENT_FRAMES)[1]
        paths = {
            "stretch_0.5x_3600s": (lambda: pv.time_stretch(x_long, 0.5, cfg, branch_policy="fast"),
                                   {"pvoc_fused": 4}),
            "stretch_1.5x_3600s": (lambda: pv.time_stretch(x_long, 1.5, cfg, branch_policy="fast"),
                                   {"pvoc_fused": 4}),
            "pitch_m5_300s": (lambda: pv.pitch_shift(x_pitch, -5.0, cfg, branch_policy="fast"),
                              {"pvoc_fused": 4, "resample_lerp": 4}),
            "fused_stream_0.5x_3600s": (lambda: streaming.fused_stream_time_stretch(x_long, 0.5, cfg),
                                        {"pvoc_fused_segment": 4 * S_long}),
            "batch_varied_64": (lambda: pv.batch_time_stretch_varied(xs64, ratios64, cfg),
                                {"pvoc_fused_batch": 24}),
            "stretch_2.5x_3600s": (lambda: pv.time_stretch(x_long, 2.5, cfg, branch_policy="fast"),
                                   {"pvoc_terms": 4, "istft_frames_cart": 4}),
            "zrev_0.5x_3600s": (lambda: fused_time_stretch(x_long, N_FFT, HOP, 128, zrev=True),
                                {"pvoc_fused_zrev": 4}),
            "batched_chunked_0.5x_8x600s": (
                lambda: chunked.batched_chunked_time_stretch(xs8, 0.5, cfg, mesh=make_mesh_2d(1, 1)),
                {"pvoc_terms_batch": 4, "phasor_istft_ola_batch": 4}),
        }
        main, launches = {}, {}
        for name, (fn, expect) in paths.items():
            main[name] = {}
            for flag, alg in ((True, "algebraic"), (False, "trig")):
                with _q_algebra(flag):
                    launches[f"{name}/{alg}"] = _counted(
                        counters, lambda: main[name].update({alg: _time_calls(fn, reps=3)}), expect,
                        f"{name} under set_q_algebraic({flag})")
        _emit("7_q_algebraic_main_paths", card=smi, ms=main, launches=launches)

        # ---- the kernels at those shapes under False, against their plain
        # versions on 3600 s of stationary tones (on the chirp two f32
        # analyses part at the branch choices of quiet bins, 4c). P is a
        # product over 224,997 frames whose step terms differ between two
        # f32 analyses, and the difference grows with the frames: 4d holds
        # pvoc_terms there at 3e-4, and at 0.5x the algebraic kernel itself
        # reads 5.0e-4 from its plain version (an H100 reading). So each
        # is held to 3e-4 or twice the algebraic pair's distance on the
        # same input, whichever is larger: the switch may add no error of
        # its own between kernel and plain version (0.5x read 6.6e-4, 1.33
        # times the algebraic pair). One 8192-frame segment from the
        # kernel stream's state after 10 segments, and the batch's 0.5x
        # group's lengths, at the 60 s bound (5e-5).
        t_long = torch.as_tensor(_tones(3600.0), dtype=torch.float32, device=dev)
        rows = {}
        with _q_algebra(False):
            for name, zrev in (("pvoc_fused", False), ("pvoc_fused_zrev", True)):
                k = fused_time_stretch(t_long, N_FFT, HOP, 128, zrev=zrev)
                p = fused_time_stretch_reference(t_long, N_FFT, HOP, 128, zrev=zrev)
                with _q_algebra(True):
                    alg_rel = _rel(fused_time_stretch(t_long, N_FFT, HOP, 128, zrev=zrev),
                                   fused_time_stretch_reference(t_long, N_FFT, HOP, 128, zrev=zrev))
                prof = _profiled(lambda: fused_time_stretch(x_long, N_FFT, HOP, 128, zrev=zrev), kernels=7)
                rows[name] = {"rel": _rel(k, p), "max_abs": _max_abs(k, p), "algebraic_rel": alg_rel,
                              "bound": max(3e-4, 2 * alg_rel),
                              "ms": prof["device_busy_ms"], "by_kernel_ms": prof["by_kernel_ms"],
                              "plain_ms": _time_ms(lambda: fused_time_stretch_reference(
                                  x_long, N_FFT, HOP, 128, zrev=zrev), reps=1),
                              **_bound(4 * (len(x_long) + len(k)), 2 * nf_long * _FFT_FLOP)}
                _check(rows[name]["rel"] < rows[name]["bound"],
                       f"{name}, angle domain, 0.5x / 3600 s tones: {rows[name]}")
                del k, p
            F_long = streaming.DEFAULT_FUSED_SEGMENT_FRAMES
            _, st10 = streaming._fused_scan_from(
                t_long, streaming.fused_init_state(N_FFT, 128, dev), nf_long, N_FFT, HOP, 128, F_long, 10)
            seg_args = (t_long, st10.carry, st10.tail, 1, 10 * F_long, nf_long, N_FFT, HOP, 128, F_long)
            ka, _, kt = fused_stream_segment(*seg_args)
            pa, _, pt = fused_stream_segment_reference(*seg_args)
            prof = _profiled(lambda: fused_stream_segment(*seg_args), reps=20)
            rows["pvoc_fused_segment"] = {
                "frames": F_long, "rel": max(_rel(ka, pa, 0), _rel(kt.reshape(-1), pt.reshape(-1), 0)),
                "max_abs": _max_abs(ka, pa, 0), "ms": prof["device_busy_ms"], "by_kernel_ms": prof["by_kernel_ms"],
                "plain_ms": _time_ms(lambda: fused_stream_segment_reference(*seg_args), reps=3),
                **_bound(4 * ((F_long - 1) * HOP + N_FFT + len(ka) + 2 * kt.numel() + 2 * st10.carry.numel()),
                         2 * F_long * _FFT_FLOP)}
            del ka, pa, kt, pt, st10
            # The batch's 0.5x group: its utterances (the chirp) are timed
            # and their distance from the plain version recorded under both
            # settings (a branch choice of a quiet bin parts two f32
            # analyses there: 7.6e-3 at k = 1/2 in the angle domain, an
            # H100 reading); the check runs on tones of the same lengths.
            grp = [x for x, r in zip(xs64, ratios64) if r == 0.5]
            t_max = max(len(x) for x in grp)
            nfs_g = [(len(x) - N_FFT) // HOP + 1 for x in grp]
            spans = [(nf_g - 1) * 128 + N_FFT for nf_g in nfs_g]
            xb = torch.stack([torch.nn.functional.pad(x, (0, t_max - len(x))) for x in grp])
            tb = torch.stack([torch.nn.functional.pad(torch.as_tensor(
                _tones(len(x) / SR)[: len(x)], dtype=torch.float32, device=dev), (0, t_max - len(x))) for x in grp])

            def batch_dist(x_b):
                a = fused_time_stretch_batch(x_b, N_FFT, HOP, 128, nfs_g)
                b = fused_time_stretch_batch_reference(x_b, N_FFT, HOP, 128, nfs_g)
                return (max(_rel(a[i, :n], b[i, :n]) for i, n in enumerate(spans)),
                        max(_max_abs(a[i, :n], b[i, :n]) for i, n in enumerate(spans)))

            rel, max_abs = batch_dist(tb)
            with _q_algebra(True):
                chirp_alg = batch_dist(xb)[0]
            prof = _profiled(lambda: fused_time_stretch_batch(xb, N_FFT, HOP, 128, nfs_g), reps=10)
            rows["pvoc_fused_batch"] = {
                "rows": len(grp), "frames": sum(nfs_g), "rel": rel, "max_abs": max_abs,
                "chirp_rel_recorded": batch_dist(xb)[0], "chirp_algebraic_rel_recorded": chirp_alg,
                "ms": prof["device_busy_ms"], "by_kernel_ms": prof["by_kernel_ms"],
                "plain_ms": _time_ms(lambda: fused_time_stretch_batch_reference(xb, N_FFT, HOP, 128, nfs_g), reps=1),
                **_bound(4 * (sum((n - 1) * HOP + N_FFT for n in nfs_g)
                              + len(grp) * (max(nfs_g) + N_FFT // 128 - 1) * 128),
                         2 * sum(nfs_g) * _FFT_FLOP)}
            del xb, tb
            for name in ("pvoc_fused_segment", "pvoc_fused_batch"):
                _check(rows[name]["rel"] < 5e-5, f"{name}, angle domain, at the main shape: {rows[name]}")
            kt = stft_phasor_terms(t_long, N_FFT, HOP, 640)
            pt = stft_phasor_terms_reference(t_long, N_FFT, HOP, 640)
            rec = _weighted_phasor_err(kt, pt)
            with _q_algebra(True):
                rec["algebraic_p_weighted"] = _weighted_phasor_err(
                    stft_phasor_terms(t_long, N_FFT, HOP, 640),
                    stft_phasor_terms_reference(t_long, N_FFT, HOP, 640))["p_weighted"]
            rec["bound"] = max(3e-4, 2 * rec["algebraic_p_weighted"])
            prof = _profiled(lambda: stft_phasor_terms(x_long, N_FFT, HOP, 640), kernels=4)
            rec.update(ms=prof["device_busy_ms"], by_kernel_ms=prof["by_kernel_ms"], frames=nf_long,
                       plain_ms=_time_ms(lambda: stft_phasor_terms_reference(x_long, N_FFT, HOP, 640), reps=1),
                       **_bound(4 * (len(x_long) + 3 * kt[0].numel()), nf_long * _FFT_FLOP))
            _check(rec["mag_rel"] < 1e-5 and rec["p_weighted"] < rec["bound"],
                   f"pvoc_terms, angle domain, 2.5x / 3600 s tones: {rec}")
            rows["pvoc_terms"] = rec
            del kt, pt
            # pvoc_terms_batch at 4e's shape and bounds: unscanned terms (no
            # walk), a term within rounding of the branch cut counted apart.
            kt = stft_phasor_terms_batch(xs8, N_FFT, HOP, 128, scan=False, return_u=True)
            pt = stft_phasor_terms_batch_reference(xs8, N_FFT, HOP, 128, scan=False, return_u=True)
            nf8 = kt[-1]
            prof = _profiled(lambda: stft_phasor_terms_batch(xs8, N_FFT, HOP, 128, scan=False, return_u=True))
            rec = {"frames": 8 * nf8, **_terms_errors(kt, pt), "ms": prof["device_busy_ms"],
                   "by_kernel_ms": prof["by_kernel_ms"],
                   "plain_ms": _time_ms(lambda: stft_phasor_terms_batch_reference(
                       xs8, N_FFT, HOP, 128, scan=False, return_u=True), reps=1),
                   **_bound(4 * (xs8.numel() + 5 * 8 * nf8 * (N_FFT // 2 + 1)), 8 * nf8 * _FFT_FLOP)}
            _check(rec["mag_rel"] < 1e-5 and max(rec["u_weighted"], rec["t_weighted"]) < 1e-4
                   and rec["flip_share"] < 1e-5, f"pvoc_terms_batch, angle domain, 8 x 600 s: {rec}")
            rows["pvoc_terms_batch"] = rec
            del kt, pt, xs8
        _emit("7_q_algebraic_kernels_main_shapes", card=smi, kernels=rows,
              bounds={"3600s_tones": "3e-4 or twice the algebraic pair's", "segment_and_batch": 5e-5,
                      "terms_batch": "4e's: mag_rel 1e-5, weighted 1e-4, flip_share 1e-5"})
    finally:
        from phase_vocoder_tpu_torch.ops import fused as fused_mod

        fused_mod.set_q_algebraic(True)

    replaces = {"pvoc_fused": "ops/pallas/fused.py:1526", "pvoc_fused_zrev": "ops/pallas/fused.py:1569",
                "pvoc_fused_segment": "ops/pallas/fused.py:1886", "pvoc_fused_batch": "ops/pallas/fused.py:1610",
                "pvoc_terms": "ops/pallas/fused.py:713", "pvoc_terms_batch": "ops/pallas/fused.py:733"}
    path_of = {"pvoc_fused": "stretch_0.5x_3600s", "pvoc_fused_zrev": "zrev_0.5x_3600s",
               "pvoc_fused_segment": "fused_stream_0.5x_3600s", "pvoc_fused_batch": "batch_varied_64",
               "pvoc_terms": "stretch_2.5x_3600s", "pvoc_terms_batch": "batched_chunked_0.5x_8x600s"}
    return [{"name": f"{name}@angle_q2", "route": "cuda", "source": "phase_vocoder_tpu_torch/csrc/pvoc_fused.cu",
             "replaces": f"phase_vocoder_tpu/{replaces[name]}",
             "launches": launches[f"{path_of[name]}/trig"][name],
             "max_abs_err": rec["max_abs"] if "max_abs" in rec else rec["y_max_abs"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": None}
            for name, rec in rows.items()]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")

    from golden import pv_ref
    import phase_vocoder_tpu_torch as pv
    from phase_vocoder_tpu_torch.ops import _build
    from phase_vocoder_tpu_torch.ops.fused import (
        fused_stream_segment,
        fused_stream_segment_reference,
        fused_time_stretch,
        fused_time_stretch_batch,
        fused_time_stretch_batch_reference,
        fused_time_stretch_reference,
        fused_time_stretch_zrev,
        phasor_istft_ola,
        phasor_istft_ola_batch,
        phasor_istft_ola_batch_reference,
        phasor_istft_ola_reference,
        stft_phasor_terms,
        stft_phasor_terms_batch,
        stft_phasor_terms_batch_reference,
        stft_phasor_terms_reference,
    )
    from phase_vocoder_tpu_torch.parallel import chunked
    from phase_vocoder_tpu_torch.parallel.mesh import make_mesh_2d
    from phase_vocoder_tpu_torch.ops import resample as resample_mod
    from phase_vocoder_tpu_torch.ops.resample import (
        block_tables,
        resample_blocked,
        resample_blocked_reference,
        resample_linear,
        resample_linear_reference,
        select_lerp,
        select_lerp_reference,
        select_lerp_two_level,
        select_tables,
    )
    from phase_vocoder_tpu_torch.ops.stft import (
        istft_frames,
        istft_frames_cart,
        istft_frames_cart_reference,
        istft_frames_reference,
        istft_ola,
        istft_ola_reference,
        stft_fused,
        stft_fused_reference,
        stft_polar,
        stft_polar_reference,
    )
    from phase_vocoder_tpu_torch import streaming
    from phase_vocoder_tpu_torch.ops.phase import segment_phase, segment_phase_reference
    from phase_vocoder_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device("cuda")
    cfg = pv.PvocConfig()
    counters = {
        "pvoc_fused": fused_time_stretch, "resample_lerp": resample_linear,
        "stft_polar": stft_polar, "istft_ola": istft_ola,
        "pvoc_fused_segment": fused_stream_segment, "pvoc_terms": stft_phasor_terms,
        "istft_frames": istft_frames, "istft_frames_cart": istft_frames_cart,
        "pvoc_fused_batch": fused_time_stretch_batch, "pvoc_terms_batch": stft_phasor_terms_batch,
        "phasor_istft_ola": phasor_istft_ola, "phasor_istft_ola_batch": phasor_istft_ola_batch,
        "pvoc_fused_zrev": fused_time_stretch_zrev, "resample_blocked": resample_blocked,
        "select_lerp_roll2": select_lerp_two_level, "select_lerp": select_lerp,
        "stft_fused": stft_fused, "segment_phase": segment_phase,
    }

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
    # q >= 2 at the smallest N of fft_real.cuh's body: hop N/4, Rs = 171
    # N/1024 rounded and 3N/8. On the chirp two f32 analyses part at the
    # branch choices of quiet bins (recorded). On stationary tones every f32
    # route's P drifts from golden as the frames add up (at N = 256, Rs = 43,
    # 14,997 frames: 1.52e-4 this kernel, 1.60e-4 the parent's, 1.73e-4 the
    # plain version; at N = 512 the plain version reads 1.2e-4 to 2.5e-4 from
    # golden, the kernel 1.5e-5 to 7.6e-5; H100 readings), so the kernel is
    # held to golden: < 1e-4 at 3,747 frames (the frames of the q >= 2 checks
    # above, at N = 1024 on 60 s), and at 60 s < 1e-4 or no further than the
    # plain version is. Its distance from the plain version is recorded.
    small_q = {}
    for n, short_s in ((256, 15.0), (512, 30.0)):
        hop = n // 4
        for rs in (round(171 * n / 1024), 3 * n // 8):
            rec = {"chirp_vs_plain_recorded": _rel(fused_time_stretch(x60, n, hop, rs),
                                                   fused_time_stretch_reference(x60, n, hop, rs), n)}
            for secs in (short_s, 60.0):
                t_np = _tones(secs)
                t_ = torch.as_tensor(t_np, dtype=torch.float32, device=dev)
                gold = pv_ref.phase_vocoder(t_np, rs / hop, n, hop)
                k, p = fused_time_stretch(t_, n, hop, rs), fused_time_stretch_reference(t_, n, hop, rs)
                rec[f"tones_{secs:g}s"] = {"frames": (len(t_np) - n) // hop + 1, "vs_golden": _rel(k, gold, n),
                                           "plain_vs_golden": _rel(p, gold, n), "vs_plain_recorded": _rel(k, p, n)}
            short, full = rec[f"tones_{short_s:g}s"], rec["tones_60s"]
            _check(short["vs_golden"] < 1e-4 and full["vs_golden"] < max(1e-4, full["plain_vs_golden"]),
                   f"pvoc_fused at N={n}, Rs={rs} on tones vs golden: {rec}")
            small_q[f"{n}/{hop}/{rs}"] = rec
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
          pvoc_fused_q_ge_2_small_n=small_q,
          small_n_bounds={"vs_golden_3747_frames": 1e-4, "vs_golden_60s": "< max(1e-4, plain vs golden)"},
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

    # The analysis and istft_ola at every power of two that takes the
    # N/2-point body (csrc/fft_real.cuh), hop N/4: against the plain
    # versions, with a frame mask; each frame's bits independent of its
    # position in the launch (frame j of the whole call = frame 0 of a call
    # from sample j*hop, for j not a multiple of the frames a block holds)
    # and of x's alignment (a slice at an element offset = its copy).
    by_n = {}
    for n in POW2_SIZES:
        hop = n // 4
        rec = {}
        mp_, pp_ = stft_polar_reference(x60, n, hop)
        rec["stft_polar"] = _spec_errors(stft_polar(x60, n, hop), (mp_, pp_))
        rp_, ip_ = stft_fused_reference(x60, n, hop)
        rk_, ik_ = stft_fused(x60, n, hop)
        top = float(mp_.max())
        rec["stft_fused_rel"] = max(float((rk_ - rp_).abs().max()), float((ik_ - ip_).abs().max())) / top
        _check(max(rec["stft_polar"]["spec_rel"], rec["stft_polar"]["mag_rel"], rec["stft_fused_rel"]) < 1e-5,
               f"analysis vs plain at N={n}: {rec}")
        mk, pk = stft_polar(x60, n, hop)
        for j in (3, 5):
            m_j, p_j = stft_polar(x60[j * hop:], n, hop)
            r_j, i_j = stft_fused(x60[j * hop:], n, hop)
            _check(bool(torch.equal(m_j, mk[j:]) and torch.equal(p_j, pk[j:])
                        and torch.equal(r_j, rk_[j:]) and torch.equal(i_j, ik_[j:])),
                   f"analysis at N={n}: frames from sample {j}*hop differ from the whole call's")
        for c in (1, 2, 3):
            view = x60[c:]
            m_c, p_c = stft_polar(view, n, hop)
            m_d, p_d = stft_polar(view.clone(), n, hop)
            _check(bool(torch.equal(m_c, m_d) and torch.equal(p_c, p_d)),
                   f"stft_polar at N={n}: a slice at offset {c} differs from its copy")
            _check(all(bool(torch.equal(u, v)) for u, v in zip(stft_fused(view, n, hop), stft_fused(view.clone(), n, hop))),
                   f"stft_fused at N={n}: a slice at offset {c} differs from its copy")
        rec["bitwise_frame_position_and_offset"] = True
        mask_n = torch.ones(mp_.shape[0], device=dev)
        mask_n[-100:] = 0.0
        for rs in (n // 4, n // 8):
            a = istft_ola(mp_, pp_, n, rs, frame_mask=mask_n)
            b = istft_ola_reference(mp_, pp_, n, rs, frame_mask=mask_n)
            rec[f"istft_ola_rs{rs}"] = _rel(a, b, n)
            _check(rec[f"istft_ola_rs{rs}"] < 1e-5, f"istft_ola vs plain at N={n}, Rs={rs}: {rec}")
            _check(bool((a[(mp_.shape[0] - 100 - 1) * rs + n:] == 0).all()),
                   f"istft_ola at N={n}: masked frames leak at Rs={rs}")
        by_n[n] = rec
        del mp_, pp_, rp_, ip_, rk_, ik_, mk, pk
    _emit("2b_stft_kernels_by_n", seconds=60, by_n_fft=by_n, masked_frames=100, bound=1e-5)

    # ---- 2c. pvoc_fused_segment vs its plain version; stream vs monolithic
    nf60 = (len(x60) - N_FFT) // HOP + 1
    seg = {}
    for rs in (512, 128, 171):
        bound = 1e-5 if rs % HOP == 0 else 5e-5
        F, S = streaming.fused_plan_segments(nf60, N_FFT, rs, 1024)
        # One segment from the state after two, kernel and plain.
        _, mid = streaming._fused_scan_from(
            x60, streaming.fused_init_state(N_FFT, rs, dev), nf60, N_FFT, HOP, rs, F, 2)
        ka, kc, kt = fused_stream_segment(x60, mid.carry, mid.tail, 1, 2 * F, nf60, N_FFT, HOP, rs, F)
        pa, pc, pt = fused_stream_segment_reference(
            x60, mid.carry, mid.tail, 1, 2 * F, nf60, N_FFT, HOP, rs, F)
        rec = {"segment_out_rel": _rel(ka, pa, 0), "tail_rel": _rel(kt.reshape(-1), pt.reshape(-1), 0),
               "carry_max_abs": float((kc - pc).abs().max())}
        _check(max(rec["segment_out_rel"], rec["tail_rel"]) < bound,
               f"pvoc_fused_segment vs plain at Rs={rs}: {rec}")
        # The whole stream, kernel and plain, each from its own state. The
        # plain stream runs cuFFT per segment, where the plain monolithic
        # version runs it once over the recording; its distance from that
        # (recorded) is the plain side's own, and bounds what the kernel
        # stream can be held to. Readings on an H100: 1.04e-5 at 2.0x and
        # 3.0e-6 to 5.5e-6 elsewhere, so 3e-5.
        k = streaming.fused_stream_time_stretch(x60, rs / HOP, cfg, segment_frames=F)
        plain = _plain_stream(x60, nf60, rs, F, S)
        rec["stream_rel"] = _rel(k, plain)
        _check(rec["stream_rel"] < 3e-5, f"fused stream vs plain stream at Rs={rs}: {rec}")
        mono = fused_time_stretch(x60, N_FFT, HOP, rs)
        rec["plain_stream_vs_plain_monolithic_rel"] = _rel(
            plain, fused_time_stretch_reference(x60, N_FFT, HOP, rs))
        rec["kernel_vs_plain_monolithic_rel"] = _rel(
            mono, fused_time_stretch_reference(x60, N_FFT, HOP, rs))
        for sf in (256, 8192):
            same = torch.equal(streaming.fused_stream_time_stretch(x60, rs / HOP, cfg, segment_frames=sf), mono)
            _check(same, f"kernel stream (segment_frames={sf}) differs from the monolithic kernel at Rs={rs}")
            rec[f"bitwise_vs_monolithic_{sf}"] = same
        seg[rs] = rec
    for rs in (171, 128):  # 1600 samples: nf = 3 < m-1
        xs = x60[:1600]
        same = torch.equal(streaming.fused_stream_time_stretch(xs, rs / HOP, cfg, segment_frames=64),
                           fused_time_stretch(xs, N_FFT, HOP, rs))
        _check(same, f"short-input kernel stream differs from the monolithic kernel at Rs={rs}")
        seg[f"short_{rs}_bitwise"] = same
    # The analysis on fft_real.cuh's body at its smallest, canonical and
    # largest N (hop N/4, k = 2 and a q >= 2 hop): zrev=True runs the same
    # kernel as zrev=False there, so the outputs are equal bit for bit; a
    # rerun is bitwise equal; at 256 and 4096 also the stream (segments of
    # 256 and 1024 frames) and a checkpointed stream killed after two
    # batches and resumed equal the monolithic kernel bit for bit.
    import tempfile

    by_n = {}
    for n in (256, N_FFT, 4096):
        hop, rec = n // 4, {}
        cfg_n = pv.PvocConfig(n_fft=n, hop=hop)
        for rs in (n // 2, round(171 * n / 1024)):
            mono = fused_time_stretch(x60, n, hop, rs)
            rec[f"rs{rs}_zrev_bitwise"] = bool(torch.equal(fused_time_stretch(x60, n, hop, rs, zrev=True), mono))
            rec[f"rs{rs}_rerun_bitwise"] = bool(torch.equal(fused_time_stretch(x60, n, hop, rs), mono))
            if n != N_FFT:
                for sf in (256, 1024):
                    rec[f"rs{rs}_stream{sf}_bitwise"] = bool(torch.equal(
                        streaming.fused_stream_time_stretch(x60, rs / hop, cfg_n, segment_frames=sf), mono))
        if n != N_FFT:
            sf = 1024 if n == 256 else 128  # 15 and 8 segments, 2 a batch
            with tempfile.TemporaryDirectory(prefix="pvoc_ck_n_") as tmp:
                kw = dict(segment_frames=sf, batch_segments=2)
                full = ckpt.checkpointed_fused_stream_time_stretch(x60, 2.0, cfg_n, checkpoint_dir=tmp + "/a", **kw)
                try:
                    ckpt.checkpointed_fused_stream_time_stretch(x60, 2.0, cfg_n, checkpoint_dir=tmp + "/b",
                                                                _fail_after_batches=2, **kw)
                    _check(False, f"the checkpointed run at N={n} was not killed")
                except RuntimeError as e:
                    _check("injected" in str(e), f"checkpointed run at N={n} failed: {e}")
                resumed = ckpt.checkpointed_fused_stream_time_stretch(x60, 2.0, cfg_n, checkpoint_dir=tmp + "/b", **kw)
                rec["resumed_vs_uninterrupted_vs_monolithic_bitwise"] = bool(
                    torch.equal(resumed, full) and torch.equal(full, fused_time_stretch(x60, n, hop, n // 2)))
        _check(all(rec.values()), f"bitwise contracts of the analysis at N={n}: {rec}")
        by_n[n] = rec
    seg["analysis_real_bitwise_by_n"] = by_n
    _emit("2c_fused_segment_vs_plain", seconds=60, pvoc_fused_segment=seg,
          bounds={"segment_integer_k": 1e-5, "segment_q_ge_2": 5e-5, "stream": 3e-5})

    # ---- 2d. pvoc_terms, istft_frames and istft_frames_cart vs plain, 60 s
    terms = {}
    for rs in (640, 768, 767):
        for scan in (True, False):
            rec = _weighted_phasor_err(stft_phasor_terms(x60, N_FFT, HOP, rs, scan=scan),
                                       stft_phasor_terms_reference(x60, N_FFT, HOP, rs, scan=scan))
            _check(rec["mag_rel"] < 1e-5 and rec["p_weighted"] < 1e-4,
                   f"pvoc_terms vs plain at Rs={rs}, scan={scan}: {rec}")
            terms[f"{rs}/{'scan' if scan else 'terms'}"] = rec
    # The chunk passes of pvoc_terms (terms_chunks, scan_carry_staged,
    # scan_apply_chunks) at the chunk edges: nf = 1, 63, 64, 65, 129 frames
    # at Rs = 768 (k = 3) and 640 (q = 2), scan on (P) and off (the terms),
    # with unit phasors; then at N = 256 and 4096 (hop N/4, k = 3 and
    # 5/2) over a batch of 3 rows, each row also bitwise the
    # single-recording kernel's. Bounds as above, and no flipped term.
    edges = {}
    for nf_e in (1, 63, 64, 65, 129):
        xe = x60[: (nf_e - 1) * HOP + N_FFT]
        for rs in (768, 640):
            for scan in (True, False):
                k_ = stft_phasor_terms(xe, N_FFT, HOP, rs, scan=scan, return_u=True)
                rec = _terms_errors(k_, stft_phasor_terms_reference(xe, N_FFT, HOP, rs, scan=scan, return_u=True))
                _check(k_[-1] == nf_e and rec["mag_rel"] < 1e-5 and rec["flip_share"] == 0
                       and max(rec["u_weighted"], rec["t_weighted"]) < 1e-4,
                       f"pvoc_terms vs plain at {nf_e} frames, Rs={rs}, scan={scan}: {rec}")
                edges[f"nf{nf_e}/{rs}/{'scan' if scan else 'terms'}"] = rec
    xb3 = torch.stack([x60[: 20 * SR], x60[7 * SR : 27 * SR],
                       torch.as_tensor(_signal(20.0, seed=5), dtype=torch.float32, device=dev)])
    for n in (256, 4096):
        for rs in (3 * n // 4, 5 * n // 8):
            for scan in (True, False):
                kb_ = stft_phasor_terms_batch(xb3, n, n // 4, rs, scan=scan, return_u=True)
                pb_ = stft_phasor_terms_batch_reference(xb3, n, n // 4, rs, scan=scan, return_u=True)
                for b in range(3):
                    rec = _terms_errors([a[b] for a in kb_[:5]], [a[b] for a in pb_[:5]])
                    one = stft_phasor_terms(xb3[b], n, n // 4, rs, scan=scan, return_u=True)
                    rec["bitwise_vs_single_kernel"] = all(bool(torch.equal(a[b], o)) for a, o in zip(kb_[:5], one[:5]))
                    _check(rec["mag_rel"] < 1e-5 and rec["flip_share"] == 0
                           and max(rec["u_weighted"], rec["t_weighted"]) < 1e-4 and rec["bitwise_vs_single_kernel"],
                           f"pvoc_terms_batch vs plain at N={n}, Rs={rs}, scan={scan}, row {b}: {rec}")
                    edges[f"N{n}/{rs}/{'scan' if scan else 'terms'}/row{b}"] = rec
    del xb3, kb_, pb_, k_
    frames = {}
    re_p, im_p = mag_p * torch.cos(phi_p), mag_p * torch.sin(phi_p)
    for name, a, b in (
        ("istft_frames", istft_frames(mag_p, phi_p, N_FFT, mask),
         istft_frames_reference(mag_p, phi_p, N_FFT, mask)),
        ("istft_frames_cart", istft_frames_cart(re_p, im_p, N_FFT, mask),
         istft_frames_cart_reference(re_p, im_p, N_FFT, mask)),
    ):
        frames[name] = float((a - b).abs().max() / b.abs().max())
        _check(frames[name] < 1e-5, f"{name} vs plain: {frames[name]:.3e}")
        _check(not bool(a[-100:].any()), f"{name}: masked frames are not zero")
    # istft_frames in both forms at every power of two of the N/2-point
    # body, with a frame mask; rows r0..r1 of a call on those rows alone
    # (an unaligned start) bitwise equal to the whole call's.
    for n in POW2_SIZES:
        mp_, pp_ = stft_polar_reference(x60, n, n // 4)
        rp_, ip_ = mp_ * torch.cos(pp_), mp_ * torch.sin(pp_)
        mask_n = torch.ones(mp_.shape[0], device=dev)
        mask_n[-100:] = 0.0
        for name, fn, ref, a_, b_ in (("istft_frames", istft_frames, istft_frames_reference, mp_, pp_),
                                      ("istft_frames_cart", istft_frames_cart, istft_frames_cart_reference, rp_, ip_)):
            a = fn(a_, b_, n, mask_n)
            b = ref(a_, b_, n, mask_n)
            frames[f"{name}_N{n}"] = float((a - b).abs().max() / b.abs().max())
            _check(frames[f"{name}_N{n}"] < 1e-5, f"{name} vs plain at N={n}: {frames}")
            _check(not bool(a[-100:].any()), f"{name} at N={n}: masked frames are not zero")
            for r0, r1 in ((3, 77), (1, 2), (101, 390)):
                _check(bool(torch.equal(fn(a_[r0:r1], b_[r0:r1], n, mask_n[r0:r1]), a[r0:r1])),
                       f"{name} at N={n}: rows {r0}..{r1} alone differ from the whole call's")
        del mp_, pp_, rp_, ip_, a, b
    _emit("2d_general_hop_kernels_vs_plain", seconds=60, pvoc_terms=terms, pvoc_terms_chunk_edges=edges,
          frames_rel_to_max=frames, masked_frames=100, rows_bitwise=True,
          bounds={"mag_rel": 1e-5, "p_weighted": 1e-4, "frames": 1e-5})
    del re_p, im_p

    # ---- 2e. the parallel layer's kernels vs their plain versions, 60 s
    lens_r = [len(x60), int(37.0 * SR), 1800, int(51.0 * SR)]  # 1800: 4 frames
    xs_r = torch.zeros((4, len(x60)), device=dev)
    for i, n in enumerate(lens_r):
        xs_r[i, :n] = torch.as_tensor(_signal(n / SR, seed=10 + i)[:n], dtype=torch.float32, device=dev)
    nfs_r = [(n - N_FFT) // HOP + 1 for n in lens_r]
    # Each row is held bit for bit to the single-recording kernel on its own
    # signal, and to the plain version at 5e-5: on row 0 at Rs = 512 the
    # single-recording kernel itself reads 1.66e-5 from its plain version
    # (an H100 reading; anchor phases of quiet bins, cuFFT against the
    # kernel's FFT), above the 1e-5 that 2a holds on the chirp of seed 0.
    batch_k = {}
    for rs in (128, 171, 512):
        k = fused_time_stretch_batch(xs_r, N_FFT, HOP, rs, nfs_r)
        p = fused_time_stretch_batch_reference(xs_r, N_FFT, HOP, rs, nfs_r)
        bound = 5e-5
        for b, nf_b in enumerate(nfs_r):
            n_out = (nf_b - 1) * rs + N_FFT
            rec = {"frames": nf_b,
                   "rel": _rel(k[b, :n_out], p[b, :n_out], N_FFT if n_out > 3 * N_FFT else 0),
                   "zeros_after": bool((k[b, n_out:] == 0).all()),
                   "bitwise_vs_single_kernel": bool(torch.equal(
                       k[b, :n_out], fused_time_stretch(xs_r[b, : lens_r[b]].contiguous(), N_FFT, HOP, rs)))}
            _check(rec["rel"] < bound and rec["zeros_after"] and rec["bitwise_vs_single_kernel"],
                   f"pvoc_fused_batch vs plain and the single kernel at Rs={rs}: {rec}")
            batch_k[f"{rs}/row{b}"] = rec
    del xs_r, k, p
    xb60 = torch.stack([x60, torch.as_tensor(_signal(60.0, seed=3), dtype=torch.float32, device=dev)])
    kt = stft_phasor_terms_batch(xb60, N_FFT, HOP, 128, scan=False, return_u=True)
    pt = stft_phasor_terms_batch_reference(xb60, N_FFT, HOP, 128, scan=False, return_u=True)
    terms_b = {}
    for b in range(2):
        rec = _weighted_phasor_err([a[b] for a in kt[:3]], [a[b] for a in pt[:3]])
        rec["u_weighted"] = _weighted_phasor_err([kt[0][b], kt[3][b], kt[4][b]],
                                                 [pt[0][b], pt[3][b], pt[4][b]])["p_weighted"]
        one = stft_phasor_terms(xb60[b], N_FFT, HOP, 128, scan=False, return_u=True)
        rec["bitwise_vs_single_kernel"] = all(bool(torch.equal(a[b], o)) for a, o in zip(kt[:5], one[:5]))
        _check(rec["mag_rel"] < 1e-5 and max(rec["p_weighted"], rec["u_weighted"]) < 1e-4,
               f"pvoc_terms_batch vs plain, row {b}: {rec}")
        terms_b[f"row{b}"] = rec
    del kt, pt
    mag_s, pre_s, pim_s, nf_s = stft_phasor_terms(x60, N_FFT, HOP, 128)  # scanned P at 0.5x
    smask = torch.ones(nf_s, device=dev)
    smask[-100:] = 0.0
    synth = {}
    for rs in (128, 256, 512):
        for name, fm in (("normalized", None), ("masked", smask)):
            a = phasor_istft_ola(mag_s, pre_s, pim_s, N_FFT, rs, nf_s, fm)
            b = phasor_istft_ola_reference(mag_s, pre_s, pim_s, N_FFT, rs, nf_s, fm)
            synth[f"{rs}/{name}"] = _rel(a, b)
            _check(synth[f"{rs}/{name}"] < 1e-5, f"phasor_istft_ola vs plain at Rs={rs}, {name}: {synth}")
            if fm is not None:
                _check(bool((a[(nf_s - 100 - 1) * rs + N_FFT :] == 0).all()),
                       f"phasor_istft_ola: masked frames leak at Rs={rs}")
    kb = stft_phasor_terms_batch(xb60, N_FFT, HOP, 128)
    bmask = torch.ones((2, nf_s), device=dev)
    bmask[:, -100:] = 0.0
    synth_b = {}
    for rs in (128, 256):
        a = phasor_istft_ola_batch(*kb[:3], N_FFT, rs, nf_s, bmask)
        b = phasor_istft_ola_batch_reference(*kb[:3], N_FFT, rs, nf_s, bmask)
        synth_b[rs] = max(_rel(a[i], b[i]) for i in range(2))
        _check(synth_b[rs] < 1e-5, f"phasor_istft_ola_batch vs plain at Rs={rs}: {synth_b[rs]:.3e}")
        _check(bool((a[:, (nf_s - 100 - 1) * rs + N_FFT :] == 0).all()), "phasor_istft_ola_batch: masked frames leak")
        synth_b[f"{rs}/row1_bitwise_vs_single_kernel"] = bool(torch.equal(
            a[1], phasor_istft_ola(kb[0][1], kb[1][1], kb[2][1], N_FFT, rs, nf_s, bmask[1])))
    # The synthesis on fft_real.cuh's body (synth_real) at its smallest and
    # largest N: phasor_istft_ola masked at Rs = N/4 against its plain
    # version, and a rerun bitwise equal; then a ragged pvoc_fused_batch at
    # N = 2048 (a row of 3 frames, shorter than the overlap at Rs = 256),
    # each row bitwise equal to the single-recording kernel.
    for n in (256, 4096):
        mg, pr_, pi_, nf_n = stft_phasor_terms(x60, n, n // 4, n // 8)
        mask_n = torch.ones(nf_n, device=dev)
        mask_n[-100:] = 0.0
        a = phasor_istft_ola(mg, pr_, pi_, n, n // 4, nf_n, mask_n)
        synth[f"N{n}/masked"] = _rel(a, phasor_istft_ola_reference(mg, pr_, pi_, n, n // 4, nf_n, mask_n), n)
        synth[f"N{n}/rerun_bitwise"] = bool(torch.equal(a, phasor_istft_ola(mg, pr_, pi_, n, n // 4, nf_n, mask_n)))
        _check(synth[f"N{n}/masked"] < 1e-5 and synth[f"N{n}/rerun_bitwise"]
               and bool((a[(nf_n - 100 - 1) * (n // 4) + n :] == 0).all()), f"phasor_istft_ola at N={n}: {synth}")
        del mg, pr_, pi_
    lens_2k = [len(x60), int(37.0 * SR), 2048 + 2 * 512, int(51.0 * SR)]
    xs_2k = torch.zeros((4, len(x60)), device=dev)
    for i, n in enumerate(lens_2k):
        xs_2k[i, :n] = torch.as_tensor(_signal(n / SR, seed=20 + i)[:n], dtype=torch.float32, device=dev)
    nfs_2k = [(n - 2048) // 512 + 1 for n in lens_2k]
    for rs in (256, 1024, 683):
        k = fused_time_stretch_batch(xs_2k, 2048, 512, rs, nfs_2k)
        for b, nf_b in enumerate(nfs_2k):
            n_out = (nf_b - 1) * rs + 2048
            same = bool(torch.equal(k[b, :n_out], fused_time_stretch(xs_2k[b, : lens_2k[b]].contiguous(),
                                                                    2048, 512, rs)))
            _check(same and bool((k[b, n_out:] == 0).all()),
                   f"pvoc_fused_batch at N=2048, Rs={rs}: row {b} ({nf_b} frames) differs from the single kernel")
            batch_k[f"N2048/{rs}/row{b}_bitwise_vs_single_kernel"] = same
    del xs_2k, k
    # A ragged batch at N = 256 (the analysis' block-wide write sweep, 32
    # frames a block) and at N = 4096 (two frames a block): rows of 60 s,
    # 37 s, 4 frames and 0 frames at an odd row stride, each row bitwise
    # equal to the single-recording kernel, at k = 2 and a q >= 2 hop.
    for n in (256, 4096):
        hop = n // 4
        lens_n = [len(x60), int(37.0 * SR), n + 3 * hop, n - 1]
        xs_n = torch.zeros((4, len(x60) + 1), device=dev)  # an odd row stride
        for i, L in enumerate(lens_n):
            xs_n[i, :L] = torch.as_tensor(_signal(L / SR + 1.0, seed=30 + i)[:L], dtype=torch.float32, device=dev)
        nfs_n = [max(0, (L - n) // hop + 1) for L in lens_n]
        for rs in (n // 2, round(171 * n / 1024)):
            k = fused_time_stretch_batch(xs_n, n, hop, rs, nfs_n)
            for b, nf_b in enumerate(nfs_n):
                n_out = (nf_b - 1) * rs + n if nf_b else 0
                same = bool(torch.equal(k[b, :n_out], fused_time_stretch(xs_n[b, : lens_n[b]].contiguous(),
                                                                        n, hop, rs))) if nf_b else True
                _check(same and bool((k[b, n_out:] == 0).all()),
                       f"pvoc_fused_batch at N={n}, Rs={rs}: row {b} ({nf_b} frames) differs from the single kernel")
                batch_k[f"N{n}/{rs}/row{b}_bitwise_vs_single_kernel"] = same
        del xs_n, k
    _emit("2e_parallel_kernels_vs_plain", seconds=60, pvoc_fused_batch=batch_k, pvoc_terms_batch=terms_b,
          phasor_istft_ola_rel=synth, phasor_istft_ola_batch_rel=synth_b, masked_frames=100,
          bounds={"batch_vs_plain": 5e-5, "batch_vs_single_kernel": "bitwise", "mag_rel": 1e-5, "weighted": 1e-4,
                  "synthesis": 1e-5})
    del mag_s, pre_s, pim_s, kb, a, b

    # ---- 2f. segment_phase (csrc/phase_scan.cu) against its plain version,
    # bit for bit through an int32 view, and a rerun bit for bit: N = 256,
    # 1024 and 4096 (hop N/4); Rs = 128, 171 and 384 at N = 1024; F = 1,
    # 1000, 1024, 1025 and 4096; first segments (frame 0, not started),
    # mid-stream states and partial last segments of real 120 s signals;
    # phases whose increments sit within an ulp of +-pi.
    x120 = torch.as_tensor(_signal(120.0, seed=5), dtype=torch.float32, device=dev)
    sp = {}

    def sp_check(name, phi, st, **kw):
        args = (phi, st.phi_prev, st.psi_carry, st.psi_carry_lo, st.phi0)
        k = segment_phase(*args, **kw)
        p = segment_phase_reference(*args, **kw)
        again = segment_phase(*args, **kw)
        rec = {"F": phi.shape[0], "n_valid": kw["n_valid"], "frame_offset": kw["frame_offset"],
               "bitwise": all(_bits_equal(a, b) for a, b in zip(k, p)),
               "rerun_bitwise": all(_bits_equal(a, b) for a, b in zip(k, again)),
               "psi_max_abs": float((k[0] - p[0]).abs().max()),
               "psi_negative_zeros": int((k[0].view(torch.int32) == -(2 ** 31)).sum())}
        sp[name] = rec
        _check(rec["bitwise"] and rec["rerun_bitwise"], f"segment_phase vs plain, {name}: {rec}")

    def real_case(n, rs, F, segs, F_state=None, rows=None):
        """The segment after `segs` segments of F_state frames of x120's
        stream (a state the kernel made), its first `rows` rows (F)."""
        cfg_n = pv.PvocConfig(n_fft=n, hop=n // 4)
        F_state = F_state or F
        nf = (len(x120) - n) // (n // 4) + 1
        S = -(-nf // F_state)
        x_pad = streaming.pad_for_segments(x120, cfg_n, F_state, S)
        st = streaming.init_state(cfg_n, rs, device=dev)
        if segs:
            _, st = streaming._stream_scan_from(x_pad, st, nf, cfg_n, rs, F_state, segs)
        g = segs * F_state
        _, phi_all = pv.pipeline.analyze(x_pad, cfg_n)
        rows = rows or F
        phi = phi_all[g : g + rows].contiguous()
        if phi.shape[0] < rows:
            phi = torch.cat([phi, phi_all[: rows - phi.shape[0]]])
        kw = dict(ra=n // 4, rs=rs, n_fft=n, frame_offset=g, n_valid=min(rows, max(nf - g, 0)),
                  started=segs > 0)
        sp_check(f"N{n}_rs{rs}_F{rows}_after{segs}x{F_state}", phi, st, **kw)
        return phi, st, kw

    for rs in (128, 171, 384):
        for segs in (0, 2, 7):  # the first, a mid-stream and the last (partial) segment
            real_case(N_FFT, rs, 1024, segs)
    for F in (1, 1000, 1025, 4096):
        real_case(N_FFT, 171, F, 0, F_state=1024, rows=F)
        real_case(N_FFT, 171, F, 1, F_state=1024, rows=F)
    real_case(N_FFT, 171, 1000, 7, F_state=1000)  # 7497 frames: 497 real of 1000
    real_case(N_FFT, 171, 1025, 7, F_state=1025)  # 322 real of 1025
    # The edges of the kernel's schedule (tests/test_torch_segment_schedule.py
    # replays it on the CPU): trees of 8 to 512 rows for F below, at and
    # past a thread's 8 rows and a warp's 32 x 8, and 1030 frames, blocked
    # and not a multiple of 8.
    for F in (2, 7, 8, 9, 33, 65, 257, 513, 1030):
        real_case(N_FFT, 171, F, 0, F_state=1024, rows=F)
        real_case(N_FFT, 171, F, 1, F_state=1024, rows=F)
    for n in (256, 4096):
        for rs in (n // 8, round(171 * n / 1024)):
            for segs in (0, 1):
                real_case(n, rs, 1024, segs)
    # Phases whose heterodyned increments sit within an ulp of +-pi: a
    # running sum of (omega_k Ra +- pi) in float64, wrapped, rounded to
    # float32 and nudged by one ulp either way at random.
    gnp = np.random.default_rng(7)
    for n, rs, F in ((N_FFT, 128, 1024), (256, 171, 1000)):
        nb_n, ra_n = n // 2 + 1, n // 4
        het = ((np.arange(nb_n) * ra_n) % n) * (2 * np.pi / n)
        steps = np.where(gnp.random((F, nb_n)) < 0.5, np.pi, -np.pi) + het
        ph = np.angle(np.exp(1j * (gnp.uniform(-np.pi, np.pi, nb_n) + np.cumsum(steps, 0)))).astype(np.float32)
        ph = np.where(gnp.random(ph.shape) < 0.5, np.nextafter(ph, np.float32(np.inf)),
                      np.nextafter(ph, np.float32(-np.inf))).astype(np.float32)
        cfg_n = pv.PvocConfig(n_fft=n, hop=ra_n)
        st = streaming.init_state(cfg_n, rs, device=dev)
        st.phi_prev = torch.as_tensor(ph[-1], device=dev)
        phi = torch.as_tensor(ph, device=dev)
        sp_check(f"near_pi_N{n}_rs{rs}_F{F}", phi, st, ra=ra_n, rs=rs, n_fft=n, frame_offset=5 * F,
                 n_valid=F, started=True)
        sp_check(f"near_pi_N{n}_rs{rs}_F{F}_first", phi, st, ra=ra_n, rs=rs, n_fft=n, frame_offset=0,
                 n_valid=F - 3, started=False)
    # Timed at the main path's shape: a mid-stream 1024-frame segment at
    # N = 1024, Rs = 128 (0.5x): the mean of 101 single calls between CUDA
    # events (the wrapper's host time included), the device time of 101
    # calls from one torch.profiler trace, the plain version's calls.
    phi_m, st_m, kw_m = real_case(N_FFT, 128, 1024, 2)
    args_m = (phi_m, st_m.phi_prev, st_m.psi_carry, st_m.psi_carry_lo, st_m.phi0)
    nb = N_FFT // 2 + 1
    sp_prof = _profile_call(lambda: segment_phase(*args_m, **kw_m), reps=101)
    _check([k.split("<")[0] for k in sp_prof["by_kernel_ms"]] == ["segment_phase_kernel"] and sp_prof["kernels"] == 1,
           f"segment_phase launches {sp_prof}")
    sp_main = {
        "frames": 1024, "max_abs": 0.0,
        "ms": sp_prof["device_busy_ms"],
        "events_ms": _time_ms(lambda: segment_phase(*args_m, **kw_m), reps=101),
        "plain_ms": _time_ms(lambda: segment_phase_reference(*args_m, **kw_m), reps=5),
        "library_ms": None,
        # phi in, psi out, six nb-vectors in (phi_prev, carry, phi0, het
        # hi and lo), the carry out.
        **_bound(4 * (2 * 1024 * nb + 8 * nb), _segment_phase_flop(1024, nb)),
    }
    # The wrapper's host time a call: what the events see beyond the card.
    sp_main["events_minus_device_ms"] = sp_main["events_ms"] - sp_main["ms"]
    # The layout at the other ends of the bin count (two bins a block at
    # N = 256, four at 4096), mid-stream, 1024 frames, Rs = N/8.
    sp_main["device_ms_by_n_fft"] = {}
    for n in (256, 4096):
        phi_n, st_n, kw_n = real_case(n, n // 8, 1024, 2)
        args_n = (phi_n, st_n.phi_prev, st_n.psi_carry, st_n.psi_carry_lo, st_n.phi0)
        sp_main["device_ms_by_n_fft"][n] = _profile_call(lambda: segment_phase(*args_n, **kw_n),
                                                         reps=101)["device_busy_ms"]
    _emit("2f_segment_phase_vs_plain", cases=sp, all_bitwise=True, main_shape=sp_main)
    del x120

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

    # ---- 3c. golden gate of the fused stream, the general-hop route and
    # the polar stages at Rs = 171, 60 s
    ggate = {}
    for s in (2.0, 0.5):
        y = streaming.fused_stream_time_stretch(x60_np, s, cfg)
        ggate[f"fused_stream_{s}"] = _rel(y, pv_ref.phase_vocoder(x60_np, s, N_FFT, HOP))
    for s in (2.5, 3.0):
        y = pv.time_stretch(x60_np, s, cfg)
        ggate[f"stretch_{s}"] = _rel(y, pv_ref.phase_vocoder(x60_np, s, N_FFT, HOP))
    mag_s, phi_s = pv.pipeline.analyze(x60, cfg)
    mag_s, psi_s = pv.pipeline.stretch_polar(mag_s, phi_s, cfg, 171)
    y = pv.pipeline.synthesize_polar(mag_s, psi_s, cfg, 171)
    ggate["polar_stages_rs171"] = _rel(y, pv_ref.phase_vocoder(x60_np, 171 / HOP, N_FFT, HOP))
    for name, err in ggate.items():
        _check(err < 1e-4, f"{name} vs golden: {err:.3e}")
    y = pv.pitch_shift(x60_np, 19.0, cfg)
    ref = pv_ref.pitch_shift(x60_np, 19.0, N_FFT, HOP)
    _check(abs(len(y) - len(ref)) <= 1, f"pitch +19 length {len(y)} vs {len(ref)}")
    n = min(len(y), len(ref))
    ggate["pitch_19"] = _rel(y[:n], torch.as_tensor(ref[:n]))
    _check(ggate["pitch_19"] < 1e-3, f"pitch_shift +19 vs golden: {ggate['pitch_19']:.3e}")
    _emit("3c_stream_and_general_golden_gate", seconds=60, rel_err=ggate,
          bounds={"stretch": 1e-4, "pitch": 1e-3})
    del mag_s, phi_s, psi_s

    # ---- 3d. golden gate of the parallel entry points, 60 s
    golden = {}

    def _golden(x_np, s):
        key = (id(x_np), s)
        if key not in golden:
            golden[key] = pv_ref.phase_vocoder(x_np, s, N_FFT, HOP)
        return golden[key]

    pgate = {}
    xs_g = [x60_np, _signal(45.0, seed=4), _signal(60.0, seed=5), _signal(30.0, seed=6)]
    for x_np, r, y in zip(xs_g, (0.5, 1.0, 1.5, 2.0),
                          pv.batch_time_stretch_varied(xs_g, [0.5, 1.0, 1.5, 2.0], cfg)):
        pgate[f"batch_varied_{r}"] = _rel(y, _golden(x_np, r))
    m11 = make_mesh_2d(1, 1)
    for s in (0.5, 2.0):
        pgate[f"chunked_force_{s}"] = _rel(chunked.chunked_time_stretch(x60_np, s, cfg, force=True),
                                           _golden(x60_np, s))
        ys = chunked.batched_chunked_time_stretch(np.stack([x60_np, xs_g[2]]), s, cfg, mesh=m11)
        for i, x_np in enumerate((x60_np, xs_g[2])):
            pgate[f"batched_chunked_{s}/row{i}"] = _rel(ys[i], _golden(x_np, s))
    for name, err in pgate.items():
        _check(err < 1e-4, f"{name} vs golden: {err:.3e}")
    _emit("3d_parallel_golden_gate", seconds=60, rel_err=pgate, bound=1e-4)
    del golden, ys

    # ---- 4. main path at real size
    x_long = torch.as_tensor(_signal(3600.0), dtype=torch.float32, device=dev)
    x_pitch = torch.as_tensor(_signal(300.0, seed=1), dtype=torch.float32, device=dev)
    # Each path's counts over its 4 calls (one warm-up, 3 timed).
    timed = {}
    launches = {
        "stretch_2x_3600s": _counted(
            counters, lambda: timed.update(stretch=_time_ms(lambda: pv.time_stretch(x_long, 2.0, cfg), reps=3)),
            {"pvoc_fused": 4}, "time_stretch 2.0x"),
        "pitch_m7_300s": _counted(
            counters, lambda: timed.update(pitch=_time_ms(lambda: pv.pitch_shift(x_pitch, -7.0, cfg), reps=3)),
            {"pvoc_fused": 4, "resample_lerp": 4}, "pitch_shift -7 st"),
    }
    stretch_ms, pitch_ms = timed["stretch"], timed["pitch"]
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
        nf_x = (len(x) - N_FFT) // HOP + 1
        shapes[name] = {
            "rel": rel, "max_abs": _max_abs(a, b),
            "ms": _time_ms(lambda: fused_time_stretch(x, N_FFT, HOP, rs), reps=3),
            "plain_ms": _time_ms(lambda: fused_time_stretch_reference(x, N_FFT, HOP, rs), reps=1),
            **_bound(4 * (len(x) + len(a)), 2 * nf_x * _FFT_FLOP),
        }
        del a, b
    # Row 1's passes, from one profiled call: the analysis (analysis_real),
    # the anchor table (phase_anchor), the synthesis with the integer-k
    # phase in its load (synth_real<10, 2>: kClosed) and the row gather
    # (ola_rows<4>: float4 runs).
    split = _profile_call(lambda: fused_time_stretch(x_long, N_FFT, HOP, 512))
    passes = ("analysis_real<10>", "phase_anchor", "synth_real<10, 2>", "ola_rows<4>")
    _check(sorted(split["by_kernel_ms"]) == sorted(passes) and split["kernels"] == len(passes),
           f"pvoc_fused at 2.0x / 3600 s: passes {split}")
    shapes["stretch_2x_3600s"]["passes"] = split
    # Which kernels pvoc_fused launches at integer k (2.0x, hop N/4) at each
    # N, from a profiled call on 60 s: no phase_closed where fft_real.cuh
    # serves N (the phase in synth_real's load), phase_closed at N = 768.
    routes = {}
    for n in POW2_SIZES + (768,):
        names = _profile_call(lambda: fused_time_stretch(x60, n, n // 4, n // 2))["by_kernel_ms"]
        routes[n] = sorted(names)
        l2 = {256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12}.get(n)
        want = (("analysis_real<%d>" % l2, "phase_anchor", "synth_real<%d, 2>" % l2, "ola_rows<4>")
                if l2 else ("fft_analysis<false>", "phase_closed", "fft_synthesis<false>", "ola_rows<4>"))
        _check(routes[n] == sorted(want), f"pvoc_fused at N={n}, integer k: kernels {routes[n]}")
    shapes["stretch_2x_3600s"]["kernels_by_n_fft"] = routes
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
    # One PyTorch call interpolating linearly to out_len points (its
    # positions are i*(n-1)/(out_len-1), the kernel's i*step).
    res_lib_ms = _time_ms(lambda: torch.nn.functional.interpolate(
        y_st[None, None], size=out_len, mode="linear", align_corners=True), reps=20)
    res_bound = _bound(4 * (len(y_st) + out_len), 3 * out_len)
    # Rows 2 and 15-17 and F.interpolate at this shape, each the median of
    # 101 single calls timed by CUDA events, in turns, in this phase (their
    # means over 20 calls spread by up to 2x between runs).
    bt = block_tables(1.0 / factor, out_len, dev)
    t1 = select_tables(1.0 / factor, out_len, len(y_st), "roll", dev)
    t2 = select_tables(1.0 / factor, out_len, len(y_st), "roll2", dev)
    med_fns = {
        "resample_lerp": lambda: resample_linear(y_st, 1.0 / factor, out_len),
        "resample_blocked": lambda: resample_blocked(y_st, *bt, out_len),
        "select_lerp_roll2": lambda: select_lerp_two_level(y_st, t2["origin"], t2["bases"], t2["k"],
                                                           t2["fr"], t2["c"]),
        "select_lerp": lambda: select_lerp(y_st, t1["origin"], t1["k"], t1["fr"], t1["c"]),
        "F.interpolate": lambda: torch.nn.functional.interpolate(
            y_st[None, None], size=out_len, mode="linear", align_corners=True),
    }
    med_calls = {name: [] for name in med_fns}
    for _ in range(101):
        for name, fn in med_fns.items():
            med_calls[name] += _time_calls(fn, reps=1)
    medians = {name: float(np.median(v)) for name, v in med_calls.items()}
    spread = {name: [float(np.percentile(v, 10)), float(np.percentile(v, 90))]
              for name, v in med_calls.items()}
    # The same five as device time (what the card spends in each call's
    # kernels, without the host time of the wrappers that the medians
    # include), the mean over 101 calls from one torch.profiler trace each,
    # with the kernels' names: one kernel a call.
    device = {name: _profile_call(fn, reps=101) for name, fn in med_fns.items()}
    for name, rec in device.items():
        _check(rec["kernels"] == 1 or name == "F.interpolate", f"{name}: {rec['kernels']} kernels a call")
    device_ms = {name: rec["device_busy_ms"] for name, rec in device.items()}
    device_kernels = {name: sorted(rec["by_kernel_ms"]) for name, rec in device.items()}
    _check(device_kernels["select_lerp"] == ["select_lerp_kernel<true>"]
           and device_kernels["select_lerp_roll2"] == ["select_lerp_kernel<true>"],
           f"the select kernels by name: {device_kernels}")
    del bt, t1, t2, med_fns
    # Row 1 at -7 st (q >= 2) by pass, from one profiled call: the carry
    # scan is scan_carry_staged.
    split_q2 = _profile_call(lambda: fused_time_stretch(x_pitch, N_FFT, HOP, rs_pitch))
    _check("scan_carry_staged" in split_q2["by_kernel_ms"], f"pvoc_fused at Rs={rs_pitch}: passes {split_q2}")
    shapes["pitch_m7_300s"]["passes"] = split_q2
    _emit("4b_kernel_vs_plain_main_shapes", card=smi, pvoc_fused=shapes,
          resample_m7_300s={"max_abs": res_abs, "ms": res_ms, "plain_ms": res_plain_ms,
                            "library_ms": res_lib_ms, **res_bound,
                            "n_in": len(y_st), "n_out": out_len},
          select_medians_ms_101_calls=medians, select_p10_p90_ms=spread,
          select_device_ms_101_calls=device_ms, select_device_kernels=device_kernels)

    del y_st, a, b
    torch.cuda.empty_cache()

    # ---- 4c. the branch-faithful route at real size, through "auto"
    ff_sec = 660.0
    x_ff_np = _signal(ff_sec, seed=2)
    x_ff = torch.as_tensor(x_ff_np, dtype=torch.float32, device=dev)
    nf_ff = (len(x_ff) - N_FFT) // HOP + 1
    _check(nf_ff > pv.pipeline.BRANCH_FAITHFUL_FRAMES, f"{nf_ff} frames do not reroute")
    segments = -(-nf_ff // streaming.DEFAULT_SEGMENT_FRAMES)
    ff_runs = {
        "stretch_0.5x_660s": lambda: pv.time_stretch(x_ff, 0.5, cfg),
        "pitch_m7_660s": lambda: pv.pitch_shift(x_ff, -7.0, cfg),
    }
    # Per call: one stft_polar over the padded recording; one segment_phase
    # per segment; one istft_ola per segment at Rs = 128 (Rs = 171 does not
    # divide N: no istft_ola); no pvoc_fused, since "auto" reroutes.
    ff_expect = {
        "stretch_0.5x_660s": {"stft_polar": 4, "istft_ola": 4 * segments, "segment_phase": 4 * segments},
        "pitch_m7_660s": {"stft_polar": 4, "resample_lerp": 4, "segment_phase": 4 * segments},
    }
    ff, ff_launches = {}, {}
    for name, fn in ff_runs.items():
        ff[name] = {}
        ff_launches[name] = _counted(
            counters, lambda: ff[name].update(ms=_time_calls(fn, reps=3)), ff_expect[name], name)
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
    # segment_phase inside the route at full size: the same runs with the
    # plain phase chain swapped in must give the same output, bit for bit.
    for name, fn in ff_runs.items():
        y_k = y if name == "stretch_0.5x_660s" else fn()
        streaming.segment_phase = segment_phase_reference
        try:
            y_plain_scan = fn()
        finally:
            streaming.segment_phase = segment_phase
        ff[name]["vs_plain_scan_bitwise"] = _bits_equal(y_k, y_plain_scan)
        _check(bool(torch.equal(y_k, y_plain_scan)) and ff[name]["vs_plain_scan_bitwise"],
               f"{name}: segment_phase vs the plain phase chain inside the route differ")
        del y_k, y_plain_scan
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
    prof = _profile_call(ff_runs["stretch_0.5x_660s"])
    ff["profile_0.5x"] = prof
    ff["kernels_per_segment"] = prof["kernels"] / segments
    ff["segments"] = segments
    print(f"faithful 0.5x / 660 s: {prof['kernels']:.0f} kernels a call, "
          f"{ff['kernels_per_segment']:.2f} a segment over {segments} segments", flush=True)
    _check(prof["kernels"] <= 1000, f"the faithful 0.5x call launches {prof['kernels']} kernels")
    ff["profile_m7"] = _profile_call(ff_runs["pitch_m7_660s"])
    ff["kernels_per_segment_m7"] = ff["profile_m7"]["kernels"] / segments
    # What launched them, from one more traced call each (Python stacks):
    # the scan, the mask and window norm, istft_ola or the matmul
    # synthesis, the epilogue, the state updates, and outside the step.
    ff["split_0.5x"] = _kernel_split(ff_runs["stretch_0.5x_660s"], streaming.DEFAULT_SEGMENT_FRAMES)
    ff["split_m7"] = _kernel_split(ff_runs["pitch_m7_660s"], streaming.DEFAULT_SEGMENT_FRAMES)
    # The faithful route on 3600 s (224,997 frames, 220 segments) at 0.5x
    # and -7 st: one timed call after a warm-up, and one traced call.
    hour = {}
    for name, fn in (("stretch_0.5x_3600s", lambda: pv.time_stretch(x_long, 0.5, cfg)),
                     ("pitch_m7_3600s", lambda: pv.pitch_shift(x_long, -7.0, cfg))):
        hour[name] = {"ms": _time_calls(fn, reps=1)[0], **_profile_call(fn)}
        hour[name]["audio_s_per_s"] = 3600.0 / (hour[name]["ms"] / 1e3)
        y = fn()
        _check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        hour[name]["length"] = len(y)
        del y
    _check(hour["stretch_0.5x_3600s"]["length"] == pv.stretch_output_length(len(x_long), cfg, 0.5),
           "faithful 0.5x / 3600 s length")
    ff["faithful_3600s"] = hour
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
    hann = torch.hann_window(N_FFT, device=dev)
    stft_main.update(
        frames=mag_k.shape[0],
        ms=_time_ms(lambda: stft_polar(x_pad, N_FFT, HOP), reps=20),
        plain_ms=_time_ms(lambda: stft_polar_reference(x_pad, N_FFT, HOP), reps=5),
        # torch.stft: the same windowed spectrum, complex instead of polar.
        library_ms=_time_ms(lambda: torch.stft(x_pad, N_FFT, HOP, window=hann, center=False,
                                               return_complex=True), reps=5),
        **_bound(4 * (len(x_pad) + 2 * mag_k.numel()), mag_k.shape[0] * _FFT_FLOP),
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
        # torch.istft on mag e^{i psi}: the same sum, window-normalized.
        spec_c = torch.polar(m_, p_).T.contiguous()
        rec["library_ms"] = _time_ms(lambda: torch.istft(spec_c, N_FFT, 128, window=hann, center=True), reps=5)
        rec.update(_bound(4 * (2 * m_.numel() + m_.shape[0] + len(a)), m_.shape[0] * _FFT_FLOP))
        istft_main[name] = rec
    # stft_fused, the cartesian form, called as a user would on the padded
    # 660 s signal: its own counted path (4 calls), then against its plain
    # version at that shape.
    fused_main = {}
    fused_launches = _counted(
        counters, lambda: fused_main.update(ms_calls=_time_calls(lambda: stft_fused(x_pad, N_FFT, HOP), reps=3)),
        {"stft_fused": 4}, "stft_fused on 660 s")
    re_k, im_k = stft_fused(x_pad, N_FFT, HOP)
    re_p, im_p = stft_fused_reference(x_pad, N_FFT, HOP)
    fused_main["max_abs"] = max(float((re_k - re_p).abs().max()), float((im_k - im_p).abs().max()))
    fused_main["rel_to_max"] = fused_main["max_abs"] / float(mag_p.max())
    _check(fused_main["rel_to_max"] < 1e-5, f"stft_fused vs plain at 660 s: {fused_main}")
    fused_main.update(
        frames=re_k.shape[0],
        ms=_time_ms(lambda: stft_fused(x_pad, N_FFT, HOP), reps=20),
        plain_ms=_time_ms(lambda: stft_fused_reference(x_pad, N_FFT, HOP), reps=5),
        library_ms=_time_ms(lambda: torch.stft(x_pad, N_FFT, HOP, window=hann, center=False,
                                               return_complex=True), reps=20),
        **_bound(4 * (len(x_pad) + 2 * re_k.numel()), re_k.shape[0] * _FFT_FLOP),
    )
    del re_k, im_k, re_p, im_p
    _emit("4c_stft_kernels_vs_plain_main_shapes", card=smi, stft_polar=stft_main,
          istft_ola_rs128=istft_main, stft_fused=fused_main, stft_fused_launches=fused_launches)
    del x_pad, mag_p, phi_p, a, b

    # ---- 4d. the fused stream, checkpoints and the general-hop route at
    # real size
    torch.cuda.empty_cache()
    nf_long = (len(x_long) - N_FFT) // HOP + 1
    F_long, S_long = streaming.fused_plan_segments(
        nf_long, N_FFT, 512, streaming.DEFAULT_FUSED_SEGMENT_FRAMES)
    stream_run = lambda: streaming.fused_stream_time_stretch(x_long, 2.0, cfg)  # noqa: E731
    fs = {"frames": nf_long, "segment_frames": F_long, "segments": S_long}
    fs["launches"] = _counted(counters, lambda: fs.update(ms=_time_calls(stream_run, reps=3)),
                              {"pvoc_fused_segment": 4 * S_long}, "fused stream 2.0x")
    fs["audio_s_per_s"] = [3600.0 / (ms / 1e3) for ms in fs["ms"]]
    fs["monolithic_ms"] = _time_calls(lambda: fused_time_stretch(x_long, N_FFT, HOP, 512), reps=3)
    fs["peak_gb"] = _peak_gb(stream_run)
    fs["monolithic_peak_gb"] = _peak_gb(lambda: fused_time_stretch(x_long, N_FFT, HOP, 512))
    fs["input_gb"] = x_long.numel() * 4 / 1e9
    fs["syncs_per_call"] = _syncs_per_call(stream_run)
    _check(fs["syncs_per_call"] == 0, f"the fused stream synchronizes {fs['syncs_per_call']} times")
    y_stream = stream_run()
    _check(bool(torch.equal(y_stream, fused_time_stretch(x_long, N_FFT, HOP, 512))),
           "fused stream differs from the monolithic kernel at 3600 s")
    fs["bitwise_vs_monolithic"] = True
    # The checkpointed fused stream: uninterrupted, then killed after two
    # batches and resumed. Its wall time split: device_s between CUDA events
    # around each batch's segment loop; fetch_s, the host copies of the
    # parts (which wait for the batch); save_s, the part and state writes
    # (on the save thread, overlapping the next batch); load_s, the read of
    # all parts at the end.
    clock = _Clock()
    streaming._fused_scan_from = clock.wrap_device(streaming._fused_scan_from)
    ckpt._part_to_numpy = clock.wrap("fetch_s", ckpt._part_to_numpy)
    ckpt.StreamCheckpointer.save_batch = clock.wrap("save_s", ckpt.StreamCheckpointer.save_batch)
    ckpt.StreamCheckpointer.load_parts = clock.wrap("load_s", ckpt.StreamCheckpointer.load_parts)
    ck = {}
    with tempfile.TemporaryDirectory(prefix="pvoc_ck_") as tmp:
        for name, kw in (("uninterrupted", {}), ("killed", {"_fail_after_batches": 2}),
                         ("resumed", {})):
            clock.reset()
            d = tmp + ("/a" if name == "uninterrupted" else "/b")
            t0 = time.perf_counter()
            try:
                y = ckpt.checkpointed_fused_stream_time_stretch(x_long, 2.0, cfg, checkpoint_dir=d, **kw)
                torch.cuda.synchronize()
            except RuntimeError as e:
                _check("injected" in str(e) and name == "killed", f"checkpointed run failed: {e}")
                y = None
            ck[name] = {"wall_s": time.perf_counter() - t0, **clock.read(),
                        "bytes_on_disk": _dir_bytes(d),
                        "batches_done": ckpt.StreamCheckpointer(d).completed_batches()}
            if name == "uninterrupted":
                y_full = y
            elif name == "resumed":
                _check(bool(torch.equal(y, y_full)), "resumed fused checkpointed run differs")
                _check(bool(torch.equal(y_full, y_stream)), "checkpointed fused run differs from the stream")
        _check(ck["killed"]["batches_done"] == [1], f"killed fused run left {ck['killed']['batches_done']}")
        ck["bitwise_resumed_vs_uninterrupted_vs_stream"] = True
        fs["checkpointed"] = ck
        del y_full, y
        # The checkpointed polar stream, 0.5x on 660 s.
        pk = {}
        for name, kw in (("uninterrupted", {}), ("killed", {"_fail_after_batches": 2}),
                         ("resumed", {})):
            d = tmp + ("/pa" if name == "uninterrupted" else "/pb")
            t0 = time.perf_counter()
            try:
                y = ckpt.checkpointed_stream_time_stretch(x_ff, 0.5, cfg, checkpoint_dir=d, **kw)
                torch.cuda.synchronize()
            except RuntimeError as e:
                _check("injected" in str(e) and name == "killed", f"checkpointed polar run failed: {e}")
                y = None
            pk[name] = {"wall_s": time.perf_counter() - t0, "bytes_on_disk": _dir_bytes(d),
                        "batches_done": ckpt.StreamCheckpointer(d).completed_batches()}
            if name == "uninterrupted":
                y_pfull = y
            elif name == "resumed":
                _check(bool(torch.equal(y, y_pfull)), "resumed polar checkpointed run differs")
        _check(pk["killed"]["batches_done"] == [1], f"killed polar run left {pk['killed']['batches_done']}")
        pk["bitwise_resumed_vs_uninterrupted"] = True
        pk["bitwise_vs_stream"] = bool(torch.equal(y_pfull, streaming.stream_time_stretch(x_ff, 0.5, cfg)))
        fs["checkpointed_polar_0.5x_660s"] = pk
    _emit("4d_fused_stream_and_checkpoints", card=smi, fused_stream_2x_3600s=fs)
    del y_stream, y_pfull

    # The general-hop route and the polar stages at Rs = 171, each path
    # with its own counts over its 4 calls (one warm-up, 3 timed).
    def polar_stages():
        mag, phi = pv.pipeline.analyze(x_pitch, cfg)
        mag, psi = pv.pipeline.stretch_polar(mag, phi, cfg, 171)
        return pv.pipeline.synthesize_polar(mag, psi, cfg, 171)

    gen, gen_launches = {}, {}
    for name, secs, fn, expect in (
        ("stretch_3x_3600s", 3600.0, lambda: pv.time_stretch(x_long, 3.0, cfg),
         {"pvoc_terms": 4, "istft_frames_cart": 4}),
        ("pitch_19_300s", 300.0, lambda: pv.pitch_shift(x_pitch, 19.0, cfg),
         {"pvoc_terms": 4, "istft_frames_cart": 4, "resample_lerp": 4}),
        ("polar_stages_rs171_300s", 300.0, polar_stages, {"stft_polar": 4, "istft_frames": 4}),
    ):
        gen[name] = {}
        gen_launches[name] = _counted(
            counters, lambda: gen[name].update(ms=_time_calls(fn, reps=3)), expect, name)
        gen[name]["audio_s_per_s"] = [secs / (ms / 1e3) for ms in gen[name]["ms"]]
    gen["stretch_3x_3600s"]["peak_gb"] = _peak_gb(lambda: pv.time_stretch(x_long, 3.0, cfg))
    y = pv.time_stretch(x_long, 3.0, cfg)
    _check(len(y) == pv.stretch_output_length(len(x_long), cfg, 3.0) and bool(torch.isfinite(y).all()),
           "general-hop 3.0x output")
    y = pv.pitch_shift(x_pitch, 19.0, cfg)
    _check(bool(torch.isfinite(y).all()), "pitch +19 output")
    del y
    # Their kernels against the plain versions at those shapes (these
    # launches are not counted above).
    kt = stft_phasor_terms(x_long, N_FFT, HOP, 768)
    pt = stft_phasor_terms_reference(x_long, N_FFT, HOP, 768)
    terms_main = _weighted_phasor_err(kt, pt)
    # P is a product over all 224,997 frames: two f32 analyses' step terms
    # differ by ~1e-7 rad and their difference walks like sqrt(frames)
    # (7.9e-5 measured on an H100; 1.1e-5 to 1.6e-5 at 60 s), so 3e-4 here.
    _check(terms_main["mag_rel"] < 1e-5 and terms_main["p_weighted"] < 3e-4,
           f"pvoc_terms vs plain at 3.0x / 3600 s: {terms_main}")
    # Its passes from one torch.profiler trace: the analysis, the terms
    # with the in-chunk products, the carry scan and the apply pass.
    split = _profile_call(lambda: stft_phasor_terms(x_long, N_FFT, HOP, 768))
    passes = ("analysis_real<10>", "terms_chunks<true, 1>", "scan_carry_staged", "scan_apply_chunks<1>")
    _check(sorted(split["by_kernel_ms"]) == sorted(passes) and split["kernels"] == len(passes),
           f"pvoc_terms at 3.0x / 3600 s: passes {split}")
    terms_main["passes"] = split
    terms_main.update(frames=nf_long,
                      ms=_time_ms(lambda: stft_phasor_terms(x_long, N_FFT, HOP, 768), reps=5),
                      plain_ms=_time_ms(lambda: stft_phasor_terms_reference(x_long, N_FFT, HOP, 768), reps=1),
                      **_bound(4 * (len(x_long) + 3 * kt[0].numel()), nf_long * _FFT_FLOP))
    y_re, y_im = kt[0] * kt[1], kt[0] * kt[2]
    del kt, pt
    a = istft_frames_cart(y_re, y_im, N_FFT)
    b = istft_frames_cart_reference(y_re, y_im, N_FFT)
    cart_main = {"frames": nf_long, "rel_to_max": float((a - b).abs().max() / b.abs().max()),
                 "max_abs": float((a - b).abs().max())}
    _check(cart_main["rel_to_max"] < 1e-5, f"istft_frames_cart vs plain at 3.0x / 3600 s: {cart_main}")
    del a, b
    y_cplx = torch.complex(y_re, y_im)
    # torch.fft.irfft: the same inverse transforms, without the window.
    cart_main.update(ms=_time_ms(lambda: istft_frames_cart(y_re, y_im, N_FFT), reps=5),
                     plain_ms=_time_ms(lambda: istft_frames_cart_reference(y_re, y_im, N_FFT), reps=5),
                     library_ms=_time_ms(lambda: torch.fft.irfft(y_cplx, n=N_FFT, dim=-1), reps=5),
                     **_bound(4 * (2 * y_re.numel() + nf_long * N_FFT), nf_long * _FFT_FLOP))
    del y_cplx
    del y_re, y_im
    mag, phi = pv.pipeline.analyze(x_pitch, cfg)
    mag, psi = pv.pipeline.stretch_polar(mag, phi, cfg, 171)
    a, b = istft_frames(mag, psi, N_FFT), istft_frames_reference(mag, psi, N_FFT)
    polar_main = {"frames": mag.shape[0], "rel_to_max": float((a - b).abs().max() / b.abs().max()),
                  "max_abs": float((a - b).abs().max()),
                  "ms": _time_ms(lambda: istft_frames(mag, psi, N_FFT), reps=10),
                  "plain_ms": _time_ms(lambda: istft_frames_reference(mag, psi, N_FFT), reps=10),
                  **_bound(4 * (2 * mag.numel() + mag.shape[0] * N_FFT), mag.shape[0] * _FFT_FLOP)}
    spec_p = torch.polar(mag, psi)
    polar_main["library_ms"] = _time_ms(lambda: torch.fft.irfft(spec_p, n=N_FFT, dim=-1), reps=10)
    del spec_p
    _check(polar_main["rel_to_max"] < 1e-5, f"istft_frames vs plain at Rs=171 / 300 s: {polar_main}")
    del a, b, mag, phi, psi
    # pvoc_fused_segment at the main path's shape: one 8192-frame segment
    # from the kernel stream's state after 10 segments, kernel and plain;
    # then the whole kernel stream against the whole plain stream.
    _, st10 = streaming._fused_scan_from(
        x_long, streaming.fused_init_state(N_FFT, 512, dev), nf_long, N_FFT, HOP, 512, F_long, 10)
    seg_args = (x_long, st10.carry, st10.tail, 1, 10 * F_long, nf_long, N_FFT, HOP, 512, F_long)
    ka, _, kt = fused_stream_segment(*seg_args)
    pa, _, pt = fused_stream_segment_reference(*seg_args)
    seg_main = {"frames": F_long, "rel": _rel(ka, pa, 0), "max_abs": _max_abs(ka, pa, 0),
                "tail_rel": _rel(kt.reshape(-1), pt.reshape(-1), 0),
                "events_ms": _time_ms(lambda: fused_stream_segment(*seg_args), reps=10),
                "plain_ms": _time_ms(lambda: fused_stream_segment_reference(*seg_args), reps=3),
                **_bound(4 * ((F_long - 1) * HOP + N_FFT + len(ka) + 2 * kt.numel() + 2 * st10.carry.numel()),
                         2 * F_long * _FFT_FLOP)}
    # Its time on the card: the device time of one segment's kernels (the
    # mean over 20 calls in one trace), by kernel; the events time above
    # also holds the wrapper's host time.
    seg_prof = _profile_call(lambda: fused_stream_segment(*seg_args), reps=20)
    seg_main.update(ms=seg_prof["device_busy_ms"], kernels=seg_prof["kernels"], by_kernel_ms=seg_prof["by_kernel_ms"])
    _check(max(seg_main["rel"], seg_main["tail_rel"]) < 1e-5,
           f"pvoc_fused_segment vs plain at 3600 s: {seg_main}")
    y_k = stream_run()
    seg_main["stream_rel"] = _rel(y_k, _plain_stream(x_long, nf_long, 512, F_long, S_long))
    _check(seg_main["stream_rel"] < 3e-5, f"fused stream vs plain stream at 3600 s: {seg_main}")
    del y_k, ka, pa, kt, pt, st10
    _emit("4d_general_hop_main_path", card=smi, launches=gen_launches, **gen,
          pvoc_terms_3x_3600s=terms_main, istft_frames_cart_3x_3600s=cart_main,
          istft_frames_rs171_300s=polar_main, pvoc_fused_segment_2x_3600s=seg_main)

    # ---- 4e. the parallel layer at full width
    # The BASELINE batch: 64 utterances of 5-30 s, six ratios, one batched
    # launch per synthesis hop (6 per call; 4 calls).
    xs64, ratios64 = baseline_batch(SR)
    xs64 = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs64]
    audio64 = sum(len(x) for x in xs64) / SR
    run64 = lambda: pv.batch_time_stretch_varied(xs64, ratios64, cfg)  # noqa: E731
    b64 = {"utterances": 64, "audio_seconds": audio64,
           "frames": sum((len(x) - N_FFT) // HOP + 1 for x in xs64)}
    b64["launches"] = _counted(counters, lambda: b64.update(ms=_time_calls(run64, reps=3)),
                               {"pvoc_fused_batch": 24}, "64-utterance batch")
    b64["audio_s_per_s"] = [audio64 / (ms / 1e3) for ms in b64["ms"]]
    worst, bitwise = 0.0, True
    for x, r, y in zip(xs64, ratios64, run64()):
        single = fused_time_stretch(x, N_FFT, HOP, cfg.synthesis_hop(r))
        worst = max(worst, _rel(y, single))
        bitwise = bitwise and bool(torch.equal(y, single))
    _check(worst <= 1e-6, f"64-utterance batch rows vs the single-recording kernel: {worst:.3e}")
    b64.update(rel_vs_single_kernel_max=worst, bitwise_vs_single_kernel=bitwise)
    # pvoc_fused_batch against its plain version on the batch's 2.0x group.
    rows = [x for x, r in zip(xs64, ratios64) if r == 2.0]
    t_max = max(len(x) for x in rows)
    xb = torch.stack([torch.nn.functional.pad(x, (0, t_max - len(x))) for x in rows])
    nfs_b = [(len(x) - N_FFT) // HOP + 1 for x in rows]
    a = fused_time_stretch_batch(xb, N_FFT, HOP, 512, nfs_b)
    b = fused_time_stretch_batch_reference(xb, N_FFT, HOP, 512, nfs_b)
    spans = [(nf_b - 1) * 512 + N_FFT for nf_b in nfs_b]
    fb_main = {"rows": len(rows), "frames": sum(nfs_b),
               "rel": max(_rel(a[i, :n], b[i, :n]) for i, n in enumerate(spans)),
               "max_abs": max(_max_abs(a[i, :n], b[i, :n]) for i, n in enumerate(spans)),
               "ms": _time_ms(lambda: fused_time_stretch_batch(xb, N_FFT, HOP, 512, nfs_b), reps=10),
               "plain_ms": _time_ms(lambda: fused_time_stretch_batch_reference(xb, N_FFT, HOP, 512, nfs_b), reps=1),
               **_bound(4 * (sum((nf_b - 1) * HOP + N_FFT for nf_b in nfs_b) + a.numel()),
                        2 * sum(nfs_b) * _FFT_FLOP)}
    _check(fb_main["rel"] < 5e-5, f"pvoc_fused_batch vs plain at the 2.0x group: {fb_main}")
    _emit("4e_batch_64_utterances", card=smi, **b64, pvoc_fused_batch_2x_group=fb_main)
    del xs64, xb, a, b

    # chunked_time_stretch(force=True) on the card at 3600 s, beside the
    # single route ("fast" at 0.5x, as the chunked program never reroutes).
    ch = {}
    for s, expect in ((2.0, {"pvoc_fused_segment": 4}), (0.5, {"pvoc_terms": 4, "phasor_istft_ola": 4})):
        rec = {}
        run = lambda: chunked.chunked_time_stretch(x_long, s, cfg, force=True)  # noqa: E731
        single = lambda: pv.time_stretch(x_long, s, cfg, branch_policy="fast")  # noqa: E731
        rec["launches"] = _counted(counters, lambda: rec.update(ms=_time_calls(run, reps=3)), expect,
                                   f"chunked {s}x on 3600 s")
        rec["audio_s_per_s"] = [3600.0 / (ms / 1e3) for ms in rec["ms"]]
        rec["single_ms"] = _time_calls(single, reps=3)
        rec["peak_gb"] = _peak_gb(run)
        rec["single_peak_gb"] = _peak_gb(single)
        y, ys = run(), single()
        rec["rel_vs_single"] = _rel(y, ys)
        rec["bitwise_vs_single"] = bool(torch.equal(y, ys))
        if s == 2.0:
            _check(rec["rel_vs_single"] <= 5e-5, f"chunked 2.0x vs time_stretch at 3600 s: {rec}")
        ch[f"{s}x_3600s"] = rec
    del y, ys
    # 0.5x is gated on stationary tones; the chirp number above is recorded.
    t = torch.arange(int(3600.0 * SR), dtype=torch.float64, device=dev) / SR
    x_tones = (0.5 * torch.sin(2 * np.pi * 440.0 * t) + 0.3 * torch.sin(2 * np.pi * 1234.5 * t)
               + 0.2 * torch.sin(2 * np.pi * 3111.0 * t))  # _tones, made on the card
    x_tones = (x_tones / x_tones.abs().max()).float()
    del t
    ch["0.5x_3600s"]["tones_rel_vs_single"] = _rel(
        chunked.chunked_time_stretch(x_tones, 0.5, cfg, force=True),
        pv.time_stretch(x_tones, 0.5, cfg, branch_policy="fast"))
    _check(ch["0.5x_3600s"]["tones_rel_vs_single"] <= 5e-5,
           f"chunked 0.5x vs time_stretch on 3600 s of tones: {ch['0.5x_3600s']}")
    del x_tones
    # phasor_istft_ola at this shape: 224,997 frames of 0.5x phasors, the
    # valid-frame mask of one rank (all ones).
    mag_c, pre_c, pim_c, nf_c = stft_phasor_terms(x_long, N_FFT, HOP, 128)
    ones_c = torch.ones(nf_c, device=dev)
    a = phasor_istft_ola(mag_c, pre_c, pim_c, N_FFT, 128, nf_c, ones_c)
    b = phasor_istft_ola_reference(mag_c, pre_c, pim_c, N_FFT, 128, nf_c, ones_c)
    y_c = torch.complex(mag_c * pre_c, mag_c * pim_c).T.contiguous()  # torch.istft's layout
    win = torch.hann_window(N_FFT, device=dev)
    synth_main = {"frames": nf_c, "rel": _rel(a, b), "max_abs": _max_abs(a, b),
                  "ms": _time_ms(lambda: phasor_istft_ola(mag_c, pre_c, pim_c, N_FFT, 128, nf_c, ones_c), reps=5),
                  "plain_ms": _time_ms(lambda: phasor_istft_ola_reference(mag_c, pre_c, pim_c, N_FFT, 128,
                                                                          nf_c, ones_c), reps=2),
                  "library_ms": _time_ms(lambda: torch.istft(y_c, N_FFT, 128, window=win, center=True), reps=5),
                  **_bound(4 * (3 * nf_c * (N_FFT // 2 + 1) + nf_c + a.numel()), nf_c * _FFT_FLOP)}
    _check(synth_main["rel"] < 1e-5, f"phasor_istft_ola vs plain at 0.5x / 3600 s: {synth_main}")
    del mag_c, pre_c, pim_c, y_c, a, b
    _emit("4e_chunked_3600s", card=smi, **ch, phasor_istft_ola_0_5x_3600s=synth_main)

    # batched_chunked_time_stretch on a (1, 1) mesh, 8 x 600 s: one
    # pvoc_terms_batch and one phasor_istft_ola_batch launch per call.
    # Eight 10-minute pieces of the hour-long signal, starting 428 s apart.
    xs8 = torch.stack([x_long[i * 428 * SR : (i * 428 + 600) * SR] for i in range(8)])
    bc = {}
    for s in (2.0, 0.5):
        rec = {}
        run = lambda: chunked.batched_chunked_time_stretch(xs8, s, cfg, mesh=m11)  # noqa: E731
        rec["launches"] = _counted(counters, lambda: rec.update(ms=_time_calls(run, reps=3)),
                                   {"pvoc_terms_batch": 4, "phasor_istft_ola_batch": 4},
                                   f"batched chunked {s}x, 8 x 600 s")
        rec["audio_s_per_s"] = [4800.0 / (ms / 1e3) for ms in rec["ms"]]
        rec["peak_gb"] = _peak_gb(run)
        ys = run()
        rec["rel_vs_single_max"] = max(
            _rel(ys[i], pv.time_stretch(xs8[i], s, cfg, branch_policy="fast")) for i in range(8))
        if s == 2.0:
            _check(rec["rel_vs_single_max"] <= 5e-5, f"batched chunked 2.0x vs time_stretch: {rec}")
        bc[f"{s}x"] = rec
    del ys
    # Their kernels against the plain versions at this shape.
    kt = stft_phasor_terms_batch(xs8, N_FFT, HOP, 128, scan=False, return_u=True)
    pt = stft_phasor_terms_batch_reference(xs8, N_FFT, HOP, 128, scan=False, return_u=True)
    nf8 = kt[-1]
    tb_main = {"frames": 8 * nf8, **_terms_errors(kt, pt),
               "ms": _time_ms(lambda: stft_phasor_terms_batch(xs8, N_FFT, HOP, 128, scan=False, return_u=True), reps=5),
               "plain_ms": _time_ms(lambda: stft_phasor_terms_batch_reference(
                   xs8, N_FFT, HOP, 128, scan=False, return_u=True), reps=1),
               **_bound(4 * (xs8.numel() + 5 * 8 * nf8 * (N_FFT // 2 + 1)), 8 * nf8 * _FFT_FLOP)}
    _check(tb_main["mag_rel"] < 1e-5 and max(tb_main["u_weighted"], tb_main["t_weighted"]) < 1e-4
           and tb_main["flip_share"] < 1e-5, f"pvoc_terms_batch vs plain at 8 x 600 s: {tb_main}")
    del kt, pt
    kb = stft_phasor_terms_batch(xs8, N_FFT, HOP, 128)
    ones8 = torch.ones((8, nf8), device=dev)
    a = phasor_istft_ola_batch(*kb[:3], N_FFT, 128, nf8, ones8)
    b = phasor_istft_ola_batch_reference(*kb[:3], N_FFT, 128, nf8, ones8)
    y8 = torch.complex(kb[0] * kb[1], kb[0] * kb[2]).transpose(1, 2).contiguous()
    sb_main = {"frames": 8 * nf8, "rel": max(_rel(a[i], b[i]) for i in range(8)),
               "max_abs": max(_max_abs(a[i], b[i]) for i in range(8)),
               "ms": _time_ms(lambda: phasor_istft_ola_batch(*kb[:3], N_FFT, 128, nf8, ones8), reps=5),
               "plain_ms": _time_ms(lambda: phasor_istft_ola_batch_reference(*kb[:3], N_FFT, 128, nf8, ones8), reps=1),
               "library_ms": _time_ms(lambda: torch.istft(y8, N_FFT, 128, window=win, center=True), reps=5),
               **_bound(4 * (3 * 8 * nf8 * (N_FFT // 2 + 1) + 8 * nf8 + a.numel()), 8 * nf8 * _FFT_FLOP)}
    _check(sb_main["rel"] < 1e-5, f"phasor_istft_ola_batch vs plain at 8 x 600 s: {sb_main}")
    del kb, y8, a, b, xs8
    _emit("4e_batched_chunked_8x600s", card=smi, **bc, pvoc_terms_batch_8x600s=tb_main,
          phasor_istft_ola_batch_8x600s=sb_main)

    # Two ranks on the one card: two processes of this script, a gloo group
    # (NCCL refuses two ranks on one card), 60 s, against the single route.
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _run_ranks(2, timeout=300)
    two = {"wall_s": time.perf_counter() - t0, "devices": [str(r["device"]) for r in ranks]}
    for s in (2.0, 0.5):
        single = pv.time_stretch(x60, s, cfg)
        two[f"{s}x_rel_vs_single"] = _rel(torch.as_tensor(ranks[0][f"y{s}"]), single)
        two[f"{s}x_ranks_equal"] = bool(np.array_equal(ranks[0][f"y{s}"], ranks[1][f"y{s}"]))
        two[f"{s}x_launches_per_rank"] = [r[f"launches{s}"].tolist() for r in ranks]
        _check(two[f"{s}x_rel_vs_single"] <= 5e-5 and two[f"{s}x_ranks_equal"],
               f"two ranks on one card at {s}x: {two}")
    # Per rank: one pvoc_fused_segment at 2.0x; one pvoc_terms and one
    # phasor_istft_ola at 0.5x.
    _check(all(r["launches2.0"].tolist() == [1, 0, 0] and r["launches0.5"].tolist() == [0, 1, 1]
               for r in ranks), f"two-rank launches: {two}")
    _emit("4e_two_ranks_one_card", card=smi, seconds=60, **two)


    # ---- 6a. the select variants, the fold analysis and general N vs plain, 60 s
    def sel_impl(impl, fn):
        """fn() with the resampler's _SEL_IMPL set to impl, then restored."""
        resample_mod._SEL_IMPL = impl
        try:
            return fn()
        finally:
            resample_mod._SEL_IMPL = "mxu"

    def select_runs(y, factor, out_len):
        """{variant: (kernel output, plain output)} of the three explicit
        resamplers on y, each from its own tables."""
        bt = block_tables(factor, out_len, dev)
        t1 = select_tables(factor, out_len, len(y), "roll", dev)
        t2 = select_tables(factor, out_len, len(y), "roll2", dev)
        runs = {
            "resample_blocked": (resample_blocked(y, *bt, out_len),
                                 resample_blocked_reference(y, *bt, out_len)),
            "select_lerp": (select_lerp(y, t1["origin"], t1["k"], t1["fr"], t1["c"]),
                            select_lerp_reference(y, t1["origin"], t1["k"], t1["fr"], t1["c"])),
        }
        if "bases" in t2:
            runs["select_lerp_roll2"] = (
                select_lerp_two_level(y, t2["origin"], t2["bases"], t2["k"], t2["fr"], t2["c"]),
                select_lerp_reference(y, t2["origin"], t2["k"], t2["fr"], t2["c"], t2["bases"]))
        return runs

    sel60 = {}
    for st in (-13, -7, -5, 3.5, 5, 7, 14):
        fac = 2.0 ** (-st / 12.0)  # what pitch_shift passes for +st
        n_out = int(round(len(x60) * fac))
        rec = {name: float((a - b).abs().max()) for name, (a, b) in select_runs(x60, fac, n_out).items()}
        f64 = resample_linear_reference(x60, fac, n_out)
        for impl in ("fused", "roll2", "roll", "matmul"):
            a = sel_impl(impl, lambda: resample_mod._resample_strided_select(x60, fac, n_out))
            rec[f"{impl}_vs_f64"] = float((a - f64).abs().max())
        _check(max(rec.values()) <= 1e-6, f"select variants at {st} st: {rec}")
        sel60[st] = rec
    # Outputs far past the input's end: the edge clamp.
    x_short = x60[:4000]
    rec = {name: float((a - b).abs().max()) for name, (a, b) in select_runs(x_short, 0.75, 40000).items()}
    f64 = resample_linear_reference(x_short, 0.75, 40000)
    for impl in ("fused", "roll2", "roll", "matmul"):
        a = sel_impl(impl, lambda: resample_mod._resample_strided_select(x_short, 0.75, 40000))
        rec[f"{impl}_vs_f64"] = float((a - f64).abs().max())
        _check(bool((a[6000:] == x_short[-1]).all()), f"{impl}: outputs past the end are not the last sample")
    _check(max(rec.values()) <= 1e-6, f"select variants past the input's end: {rec}")
    sel60["past_the_end"] = rec

    zrev60 = {}
    for rs in (512, 128, 171):
        z = fused_time_stretch(x60, N_FFT, HOP, rs, zrev=True)
        rec = {"vs_plain_rel": _rel(z, fused_time_stretch_reference(x60, N_FFT, HOP, rs, zrev=True)),
               "vs_zrev_false_rel": _rel(z, fused_time_stretch(x60, N_FFT, HOP, rs)),
               "rerun_bitwise": bool(torch.equal(z, fused_time_stretch(x60, N_FFT, HOP, rs, zrev=True)))}
        _check(rec["vs_plain_rel"] < 1e-5 and rec["vs_zrev_false_rel"] < 1e-5 and rec["rerun_bitwise"],
               f"pvoc_fused_zrev at Rs={rs}: {rec}")
        zrev60[rs] = rec
    _check(bool(torch.equal(fused_time_stretch(x60, 768, 256, 128, zrev=True),
                            fused_time_stretch(x60, 768, 256, 128))), "zrev at an odd overlap is not a no-op")

    # Every FFT kernel at sizes that are not powers of two. Against the
    # plain version (cuFFT's transform of that size) the fused TSM is held
    # to 5e-5 at every k: at integer k it reads up to 1.5e-5 on an H100
    # (anchor phases of quiet bins), 3.6e-6 at N = 1024.
    SIZES = ((768, 192), (1000, 250), (1536, 384), (896, 224))
    gen_n = {}
    for n, ra in SIZES:
        rec = {}
        for rs in (2 * ra, ra // 2, int(round(ra * 2.0 ** (-7 / 12)))):
            rec[f"pvoc_fused_rs{rs}"] = _rel(fused_time_stretch(x60, n, ra, rs),
                                             fused_time_stretch_reference(x60, n, ra, rs), n)
            _check(rec[f"pvoc_fused_rs{rs}"] < 5e-5, f"pvoc_fused vs plain at N={n}, Rs={rs}: {rec}")
        if n % 4 == 0:
            rec["pvoc_fused_zrev"] = _rel(fused_time_stretch(x60, n, ra, 2 * ra, zrev=True),
                                          fused_time_stretch_reference(x60, n, ra, 2 * ra, zrev=True), n)
            _check(rec["pvoc_fused_zrev"] < 5e-5, f"pvoc_fused_zrev vs plain at N={n}: {rec}")
        mp_, pp_ = stft_polar_reference(x60, n, ra)
        rec["stft_polar"] = _spec_errors(stft_polar(x60, n, ra), (mp_, pp_))
        _check(rec["stft_polar"]["spec_rel"] < 1e-5 and rec["stft_polar"]["mag_rel"] < 1e-5,
               f"stft_polar vs plain at N={n}: {rec}")
        rec["istft_ola"] = _rel(istft_ola(mp_, pp_, n, ra // 2), istft_ola_reference(mp_, pp_, n, ra // 2), n)
        a, b = istft_frames(mp_, pp_, n), istft_frames_reference(mp_, pp_, n)
        rec["istft_frames"] = float((a - b).abs().max() / b.abs().max())
        kt, pt = stft_phasor_terms(x60, n, ra, 3 * ra), stft_phasor_terms_reference(x60, n, ra, 3 * ra)
        rec["pvoc_terms"] = _weighted_phasor_err(kt, pt)
        _check(rec["pvoc_terms"]["mag_rel"] < 1e-5 and rec["pvoc_terms"]["p_weighted"] < 1e-4,
               f"pvoc_terms vs plain at N={n}: {rec}")
        rec["phasor_istft_ola"] = _rel(phasor_istft_ola(*kt[:3], n, ra // 2, kt[3]),
                                       phasor_istft_ola_reference(*kt[:3], n, ra // 2, kt[3]), n)
        _check(max(rec["istft_ola"], rec["istft_frames"], rec["phasor_istft_ola"]) < 1e-5,
               f"synthesis kernels vs plain at N={n}: {rec}")
        gen_n[n] = rec
        del mp_, pp_, a, b, kt, pt
    # The bitwise contracts at N = 768: stream = monolithic kernel, and the
    # 64-utterance batch's rows = the single-recording kernel.
    cfg768 = pv.PvocConfig(n_fft=768, hop=192)
    for s in (2.0, 0.5, 171 / 256):
        same = torch.equal(streaming.fused_stream_time_stretch(x60, s, cfg768, segment_frames=256),
                           fused_time_stretch(x60, 768, 192, cfg768.synthesis_hop(s)))
        _check(same, f"kernel stream differs from the monolithic kernel at N=768, {s}x")
    xs64, ratios64 = baseline_batch(SR)
    xs64 = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs64]
    for x, r, y in zip(xs64, ratios64, pv.batch_time_stretch_varied(xs64, ratios64, cfg768)):
        _check(bool(torch.equal(y, fused_time_stretch(x, 768, 192, cfg768.synthesis_hop(r)))),
               f"64-utterance batch at N=768: a {r}x row differs from the single kernel")
    gen_n["bitwise_at_768"] = {"stream_vs_monolithic": True, "batch_64_rows_vs_single_kernel": True}
    del xs64
    _emit("6a_new_kernels_vs_plain", seconds=60, select_max_abs=sel60, pvoc_fused_zrev=zrev60,
          general_n=gen_n, bounds={"select": 1e-6, "zrev": 1e-5, "general_n_fused": 5e-5,
                                   "general_n_stft_and_synthesis": 1e-5})

    # ---- 6b. their golden gate, 60 s
    ngate = {}
    for n, ra in SIZES:
        cfg_n = pv.PvocConfig(n_fft=n, hop=ra)
        for s in (2.0, 0.5):
            y = pv.time_stretch(x60_np, s, cfg_n)
            ngate[f"N{n}_stretch_{s}"] = _rel(y, pv_ref.phase_vocoder(x60_np, s, n, ra), n)
            _check(ngate[f"N{n}_stretch_{s}"] < 1e-4, f"time_stretch {s} at N={n} vs golden: {ngate}")
        y = pv.pitch_shift(x60_np, -7.0, cfg_n)
        ref = pv_ref.pitch_shift(x60_np, -7.0, n, ra)
        _check(abs(len(y) - len(ref)) <= 1, f"pitch -7 at N={n}: length {len(y)} vs {len(ref)}")
        m_ = min(len(y), len(ref))
        ngate[f"N{n}_pitch_-7"] = _rel(y[:m_], torch.as_tensor(ref[:m_]), n)
        _check(ngate[f"N{n}_pitch_-7"] < 1e-3, f"pitch_shift -7 at N={n} vs golden: {ngate}")
    for rs in (512, 128):
        ngate[f"zrev_rs{rs}"] = _rel(fused_time_stretch(x60, N_FFT, HOP, rs, zrev=True),
                                     pv_ref.phase_vocoder(x60_np, rs / HOP, N_FFT, HOP))
        _check(ngate[f"zrev_rs{rs}"] < 1e-4, f"fused_time_stretch(zrev=True) at Rs={rs} vs golden: {ngate}")
    ref = pv_ref.pitch_shift(x60_np, -7.0, N_FFT, HOP)
    for impl in ("fused", "roll2", "roll", "matmul"):
        y = sel_impl(impl, lambda: pv.pitch_shift(x60_np, -7.0, cfg))
        m_ = min(len(y), len(ref))
        ngate[f"pitch_-7_{impl}"] = _rel(y[:m_], torch.as_tensor(ref[:m_]))
        _check(ngate[f"pitch_-7_{impl}"] < 1e-3, f"pitch_shift -7 under {impl} vs golden: {ngate}")
    # hop does not divide N: the matmul analysis, the synthesis kernels.
    cfg320 = pv.PvocConfig(n_fft=1024, hop=320)
    fb_launches = {}
    for s, expect in ((1.6, {"istft_ola": 1}), (0.5, {"istft_frames": 1})):
        got = {}
        fb_launches[s] = _counted(counters, lambda: got.update(y=pv.time_stretch(x60_np, s, cfg320)), expect,
                                  f"time_stretch {s}x at (1024, 320)")
        ngate[f"hop320_stretch_{s}"] = _rel(got["y"], pv_ref.phase_vocoder(
            x60_np, cfg320.synthesis_hop(s) / 320, 1024, 320))
        _check(ngate[f"hop320_stretch_{s}"] < 1e-4, f"time_stretch {s} at (1024, 320) vs golden: {ngate}")
    _emit("6b_new_paths_golden_gate", seconds=60, rel_err=ngate, hop320_launches=fb_launches,
          bounds={"stretch": 1e-4, "pitch": 1e-3})

    # ---- 6c. the new paths at real size
    y_mxu = pv.pitch_shift(x_pitch, -7.0, cfg)
    own = {"fused": "resample_blocked", "roll2": "select_lerp_roll2", "roll": "select_lerp",
           "matmul": "select_lerp"}
    sel_main, sel_launches = {}, {}
    for impl, kernel in own.items():
        rec = {}
        run = lambda: sel_impl(impl, lambda: pv.pitch_shift(x_pitch, -7.0, cfg))  # noqa: E731
        sel_launches[impl] = _counted(counters, lambda: rec.update(ms=_time_calls(run, reps=3)),
                                      {"pvoc_fused": 4, kernel: 4}, f"pitch_shift -7 st under {impl}")
        rec["audio_s_per_s"] = [300.0 / (ms / 1e3) for ms in rec["ms"]]
        rec["max_abs_vs_mxu"] = _max_abs(run(), y_mxu)
        _check(rec["max_abs_vs_mxu"] <= 1e-6, f"pitch_shift -7 st under {impl} vs mxu: {rec}")
        sel_main[impl] = rec
    sel_main["mxu_ms"] = _time_calls(lambda: pv.pitch_shift(x_pitch, -7.0, cfg), reps=3)
    del y_mxu

    zr = {}
    zr_launches = {}
    for name, x, rs, secs in (("2x_3600s", x_long, 512, 3600.0), ("rs171_300s", x_pitch, rs_pitch, 300.0)):
        rec = {}
        run = lambda: fused_time_stretch(x, N_FFT, HOP, rs, zrev=True)  # noqa: E731
        zr_launches[name] = _counted(counters, lambda: rec.update(ms=_time_calls(run, reps=3)),
                                     {"pvoc_fused_zrev": 4}, f"fused_time_stretch(zrev=True) {name}")
        z = run()
        zp = fused_time_stretch_reference(x, N_FFT, HOP, rs, zrev=True)
        rec.update(audio_s_per_s=[secs / (ms / 1e3) for ms in rec["ms"]],
                   rel=_rel(z, zp), max_abs=_max_abs(z, zp),
                   vs_zrev_false_rel=_rel(z, fused_time_stretch(x, N_FFT, HOP, rs)),
                   zrev_false_ms=_time_calls(lambda: fused_time_stretch(x, N_FFT, HOP, rs), reps=3),
                   rerun_bitwise=bool(torch.equal(z, run())))
        del z, zp
        rec["plain_ms"] = _time_ms(lambda: fused_time_stretch_reference(x, N_FFT, HOP, rs, zrev=True), reps=1)
        rec.update(_bound(4 * (len(x) + (((len(x) - N_FFT) // HOP) * rs + N_FFT)),
                          2 * ((len(x) - N_FFT) // HOP + 1) * _FFT_FLOP))
        bound = 1e-5 if rs % HOP == 0 else 5e-5
        _check(rec["vs_zrev_false_rel"] < bound and rec["rerun_bitwise"], f"pvoc_fused_zrev, {name}: {rec}")
        if rs % HOP:
            # q >= 2 at 300 s: on the chirp two f32 analyses part at a branch
            # choice of a quiet bin that later turns loud (as in 4c), so the
            # plain version's distance there is recorded, and the kernel is
            # held to it on stationary tones. There P is a product over
            # 18,747 frames whose step terms differ by ~1e-7 rad between two
            # f32 analyses, a walk like sqrt(frames) (as pvoc_terms in 4d):
            # 8.1e-5 read on an H100, so 2e-4, with the zrev=False pair's
            # distance on the same tones beside it.
            rec["chirp_plain_rel_recorded"] = rec.pop("rel")
            x_t = torch.as_tensor(_tones(secs), dtype=torch.float32, device=dev)
            rec["rel"] = _rel(fused_time_stretch(x_t, N_FFT, HOP, rs, zrev=True),
                              fused_time_stretch_reference(x_t, N_FFT, HOP, rs, zrev=True))
            rec["tones_zrev_false_vs_plain_rel"] = _rel(fused_time_stretch(x_t, N_FFT, HOP, rs),
                                                        fused_time_stretch_reference(x_t, N_FFT, HOP, rs))
            bound = 2e-4
            del x_t
        _check(rec["rel"] < bound, f"pvoc_fused_zrev vs plain, {name}: {rec}")
        rec["ms"] = sum(rec["ms"]) / len(rec["ms"])
        zr[name] = rec

    # 2.0x on 3600 s at each FFT size, hop N/4, through time_stretch.
    sizes_main, sizes_launches = {}, {}
    for n, ra in ((1024, 256),) + SIZES:
        cfg_n = pv.PvocConfig(n_fft=n, hop=ra)
        rec = {"frames": (len(x_long) - n) // ra + 1, "radices": "2" if n == 1024 else "mixed"}
        sizes_launches[n] = _counted(
            counters, lambda: rec.update(ms=_time_calls(lambda: pv.time_stretch(x_long, 2.0, cfg_n), reps=3)),
            {"pvoc_fused": 4}, f"time_stretch 2.0x on 3600 s at N={n}")
        rec["audio_s_per_s"] = [3600.0 / (ms / 1e3) for ms in rec["ms"]]
        rec["ns_per_frame"] = min(rec["ms"]) * 1e6 / rec["frames"]
        y = pv.time_stretch(x_long, 2.0, cfg_n)
        _check(len(y) == pv.stretch_output_length(len(x_long), cfg_n, 2.0) and bool(torch.isfinite(y).all()),
               f"time_stretch 2.0x on 3600 s at N={n}: output")
        if n == 1536:
            rec["rel_vs_plain"] = _rel(y, fused_time_stretch_reference(x_long, n, ra, 2 * ra), n)
            _check(rec["rel_vs_plain"] < 5e-5, f"pvoc_fused vs plain at N=1536 / 3600 s: {rec}")
        del y
        sizes_main[n] = rec

    # The three explicit resamplers at the -7 st / 300 s shape, timed.
    y_st = fused_time_stretch(x_pitch, N_FFT, HOP, rs_pitch)
    out_len = int(round(len(y_st) / factor))
    bt = block_tables(1.0 / factor, out_len, dev)
    t1 = select_tables(1.0 / factor, out_len, len(y_st), "roll", dev)
    t2 = select_tables(1.0 / factor, out_len, len(y_st), "roll2", dev)
    nb_sel = t1["k"].shape[0]
    lib_ms = _time_ms(lambda: torch.nn.functional.interpolate(
        y_st[None, None], size=out_len, mode="linear", align_corners=True), reps=20)
    sel_k = {}
    for name, kern, plain, moved in (
        ("resample_blocked", lambda: resample_blocked(y_st, *bt, out_len),
         lambda: resample_blocked_reference(y_st, *bt, out_len),
         4 * (len(y_st) + out_len) + 12 * nb_sel + 8 * 512),
        ("select_lerp", lambda: select_lerp(y_st, t1["origin"], t1["k"], t1["fr"], t1["c"]),
         lambda: select_lerp_reference(y_st, t1["origin"], t1["k"], t1["fr"], t1["c"]),
         4 * (len(y_st) + 3 * t1["k"].numel()) + 8 * nb_sel),
        ("select_lerp_roll2",
         lambda: select_lerp_two_level(y_st, t2["origin"], t2["bases"], t2["k"], t2["fr"], t2["c"]),
         lambda: select_lerp_reference(y_st, t2["origin"], t2["k"], t2["fr"], t2["c"], t2["bases"]),
         4 * (len(y_st) + 3 * t2["k"].numel() + t2["bases"].numel()) + 8 * nb_sel),
    ):
        a, b = kern().reshape(-1)[:out_len], plain().reshape(-1)[:out_len]
        rec = {"max_abs": _max_abs(a, b), "bitwise_vs_plain": bool(torch.equal(a, b)),
               "ms": _time_ms(kern, reps=20), "plain_ms": _time_ms(plain, reps=5), "library_ms": lib_ms,
               **_bound(moved, 3 * out_len), "n_in": len(y_st), "n_out": out_len}
        _check(rec["max_abs"] <= 1e-6, f"{name} vs plain at the -7 st shape: {rec}")
        # The blocked positions' kernel forms the plain version's taps and
        # lerp, rounding for rounding.
        _check(name != "resample_blocked" or rec["bitwise_vs_plain"], f"{name} not bitwise the plain version: {rec}")
        sel_k[name] = rec
        del a, b
    sel_k["tables_ms"] = {"block_tables": _time_ms(lambda: block_tables(1.0 / factor, out_len, dev), reps=5),
                          "select_tables_roll": _time_ms(
                              lambda: select_tables(1.0 / factor, out_len, len(y_st), "roll", dev), reps=5),
                          "select_tables_roll2": _time_ms(
                              lambda: select_tables(1.0 / factor, out_len, len(y_st), "roll2", dev), reps=5)}
    del y_st, bt, t1, t2
    _emit("6c_new_paths_main_size", card=smi, pitch_m7_300s_by_select=sel_main, select_launches=sel_launches,
          zrev=zr, zrev_launches=zr_launches, stretch_2x_3600s_by_n_fft=sizes_main,
          sizes_launches=sizes_launches, select_kernels_m7_300s=sel_k)

    # ---- 7. the q in {2, 4} term algebra's angle domain
    # (set_q_algebraic(False)) through every phasor kernel
    kernels_q = _q_algebraic_phase(smi, counters, cfg, dev)

    # ---- 5. determinism
    a = pv.time_stretch(x60, 2.0, cfg)
    b = pv.time_stretch(x60, 2.0, cfg)
    _check(bool(torch.equal(a, b)), "two 2.0x runs differ")
    a = pv.time_stretch(x60, 0.5, cfg, branch_policy="faithful")
    b = pv.time_stretch(x60, 0.5, cfg, branch_policy="faithful")
    _check(bool(torch.equal(a, b)), "two faithful 0.5x runs differ")
    a = pv.time_stretch(x60, 3.0, cfg)
    b = pv.time_stretch(x60, 3.0, cfg)
    _check(bool(torch.equal(a, b)), "two general-hop 3.0x runs differ")
    xs_d = [x60, x60[: 30 * SR], x60[: 45 * SR]]
    a = pv.batch_time_stretch_varied(xs_d, [0.5, 1.5, 2.0], cfg)
    b = pv.batch_time_stretch_varied(xs_d, [0.5, 1.5, 2.0], cfg)
    _check(all(bool(torch.equal(u, v)) for u, v in zip(a, b)), "two batch runs differ")
    a = chunked.chunked_time_stretch(x60, 0.5, cfg, force=True)
    b = chunked.chunked_time_stretch(x60, 0.5, cfg, force=True)
    _check(bool(torch.equal(a, b)), "two chunked 0.5x runs differ")
    a = fused_time_stretch(x60, N_FFT, HOP, 171, zrev=True)
    b = fused_time_stretch(x60, N_FFT, HOP, 171, zrev=True)
    _check(bool(torch.equal(a, b)), "two zrev runs differ")
    cfg1000 = pv.PvocConfig(n_fft=1000, hop=250)
    a = pv.time_stretch(x60, 0.5, cfg1000)
    b = pv.time_stretch(x60, 0.5, cfg1000)
    _check(bool(torch.equal(a, b)), "two N = 1000 runs differ")
    # The stft.cu kernels, run twice at the smallest, canonical and largest N.
    for n in (256, 1024, 4096):
        runs = [(stft_polar(x60, n, n // 4), stft_fused(x60, n, n // 4)) for _ in range(2)]
        _check(all(bool(torch.equal(u, v)) for u, v in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1])),
               f"two analyses at N={n} differ")
        mg, ph = runs[0][0]
        for fn in (istft_frames, istft_frames_cart):
            _check(bool(torch.equal(fn(mg, ph, n), fn(mg, ph, n))), f"two {fn.__name__} runs at N={n} differ")
        _check(bool(torch.equal(istft_ola(mg, ph, n, n // 8), istft_ola(mg, ph, n, n // 8))),
               f"two istft_ola runs at N={n} differ")
    _emit("5_determinism", bitwise_equal={"fused_2.0x": True, "faithful_0.5x": True,
                                          "general_3.0x": True, "batch_varied": True,
                                          "chunked_0.5x": True, "zrev_rs171": True,
                                          "n1000_0.5x": True, "stft_kernels_256_1024_4096": True})

    # ---- 5_bench. the bench on the cells of PERF.md section 4, in this
    # process, 3 timed calls each; each bench line is printed as it comes.
    import io

    from phase_vocoder_tpu_torch import bench

    torch.cuda.empty_cache()
    card_name = smi.rsplit(",", 1)[0].strip()
    cells = {
        "stretch_2x_3600s": ([], "fused"),
        "stream_checkpoint_2x_3600s": (["--stream", "--stream-checkpoint"], "fused-stream"),
        "faithful_0.5x_660s": (["--ratio", "0.5", "--seconds", "660"], "stream"),
        "general_3x_3600s": (["--ratio", "3.0"], "general"),
        "pitch_m7_300s": (["--pitch", "--semitones", "-7", "--seconds", "300"], "fused"),
        "batch_varied_64": (["--batch-varied"], "fused-batch-varied"),
        "scaling_2x_3600s": (["--scaling", "--seconds-per-device", "3600"], "chunked-fused1"),
    }
    bench_lines = {}
    for name, (argv, path) in cells.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(argv + ["--iters", "3"])
        print(buf.getvalue().strip(), flush=True)
        rec = bench_lines[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
        _check(rc == 0 and rec["allclose_pass"] is True, f"bench {name}: gate {rec}")
        _check(0 < rec["vs_baseline"] <= 1.05, f"bench {name}: vs_baseline {rec['vs_baseline']}")
        _check(rec["card"] == card_name, f"bench {name}: card {rec['card']!r}, not {card_name!r}")
        _check(rec["path"] == path, f"bench {name}: path {rec['path']!r}, not {path!r}")
    # The headline against pvoc_fused's device time at the same shape (4b).
    fused_busy = shapes["stretch_2x_3600s"]["passes"]["device_busy_ms"]
    head_ms = bench_lines["stretch_2x_3600s"]["ms_median"]
    _check(fused_busy <= head_ms <= 1.5 * fused_busy,
           f"bench headline {head_ms} ms against pvoc_fused's {fused_busy} ms of device time")
    _emit("5_bench", card=smi, pvoc_fused_device_ms_4b=fused_busy,
          cells={name: {k: rec.get(k) for k in ("path", "value", "ms_median", "ms_min", "vs_baseline",
                                                 "device_busy_ms", "device_idle_share", "kernels_per_call",
                                                 "peak_device_gb", "numpy_input_ms", "allclose_rel_err")}
                 for name, rec in bench_lines.items()})

    def _row(name, source, replaces, launches, rec, max_abs, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"phase_vocoder_tpu_torch/csrc/{source}",
                "replaces": f"phase_vocoder_tpu/{replaces}", "launches": launches,
                "max_abs_err": max_abs, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec.get("library_ms", library_ms)}

    # library_ms is null where no single PyTorch call computes the function
    # (a whole phase vocoder; the phasor terms).
    fused_2x = shapes["stretch_2x_3600s"]
    kernels = [
        _row("pvoc_fused", "pvoc_fused.cu", "ops/pallas/fused.py:1526",
             launches["stretch_2x_3600s"]["pvoc_fused"], fused_2x, fused_2x["max_abs"]),
        _row("resample_lerp", "resample.cu", "ops/resample.py:372", launches["pitch_m7_300s"]["resample_lerp"],
             {"ms": device_ms["resample_lerp"], "plain_ms": res_plain_ms, "library_ms": device_ms["F.interpolate"],
              **res_bound}, res_abs),
        _row("stft_polar", "stft.cu", "ops/pallas/stft.py:117", ff_launches["stretch_0.5x_660s"]["stft_polar"],
             stft_main, stft_main["mag_max_abs"]),
        _row("stft_fused", "stft.cu", "ops/pallas/stft.py:155", fused_launches["stft_fused"],
             fused_main, fused_main["max_abs"]),
        _row("istft_ola", "stft.cu", "ops/pallas/stft.py:207", ff_launches["stretch_0.5x_660s"]["istft_ola"],
             istft_main["segment_1024"], istft_main["segment_1024"]["max_abs"]),
        _row("segment_phase", "phase_scan.cu", "streaming.py:115-128 (XLA, no Pallas kernel)",
             ff_launches["stretch_0.5x_660s"]["segment_phase"], sp_main, sp_main["max_abs"]),
        _row("pvoc_fused_segment", "pvoc_fused.cu", "ops/pallas/fused.py:1886",
             fs["launches"]["pvoc_fused_segment"], seg_main, seg_main["max_abs"]),
        _row("pvoc_terms", "pvoc_fused.cu", "ops/pallas/fused.py:713",
             gen_launches["stretch_3x_3600s"]["pvoc_terms"], terms_main, terms_main["y_max_abs"]),
        _row("istft_frames", "stft.cu", "ops/pallas/stft.py:264",
             gen_launches["polar_stages_rs171_300s"]["istft_frames"], polar_main, polar_main["max_abs"]),
        _row("istft_frames_cart", "stft.cu", "ops/pallas/stft.py:280",
             gen_launches["stretch_3x_3600s"]["istft_frames_cart"], cart_main, cart_main["max_abs"]),
        _row("pvoc_fused_batch", "pvoc_fused.cu", "ops/pallas/fused.py:1610",
             b64["launches"]["pvoc_fused_batch"], fb_main, fb_main["max_abs"]),
        _row("pvoc_terms_batch", "pvoc_fused.cu", "ops/pallas/fused.py:733",
             bc["0.5x"]["launches"]["pvoc_terms_batch"], tb_main, tb_main["y_max_abs"]),
        _row("phasor_istft_ola", "pvoc_fused.cu", "ops/pallas/fused.py:990",
             ch["0.5x_3600s"]["launches"]["phasor_istft_ola"], synth_main, synth_main["max_abs"]),
        _row("phasor_istft_ola_batch", "pvoc_fused.cu", "ops/pallas/fused.py:1021",
             bc["0.5x"]["launches"]["phasor_istft_ola_batch"], sb_main, sb_main["max_abs"]),
        _row("pvoc_fused_zrev", "pvoc_fused.cu", "ops/pallas/fused.py:1569",
             zr_launches["2x_3600s"]["pvoc_fused_zrev"], zr["2x_3600s"], zr["2x_3600s"]["max_abs"]),
        *(_row(name, "resample.cu", replaces, sel_launches[impl][name],
               {**sel_k[name], "ms": device_ms[name], "library_ms": device_ms["F.interpolate"]},
               sel_k[name]["max_abs"])
          for name, replaces, impl in (("resample_blocked", "ops/resample.py:715", "fused"),
                                       ("select_lerp_roll2", "ops/resample.py:786", "roll2"),
                                       ("select_lerp", "ops/resample.py:662", "matmul"))),
        *kernels_q,
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(_rank_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--ptxas"]:
        sys.exit(_ptxas())
    if sys.argv[1:2] in (["--ab"], ["--ab-worker"]):
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
        only = sys.argv[3:4] == ["--faithful"]
        sys.exit(_ab(sys.argv[2], only) if sys.argv[1] == "--ab" else _ab_worker(sys.argv[2], only))
    sys.exit(main())
