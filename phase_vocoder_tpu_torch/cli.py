"""Command-line front-end (counterpart of phase_vocoder_tpu/cli.py).

Usage:
  pvoc-torch stretch in.wav out.wav --ratio 2.0 [--n-fft 1024 --hop 256]
  pvoc-torch stretch in.wav out.wav --ratio 0.5 --segment-frames 1024
  pvoc-torch stretch in.wav out.wav --ratio 2.0 --checkpoint-dir ck/ \
      [--batch-segments 8] [--trace-dir trace/]
  pvoc-torch pitch   in.wav out.wav --semitones -5 [--branch-policy faithful]
  pvoc-torch batch   a.wav b.wav c.wav --ratio 2.0 --out-dir stretched/
  pvoc-torch chunked in.wav out.wav --ratio 2.0 \
      --coordinator HOST:PORT --num-processes 2 --process-id 0   # one per device
  pvoc-torch bench   [--seconds 3600 --ratio 2.0 | --stream | --pitch | --batch |
                      --batch-varied | --scaling]   # one JSON line (bench.py's modes)
  (add --device cpu to run the plain torch versions on the host)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .config import PvocConfig
from .io.wav import read_wav, write_wav
from .utils.metrics import audio_seconds_per_second, emit_metric


def _add_dsp_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n-fft", type=int, default=1024, help="FFT size N (even; up to 4096 on the fused backend)")
    p.add_argument("--hop", type=int, default=256, help="analysis hop Ra")
    p.add_argument(
        "--float32", action="store_true",
        help="write float32 WAV instead of PCM16 (PCM16 clips stretched "
        "samples that overshoot +-1.0)",
    )
    p.add_argument(
        "--fft-backend", choices=["fused", "matmul", "xla"], default="fused",
        help="'fused' (default): the CUDA kernels; 'matmul': the polar path "
        "with the DFT as FP32 matrix products; 'xla': the polar path with "
        "torch.fft",
    )
    p.add_argument(
        "--phase-method", choices=["wrapped_scan", "cumsum"], default="wrapped_scan",
        help="polar path: drift-free compensated wrapped scan (default) or "
        "the literal cumsum",
    )
    p.add_argument(
        "--branch-policy", choices=["auto", "fast", "faithful"], default="auto",
        help="non-integer hop ratios only: 'auto' (default) routes "
        "recordings past ~10 min to the branch-faithful polar streaming "
        "executor, which follows the float64 golden model's princarg branch "
        "choices; 'faithful' routes every such input there; 'fast' always "
        "uses the fused phasor kernel",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the plain "
        "torch versions of the kernels)",
    )


def _cfg(args) -> PvocConfig:
    return PvocConfig(
        n_fft=args.n_fft,
        hop=args.hop,
        fft_backend=args.fft_backend,
        phase_method=args.phase_method,
    )


def _run_stretch(args) -> int:
    from . import pipeline, streaming
    from .utils import profiling

    x, sr = read_wav(args.input)
    cfg = _cfg(args)
    t0 = time.perf_counter()
    with profiling.trace(args.trace_dir):
        if args.checkpoint_dir:
            from .utils import checkpoint

            if pipeline.fused_ok(cfg, cfg.synthesis_hop(args.ratio)):
                # Long jobs ride the fused segment kernel (bitwise equal to
                # the single-recording fused kernel).
                run = checkpoint.checkpointed_fused_stream_time_stretch
                default_frames = streaming.DEFAULT_FUSED_SEGMENT_FRAMES
            else:
                run = checkpoint.checkpointed_stream_time_stretch
                default_frames = streaming.DEFAULT_SEGMENT_FRAMES
            y = run(
                x, args.ratio, cfg, checkpoint_dir=args.checkpoint_dir,
                segment_frames=args.segment_frames or default_frames,
                batch_segments=args.batch_segments, device=args.device,
            )
        elif args.segment_frames:
            y = streaming.stream_time_stretch(
                x, args.ratio, cfg, segment_frames=args.segment_frames,
                device=args.device,
            )
        else:
            y = pipeline.time_stretch(
                x, args.ratio, cfg, branch_policy=args.branch_policy,
                device=args.device,
            )
        y = y.cpu().numpy()
    dt = time.perf_counter() - t0
    write_wav(args.output, y, sr, pcm16=not args.float32)
    emit_metric("audio_seconds_per_second", audio_seconds_per_second(len(x), sr, dt),
                "audio-s/s", stretch=args.ratio, samples=len(x), device=args.device)
    return 0


def _run_pitch(args) -> int:
    from .pipeline import pitch_shift

    x, sr = read_wav(args.input)
    y = pitch_shift(
        x, args.semitones, _cfg(args), branch_policy=args.branch_policy,
        device=args.device,
    ).cpu().numpy()
    write_wav(args.output, y, sr, pcm16=not args.float32)
    return 0


def _run_batch(args) -> int:
    from .parallel.batch import batch_time_stretch_ragged

    loaded = [read_wav(p) for p in args.inputs]
    srs = {sr for _, sr in loaded}
    if len(srs) != 1:
        print(f"error: mixed sample rates {sorted(srs)}", file=sys.stderr)
        return 2
    sr = srs.pop()
    xs = [x for x, _ in loaded]
    t0 = time.perf_counter()
    ys = [y.cpu().numpy() for y in batch_time_stretch_ragged(xs, args.ratio, _cfg(args),
                                                           device=args.device)]
    dt = time.perf_counter() - t0
    os.makedirs(args.out_dir, exist_ok=True)
    for path, y in zip(args.inputs, ys):
        write_wav(os.path.join(args.out_dir, os.path.basename(path)), y, sr, pcm16=not args.float32)
    emit_metric("batch_audio_seconds_per_second",
                audio_seconds_per_second(sum(len(x) for x in xs), sr, dt), "audio-s/s",
                utterances=len(xs), device=args.device)
    return 0


def _run_chunked(args) -> int:
    import torch.distributed as dist

    from .parallel import distributed
    from .parallel.chunked import chunked_time_stretch
    from .parallel.mesh import make_mesh

    multihost = args.coordinator is not None or args.num_processes is not None
    if multihost:
        # One process per device, on one host or many: the chunked bodies'
        # collectives run over the process group (parallel/mesh.py).
        distributed.initialize(
            coordinator_address=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id, backend="gloo" if args.device == "cpu" else "nccl",
        )
    try:
        mesh = make_mesh(args.devices)
        x, sr = read_wav(args.input)
        t0 = time.perf_counter()
        y = chunked_time_stretch(x, args.ratio, _cfg(args), mesh=mesh, device=args.device)
        y = y.cpu().numpy()
        dt = time.perf_counter() - t0
        if not multihost or dist.get_rank() == 0:
            write_wav(args.output, y, sr, pcm16=not args.float32)
            emit_metric("chunked_audio_seconds_per_second",
                        audio_seconds_per_second(len(x), sr, dt), "audio-s/s",
                        devices=mesh.size(), device=args.device)
    finally:
        if multihost:
            dist.destroy_process_group()
    return 0


def _run_bench(args) -> int:
    from . import bench

    return bench.run(args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pvoc-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stretch", help="time-stretch a WAV (pitch preserved)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--ratio", type=float, required=True, help="duration multiplier")
    p.add_argument(
        "--segment-frames", type=int, default=None,
        help="run the polar streaming executor with this many frames per "
        "segment (default: time_stretch's own routing); with "
        "--checkpoint-dir, the frames per checkpointed segment",
    )
    p.add_argument(
        "--checkpoint-dir", default=None,
        help="checkpoint/resume directory for long runs: the fused segment "
        "executor where the fused kernel covers the geometry, else the polar "
        "one; a rerun resumes after the last completed segment batch",
    )
    p.add_argument(
        "--batch-segments", type=int, default=8,
        help="segments per checkpoint batch (with --checkpoint-dir)",
    )
    p.add_argument(
        "--trace-dir", default=None,
        help="write a torch.profiler trace (Chrome/Perfetto JSON) here",
    )
    _add_dsp_args(p)
    p.set_defaults(fn=_run_stretch)

    p = sub.add_parser("pitch", help="pitch-shift a WAV (duration preserved)")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--semitones", type=float, required=True)
    _add_dsp_args(p)
    p.set_defaults(fn=_run_pitch)

    p = sub.add_parser("batch", help="data-parallel TSM of many WAVs (one padded batch)")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--ratio", type=float, required=True)
    p.add_argument("--out-dir", default="stretched")
    _add_dsp_args(p)
    p.set_defaults(fn=_run_batch)

    p = sub.add_parser("chunked", help="sequence-parallel TSM of one long WAV")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--ratio", type=float, required=True)
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size: the number of processes (default: all of them)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process: rank 0's address for torch.distributed "
                        "(run one pvoc-torch process per device, each with the "
                        "same three flags and its own --process-id)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: total number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's rank (rank 0 writes the output)")
    _add_dsp_args(p)
    p.set_defaults(fn=_run_chunked)

    from .bench import add_arguments

    p = sub.add_parser("bench", help="run the throughput bench (phase_vocoder_tpu_torch.bench)")
    add_arguments(p)
    p.set_defaults(fn=_run_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
