#!/usr/bin/env python3
"""Drive the port's parallel layer over every visible card, one process
per card, NCCL between them, and check it against one card.

    python3 chip_multi.py                      # all visible cards
    python3 chip_multi.py --world 4 --device cpu --backend gloo --seconds 120

Each rank joins the process group through parallel.distributed.initialize
and runs, on the same chirp + tone + noise signal:
  1. chunked_time_stretch over a 1-D "seq" mesh of every rank at 2.0x
     (the fused1 body: one pvoc_fused_segment per rank) and 0.5x (the split
     body: pvoc_terms and phasor_istft_ola per rank) on `--seconds` of
     audio, timed with CUDA events between barriers, against
     pipeline.time_stretch on rank 0 (<= 5e-5 interior relative);
  2. batched_chunked_time_stretch on a (2, W/2) mesh (W even), four rows of
     a tenth of that length, against the single route row by row;
  3. batch_time_stretch_varied over a "data" mesh of every rank, 24
     utterances of 5-30 s, against the one-rank batch, bitwise.
Rank 0 prints one JSON line per phase, then the card's name and power
limit, then {"ok": true, ...}. It exits non-zero on a failed check or a
rank that fails or outlives --timeout. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

import numpy as np
import torch

N_FFT, HOP, SR = 1024, 256, 16000


def _signal(seconds: float, seed: int = 0) -> np.ndarray:
    """Chirp + tone + noise (chip_smoke.py's signal)."""
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * np.sin(2 * np.pi * (200.0 * t + 400.0 * t * t))
         + 0.05 * g.standard_normal(len(t)))
    return x / np.max(np.abs(x))


def _rel(a, b, edge=N_FFT) -> float:
    a, b = a.double().cpu()[edge:-edge], b.double().cpu()[edge:-edge]
    if a.shape != b.shape:
        raise RuntimeError(f"length mismatch {tuple(a.shape)} != {tuple(b.shape)}")
    return float((a - b).abs().max() / b.abs().max())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _rank(args) -> int:
    import torch.distributed as dist

    import phase_vocoder_tpu_torch as pv
    from phase_vocoder_tpu_torch.parallel import chunked, distributed
    from phase_vocoder_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    distributed.initialize(f"127.0.0.1:{args.port}", args.world, args.rank, backend=args.backend,
                           timeout_s=args.timeout)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(args.device) if args.device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"

    def timed(fn, reps=3):
        """Per-call wall time of fn() on this rank, between barriers (CUDA
        events on a card)."""
        fn()
        out = []
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize()
            dist.barrier()
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                out.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    def emit(phase, **rec):
        if rank == 0:
            print(json.dumps({"phase": phase, "world": world, "backend": args.backend, **rec}), flush=True)

    cfg = pv.PvocConfig()
    x = torch.as_tensor(_signal(args.seconds), dtype=torch.float32, device=dev)
    seq = make_mesh(axis="seq")
    rec = {}
    for s in (2.0, 0.5):
        run = lambda: chunked.chunked_time_stretch(x, s, cfg, mesh=seq)  # noqa: E731
        rec[f"{s}x_ms"] = timed(run)
        y = run()
        if rank == 0:
            single = lambda: pv.time_stretch(x, s, cfg, branch_policy="fast")  # noqa: E731
            rec[f"{s}x_single_ms"] = timed_local(single, cuda)
            rec[f"{s}x_rel_vs_single"] = _rel(y, single())
            _check(rec[f"{s}x_rel_vs_single"] <= 5e-5, f"chunked {s}x over {world} ranks: {rec}")
        dist.barrier()
    emit("1_chunked", seconds=args.seconds, **rec)

    rec = {}
    if world % 2 == 0:
        mesh2 = make_mesh_2d(2, world // 2)
        xs = torch.stack([x[i * len(x) // 8 : i * len(x) // 8 + len(x) // 10] for i in range(4)])
        for s in (2.0, 0.5):
            run = lambda: chunked.batched_chunked_time_stretch(xs, s, cfg, mesh=mesh2)  # noqa: E731
            rec[f"{s}x_ms"] = timed(run)
            ys = run()
            if rank == 0:
                rec[f"{s}x_rel_vs_single_max"] = max(
                    _rel(ys[i], pv.time_stretch(xs[i], s, cfg, branch_policy="fast")) for i in range(4))
                _check(rec[f"{s}x_rel_vs_single_max"] <= 5e-5, f"batched chunked {s}x: {rec}")
        emit("2_batched_chunked", mesh=[2, world // 2], rows=4, seconds_per_row=args.seconds / 10, **rec)

    rng = np.random.default_rng(24)
    ratios = [(0.5, 0.75, 1.0, 1.25, 1.5, 2.0)[i % 6] for i in range(24)]
    us = [torch.as_tensor(_signal(float(s), seed=500 + i), dtype=torch.float32, device=dev)
          for i, s in enumerate(rng.uniform(5.0, 30.0, 24))]
    data = make_mesh(axis="data")
    run = lambda: pv.batch_time_stretch_varied(us, ratios, cfg, mesh=data)  # noqa: E731
    rec = {"ms": timed(run)}
    ys = run()
    if rank == 0:
        one = pv.batch_time_stretch_varied(us, ratios, cfg)
        rec["one_rank_ms"] = timed_local(lambda: pv.batch_time_stretch_varied(us, ratios, cfg), cuda)
        rec["bitwise_vs_one_rank"] = all(bool(torch.equal(a, b)) for a, b in zip(ys, one))
        _check(rec["bitwise_vs_one_rank"], f"batch over {world} data ranks differs from one rank")
    emit("3_batch", utterances=24, audio_seconds=sum(len(u) for u in us) / SR, **rec)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def timed_local(fn, cuda: bool, reps: int = 3) -> list:
    """Per-call time of fn() on this process alone."""
    fn()
    out = []
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=None, help="processes (default: visible cards)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--seconds", type=float, default=3600.0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return _rank(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chip_multi: torch.cuda.is_available() is false")
    world = args.world or torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, __file__, "--world", str(world), "--device", args.device, "--backend",
            args.backend, "--seconds", str(args.seconds), "--timeout", str(args.timeout), "--port", str(port)]
    procs = [subprocess.Popen(base + ["--rank", str(r)], stdout=None if r == 0 else subprocess.DEVNULL)
             for r in range(world)]
    deadline = time.monotonic() + args.timeout
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
        print(f"ranks {failed} failed or timed out", file=sys.stderr)
        return 1
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
    else:
        print(json.dumps({"ok": True, "device": {"platform": "cpu", "count": world}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
