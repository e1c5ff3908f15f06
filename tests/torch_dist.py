"""Process groups for the port's multi-rank tests: a test file runs its own
worker function in `world` processes over gloo on the CPU.

A worker process is `python <test file> --worker <case> <rank> <world>
<port> <out dir>`; the file's __main__ calls worker_main with its cases,
each a function(rank, world, out_dir) that writes its results under
out_dir. run_group starts the processes, waits for them within a timeout
and kills them all on expiry or on the first failure. The workers import
no JAX: test files import it inside their tests only.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def make_test_signal(seconds: float = 1.0, sr: int = 16000, seed: int = 0):
    """tests/conftest.py's chirp + tone + noise signal (conftest imports
    jax, which the workers must not)."""
    import numpy as np

    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.3 * np.sin(2 * np.pi * (200.0 * t + 400.0 * t * t))
        + 0.05 * g.standard_normal(len(t))
    )
    return (x / np.max(np.abs(x))).astype(np.float64)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(test_file: str, case: str, world: int, out_dir, timeout: float = 300.0,
              args: tuple = ()) -> None:
    """Run `case` of test_file's workers in `world` processes; raise with
    their output if one fails or the group outlives `timeout` seconds."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(pathlib.Path(out_dir) / f"{case}.rank{r}.log", "w+") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, test_file, "--worker", case, str(r), str(world), str(port),
             str(out_dir), *map(str, args)],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        out = []
        for r in failed:
            logs[r].seek(0)
            out.append(f"--- rank {r} (rc {procs[r].returncode}):\n{logs[r].read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if failed:
        raise RuntimeError(f"worker group {case!r} x{world} failed:\n" + "\n".join(out))


def worker_main(argv: list, cases: dict) -> None:
    """Entry of a worker process: join the gloo group of `world` ranks on
    localhost, run the case, leave the group."""
    import torch

    from phase_vocoder_tpu_torch.parallel import distributed

    case, rank, world, port, out_dir = argv[2], int(argv[3]), int(argv[4]), int(argv[5]), argv[6]
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120)
    try:
        cases[case](rank, world, pathlib.Path(out_dir), *argv[7:])
    finally:
        torch.distributed.destroy_process_group()
