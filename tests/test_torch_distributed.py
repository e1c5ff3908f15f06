"""Multi-process runs of the port (twins of tests/test_distributed.py): two
processes join one gloo process group through
parallel.distributed.initialize and run the sequence-parallel chunked
program across the process boundary, and the CLI's `chunked` and `batch`
subcommands run end to end on the CPU. Each process group is killed if it
outlives its timeout (tests/torch_dist.py).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch.distributed as dist
from scipy.io import wavfile

from golden import pv_ref
import phase_vocoder_tpu_torch as tpv
from phase_vocoder_tpu_torch.parallel import chunked, distributed
from tests.torch_dist import REPO, free_port, make_test_signal, run_group, worker_main

N, RA = 1024, 256


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


def _golden_case(rank, world, out):
    mesh = distributed.global_mesh("seq")
    x = make_test_signal(6.0, seed=1)
    res = {f"s{s}": chunked.chunked_time_stretch(x, s, mesh=mesh, device="cpu").numpy()
           for s in (0.5, 2.0)}
    np.savez(out / f"golden.{rank}.npz", world=dist.get_world_size(), mesh=mesh.size(),
             rank=dist.get_rank(), **res)


CASES = {"golden": _golden_case}


def test_two_process_chunked_matches_golden(tmp_path):
    run_group(__file__, "golden", 2, tmp_path, timeout=300)
    recs = [np.load(tmp_path / f"golden.{r}.npz") for r in range(2)]
    x = make_test_signal(6.0, seed=1)
    for r, rec in enumerate(recs):
        assert int(rec["world"]) == 2 and int(rec["mesh"]) == 2 and int(rec["rank"]) == r
    for s in (0.5, 2.0):
        ref = pv_ref.phase_vocoder(x, s, N, RA)
        assert rel_err(recs[0][f"s{s}"], ref) < 1e-4
        assert np.array_equal(recs[0][f"s{s}"], recs[1][f"s{s}"])


def _cli(*args):
    return [sys.executable, "-m", "phase_vocoder_tpu_torch.cli", *map(str, args)]


def _wait_all(procs, timeout: float) -> list:
    """Outputs of the processes; kill all of them past `timeout` seconds."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail("CLI processes timed out")
    return outs


@pytest.fixture(scope="module")
def in_wav(tmp_path_factory):
    x = make_test_signal(6.0, seed=2).astype(np.float32)
    path = tmp_path_factory.mktemp("wav") / "in.wav"
    wavfile.write(path, 16000, x)
    return path, x


def test_cli_chunked_two_processes(in_wav, tmp_path):
    """`pvoc-torch chunked --coordinator ... --num-processes 2` bootstraps
    two processes; only rank 0 writes, and its output is the single
    route's."""
    path, x = in_wav
    coord = f"127.0.0.1:{free_port()}"
    outs = [tmp_path / f"out{i}.wav" for i in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            _cli("chunked", path, outs[i], "--ratio", 2.0, "--coordinator", coord,
                 "--num-processes", 2, "--process-id", i, "--device", "cpu", "--float32"),
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    logs = _wait_all(procs, 240)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert outs[0].exists() and not outs[1].exists()
    assert '"chunked_audio_seconds_per_second"' in logs[0] and "devices" in logs[0]
    sr, y = wavfile.read(outs[0])
    assert sr == 16000 and y.dtype == np.float32
    assert rel_err(y, tpv.time_stretch(x, 2.0, device="cpu").numpy()) < 5e-5


def test_cli_chunked_one_process(in_wav, tmp_path):
    """No coordinator: a world of one, which takes the single route."""
    path, x = in_wav
    out = tmp_path / "out.wav"
    proc = subprocess.run(_cli("chunked", path, out, "--ratio", 0.5, "--device", "cpu", "--float32"),
                          cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    _, y = wavfile.read(out)
    assert np.array_equal(y, tpv.time_stretch(x, 0.5, device="cpu").numpy())


def test_cli_batch(tmp_path):
    xs = [make_test_signal(s, seed=i).astype(np.float32) for i, s in enumerate([1.0, 0.6, 1.4])]
    paths = []
    for i, x in enumerate(xs):
        paths.append(tmp_path / f"u{i}.wav")
        wavfile.write(paths[-1], 16000, x)
    out_dir = tmp_path / "stretched"
    proc = subprocess.run(
        _cli("batch", *paths, "--ratio", 2.0, "--out-dir", out_dir, "--device", "cpu", "--float32"),
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"batch_audio_seconds_per_second"' in proc.stdout
    for path, x in zip(paths, xs):
        sr, y = wavfile.read(out_dir / path.name)
        ref = pv_ref.phase_vocoder(x.astype(np.float64), 2.0, N, RA)
        assert sr == 16000 and len(y) == len(ref)
        assert rel_err(y, ref) < 1e-4


def test_cli_help_lists_parallel_subcommands():
    proc = subprocess.run(_cli("--help"), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "batch" in proc.stdout and "chunked" in proc.stdout
    proc = subprocess.run(_cli("chunked", "--help"), cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    for flag in ("--devices", "--coordinator", "--num-processes", "--process-id"):
        assert flag in proc.stdout


def test_initialize_needs_a_rank_with_an_address():
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("127.0.0.1:1", num_processes=2)
    assert not dist.is_initialized()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main(sys.argv, CASES)
