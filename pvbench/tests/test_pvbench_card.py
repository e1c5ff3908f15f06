"""One short cell on a CUDA card, through the command itself."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
def test_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = subprocess.run([sys.executable, "pvbench/run.py", "--workload", "hour_recording.stretch2x",
                           "--seed", "4000000007", "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu" and out["attempted"] > 0
    assert set(out["metrics"]) == {"audio_s_per_s", "job_ms_p95", "setup_s"}
