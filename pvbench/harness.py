"""The benchmark's machinery: cells found by name, the closed-loop window,
the traced jobs, the comparison with the plain reference, and the result.

A cell is pvbench/workloads/<name>.json; it names its configuration
(pvbench/configs/<config>.json) and its job kind (pvbench/jobs/<kind>.py).
Per-layer metrics are the readers in pvbench/metrics/<metric>.py. Adding
a cell, a configuration, a kind or a metric adds files; nothing here
changes.

run() builds the pool of inputs from the seed, warms every pooled input
once, then runs jobs back to back, each timed on the host clock from the
call to torch.cuda.synchronize(), until the window has lasted `seconds`.
It keeps, for each pooled input, the output of one job drawn from the
seed (reservoir sampling), and judges those after the window against the
float64 reference.

With control=True the job is the control instead of the program: the
reference itself with its transforms rounded to TF32 (pvbench/control.py),
judged in the same way; it has to come out not correct.
"""

from __future__ import annotations

import gc
import importlib
import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import control as control_job
from . import signals, trace
from .reference import pv64

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "phase_vocoder_tpu")
CHECK = "max_rel_err"


def load_cell(name: str, workloads: Path | None = None, configs: Path | None = None) -> dict:
    """The cell `name`: its file, with its configuration's file under
    "config" and the cell's own name."""
    cell = json.loads(((workloads or HERE / "workloads") / f"{name}.json").read_text())
    cell["config"] = json.loads(((configs or HERE / "configs") / f"{cell['config']}.json").read_text())
    cell["name"] = name
    return cell


def cell_names() -> list:
    """Every cell under pvbench/workloads/."""
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def kind(cell: dict):
    return importlib.import_module(f"{__package__}.jobs.{cell['kind']}")


def metric_readers() -> dict:
    """{metric name: module} for every file under pvbench/metrics/."""
    return {p.stem: importlib.import_module(f"{__package__}.metrics.{p.stem}")
            for p in sorted((HERE / "metrics").glob("*.py")) if p.stem != "__init__"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: dict, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, control: bool = False) -> dict:
    """The run's record; t0 is the wall clock (time.time) at process start."""
    k = kind(cell)
    job = control_job.entry(cell, k) if control else k.entry(cell)
    outputs = control_job.outputs if control else k.outputs
    pool = k.make_pool(cell, seed, device)
    for item in pool:  # every shape of the window, and the kernel build
        job(item)
    _sync(device)

    pick = random.Random(signals.stream_seed(seed, 900))
    kept, counts, spans = {}, [0] * len(pool), []
    window_start = time.time()
    begin = time.perf_counter()
    j = 0
    while not spans or spans[-1][1] - begin < seconds:
        p = j % len(pool)
        a = time.perf_counter()
        out = job(pool[p])
        _sync(device)
        spans.append((a, time.perf_counter()))
        counts[p] += 1
        if pick.random() * counts[p] < 1.0:
            kept[p] = out
        del out
        j += 1
    rec = {"setup_s": window_start - t0,
           "window_s": spans[-1][1] - spans[0][0],
           "job_s": [b - a for a, b in spans],
           "audio_s": sum(k.audio_seconds(cell, pool[i % len(pool)]) for i in range(j)),
           "jobs": j}

    if traced:
        n = cell["parameters"]["traced_jobs"]
        items = [(j + trace.DISCARDED + i) % len(pool) for i in range(n)]

        def one(step):
            job(pool[(j + step) % len(pool)])
            _sync(device)

        jobs = trace.run_traced(one, n)
        for tj, p in zip(jobs, items):
            tj["work"] = list(k.work(cell, pool[p]))
        rec["trace"] = jobs

    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec["forbidden"] = forbidden_modules()
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec.update(judge(cell, k, pool, {p: outputs(cell, y) for p, y in kept.items()}))
    return rec


def judge(cell: dict, k, pool: list, kept: dict) -> dict:
    """Each kept output (a list, one a stretched input) against the
    reference on the same input: the worst interior max-rel error, answers
    judged, and jobs with a wrong answer."""
    c = cell["config"]
    limit = cell["limits"][CHECK]
    worst, answers, wrong_jobs = 0.0, 0, 0
    for p in sorted(kept):
        errs = [pv64.max_rel_err(y, pv64.time_stretch(x, r, c["n_fft"], c["hop"]),
                                 c["comparison"]["interior_skip_samples"])
                for (x, r), y in zip(k.inputs(cell, pool[p]), kept[p], strict=True)]
        answers += len(errs)
        worst = max([worst, *errs])
        wrong_jobs += any(not e <= limit for e in errs)
    return {"checks": {CHECK: {"value": worst, "limit": limit}}, "answers": answers,
            "wrong_jobs": wrong_jobs}


def result(cell: dict, rec: dict, traced: bool, device_name: str) -> dict:
    """The run's last line from its record."""
    check = rec["checks"]
    correct = (rec["answers"] > 0 and rec["wrong_jobs"] == 0
               and check[CHECK]["value"] <= check[CHECK]["limit"] and not rec["forbidden"])
    device = {"platform": "cpu" if device_name == "cpu" else "gpu", "kind": device_name,
              "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": rec["jobs"], "failed": rec["wrong_jobs"]}
    if traced:
        record = {"jobs": rec["trace"]}
        metrics = {}
        for name, reader in metric_readers().items():
            value = reader.read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        busy = sum(trace.union((o[1], o[2]) for o in tj["ops"]) for tj in rec["trace"])
        spans = sum(tj["end"] - tj["start"] for tj in rec["trace"])
        device.update(busy_s=busy / 1e6, window_s=spans / 1e6)
        out.update(metrics=metrics, device=device, breakdown=breakdown(rec["trace"]))
    else:
        ms = np.array(rec["job_s"]) * 1e3
        out.update(metrics={
            "audio_s_per_s": {"value": rec["audio_s"] / rec["window_s"], "unit": "audio-s/s"},
            "job_ms_p95": {"value": float(np.percentile(ms, 95)), "unit": "ms"},
            "setup_s": {"value": rec["setup_s"], "unit": "s"},
        }, device=device)
    out["checks"] = check
    return out


def breakdown(jobs: list) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the host operation open during them, over the traced jobs."""
    ops, gaps = {}, {}
    for tj in jobs:
        for name, a, b in tj["ops"]:
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
        for name, us in tj["gaps"]:
            gaps[name] = gaps.get(name, 0.0) + us / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
