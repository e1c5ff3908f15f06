"""The benchmark of phase_vocoder_tpu_torch, one cell a run.

    python3 pvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell pvbench/workloads/<cell>.json on the first card of this
machine and prints one JSON line last: `correct`, `attempted` and
`failed` jobs, `metrics` (with --trace 0 the end-to-end metrics
audio_s_per_s, job_ms_p95 and setup_s; with --trace 1 the per-layer
readers of pvbench/metrics/), `device`, with --trace 1 a `breakdown`, and
last `checks`, each number compared with its limit, which also close
standard error. There is no CPU fallback: with no
card, or fewer than the cell takes, it exits 2 and prints no result; it
exits 3 if jax or the JAX package was loaded. `--control 1` runs the
control (pvbench/control.py) in the program's place, for setting and
testing the limits; the benchmark's own runs leave it at 0.

Build caches stay inside the checkout, at fixed paths: the kernels'
library in phase_vocoder_tpu_torch/build/ (the program's own); CUDA's JIT
cache, and any Triton or torch-extension cache a later kernel brings,
under .pvbench_cache/.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".pvbench_cache" / sub)
# The script's own folder would shadow modules of the standard library
# (trace) by the harness's; the checkout's root takes its place.
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "pvbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def program_in_checkout() -> None:
    """Raise unless the program imported is this checkout's."""
    import phase_vocoder_tpu_torch

    where = Path(phase_vocoder_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"phase_vocoder_tpu_torch comes from {where}, not from {ROOT}")


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t0: float = T0, control: bool = False):
    """(the result line, forbidden modules found after the window)."""
    import torch

    from pvbench import harness

    program_in_checkout()
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    rec = harness.run(cell, seed, seconds, traced, dev, t0, control)
    name = torch.cuda.get_device_name(dev) if device == "cuda" else "cpu"
    forbidden = sorted(set(rec["forbidden"]) | set(harness.forbidden_modules()))
    return harness.result(cell, rec, traced, name), forbidden


def report(out: dict, forbidden: list) -> int:
    if forbidden:
        print(f"pvbench: modules that must not load were loaded: {forbidden}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 pvbench/run.py", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell: pvbench/workloads/<name>.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: run the control in the program's place (it has to read not correct)")
    args = ap.parse_args(argv)

    from pvbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"pvbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    return report(*run_cell(cell, args.seed, args.seconds, bool(args.trace), control=bool(args.control)))


if __name__ == "__main__":
    sys.exit(main())
