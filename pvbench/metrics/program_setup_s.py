"""Set-up (the package's import, ops/_build.kernels, the table caches of
ops/fused.py): the program's own set-up spans in the run's process, in
seconds: the union of pv.setup.import, pv.setup.library and every
pv.setup.tables (a table built inside another counts once), less the
nvcc compiles (pv.setup.nvcc) inside the library's load. The rest of
setup_s is torch, the CUDA context and the harness's own pool and warm
jobs."""

from .. import program_spans
from ..trace import union

UNIT = "s"
PARTS = ("import", "library", "tables")


def read(record):
    spans = program_spans.registry(record)
    if not spans:
        return None
    parts = [(a, b) for name, _, a, b in spans if name in {program_spans.SETUP + p for p in PARTS}]
    if not parts:
        return None
    nvcc = [(a, b) for name, _, a, b in spans if name == program_spans.SETUP + "nvcc"]
    return (union(parts) - union(nvcc)) / 1e9
