"""Wrappers and executors (ops/_build.launch): the host time of one kernel
entry's call, its span pv.launch:<wrapper> (the ctypes call, the return
code's check and the launch count), the mean over every launch of the
traced jobs, in microseconds, from the program's own spans
(pvbench/program_spans.py)."""

from .. import program_spans

UNIT = "us"


def read(record):
    pairs = program_spans.jobs_with_entries(record, program_spans.registry(record))
    if pairs is None:
        return None
    times = [d - c for _, _, launches in pairs for c, d in launches]
    if not times:
        return None
    return sum(times) / len(times) / 1e3
