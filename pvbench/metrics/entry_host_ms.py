"""Entry points (pipeline.py, streaming.py, parallel/): the host time from
an entry point's span to its first kernel launch span (the whole entry
span where it launches none), the mean over the traced jobs, in
milliseconds, from the program's own spans (pvbench/program_spans.py)."""

from .. import program_spans

UNIT = "ms"


def read(record):
    pairs = program_spans.jobs_with_entries(record, program_spans.registry(record))
    if pairs is None:
        return None
    leads = [(min(c for c, _ in launches) if launches else b) - a for _, (a, b), launches in pairs]
    return sum(leads) / len(leads) / 1e6
