"""Device (H100): the share of the traced jobs' host wall time in which
the card ran nothing while the program's entry span was open: 100 x (the
entry span, placed on the device trace's clock and cut to its job's span,
less the union of the device operations inside it) / summed job span
wall. The denominator is device_idle_share's, so device_idle_share less
this is the idle time outside the program: the caller and the
synchronize. From the program's own spans (pvbench/program_spans.py)."""

from .. import program_spans
from ..trace import union

UNIT = "%"


def read(record):
    pairs = program_spans.jobs_with_entries(record, program_spans.registry(record))
    if pairs is None:
        return None
    idle = wall = 0.0
    for (job, _, _), (a, b) in zip(pairs, program_spans.placed(pairs)):
        a, b = max(a, job["start"]), min(b, job["end"])
        if b > a:
            idle += (b - a) - union((max(s, a), min(t, b)) for _, s, t in job["ops"] if s < b and t > a)
        wall += job["end"] - job["start"]
    if wall <= 0:
        return None
    return 100.0 * idle / wall
