"""The program's own spans (phase_vocoder_tpu_torch/utils/profiling.py),
for the per-layer readers that read them.

The program records a span (name, depth, start_ns, end_ns) on
time.time_ns() while torch.profiler records, so during the traced jobs,
and its set-up spans (pv.setup.*) always. The outermost span of a call
(depth 0, not set-up) is its entry point's, and a traced job is one call
of an entry point, so the last len(jobs) entry spans pair, in order,
with the record's jobs.

The device trace's times are microseconds from the profiler's own start,
which the record does not hold. An entry span is placed on that clock by
subtracting off = min over the jobs of (entry start - job start): the
job whose entry opened soonest after its job span is taken to have
opened at once. So every entry is placed early by the least delay from
the harness's span of a job to the entry's, on the H100's host 45-70 us
after the traced jobs' 50 ms pauses (PERF.md, section 6), and the
device's idle time in that delay at each job's start counts as the
program's.

A program that keeps no registry (an older checkout) gives None, and so
does a record whose jobs ran nothing on the device (no device trace to
read them beside) or a run in which the program recorded nothing a
reader needs."""

from __future__ import annotations

LAUNCH = "pv.launch:"
SETUP = "pv.setup."


def registry(record: dict):
    """The program's spans by start, or None where it keeps none or no
    traced job ran a device operation."""
    if not any(job["ops"] for job in record["jobs"]):
        return None
    from phase_vocoder_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def entries(spans: list) -> list:
    """(start_ns, end_ns) of each entry span, by start."""
    return [(a, b) for name, depth, a, b in spans if depth == 0 and not name.startswith(SETUP)]


def jobs_with_entries(record: dict, spans):
    """[(job, (start_ns, end_ns), [launch (start_ns, end_ns), ...])] for the
    traced jobs, or None where there are fewer entry spans than jobs."""
    jobs = record["jobs"]
    if not spans:
        return None
    found = entries(spans)
    if len(found) < len(jobs):
        return None
    found = found[-len(jobs):]
    launches = [(a, b) for name, _, a, b in spans if name.startswith(LAUNCH)]
    return [(job, (a, b), [(c, d) for c, d in launches if a <= c <= b])
            for job, (a, b) in zip(jobs, found)]


def placed(pairs: list) -> list:
    """Each job's entry span as (start, end) in microseconds on the device
    trace's clock."""
    base = pairs[0][1][0]
    off = min((a - base) / 1e3 - job["start"] for job, (a, _), _ in pairs)
    return [((a - base) / 1e3 - off, (b - base) / 1e3 - off) for _, (a, b), _ in pairs]
