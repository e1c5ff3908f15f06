"""The device trace of a few jobs, read from torch.profiler.

Each traced job runs inside the harness's own span (a record_function
named SPAN) and ends in a synchronize, so every device operation it
caused starts and ends inside the span. The discipline is that of the
port's profile_call: two traced steps are discarded first, and every step
pauses 50 ms before and after its job (on an H100 the profiler dropped
kernels of 13 in 143 traces without the pauses and of none in 143 with
them). The pauses lie outside the spans and count nowhere.

summarize() turns the events into plain data, per job: the span's start
and end, its device operations (kernels, copies, fills) as (name, start,
end), and its idle gaps, each named by the outermost host operation open
in the span at the gap's midpoint. Times are microseconds on the
profiler's clock.
"""

from __future__ import annotations

import bisect
import re
import time

import torch

SPAN = "pvbench.job"
PAUSE_S = 0.05
DISCARDED = 2
NO_OP = "host (no op open)"


def clean(name: str) -> str:
    """A kernel's name without its argument list and template noise."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.sub(r"\(.*", "", name).strip()[:120]


def run_traced(run_one, count: int) -> list:
    """Run run_one(step) for DISCARDED + count steps under torch.profiler,
    each in its span; returns the kept steps' jobs (summarize)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=DISCARDED, active=count, repeat=1)) as prof:
        for step in range(DISCARDED + count):
            time.sleep(PAUSE_S)
            with record_function(SPAN):
                run_one(step)
            time.sleep(PAUSE_S)
            prof.step()
    return summarize(prof.events())


def _annotation(e) -> bool:
    return (getattr(e, "is_user_annotation", False) or e.name == SPAN
            or e.name.startswith("ProfilerStep"))


def summarize(events) -> list:
    """Jobs (dicts) from profiler events, in time order."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, host, dev = [], [], []
    for e in events:
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if not _annotation(e):
                dev.append((r[0], r[1], clean(e.name)))
        elif e.name == SPAN:
            spans.append(r)
        elif not _annotation(e) and e.cpu_parent is not None and e.cpu_parent.name == SPAN:
            host.append((r[0], r[1], e.name))
    spans.sort()
    dev.sort()
    host.sort()
    host_starts = [h[0] for h in host]
    jobs = []
    for s, t in spans:
        ops = [[name, a, b] for a, b, name in dev if s <= a <= t]
        jobs.append({"start": s, "end": t, "ops": ops,
                     "gaps": _gaps(s, t, ops, host, host_starts)})
    return jobs


def union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total, reach = total + b - a, b
        elif b > reach:
            total, reach = total + b - reach, b
    return total


def _gaps(s, t, ops, host, host_starts) -> list:
    """[name, microseconds] of each stretch of the span [s, t] in which no
    device operation ran."""
    out, reach = [], s
    for _, a, b in sorted(ops, key=lambda o: o[1]) + [["", t, t]]:
        if a > reach:
            mid = (reach + a) / 2
            # the span's direct children do not overlap: only the last one
            # that starts before the midpoint can cover it
            i = bisect.bisect_right(host_starts, mid) - 1
            covered = i >= 0 and host_starts[i] >= s and host[i][1] >= mid
            out.append([host[i][2] if covered else NO_OP, a - reach])
        reach = max(reach, b)
    return out
