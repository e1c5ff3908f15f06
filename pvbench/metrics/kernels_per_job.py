"""Wrappers and executors (ops/*.py, streaming.py, parallel/batch.py): the
device operations (kernels, copies, fills) one traced job launches, the
mean over the traced jobs (an exact count where every job launches the
same)."""

UNIT = "launches"


def read(record):
    counts = [len(tj["ops"]) for tj in record["jobs"]]
    if not counts or not any(counts):
        return None
    return sum(counts) / len(counts)
