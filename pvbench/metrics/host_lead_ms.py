"""Entry points (pipeline.py): the host time from a job's call to its
first device operation, the mean over the traced jobs, in milliseconds."""

UNIT = "ms"


def read(record):
    leads = [min(a for _, a, _ in tj["ops"]) - tj["start"] for tj in record["jobs"] if tj["ops"]]
    if not leads:
        return None
    return sum(leads) / len(leads) / 1e3
