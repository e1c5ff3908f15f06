"""Device (H100): the share of the traced jobs' host wall time in which no
device operation ran: 100 (1 - union of the operations' intervals /
summed span wall), the pauses between jobs excluded."""

from ..trace import union

UNIT = "%"


def read(record):
    busy = wall = 0.0
    for tj in record["jobs"]:
        busy += union((a, b) for _, a, b in tj["ops"])
        wall += tj["end"] - tj["start"]
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
