"""Kernels (csrc/*.cu): the least time of the traced jobs on an H100
(pvbench/roofline.py: the bytes any implementation moves at 3.35 TB/s or
two real transforms a frame at 67 TFLOP/s, whichever is longer) over
their device busy time (the union of every device operation's interval),
summed over the jobs, in percent."""

from .. import roofline
from ..trace import union

UNIT = "%"


def read(record):
    least = busy = 0.0
    for tj in record["jobs"]:
        least += roofline.bound_s(*tj["work"])[0]
        busy += union((a, b) for _, a, b in tj["ops"]) / 1e6
    if busy <= 0:
        return None
    return 100.0 * least / busy
