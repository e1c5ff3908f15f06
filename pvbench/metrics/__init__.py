"""Per-layer metrics: one reader a file, named as the metric. Each
defines UNIT and read(record) -> float or None, where record is
{"jobs": [traced job, ...]} and a traced job is pvbench/trace.py's dict
with "work" (bytes, FP32 operations) added. A reader that finds nothing
to read returns None and the metric is left out of the run's line."""
