"""Job kinds: one module per shape of entry call, found by the name a
cell's file gives under "kind". Each module defines

    make_pool(cell, seed, device) -> list of pooled inputs (made on device)
    entry(cell) -> job(item) -> output   (the call under test)
    audio_seconds(cell, item) -> audio seconds one job completes
    work(cell, item) -> (bytes, FP32 operations) the least implementation needs
    inputs(cell, item) -> [(input, ratio), ...] each stretch a job makes
    outputs(cell, output) -> [stretched input, ...] in the order of inputs()

The program is imported inside entry(), never at import time.
"""
