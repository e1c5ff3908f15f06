"""Wrappers and executors (pipeline.py's channel handling, onto
ops/_build.launch): the channels of a multichannel recording that one
kernel launch covers, from the program's counters: every channels.<wrapper>
over the launches.<wrapper> of the same wrappers, over the whole run (the
counters are the process's). 8.0 where the batch axis carries an 8-channel
job, 1.0 where the channels go one launch each. None where the program
counts no channels (an older checkout, a one-channel cell) or the traced
jobs ran nothing on the device."""

UNIT = "channels"
PREFIX = "channels."


def read(record):
    if not any(job["ops"] for job in record["jobs"]):
        return None
    from phase_vocoder_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    counts = counters()
    wrappers = [name[len(PREFIX):] for name in counts if name.startswith(PREFIX)]
    launches = sum(counts.get("launches." + w, 0) for w in wrappers)
    if not launches:
        return None
    return sum(counts[PREFIX + w] for w in wrappers) / launches
