"""One hour-long (or any) recording a job, through
phase_vocoder_tpu_torch.pipeline.time_stretch with the cell's
branch_policy; the input stays on the card and so does the output."""

from __future__ import annotations

from .. import roofline, signals


def make_pool(cell, seed, device):
    c, t = cell["config"], cell["parameters"]
    return [{"x": signals.recording(c["seconds"], signals.stream_seed(seed, 100, i), device,
                                    c["sample_rate"]),
             "ratio": float(t["ratio"])}
            for i in range(t["pool"])]


def entry(cell):
    from phase_vocoder_tpu_torch import pipeline
    from phase_vocoder_tpu_torch.config import PvocConfig

    c = cell["config"]
    cfg = PvocConfig(n_fft=c["n_fft"], hop=c["hop"], sample_rate=c["sample_rate"])
    policy = c["branch_policy"]

    def job(item):
        return pipeline.time_stretch(item["x"], item["ratio"], cfg, branch_policy=policy)

    return job


def audio_seconds(cell, item):
    return item["x"].shape[0] / cell["config"]["sample_rate"]


def stretch_work(cell, length, ratio):
    c = cell["config"]
    n, hop = c["n_fft"], c["hop"]
    nf = roofline.frames(length, n, hop)
    out = 0 if nf == 0 else (nf - 1) * int(round(hop * ratio)) + n
    return roofline.stretch_work(length, out, n, hop)


def work(cell, item):
    return stretch_work(cell, item["x"].shape[0], item["ratio"])


def inputs(cell, item):
    return [(item["x"], item["ratio"])]


def outputs(cell, output):
    return [output]
