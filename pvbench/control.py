"""The control: the plain reference put in the program's place, with both
of its transforms rounded to TF32 (the step below float32 with TF32 off),
cast to float32 as the program's outputs are. Run through the harness
(`python3 pvbench/run.py ... --control 1`) it has to come out not correct
at the cell's own limit; the benchmark's own runs never run it."""

from __future__ import annotations

import torch

from .reference import pv64


def entry(cell, kind):
    """A job that stretches each input of a pooled item as the control."""
    c = cell["config"]

    def job(item):
        return [pv64.time_stretch(x, r, c["n_fft"], c["hop"], transform="tf32").to(torch.float32)
                for x, r in kind.inputs(cell, item)]

    return job


def outputs(cell, output):
    return output
