"""pvbench/roofline.py, the frozen yardstick, against the program's
utils/metrics.py at every cell's shape and that of the 0.5x hour kept for
later."""

import pytest

from phase_vocoder_tpu_torch.utils import metrics
from pvbench import harness, roofline
from pvbench.jobs.stretch import stretch_work

SR, N, HOP = 16000, 1024, 256
SHAPES = [(name, harness.load_cell(name)["parameters"]["ratio"]) for name in harness.cell_names()]


@pytest.mark.parametrize("name,ratio", SHAPES + [("hour_recording.stretch2x", 0.5)])
def test_bound_equals_the_programs(name, ratio):
    cell = harness.load_cell(name)
    seconds = cell["config"]["seconds"]
    n = int(seconds * SR)
    moved, flop = stretch_work(cell, n, ratio)
    nf = roofline.frames(n, N, HOP)
    assert flop == 2 * metrics.fft_flop(N) * nf
    theirs = metrics.bound_ms(moved, flop)
    ours, by = roofline.bound_s(moved, flop)
    assert ours * 1e3 == pytest.approx(theirs["bound_ms"], rel=1e-12)
    assert by == theirs["bound_by"]
    # per audio second, the program's rooflines (its output counted as
    # stretch x input) agree to the frames at the edges
    rate = metrics.binding_roofline_audio_s(SR, N, HOP, ratio)["audio_s_per_s"]
    assert seconds / ours == pytest.approx(rate, rel=2e-3)


def test_known_bounds():
    """PERF.md's bounds of the hour: 0.2063 ms (bytes) at 2.0x, 0.172 ms
    (operations) at 0.5x."""
    cell = harness.load_cell("hour_recording.stretch2x")
    t, by = roofline.bound_s(*stretch_work(cell, 3600 * SR, 2.0))
    assert by == "bytes" and t * 1e3 == pytest.approx(0.2063, abs=5e-5)
    t, by = roofline.bound_s(*stretch_work(cell, 3600 * SR, 0.5))
    assert by == "operations" and t * 1e3 == pytest.approx(0.1719, abs=5e-4)
