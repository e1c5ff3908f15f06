"""Runs of every cell, small and on the CPU, the card check skipped: a
sound run reads correct; with the timed path broken underneath, or with
the control in the program's place, the same run reads not correct at
the cell's own limit.

The fault a cell of one stretch can have: an answer altered where it is
produced. None of today's cells batches answers (no half of a batch to
leave out), spans cards (no exchange), or carries state from one job to
the next (no step to return unchanged)."""

import pytest
import torch

from pvbench import harness
from pvbench.run import run_cell
from pvbench.tests.conftest import SEED

WINDOW_S = 0.2
CELLS = harness.cell_names()


def run(cell, traced=False, control=False):
    out, forbidden = run_cell(cell, SEED, WINDOW_S, traced, device="cpu", control=control)
    assert not forbidden and list(out)[-1] == "checks"
    return out


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(small, name):
    out = run(small(name), traced=True)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["max_rel_err"]["value"] < out["checks"]["max_rel_err"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(small, name):
    cell = small(name)
    out = run(cell, control=True)
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["max_rel_err"]["limit"] == cell["limits"]["max_rel_err"]


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(small, name, monkeypatch):
    cell = small(name)
    k = harness.kind(cell)
    sound = k.entry

    def broken_entry(cell):
        job = sound(cell)

        def broken(item):
            out = job(item)
            y = k.outputs(cell, out)[-1]
            y[y.shape[0] // 2] += 0.1
            return out

        return broken

    monkeypatch.setattr(k, "entry", broken_entry)
    out = run(cell)
    assert not out["correct"] and out["failed"] >= 1


def test_the_control_is_float32():
    """The control's outputs are float32, as the program's are."""
    cell = harness.load_cell(CELLS[0])
    cell["config"]["seconds"] = 1.0
    from pvbench import control

    k = harness.kind(cell)
    item = k.make_pool(cell, SEED, torch.device("cpu"))[0]
    ys = control.outputs(cell, control.entry(cell, k)(item))
    assert [y.dtype for y in ys] == [torch.float32] * len(k.inputs(cell, item))
