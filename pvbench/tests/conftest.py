"""pvbench's own tests: on the CPU, at small sizes, apart from the repo's
tests/. `python -m pytest pvbench/tests -q`. The test marked `card` runs
one short cell on a CUDA card and skips where there is none; it decides
inside the test, never at import.

Every cell file carries under "small" the configuration's and the
parameters' keys that make it small enough for the CPU, so a new cell is
tested with no edit here."""

import pytest

SEED = 4_000_000_007  # past 32 signed bits, as a run's seed may be


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def small():
    """The cell `name` made small by its own "small" overrides."""
    from pvbench import harness

    def make(name):
        cell = harness.load_cell(name)
        cell["config"].update(cell["small"].get("config", {}))
        cell["parameters"].update(cell["small"].get("parameters", {}))
        return cell

    return make
