"""Nothing under pvbench/ imports jax or the JAX package, comparing the
top-level name whole (the port's own name begins with the JAX
package's); nothing under pvbench/reference/, nor the control, imports the
program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PV = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "phase_vocoder_tpu"}
PROGRAM = "phase_vocoder_tpu_torch"


def imported(path: Path) -> set:
    """Top-level names of every module the file imports (relative imports
    resolved within pvbench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("pvbench" if node.level else node.module.split(".")[0])
    return names


FILES = sorted(p for p in PV.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PV)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PV / "reference").glob("*.py")) + [PV / "control.py"],
                         ids=lambda p: p.name)
def test_reference_and_control_are_independent(path):
    assert imported(path) <= {"__future__", "functools", "math", "torch", "pvbench"}
    assert PROGRAM not in path.read_text()


def test_whole_names_are_compared():
    assert "phase_vocoder_tpu_torch".split(".")[0] not in FORBIDDEN
    assert PROGRAM != "phase_vocoder_tpu"


def test_a_run_loads_no_jax():
    """A small CPU run, in a fresh process, leaves no JAX module loaded."""
    code = ("import sys; from pvbench import harness; from pvbench.run import run_cell;"
            "c = harness.load_cell('hour_recording.stretch2x'); c['config']['seconds'] = 2.0;"
            "c['parameters']['pool'] = 1;"
            "out, bad = run_cell(c, 5, 0.1, False, device='cpu');"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(harness.FORBIDDEN)), bad,"
            " out['correct'])")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PV.parent, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-3:] == ["[]", "[]", "True"]
