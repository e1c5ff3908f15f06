"""Cells, configurations, kinds and metrics are found by file name, and
every name, unit and limit of BENCHMARK.json agrees with those files."""

import json
import re
import shutil
from pathlib import Path

import pytest

from pvbench import harness
from pvbench.run import run_cell
from pvbench.tests.conftest import SEED

ROOT = Path(__file__).resolve().parents[2]
PV = ROOT / "pvbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", harness.cell_names())
def test_every_cell_file_is_found_by_name(name):
    cell = harness.load_cell(name)
    raw = json.loads((PV / "workloads" / f"{name}.json").read_text())
    assert NAME.match(name) and NAME.match(cell["traffic"]) and NAME.match(cell["kind"])
    assert name == f"{raw['config']}.{cell['traffic']}"
    assert harness.kind(cell).__name__ == f"pvbench.jobs.{cell['kind']}"
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert set(cell["small"]) <= {"config", "parameters"}
    assert harness.CHECK in cell["limits"] and cell["limits"][harness.CHECK] > 0


@pytest.mark.parametrize("name", sorted(harness.metric_readers()))
def test_every_metric_file_is_found_by_name(name):
    reader = harness.metric_readers()[name]
    assert NAME.match(name) and UNIT.match(reader.UNIT) and callable(reader.read)


@pytest.mark.parametrize("path", sorted((PV / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_every_config_file_is_found_by_name(path):
    config = json.loads(path.read_text())
    assert NAME.match(path.stem) and isinstance(config["reduced"], list)
    assert 1 <= len(config["source"]) <= 200


def test_benchmark_json_matches_the_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "pvbench/run.py"] and b["paths"] == ["pvbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"pvbench/configs/{c['name']}.json"
        assert c["source"] == data["source"] and c["reduced"] == data["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            json.loads((PV / "workloads" / f"{w['name']}.json").read_text())["config"],
            cell["traffic"], cell["chips"], cell["why"])
        assert w["config"] in configs
    readers = harness.metric_readers()
    for m in b["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"] and m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_cell_needs_only_a_new_file(tmp_path):
    """A throwaway cell in another folder runs with no code edit."""
    cell = json.loads((PV / "workloads" / "hour_recording.stretch2x.json").read_text())
    cell.update(traffic="identity", why="identity resynthesis", parameters={"ratio": 1.0, "pool": 1,
                                                                          "traced_jobs": 1})
    (tmp_path / "hour_recording.identity.json").write_text(json.dumps(cell))
    config = json.loads((PV / "configs" / "hour_recording.json").read_text())
    config["seconds"] = 2.0
    (tmp_path / "hour_recording.json").write_text(json.dumps(config))
    loaded = harness.load_cell("hour_recording.identity", workloads=tmp_path, configs=tmp_path)
    out, forbidden = run_cell(loaded, SEED, 0.2, True, device="cpu")
    assert out["correct"] and out["attempted"] >= 1 and not forbidden
    assert out["checks"]["max_rel_err"]["value"] < 1e-5
    assert list(out)[-1] == "checks"


def test_a_missing_cell_raises():
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no_such_config.no_such_traffic")


def test_only_the_benchmark_and_its_folder_is_not_enough(tmp_path):
    """In a folder that holds only BENCHMARK.json and pvbench/, the program
    is missing and a run gives no result."""
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PV, tmp_path / "pvbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-c", "from pvbench import run; run.program_in_checkout()"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()
