"""The benchmark is data: every cell, configuration, traffic mix and metric
loads by its name, and a new cell or metric is new files and entries."""
import json
import os
import shutil

import pytest

from portbench import run
from portbench.reference import load_judge
from portbench.run import ROOT, load_cell, load_metric

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = load_cell(name)
    assert cell.config["program"] in ("sibelia", "csibelia")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.config["limits"]) >= {"jobs_differing"}


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_file_loads_by_name(name):
    assert callable(load_metric(name))


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in load_cell(w).end_to_end}


def test_a_new_cell_and_metric_are_files_and_entries_alone(tmp_path):
    """A copy of the benchmark with one more traffic mix, cell and
    per-layer metric, each a new file and a new entry, runs that cell and
    reports the metric; the old cells are unchanged."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "portbench/traffic/tiny3.json").write_text(json.dumps(
        {"genomes": "strains", "strains": 2, "length": 210_000,
         "layout_seed": 4}))
    (tmp_path / "portbench/cells/sibelia_loose.tiny3.json").write_text(
        json.dumps({"config": "sibelia_loose", "traffic": "tiny3"}))
    (tmp_path / "portbench/metrics/jobs_done.sibelia.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    bench["workloads"].append({"name": "sibelia_loose.tiny3",
                               "config": "sibelia_loose", "traffic": "tiny3",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "sibelia_Mbp_s":
            m["workloads"].append("sibelia_loose.tiny3")
    bench["per_layer"].append({"name": "jobs_done.sibelia", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "sibelia_Mbp_s",
                               "workloads": ["sibelia_loose.tiny3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("sibelia_loose.tiny3", root=str(tmp_path))
    assert cell.traffic["length"] == 210_000
    assert [m["name"] for m in cell.per_layer][-1] == "jobs_done.sibelia"
    result, checks = run.bench(cell, 5, 0.0, True, device="cpu")
    assert result["correct"], checks
    assert result["metrics"]["jobs_done.sibelia"]["value"] == 1.0
    old = load_cell(CELLS[0], root=str(tmp_path))
    assert "jobs_done.sibelia" not in {m["name"] for m in old.per_layer}


@pytest.mark.parametrize("name,module", [
    ("sibelia_loose.saureus4", "blocks"),
    ("csibelia_default.saureus_half_pair", "variants"),
    ("csibelia_fast.saureus_half_pair", "fast")])
def test_each_configuration_takes_its_judge(name, module):
    """Without a ``judge`` key a configuration is judged by its program's
    module; csibelia_fast names its own."""
    config = load_cell(name).config
    assert ("judge" in config) == (module == "fast")
    assert load_judge(config).__module__ == f"portbench.reference.{module}"


def _copy_with_judge(tmp_path, judge):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    path = tmp_path / "portbench/configs/sibelia_loose.json"
    config = json.loads(path.read_text())
    path.write_text(json.dumps({**config, "judge": judge}))
    return str(tmp_path)


@pytest.mark.parametrize("judge", ["no_such_judge", "../run", "alignscore"])
def test_an_unknown_judge_fails_at_load_cell(tmp_path, judge):
    root = _copy_with_judge(tmp_path, judge)
    with pytest.raises(SystemExit, match="names no judge"):
        load_cell("sibelia_loose.hpylori2", root=root)


def test_a_judge_is_a_new_file_and_its_name(tmp_path):
    root = _copy_with_judge(tmp_path, "mine")
    (tmp_path / "portbench/reference/mine.py").write_text(
        "from .blocks import judge as blocks\n\n\n"
        "def judge(out, inputs, config):\n"
        "    return {**blocks(out, inputs, config), 'mine': 0}\n")
    cell = load_cell("sibelia_loose.hpylori2", root=root)
    found = load_judge(cell.config, os.path.join(root, "portbench", "reference"))
    assert found.__module__ == "portbench.reference.mine"
    cell.traffic = {"genomes": "strains", "strains": 2, "length": 210_000,
                    "layout_seed": 4}
    result, checks = run.bench(cell, 5, 0.0, False, device="cpu")
    assert result["correct"] and checks["mine"] == 0, checks
