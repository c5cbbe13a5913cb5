"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, traffic, limits and metric readers by name, a new cell is
files and entries only, and every name and unit keeps to the contract's
characters."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.Cell(name)
    assert cell.cfg["name"] == cell.entry["config"]
    assert cell.driver is spec.found("drivers", cell.traffic["driver"]).Driver
    assert cell.family is spec.found("families", cell.cfg["family"])
    for fn in ("resolutions", "param_specs", "forward_flops", "reference_logits",
               "program_model", "train_step"):
        assert callable(getattr(cell.family, fn))
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
        assert m["moves"] in e2e


def test_keys_and_characters():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])


@pytest.mark.parametrize("kind,name", [("families", "ndtnet_cls"), ("drivers", "serve_open"),
                                       ("metrics", "no_such.train"), ("families", "../spec")])
def test_unknown_name_raises(kind, name):
    with pytest.raises(ValueError, match="no .* file for"):
        spec.found(kind, name)


def test_new_cell_is_files_and_entries(tmp_path):
    """A copy of the benchmark gains a cell (a traffic file, a limits file,
    an entry), a model family and a configuration of it (a family file, a
    configuration file, an entry), a driver (a file) and a per-layer
    metric (a reader file, an entry) without an edit to a file it had."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench")
    bench = json.loads(json.dumps(BENCH))
    here = root / "portbench"
    (here / "families" / "ndtnet_cls.py").write_text(
        "def resolutions(cfg):\n    return [cfg['train_nds']]\n")
    (here / "drivers" / "train_graph_b8.py").write_text(
        "class Driver:\n    batch = 8\n")
    cfg = dict(spec.Cell("ndtnet-seg.train-graph").cfg, name="ndtnet-cls",
               family="ndtnet_cls", train_nds=1000)
    (here / "configs" / "ndtnet-cls.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "ndtnet-cls", "source": "https://example.org/ndtnet",
                             "file": "portbench/configs/ndtnet-cls.json", "reduced": [],
                             "why": "classification"})
    traffic = dict(spec.Cell("ndtnet-seg.train-graph").traffic, batch=8, driver="train_graph_b8")
    (here / "traffic" / "train-graph-b8.json").write_text(json.dumps(traffic))
    limits = spec.Cell("ndtnet-seg.train-graph").limits
    (root / "portbench" / "limits" / "ndtnet-seg.train-graph-b8.json").write_text(
        json.dumps(limits))
    (root / "portbench" / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return run.window['steps']\n")
    bench["workloads"].append({"name": "ndtnet-seg.train-graph-b8", "config": "ndtnet-cls",
                               "traffic": "train-graph-b8", "chips": 1, "why": "batch 8"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_clouds_per_s":
            m["workloads"].append("ndtnet-seg.train-graph-b8")
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "train_clouds_per_s",
                               "workloads": ["ndtnet-seg.train-graph-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("ndtnet-seg.train-graph-b8", root=root)
    assert cell.traffic["batch"] == 8 and cell.driver.batch == 8
    assert cell.family.resolutions(cell.cfg) == [1000]
    assert [m["name"] for m in cell.end_to_end] == ["train_clouds_per_s", "setup_s"]
    assert "steps.train" in [m["name"] for m in cell.per_layer]
    assert cell.reader("steps.train")(type("R", (), {"window": {"steps": 3}})) == 3
    for old in CELLS:
        assert spec.Cell(old, root=root).cfg == spec.Cell(old).cfg


def test_every_metric_file_has_an_entry():
    files = {p.stem for p in (spec.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}
