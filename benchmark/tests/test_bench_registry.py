"""``BENCHMARK.json`` against the benchmark's contract, and the registry
finding each cell's configuration, traffic mix, limits and metric
readers by the names in it."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness.registry import REPO_ROOT, Registry, reference_cfg
from benchmark.reference import model as reference

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO_ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO_ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert m["source"] in SOURCES
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    registry = Registry()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in BENCH["workloads"]:
        reported = {m["name"] for m in registry.metrics("end_to_end",
                                                        w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = registry.metrics("per_layer", w["name"])
        assert layers and all(m["moves"] in reported for m in layers)


def test_the_registry_finds_each_cells_files_by_name():
    registry = Registry()
    for w in BENCH["workloads"]:
        config = registry.config(w["config"])
        assert config["name"] == w["config"]
        driver = registry.driver(registry.traffic(w["traffic"])["kind"])
        assert callable(driver.execute) and callable(driver.readings)
        assert driver.FAULTS
        assert registry.limits(w["name"])["limits"]
        cfg = reference_cfg(config)
        leaves = set(reference.trainable(cfg))
        for names in registry.limits(w["name"]).get("left_out", {}).values():
            assert set(names) <= leaves
        for part in ("image", "text"):
            tower = reference.tower(part, cfg)
            assert Path(tower.__file__).stem == config["towers"][part]
    for m in BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_a_missing_name_is_not_found():
    registry = Registry()
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        registry.traffic("no_such_mix")
    with pytest.raises(FileNotFoundError):
        registry.reader("no.such.metric")
    with pytest.raises(FileNotFoundError):
        registry.driver("no_such_kind")
    with pytest.raises(ModuleNotFoundError):
        reference.tower("image", {"TOWERS": {"image": "no_such_tower"}})


def test_a_new_metric_is_a_new_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x.y_ms.py").write_text(
        "def read(run):\n    return 1.5\n")
    registry = Registry(tmp_path, REPO_ROOT / "BENCHMARK.json")
    assert registry.reader("x.y_ms")(None) == 1.5


def test_configuration_files_state_source_and_cuts():
    for c in BENCH["configs"]:
        body = json.loads((REPO_ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] == []
        assert body["assumed"]
        assert c["file"].startswith("benchmark/")
