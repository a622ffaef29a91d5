"""Finds what a cell needs by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``, which names the plain
reference's towers, ``reference/image/<name>.py`` and
``reference/text/<name>.py``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the driver,
``drivers/<kind>.py``), the limits of its correctness comparison
(``limits/<cell>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``, whose ``read(run)`` returns a number or
``None``).  A new cell, architecture, kind of traffic or metric is a new
file; nothing here changes."""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


def deep_merge(base: dict, extra: dict) -> dict:
    """``base`` with ``extra``'s leaves written over it (a copy)."""
    out = copy.deepcopy(base)
    for key, value in extra.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


class Registry:
    def __init__(self, bench_dir: Path = BENCH_DIR,
                 benchmark_json: Optional[Path] = None):
        self.dir = Path(bench_dir)
        path = benchmark_json or (REPO_ROOT / "BENCHMARK.json")
        with open(path) as f:
            self.benchmark = json.load(f)
        self._drivers: dict = {}

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        with open(path) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for entry in self.benchmark["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def metrics(self, section: str, cell: str) -> list:
        """The entries of ``section`` (``end_to_end`` or ``per_layer``)
        that ``cell`` reports: those with no ``workloads`` list, or whose
        list names it."""
        return [m for m in self.benchmark[section]
                if cell in m.get("workloads", [cell])]

    def _module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` loaded from its file (its imports are
        absolute: ``benchmark.harness...``)."""
        path = self.dir / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str) -> Callable:
        return self._module("metrics", metric).read

    def driver(self, kind: str) -> ModuleType:
        """The driver of a traffic mix's ``kind``: ``execute(run)`` runs
        one run's set-up, window, trace and comparison and returns its
        end-to-end readings; ``readings(run, seed, control, faults,
        emit)`` takes the correctness readings of one seed
        (``tools/readings.py``); ``FAULTS`` names the faults planted under
        its timed path, each a ``hooks`` dict for ``runner.Run``.  A
        driver may launch processes of its own (a cell on several cards
        runs a rank on each) and stops and waits for each."""
        if kind not in self._drivers:
            self._drivers[kind] = self._module("drivers", kind)
        return self._drivers[kind]


def reference_cfg(config: dict) -> dict:
    """The configuration as the plain reference reads it: the program's
    settings with the published widths beside them, and the names of the
    reference's towers under ``TOWERS``."""
    cfg = deep_merge(config["cfg"], config.get("widths", {}))
    cfg["TOWERS"] = dict(config["towers"])
    return cfg
