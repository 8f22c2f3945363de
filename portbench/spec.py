"""Finding the parts of a cell by name.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics. Everything else is found by name under ``portbench/``:

- a configuration ``<c>``: its file of sizes (``configs/<c>.json``, the
  ``file`` of its entry) and its module ``configs/<c>.py`` (the data it is
  run on, made from the seed, the program's model of it, the objects its
  traffic names as ``{"config": key}`` (``program_objects``) and its plain
  reference's density);
- a traffic mix ``<t>`` of configuration ``<c>``: the data file
  ``traffic/<c>.<t>.json``, read by the driver it names
  (``drivers/<call>.py``), judged by the reference it names
  (``reference/<name>.py``: ``plan``, ``steps_before``, ``noise`` and
  ``replay``), counted by its bounds module (``bounds/<name>.py``, the
  reference's name unless it names ``"bounds"``), and run by the CPU tests
  at the sizes of its ``"cpu_test"``, which the timed path never reads;
- a metric ``<m>``: its reader ``metrics/<m>.py``, or, for a name
  ``<q>.<suffix>`` whose reader is shared, ``metrics/<q>.py``. An
  end-to-end metric with no ``workloads`` list is reported by every cell.

A later cell, configuration or metric is new files and new entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` (whose name may hold dots) as a module."""
    name = "portbench._by_name." + str(path.relative_to(PACKAGE_DIR)).replace("/", ".")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]  # None: every cell reports it

    def reported_by(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads

    def reader(self) -> ModuleType:
        own = PACKAGE_DIR / "metrics" / f"{self.name}.py"
        if own.is_file():
            return load_module(own)
        return load_module(PACKAGE_DIR / "metrics" / f"{self.name.split('.')[0]}.py")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]  # the configuration's file, with its entry's keys
    traffic: Dict[str, Any]  # the traffic mix's file
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def config_module(self) -> ModuleType:
        return load_module(PACKAGE_DIR / "configs" / f"{self.config['name']}.py")

    def driver(self) -> ModuleType:
        return load_module(PACKAGE_DIR / "drivers" / f"{self.traffic['call']}.py")


def read_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _metrics(entries) -> List[Metric]:
    return [Metric(m["name"], m["unit"], m.get("workloads")) for m in entries]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = read_benchmark(root)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {known})")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / entry["file"]).read_text())
    config.update(name=entry["name"], source=entry["source"], reduced=entry["reduced"])
    traffic_file = PACKAGE_DIR / "traffic" / f"{wl['config']}.{wl['traffic']}.json"
    traffic = json.loads(traffic_file.read_text())
    e2e = [m for m in _metrics(bench["end_to_end"]) if m.reported_by(name)]
    layer = [m for m in _metrics(bench["per_layer"]) if m.reported_by(name)]
    return Cell(name=name, chips=int(wl["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer)
