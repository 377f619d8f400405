"""The benchmark as data: a cell, its configuration, its traffic and its
metrics are found by the names that ``BENCHMARK.json`` gives them.

- ``benchmark/workloads/<cell>.json``: the cell's driver
  (``benchmark/drivers/<driver>.py``), its options and its limits;
- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters;
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric.

Adding a cell, a configuration, a traffic mix or a metric is adding its
file and its entry; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict            # the cell's entry of BENCHMARK.json
    workload: Dict         # workloads/<cell>.json
    config: Dict           # configs/<config>.json
    traffic: Dict          # traffic/<traffic>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    data = root / "benchmark"
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name, entry=entry,
                workload=_json(data / "workloads" / f"{name}.json"),
                config=_json(root / configs[entry["config"]]["file"]),
                traffic=_json(data / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=e2e, per_layer=layer, root=root)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    """The module of the cell's driver."""
    d = cell.workload["driver"]
    return load_module(cell.root / "benchmark" / "drivers" / f"{d}.py",
                       f"benchmark_driver_{d}")


def reader(cell: Cell, metric: str):
    """The module that reads per-layer metric ``metric``."""
    return load_module(cell.root / "benchmark" / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_"))
