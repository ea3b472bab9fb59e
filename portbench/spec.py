"""Find a cell's data by name: its entry in ``BENCHMARK.json``, its
configuration, its traffic mix, its limits and its per-layer metrics'
readers. Nothing here knows any cell: adding one adds files and entries."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None  # end-to-end only, None: every cell


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<mix>.json
    limits: dict           # limits/<cell>.json
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(entry: dict) -> Metric:
    return Metric(name=entry["name"], unit=entry["unit"], moves=entry.get("moves"),
                  workloads=entry.get("workloads"))


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with everything its
    entry names; KeyError for a cell the file does not hold, or a per-layer
    metric without its ``workloads``."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = _load_json(os.path.join(root, config_entry["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json"))
    limits = _load_json(os.path.join(HERE, "limits", name + ".json"))
    e2e = [_metric(m) for m in bench["end_to_end"]
           if m.get("workloads") is None or name in m["workloads"]]
    per_layer = [_metric(m) for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def reader(metric: str) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric>.py``: the metric's
    value from what the traced run collected, or None where it found
    nothing to read."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[Metric], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader found a value."""
    out = {}
    for m in metrics:
        value = reader(m.name)(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
