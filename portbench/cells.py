"""Finds everything of a cell by name: its entry in the root
``BENCHMARK.json``, its configuration file, its traffic mix
(``traffic/<traffic>.json``), its correctness limits
(``workloads/<cell>.json``) and the readers of its metrics
(``metrics/<metric>.py``). Nothing here names a cell: a cell, a traffic mix
or a metric is added by adding files."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def steps(self) -> int:
        return int(self.config["num_inference_steps"])


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(name=name, config=load_json(ROOT / cfg["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]),
                limits=load_json(HERE / "workloads" / f"{name}.json")["limits"],
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from a
    finished run, or None where the run holds nothing to read it from."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
