"""Everything a cell needs, found by name: ``BENCHMARK.json`` at the root
of the checkout, the cell's file ``benchmark/workloads/<cell>.json``, its
configuration ``benchmark/configs/<config>.json``, its driver
``benchmark/drivers/<driver>.py`` and each per-layer metric's reader
``benchmark/metrics/<metric>.py``. Adding a cell, a configuration or a
metric adds files and entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: Dict  # the cell's entry in BENCHMARK.json
    spec: Dict  # benchmark/workloads/<cell>.json
    cfg: Dict  # benchmark/configs/<config>.json
    end_to_end: List[Dict]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict]  # ... and with --trace 1

    @property
    def params(self) -> Dict:
        return self.spec["params"]

    def driver(self):
        return _module(os.path.join(BENCH_DIR, "drivers", f"{self.spec['driver']}.py"),
                       f"bench_driver_{self.spec['driver']}")

    def metric_reader(self, name: str):
        return _module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                       "bench_metric_" + name.replace(".", "_"))


def reports(metric: Dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``,
    or (without that key) wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None:
        return True
    return metric.get("moves") in e2e_names


def load_cell(name: str, bench_path: str = None) -> Cell:
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))
    if spec["config"] != entry["config"] or spec["traffic"] != entry["traffic"]:
        raise ValueError(f"{name}: the cell file's config/traffic differ from BENCHMARK.json")
    if spec["chips"] != entry["chips"]:
        raise ValueError(f"{name}: the cell file's chips differ from BENCHMARK.json")
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise KeyError(f"no configuration {entry['config']!r} in BENCHMARK.json")
    cfg = load_json(os.path.join(ROOT, configs[0]["file"]))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name, entry, spec, cfg, e2e, per_layer)
