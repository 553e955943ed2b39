"""Finds a cell's files by the names in ``BENCHMARK.json``.

* configuration ``<config>``: ``perfbench/configs/<config>.json`` (the
  entry's ``file``);
* traffic mix ``<traffic>``: ``perfbench/traffic/<traffic>.json``;
* limits of the cell ``<workload>``: ``perfbench/limits/<workload>.json``;
* data recipe ``<recipe>`` (a configuration's ``data.recipe``):
  ``perfbench/recipes/<recipe>.py``, whose ``make(cfg, seed, root, device)``
  returns the instance;
* metric ``<name>``, end-to-end or per-layer: ``perfbench/metrics/<name>.py``,
  whose ``read(readings)`` returns the value or None.

A new configuration, recipe, mix, cell or metric is new files and new
entries in ``BENCHMARK.json``; nothing here names one.  A mix holds only
the keys the harness reads (``MIX_KEYS``): a knob it would ignore is
refused.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX_KEYS = {"dtype", "precision", "path", "why", "controls"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic", f"{entry['traffic']}.json"))
    if set(traffic) - MIX_KEYS:
        raise ValueError(f"traffic {entry['traffic']!r}: keys {sorted(set(traffic) - MIX_KEYS)} are read by nothing")
    return Cell(name=name, chips=entry["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _module(folder: str, name: str, root: str):
    """``perfbench/<folder>/<name>.py`` under ``root``, loaded from its path."""
    path = os.path.join(root, "perfbench", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    return _module("metrics", name, root).read


def recipe(name: str, root: str = ROOT):
    """The ``make`` function of ``perfbench/recipes/<name>.py``."""
    return _module("recipes", name, root).make


def read_metrics(metrics: list, readings: dict, root: str = ROOT) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds a value."""
    out = {}
    for m in metrics:
        v = reader(m["name"], root)(readings)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
