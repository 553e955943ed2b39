"""A throwaway benchmark root for the CPU tests: the real ``perfbench``
files plus a small configuration (``tiny``, ML-1M's recipe at 60 x 90) and
two mixes that force the dense route (``cpu32``) and BELL (``cpu64``), so
that a cell runs on the CPU through the program's plain twins.  Each tiny
cell reports the metrics of the cell on its route (``ml100k.f32``,
``ml100k.f64``)."""

from __future__ import annotations

import json
import os
import shutil

from perfbench import registry

REPO = registry.ROOT
FIXTURE = "tests/fixtures/instML100k.in"


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_root(tmp: str, iters: int = 200, features: int = 8) -> str:
    """A benchmark root under ``tmp`` whose BENCHMARK.json adds the cells
    ``tiny.cpu32`` and ``tiny.cpu64``; returns its path."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.makedirs(os.path.join(root, "tests", "fixtures"))
    shutil.copy(os.path.join(REPO, FIXTURE), os.path.join(root, FIXTURE))
    pb = os.path.join(root, "perfbench")
    cfg = registry.load_json(os.path.join(pb, "configs", "ml1m.json"))
    cfg.update(name="tiny", users=60, items=90, ratings=1500, features=features, iters=iters)
    cfg["data"].update(rated_items=80, min_user_ratings=10)
    _dump(os.path.join(pb, "configs", "tiny.json"), cfg)
    for mix, src, path in (("cpu32", "f32", "pallas"), ("cpu64", "f64", "bell")):
        tr = registry.load_json(os.path.join(pb, "traffic", f"{src}.json"))
        tr["path"] = path
        _dump(os.path.join(pb, "traffic", f"{mix}.json"), tr)
        shutil.copy(os.path.join(pb, "limits", f"ml100k.{src}.json"), os.path.join(pb, "limits", f"tiny.{mix}.json"))
    bench = registry.benchmark(REPO)
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "file": "perfbench/configs/tiny.json",
                             "reduced": ["users", "items", "ratings", "features", "iters"], "why": "a CPU test"})
    for mix, like in (("cpu32", "ml100k.f32"), ("cpu64", "ml100k.f64")):
        bench["workloads"].append({"name": f"tiny.{mix}", "config": "tiny", "traffic": mix, "chips": 1,
                                   "why": "a CPU test"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(f"tiny.{mix}")
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root
