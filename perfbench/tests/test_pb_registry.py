"""BENCHMARK.json against the contract's shape, and cells, mixes, limits
and metrics found by name: a throwaway set of files becomes a cell."""

import json
import os
import re
import shutil
import time

import pytest

from perfbench import registry, run
from perfbench.tests.pb_helpers import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark(REPO)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_unit_and_entry(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(REPO, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(REPO, "perfbench", "limits", f"{w['name']}.json"))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(registry.reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert cell.traffic["dtype"] in ("float32", "float64")


def test_a_throwaway_config_mix_metric_and_limits_become_a_cell(tmp_path):
    root = tiny_root(str(tmp_path))
    with open(os.path.join(root, "perfbench", "metrics", "jobs_done.py"), "w") as f:
        f.write("def read(readings):\n    return float(len(readings['jobs']))\n")
    bench = registry.benchmark(root)
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher", "source": "program_counter",
                               "layer": "cli and io", "moves": "solve_s", "workloads": ["tiny.cpu32"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = registry.cell("tiny.cpu32", root)
    assert cell.config["users"] == 60 and cell.traffic["path"] == "pallas"
    assert "jobs_done" in {m["name"] for m in cell.per_layer}
    inst = {"users": 60, "items": 90, "features": 8, "iters": 200, "nnz": 1500, "rated_users": 60,
            "rated_items": 80}
    jobs = [{"ok": True, "wall": 1.0, "phases": {"prep": 0.1, "upload": 0.1, "train": 0.5, "top1": 0.1}}] * 3
    got = registry.read_metrics(cell.per_layer, {"jobs": jobs, "window_s": 3.0, "trace": None, "instance": inst,
                                                 "dtype": "float32"}, root)
    assert got["jobs_done"] == {"value": 3.0, "unit": "jobs"}
    assert got["train_s"]["value"] == 0.5 and abs(got["cli_s"]["value"] - 0.2) < 1e-12
    assert "device_idle_pct" not in got  # a reader that finds nothing returns nothing


GRID = """
import numpy as np

from perfbench.datagen import Instance, rng_for, sorted_row_major


def make(cfg, seed, root, device="cpu"):
    rng = rng_for(seed)
    users, items = cfg["users"], cfg["items"]
    cells = rng.choice(users * items, size=cfg["ratings"], replace=False)
    rows, cols, vals = sorted_row_major(items, cells // items, cells % items,
                                        rng.integers(1, 6, size=cells.size).astype(np.float64))
    return Instance(cfg["iters"], cfg["alpha"], cfg["features"], users, items, rows, cols, vals)
"""


def test_a_throwaway_recipe_becomes_a_working_cell(tmp_path):
    root = tiny_root(str(tmp_path))
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "recipes", "grid.py"), "w") as f:
        f.write(GRID)
    cfg = {"name": "grid", "users": 40, "items": 50, "ratings": 600, "features": 8, "iters": 200, "alpha": 1e-3,
           "data": {"recipe": "grid"}, "reduced": [], "assumed": []}
    with open(os.path.join(pb, "configs", "grid.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(pb, "limits", "ml100k.f32.json"), os.path.join(pb, "limits", "grid.cpu32.json"))
    bench = registry.benchmark(root)
    bench["configs"].append({"name": "grid", "source": "https://example.org/grid", "file": "perfbench/configs/grid.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": "grid.cpu32", "config": "grid", "traffic": "cpu32", "chips": 1,
                               "why": "a CPU test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = run.run_cell(registry.cell("grid.cpu32", root), 2**33 + 1, 0.2, False, device="cpu", root=root,
                     t0=time.perf_counter())
    assert r["correct"] is True and r["attempted"] >= 1, r["checks"]
    assert r["metrics"]["solve_s"]["value"] > 0


def test_a_mix_knob_the_harness_ignores_is_refused(tmp_path):
    root = tiny_root(str(tmp_path))
    path = os.path.join(root, "perfbench", "traffic", "cpu32.json")
    mix = registry.load_json(path)
    mix["clients"] = 2
    with open(path, "w") as f:
        json.dump(mix, f)
    with pytest.raises(ValueError, match="clients"):
        registry.cell("tiny.cpu32", root)


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        registry.cell("no.such.cell")
