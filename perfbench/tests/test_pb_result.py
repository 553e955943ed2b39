"""A whole run of a cell on the CPU (the program's plain twins): the last
line's schema, traced and untraced; and the refusals of ``main``."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import registry, run
from perfbench.tests.pb_helpers import REPO, tiny_root


# The per-layer metrics that a run on the CPU cannot read, and why.
CARD_ONLY = {"device_idle_pct": "no device in the profiler's trace",
             "walk_s": "the dense routes build their walk tables on the card only",
             "bell_waves": "counted at the BELL step's launch on the card"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("pb")))


@pytest.mark.parametrize("workload", ["tiny.cpu32", "tiny.cpu64"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(root, workload, trace):
    cell = registry.cell(workload, root)
    r = run.run_cell(cell, 2**31 + 11, 0.5, trace, device="cpu", root=root, t0=time.perf_counter())
    json.loads(json.dumps(r))
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"factor_gap", "top1_gap", "failed_jobs"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(r["metrics"])
    if trace:
        assert want - got == set(CARD_ONLY) & want
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"} and r["breakdown"]["idle_gaps"]
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert got == want and r["metrics"]["setup_s"]["value"] > 0
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "ml100k.f32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(os.path.join(REPO, "perfbench"), tmp_path / "perfbench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "ml100k.f32", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""
