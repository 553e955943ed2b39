"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or
``recsys_tpu`` (the JAX package), compared by whole top-level names, so
``recsys_tpu_torch`` passes; and the harness's own check catches one."""

import json
import os
import subprocess
import sys

from perfbench import run
from perfbench.tests.pb_helpers import REPO, tiny_root

SCRIPT = """
import json, sys, time
from perfbench import registry, run
cell = registry.cell("tiny.cpu32", sys.argv[1])
r = run.run_cell(cell, 3, 0.3, True, device="cpu", root=sys.argv[1], t0=time.perf_counter())
import perfbench.control, perfbench.reference, perfbench.judge, perfbench.datagen
print(json.dumps({"correct": r["correct"], "forbidden": run.forbidden_modules(),
                  "tops": sorted({n.split(".")[0] for n in sys.modules})}))
"""


def test_a_whole_run_loads_no_jax(tmp_path):
    root = tiny_root(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    p = subprocess.run([sys.executable, "-c", SCRIPT, root], cwd=REPO, capture_output=True, text=True,
                       timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["forbidden"] == []
    assert "recsys_tpu_torch" in got["tops"] and not {"jax", "jaxlib", "flax", "recsys_tpu"} & set(got["tops"])


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "recsys_tpu_torch_like", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "recsys_tpu", raising=False)
    assert "recsys_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "recsys_tpu.engine", sys)
    assert "recsys_tpu" in run.forbidden_modules()


def test_a_tap_keeps_the_counters_the_program_keeps_on_its_function():
    import types

    from perfbench.taps import Sink, wrap

    mod = types.ModuleType("fake_ops")
    exec("def train(x):\n    train.launches += 1\n    return x, x\ntrain.launches = 0\n", mod.__dict__)
    sink = Sink()
    undo = wrap(mod, "train", sink, "rows", lambda out: out)
    sink.begin(True)
    assert mod.train(5) == (5, 5) and mod.train.launches == 1
    sink.end()
    undo()
    assert mod.train.launches == 1 and sink.captures() == [("rows", 5, 5)]
