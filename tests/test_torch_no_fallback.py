"""The port stands alone and never swaps a device: it runs with jax never
imported, a CUDA request without a card raises, and ``chip_smoke.py``
fails fast where there is no card or no checkout around it."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from helpers import FIXTURES
from recsys_tpu.config import RunConfig
from recsys_tpu.io.parser import load_problem
from recsys_tpu_torch.engine import trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX = r"""
import sys
import recsys_tpu_torch, recsys_tpu_torch.cli, recsys_tpu_torch.convert
from recsys_tpu_torch.engine import trainer
from recsys_tpu.config import RunConfig
from recsys_tpu.io.generator import generate_instance
from recsys_tpu.io.parser import load_problem
spec = generate_instance(32, 40, 10, 2, 8, iters=20, alpha=0.01, seed=11)
out, _ = trainer.run(spec, RunConfig(dtype="float32", path="pallas"), "cpu")
assert out.count("\n") == 32
out, _ = trainer.run(load_problem(sys.argv[1]), RunConfig(dtype="float64"), "cpu")
assert out == open(sys.argv[2]).read()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("no-jax ok")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_runs_without_importing_jax():
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(FIXTURES / "inst0.in"), str(FIXTURES / "inst0.out")],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=str(ROOT),
    )
    assert r.returncode == 0, r.stderr
    assert "no-jax ok" in r.stdout


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    spec = load_problem(str(FIXTURES / "inst0.in"))
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.run(spec, RunConfig(dtype="float32", path="pallas"), "cuda")


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_fast_without_a_card(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       timeout=60, cwd=str(cwd), env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
