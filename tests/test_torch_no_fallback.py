"""The port stands alone and never swaps a device: it runs with neither
jax nor the JAX package ever imported, a CUDA request without a card
raises, and ``chip_smoke.py`` fails fast where there is no card or no
checkout around it."""

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
import contextlib, io, os, sys, tempfile
import chip_smoke
import recsys_tpu_torch, recsys_tpu_torch.cli, recsys_tpu_torch.convert, recsys_tpu_torch.probes.mosaic_gather
import recsys_tpu_torch.probes.gather, recsys_tpu_torch.probes.stream_v2
import recsys_tpu_torch.probes.tiled_fused, recsys_tpu_torch.probes.tiled_clocks
from recsys_tpu_torch.ops import coo, device_rng, lane, stream_v2
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem, save_problem
from recsys_tpu_torch.utils import checkpoint
spec = generate_instance(32, 40, 10, 2, 8, iters=20, alpha=0.01, seed=11)
out, _ = trainer.run(spec, RunConfig(dtype="float32", path="pallas"), "cpu")
assert out.count("\n") == 32
out2, _ = trainer.run(spec, RunConfig(dtype="float32", path="pallas"), "cpu", a_max_bytes=0)
assert out2 == out
state = trainer.factorize(spec, RunConfig(dtype="float32", path="pallas"), "cpu")
trainer.recommend(state, spec, RunConfig(), "cpu")
out, _ = trainer.run(load_problem(sys.argv[1]), RunConfig(dtype="float64"), "cpu")
assert out == open(sys.argv[2]).read()
out, _ = trainer.run(load_problem(sys.argv[1]), RunConfig(dtype="float64", path="bell"), "cpu")
assert out == open(sys.argv[2]).read()
out, _ = trainer.run(load_problem(sys.argv[1]), RunConfig(dtype="float64", path="coo"), "cpu")
assert out == open(sys.argv[2]).read()
device_rng.device_init_factors(5, 4, 3)
lane.lane_cumsum_loop(lane.lane_gather_loop(*recsys_tpu_torch.probes.gather.gather_inputs(2, 64, "cpu", __import__("numpy").random.default_rng(0)), 2), 2)
lane.lane_cumsum_loop_block(lane.lane_gather_loop_direct(*recsys_tpu_torch.probes.gather.gather_inputs(2, 64, "cpu", __import__("numpy").random.default_rng(0)), 2), 2)
with tempfile.TemporaryDirectory() as tmp:
    save_problem(spec, os.path.join(tmp, "s.in"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recsys_tpu_torch.cli.main(["run", os.path.join(tmp, "s.in"), "--device", "cpu", "--dtype", "float32",
                                   "--path", "pallas", "--checkpoint", os.path.join(tmp, "ck.npz"),
                                   "--checkpoint-every", "7"])
    assert checkpoint.load(os.path.join(tmp, "ck.npz")).completed_iters == 20
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "recsys_tpu" or m.startswith("recsys_tpu."))
assert not leaked, leaked
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
