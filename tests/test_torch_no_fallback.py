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
import recsys_tpu_torch.parallel.engine, recsys_tpu_torch.parallel.mesh, recsys_tpu_torch.parallel.sharding
import recsys_tpu_torch.parallel.step, recsys_tpu_torch.parallel.multihost, recsys_tpu_torch.parallel.launch
import recsys_tpu_torch.bench.roofline, recsys_tpu_torch.bench.sweep, recsys_tpu_torch.bench.bf16_policy
import recsys_tpu_torch.bench.scaling
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
out, _ = trainer.run(load_problem(sys.argv[1]), RunConfig(dtype="float64", mesh_shape=(2, 4)), "cpu")
assert out == open(sys.argv[2]).read()
recsys_tpu_torch.parallel.engine.dryrun(4, device="cpu")
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
from recsys_tpu_torch.parallel import multihost
multihost.initialize()
out, _ = multihost.run(load_problem(sys.argv[1]), RunConfig(dtype="float64", mesh_shape=(1, 2)), "cpu")
assert out == open(sys.argv[2]).read()
with tempfile.TemporaryDirectory() as tmp:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        recsys_tpu_torch.cli.main(["oracle", sys.argv[1], "--no-time"])
        recsys_tpu_torch.cli.main(["generate", "inst6-7-2-1-3", os.path.join(tmp, "g.in"), "--iters", "3"])
        recsys_tpu_torch.cli.main(["bench", os.path.join(tmp, "g.in"), "--device", "cpu", "--repeats", "1"])
    assert buf.getvalue().startswith(open(sys.argv[2]).read()) and '"wall_s"' in buf.getvalue()
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    recsys_tpu_torch.bench.sweep.main(["--device", "cpu", "--instances", "inst0", "--dtype", "float64", "--repeats", "1"])
assert '"golden_exact": true' in buf.getvalue()
recsys_tpu_torch.bench.scaling.measure_mesh(spec, RunConfig(dtype="float32"), [(1, 2)], "cpu", repeats=1)
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


def test_mesh_on_cuda_without_a_card_raises():
    """A mesh asked for on "cuda" raises without a card: its shards are not
    put on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from recsys_tpu_torch.parallel import engine as par

    spec = load_problem(str(FIXTURES / "inst0.in"))
    for entry in (lambda: trainer.run(spec, RunConfig(dtype="float32", mesh_shape=(2, 2)), "cuda"),
                  lambda: trainer.factorize(spec, RunConfig(dtype="float64", mesh_shape=(1, 2)), "cuda"),
                  lambda: par.factorize_sharded(spec, RunConfig(dtype="float32", mesh_shape=(2, 2)))):
        with pytest.raises(RuntimeError, match="cuda"):
            entry()


def test_nccl_without_cuda_raises_and_never_switches_to_gloo():
    """``initialize`` with ``backend="nccl"`` on a CPU device, or NCCL (the
    CUDA default) where CUDA is absent, raises and joins no group: no
    backend switch, no rank moved to the CPU."""
    import torch.distributed as dist

    from recsys_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match="nccl"):
        multihost.initialize("127.0.0.1:1", 1, 0, "nccl", device="cpu")
    assert not dist.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for backend in ("nccl", None):
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.initialize("127.0.0.1:1", 1, 0, backend, device="cuda")
        assert not dist.is_initialized()


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
