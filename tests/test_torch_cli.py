"""The port's CLI subcommands ``oracle``, ``bench`` and ``generate``
(``recsys_tpu_torch/cli.py``) against the JAX package's CLI, which runs in
a subprocess with ``JAX_PLATFORMS=cpu``.  Files go to ``tmp_path``, never
to ``tests/fixtures/``."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from helpers import FIXTURES, read_golden
from recsys_tpu_torch import cli
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.parallel import engine as par
from recsys_tpu_torch.parallel.mesh import make_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_cli(*argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "recsys_tpu.cli", *map(str, argv)], capture_output=True, text=True,
                       timeout=240, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.mark.parametrize("inst", ["inst0", "inst30-40-10-2-10"])
def test_oracle_prints_the_jax_oracle(inst, capsys):
    assert cli.main(["oracle", str(FIXTURES / f"{inst}.in"), "--no-time"]) == 0
    out = capsys.readouterr().out
    assert out == _jax_cli("oracle", FIXTURES / f"{inst}.in", "--no-time").stdout
    assert out == read_golden(inst)


def test_oracle_time_line(capsys):
    assert cli.main(["oracle", str(FIXTURES / "inst0.in")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:-1] == read_golden("inst0").splitlines() and lines[-1].startswith("time : ")


def test_oracle_dump_mats_equals_the_jax_dump(tmp_path):
    mine, theirs = tmp_path / "port.mats", tmp_path / "jax.mats"
    assert cli.main(["oracle", str(FIXTURES / "inst0.in"), "--dump-mats", str(mine), "--record", "3"]) == 0
    _jax_cli("oracle", FIXTURES / "inst0.in", "--dump-mats", theirs, "--record", "3")
    assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("name,seed", [("inst20-30-4-1-5", 42), ("inst50-40-6-2-9", 7)])
def test_generate_equals_the_jax_generate(tmp_path, name, seed, capsys):
    mine, theirs = tmp_path / "port.in", tmp_path / "jax.in"
    argv = ["--iters", "7", "--alpha", "0.002", "--seed", str(seed)]
    assert cli.main(["generate", name, str(mine), *argv]) == 0
    jax = _jax_cli("generate", name, theirs, *argv)
    assert mine.read_bytes() == theirs.read_bytes()
    assert capsys.readouterr().err.replace(str(mine), "F") == jax.stderr.replace(str(theirs), "F")


@pytest.mark.parametrize("argv", [[], ["--dtype", "float32", "--path", "pallas"], ["--mesh", "1x2"]],
                         ids=["auto", "pallas", "mesh"])
def test_bench_prints_the_jax_keys(argv, capsys):
    path = FIXTURES / "inst0.in"
    assert cli.main(["bench", str(path), "--device", "cpu", "--repeats", "2", *argv]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(row) == {"instance", "wall_s", "updates_per_s", "dtype", "path", "repeats"}
    spec = load_problem(path)
    dtype = argv[argv.index("--dtype") + 1] if "--dtype" in argv else "float64"
    cfg = RunConfig(dtype=dtype, path=argv[argv.index("--path") + 1] if "--path" in argv else "auto")
    if "--mesh" in argv:
        want = par.sharded_route(spec, cfg, make_mesh(0, 0, (1, 2), device="cpu"))
    else:
        want = trainer.choose_path(spec, cfg, "cpu")
    assert row["path"] == want
    assert (row["instance"], row["dtype"], row["repeats"]) == ("inst0.in", dtype, 2)
    assert row["wall_s"] > 0 and row["updates_per_s"] == pytest.approx(spec.iters * spec.nnz / row["wall_s"])


def test_bench_refuses_bf16_under_strict(capsys):
    """On a shape the card's rows put below the bf16 floor (inst500-500:
    0.734, ``bench/bf16_policy.MEASURED``), ``bench --strict`` refuses."""
    rc = cli.main(["bench", str(FIXTURES / "inst500-500-20-2-100.in"), "--device", "cpu", "--dtype", "bfloat16",
                   "--strict"])
    captured = capsys.readouterr()
    assert rc == 2 and captured.out == ""
    assert "73.40% argmax agreement" in captured.err
    assert "refusing bfloat16 under --strict" in captured.err


def test_no_host_path_and_no_multihost_subcommand(capsys):
    """``--path host`` is refused as in the JAX CLI, and no subcommand
    reaches the multi-process layer (the library entry
    ``parallel.multihost.run`` does)."""
    with pytest.raises(SystemExit):
        cli.main(["run", str(FIXTURES / "inst0.in"), "--path", "host"])
    with pytest.raises(SystemExit):
        cli.main(["multihost", str(FIXTURES / "inst0.in")])
    capsys.readouterr()
