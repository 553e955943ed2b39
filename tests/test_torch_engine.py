"""The port's engine (recsys_tpu_torch/engine/trainer.py, convert.py, cli.py)
against the JAX engine, the f64 oracle and the golden outputs, on the CPU.

The CPU device runs the fused route's plain twin when ``path="pallas"``
is forced, as tests/test_pallas.py:368 forces it on the JAX side.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from helpers import FIXTURES, read_golden
from recsys_tpu.config import RunConfig
from recsys_tpu.engine import trainer as jax_trainer
from recsys_tpu.engine.oracle import run_oracle
from recsys_tpu.io.generator import generate_instance
from recsys_tpu.io.parser import load_problem
from recsys_tpu.models.mf import init_factors
from recsys_tpu_torch import cli, convert
from recsys_tpu_torch.engine import trainer


@pytest.fixture(scope="module")
def spec20():
    return generate_instance(32, 40, 10, 2, 8, iters=20, alpha=0.01, seed=11)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_run_matches_jax_and_oracle(spec20, precision):
    cfg = RunConfig(dtype="float32", path="pallas", precision=precision)
    out, top1 = trainer.run(spec20, cfg, "cpu")
    want, _ = jax_trainer.run(spec20, cfg)
    assert out == want == run_oracle(spec20)
    assert top1.dtype == np.int32 and top1.shape == (spec20.users,)


def test_auto_takes_host_route_and_matches_golden():
    spec = load_problem(str(FIXTURES / "inst0.in"))
    assert trainer.choose_path(spec, RunConfig(dtype="float64"), "cpu") == "host"
    out, _ = trainer.run(spec, RunConfig(dtype="float64"), "cpu")
    assert out == read_golden("inst0")


@pytest.mark.parametrize("name,dtype", [
    ("instML100k", "float32"), ("instML100k", "float64"), ("instML100k", "bfloat16"),
    ("inst500-500-20-2-100", "float32"), ("inst600-10000-10-40-400", "float32"),
    ("inst0", "float64"),
])
def test_choose_path_matches_jax(name, dtype):
    """Same decision as the JAX engine on a CPU backend; on a CUDA device
    the fused route replaces the JAX engine's TPU-only pallas pick."""
    spec = load_problem(str(FIXTURES / f"{name}.in"))
    cfg = RunConfig(dtype=dtype)
    assert trainer.choose_path(spec, cfg, "cpu") == jax_trainer.choose_path(spec, cfg)
    if name == "instML100k" and dtype != "float64":
        assert trainer.choose_path(spec, cfg, "cuda") == "pallas"


def test_dense_plan_instml100k():
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    plan = trainer.dense_plan(spec)
    assert (plan.kind, plan.a_dtype, plan.U, plan.I, plan.K) == ("resident", torch.int8, 1024, 1792, 32)
    assert plan.device_bytes <= trainer.DEVICE_BUDGET_BYTES


def test_unported_routes_raise_and_never_fall_back(spec20):
    # Exact f64 on a sparse, non-toy shape routes to BELL; COO (ported)
    # runs what it is asked in both dtypes, as the JAX engine's coo route
    # does; so does a mesh (the sharded engine), as the JAX one does.
    spec = generate_instance(200, 2000, 10, 2, 5, iters=100_000, alpha=1e-4, seed=1)
    cfg = RunConfig(dtype="float64")
    assert trainer.choose_path(spec, cfg, "cpu") == "bell"
    for dtype in ("float64", "float32"):
        out, _ = trainer.run(spec20, RunConfig(dtype=dtype, path="coo"), "cpu")
        assert out == jax_trainer.run(spec20, RunConfig(dtype=dtype, path="coo"))[0]
    from recsys_tpu.parallel import engine as jax_parallel

    mesh_cfg = RunConfig(dtype="float32", path="pallas", mesh_shape=(2, 4))
    assert trainer.run(spec20, mesh_cfg, "cpu")[0] == jax_parallel.run(spec20, mesh_cfg)[0]
    ml = load_problem(str(FIXTURES / "instML100k.in"))
    with pytest.raises(ValueError, match="float32"):
        trainer.run(ml, RunConfig(dtype="float64", path="pallas"), "cpu")


def test_convert_round_trips(spec20):
    state = init_factors(spec20.users, spec20.items, spec20.features)
    Lt, Rt = convert.from_state(state, spec20, "cpu")
    assert tuple(Lt.shape) == (16, 128) and Lt.dtype == torch.float32
    back = convert.to_state(Lt, Rt, spec20)
    np.testing.assert_array_equal(back.L, state.L.astype(np.float32))
    np.testing.assert_array_equal(back.R, state.R.astype(np.float32))
    from recsys_tpu.ops.pallas_dense import pad_factors_for_pallas

    Ltj, Rtj, _ = pad_factors_for_pallas(spec20, strip=128, state=state)
    Lt2, Rt2 = convert.from_jax_kmajor(Ltj, Rtj, "cpu")
    assert torch.equal(Lt2, Lt) and torch.equal(Rt2, Rt)


def test_cli_run_matches_oracle(spec20, tmp_path):
    from recsys_tpu.io.parser import save_problem

    path = tmp_path / "spec20.in"
    save_problem(spec20, str(path))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["run", str(path), "--device", "cpu", "--dtype", "float32",
                       "--path", "pallas", "--precision", "bf16x3"])
    lines = buf.getvalue().splitlines(keepends=True)
    assert rc == 0 and lines[-1].startswith("time : ")
    assert "".join(lines[:-1]) == run_oracle(load_problem(str(path)))


@pytest.mark.parametrize("flag", [["--path", "coo"], ["--mesh", "2x2"]])
def test_cli_refuses_what_is_not_ported(flag):
    # A flag the port cannot honour raises; it is never accepted and
    # ignored.  --path coo and --mesh are ported: each runs and prints the
    # golden.
    argv = ["run", str(FIXTURES / "inst0.in"), "--device", "cpu", "--no-time", *flag]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(argv) == 0
    assert buf.getvalue() == read_golden("inst0")


@pytest.mark.parametrize("entry", ["factorize", "recommend"])
def test_factorize_and_recommend_refuse_cuda_without_a_card(spec20, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cfg = RunConfig(dtype="float32", path="pallas")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "factorize":
            trainer.factorize(spec20, cfg, "cuda")
        else:
            trainer.recommend(init_factors(spec20.users, spec20.items, spec20.features), spec20, cfg, "cuda")


def test_factorize_refuses_unported_routes():
    # COO is ported: factorize takes it and gives the oracle's factors.
    from recsys_tpu_torch.engine.oracle import factorize_numpy

    small = generate_instance(30, 50, 6, 2, 8, iters=25, alpha=0.01, seed=1)
    got = trainer.factorize(small, RunConfig(dtype="float64", path="coo"), "cpu")
    want, _ = factorize_numpy(small)
    np.testing.assert_allclose(got.L, want.L, rtol=1e-12)
    np.testing.assert_allclose(got.R, want.R, rtol=1e-12)
    # The mesh is ported too: the sharded engine gives the same factors.
    got = trainer.factorize(small, RunConfig(dtype="float64", path="coo", mesh_shape=(2, 2)), "cpu")
    np.testing.assert_allclose(got.L, want.L, rtol=1e-12)
    np.testing.assert_allclose(got.R, want.R, rtol=1e-12)
