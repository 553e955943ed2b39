"""The port's ``factorize``, ``recommend`` and checkpoint route
(recsys_tpu_torch/engine/trainer.py, ops/topk.py, utils/checkpoint.py and
the CLI's ``--checkpoint``) against the JAX package, on the CPU.

On the CPU the dense route runs the plain twins of B2/B3; the JAX side
runs its Pallas kernels in interpret mode.
"""

import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from recsys_tpu.config import RunConfig as JaxRunConfig
from recsys_tpu.engine import trainer as jax_trainer
from recsys_tpu.ops import topk as jax_topk
from recsys_tpu.utils import checkpoint as jax_checkpoint
from recsys_tpu_torch import cli, convert
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem, save_problem
from recsys_tpu_torch.io.writers import format_recommendations
from recsys_tpu_torch.models.mf import MFState, init_factors
from recsys_tpu_torch.ops import topk
from recsys_tpu_torch.utils import checkpoint

from helpers import FIXTURES


@pytest.fixture(scope="module")
def spec():
    return generate_instance(40, 300, 10, 2, 12, iters=20, alpha=0.01, seed=21)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("a_max_bytes", [trainer.RESIDENT_A_MAX_BYTES, 0], ids=["resident", "stream"])
def test_factorize_recommend_match_jax(spec, precision, a_max_bytes):
    cfg = RunConfig(dtype="float32", path="pallas", precision=precision)
    state = trainer.factorize(spec, cfg, "cpu", a_max_bytes=a_max_bytes)
    jcfg = JaxRunConfig(dtype="float32", path="pallas", precision=precision)
    want = jax_trainer.factorize(spec, jcfg)
    assert state.L.dtype == np.float32 and state.L.shape == (spec.users, spec.features)
    # f32 sums in another order than XLA's: a few ulps.
    np.testing.assert_allclose(state.L, np.asarray(want.L), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(state.R, np.asarray(want.R), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(trainer.recommend(state, spec, cfg, "cpu"),
                                  np.asarray(jax_trainer.recommend(want, spec, jcfg)))


def test_factorize_host_route_bit_equal():
    spec = load_problem(str(FIXTURES / "inst0.in"))
    cfg = RunConfig(dtype="float64")
    got = trainer.factorize(spec, cfg, "cpu")
    want = jax_trainer.factorize(spec, JaxRunConfig(dtype="float64"))
    np.testing.assert_array_equal(got.L, np.asarray(want.L))
    np.testing.assert_array_equal(got.R, np.asarray(want.R))


@pytest.mark.parametrize("block", [128, 4096])
@pytest.mark.parametrize("dense_user", [False, True], ids=["rated-table", "mask-blocks"])
def test_recommend_matches_jax(dense_user, block):
    spec = generate_instance(30, 260, 6, 2, 20, iters=5, alpha=0.01, seed=5)
    if dense_user:  # one user rated most items: the mask-block form
        extra = np.setdiff1d(np.arange(200), spec.cols[spec.rows == 0])
        rows = np.concatenate([spec.rows, np.zeros(len(extra), np.int32)])
        cols = np.concatenate([spec.cols, extra.astype(np.int32)])
        order = np.lexsort((cols, rows))
        spec = dataclasses.replace(spec, rows=rows[order], cols=cols[order],
                                   vals=np.ones(len(rows)))
    state = init_factors(spec.users, spec.items, spec.features)
    state = MFState(L=state.L + 0.01 * np.sin(np.arange(state.L.size)).reshape(state.L.shape), R=state.R)
    got = trainer.recommend(state, spec, RunConfig(block_items=block), "cpu")
    want = np.asarray(jax_trainer.recommend(state, spec, JaxRunConfig(block_items=block)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_topk_tables_equal():
    spec = generate_instance(20, 50, 4, 1, 9, iters=1, alpha=0.01, seed=2)
    np.testing.assert_array_equal(topk.make_rated_table(spec), jax_topk.make_rated_table(spec))
    np.testing.assert_array_equal(topk.make_mask_blocks(spec, 32), jax_topk.make_mask_blocks(spec, 32))


def test_topk_tie_break_and_ragged_block():
    L = torch.ones((4, 3), dtype=torch.float64)
    R = torch.ones((10, 3), dtype=torch.float64)  # 10 rows: the last block of 4 is ragged
    rated = torch.tensor([[0, 1], [-1, -1], [5, -1], [0, 9]], dtype=torch.int32)
    got = topk.top1_rated_blocked(L, R, rated, 4, 9)
    np.testing.assert_array_equal(got.numpy(), [2, 0, 0, 1])


def _cli(path, *flags):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["run", str(path), "--device", "cpu", "--dtype", "float32", "--path", "pallas",
                       "--no-time", *flags])
    assert rc == 0
    return buf.getvalue()


@pytest.fixture()
def spec_file(spec, tmp_path):
    path = tmp_path / "spec.in"
    save_problem(spec, str(path))
    return path


def test_cli_checkpoint_resume_equals_unchunked(spec_file, tmp_path):
    spec = load_problem(str(spec_file))
    cfg = RunConfig(dtype="float32", path="pallas")
    straight = trainer.factorize(spec, cfg, "cpu")
    ck = tmp_path / "ck.npz"
    half = trainer.factorize(dataclasses.replace(spec, iters=spec.iters // 2), cfg, "cpu")
    checkpoint.save(str(ck), half, spec.iters // 2)  # a run stopped half way
    out = _cli(spec_file, "--checkpoint", str(ck), "--checkpoint-every", "3")
    resumed = checkpoint.load(str(ck))
    assert resumed.completed_iters == spec.iters
    np.testing.assert_array_equal(resumed.state.L, straight.L)  # bit for bit on the twin
    np.testing.assert_array_equal(resumed.state.R, straight.R)
    want = trainer.recommend(straight, spec, cfg, "cpu")
    assert out == format_recommendations(want, spec.rated_counts(), spec.items)


def test_jax_checkpoint_resumes_in_the_port(spec_file, tmp_path):
    spec = load_problem(str(spec_file))
    ck = tmp_path / "jax.npz"
    jcfg = JaxRunConfig(dtype="float32", path="pallas")
    part = jax_trainer.factorize(dataclasses.replace(spec, iters=7), jcfg)
    jax_checkpoint.save(str(ck), part, 7)
    Lt, Rt = convert.from_checkpoint(str(ck), spec, "cpu")
    assert torch.equal(Lt[: spec.features, : spec.users], torch.from_numpy(np.array(part.L, np.float32).T))
    state = checkpoint.run_with_checkpoints(spec, RunConfig(dtype="float32", path="pallas"), str(ck), 100, "cpu")
    want = trainer.factorize(dataclasses.replace(spec, iters=spec.iters - 7),
                             RunConfig(dtype="float32", path="pallas"), "cpu",
                             state=MFState(L=np.asarray(part.L), R=np.asarray(part.R)))
    np.testing.assert_array_equal(state.L, want.L)
    assert checkpoint.load(str(ck)).completed_iters == spec.iters
    # and the JAX package reads what the port wrote
    assert jax_checkpoint.load(str(ck)).completed_iters == spec.iters


def test_cli_block_items_feeds_recommend(spec_file, tmp_path):
    spec = load_problem(str(spec_file))
    cfg = RunConfig(dtype="float32", path="pallas", block_items=128)
    out = _cli(spec_file, "--checkpoint", str(tmp_path / "ck.npz"), "--block-items", "128")
    state = trainer.factorize(spec, cfg, "cpu")
    top1 = trainer.recommend(state, spec, cfg, "cpu")
    assert out == format_recommendations(top1, spec.rated_counts(), spec.items)


def test_checkpoint_keys_and_atomic_overwrite(tmp_path):
    st = init_factors(5, 6, 2)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, st, 1)
    checkpoint.save(path, st, 2)
    with np.load(path) as z:
        assert sorted(z.files) == ["L", "R", "completed_iters"]
    assert checkpoint.load(path).completed_iters == 2
    assert [p.name for p in tmp_path.iterdir()] == ["ck.npz"]
