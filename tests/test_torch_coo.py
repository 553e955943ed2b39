"""The port's COO route (recsys_tpu_torch/ops/coo.py and the engine's ``coo``
route) against the JAX package's ``recsys_tpu.ops.coo``, the numpy oracle
and the golden outputs, on the CPU.

Tolerances: one step in f64 within rtol 1e-12 of JAX's (the JAX suite's
own limit, tests/test_jax_engine.py:29); in f32 within 1e-6 of the step's
largest factor (the two sum the k-term dot and the segments in other f32
orders).  The prefix-sum form against the segment sums: 1e-12 in f64 and
1e-5 in f32 (its O(eps * |S|) cancellation on this small instance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import FIXTURES, read_golden
from recsys_tpu.config import RunConfig as JaxRunConfig
from recsys_tpu.engine import trainer as jax_trainer
from recsys_tpu.ops import coo as jax_coo
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.engine.oracle import factorize_numpy
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.models.mf import init_factors
from recsys_tpu_torch.ops import coo

_TORCH = {np.float64: torch.float64, np.float32: torch.float32}
_STEP_RTOL = {np.float64: 1e-12, np.float32: 1e-6}
_FORMS_RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(scope="module")
def spec():
    # Users with one rating and items with none: empty and single segments.
    return generate_instance(50, 80, 7, 1, 9, iters=3, alpha=0.01, seed=13)


def _state(spec, dtype):
    st = init_factors(spec.users, spec.items, spec.features)
    return st.L.astype(dtype), st.R.astype(dtype)


def _rel(got, want):
    return max(float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max())
               / float(np.abs(np.asarray(w, np.float64)).max()) for g, w in zip(got, want))


def test_builders_equal_jax(spec):
    got, want = coo.make_coo_inputs(spec, np.float64), jax_coo.make_coo_inputs(spec, np.float64)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.row_counts, np.bincount(spec.rows, minlength=spec.users))
    np.testing.assert_array_equal(got.col_counts, np.bincount(spec.cols, minlength=spec.items))
    got, want = coo.make_coo_seg_inputs(spec, np.float32), jax_coo.make_coo_seg_inputs(spec, np.float32)
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", ["segment", "cumsum"])
def test_one_step_matches_jax(spec, dtype, form):
    L, R = _state(spec, dtype)
    alpha2 = 2.0 * spec.alpha
    if form == "segment":
        want = jax_coo.coo_gd_step(jnp.asarray(L), jnp.asarray(R),
                                   jax.tree.map(jnp.asarray, jax_coo.make_coo_inputs(spec, dtype)),
                                   jnp.asarray(alpha2, dtype), spec.users, spec.items)
        data, step = coo.make_coo_inputs(spec, np.float64), coo.coo_gd_step
    else:
        want = jax_coo.coo_gd_step_cumsum(jnp.asarray(L), jnp.asarray(R),
                                          jax.tree.map(jnp.asarray, jax_coo.make_coo_seg_inputs(spec, dtype)),
                                          jnp.asarray(alpha2, dtype))
        data, step = coo.make_coo_seg_inputs(spec, np.float64), coo.coo_gd_step_cumsum
    got = step(torch.from_numpy(L), torch.from_numpy(R), coo.to_device(data, "cpu", _TORCH[dtype]), alpha2)
    assert got[0].dtype == _TORCH[dtype]
    assert _rel([g.numpy() for g in got], want) <= _STEP_RTOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cumsum_form_matches_segment_sums(spec, dtype):
    L, R = (torch.from_numpy(x) for x in _state(spec, dtype))
    seg = coo.to_device(coo.make_coo_inputs(spec, np.float64), "cpu", _TORCH[dtype])
    pre = coo.to_device(coo.make_coo_seg_inputs(spec, np.float64), "cpu", _TORCH[dtype])
    a, b = (L, R), (L, R)
    for _ in range(3):
        a, b = coo.coo_gd_step(*a, seg, 2 * spec.alpha), coo.coo_gd_step_cumsum(*b, pre, 2 * spec.alpha)
    assert _rel([x.numpy() for x in b], [x.numpy() for x in a]) <= _FORMS_RTOL[dtype]


def test_factorize_coo_matches_oracle():
    spec = load_problem(str(FIXTURES / "inst30-40-10-2-10.in"))
    got = trainer.factorize(spec, RunConfig(dtype="float64", path="coo"), "cpu")
    want, _ = factorize_numpy(spec)
    np.testing.assert_allclose(got.L, want.L, rtol=1e-12)
    np.testing.assert_allclose(got.R, want.R, rtol=1e-12)


@pytest.mark.parametrize("name", ["inst0", "inst1", "inst2", "inst30-40-10-2-10"])
def test_run_coo_matches_golden(name):
    spec = load_problem(str(FIXTURES / f"{name}.in"))
    out, _ = trainer.run(spec, RunConfig(dtype="float64", path="coo"), "cpu")
    assert out == read_golden(name)


def test_coo_use_cumsum_gate():
    # trainer.py:210-222 with the TPU backend read as a CUDA device.
    ml = load_problem(str(FIXTURES / "instML100k.in"))
    sparse = generate_instance(300, 5000, 4, 1, 2, iters=1, alpha=1e-3, seed=1)  # nnz < users + items
    assert trainer._coo_use_cumsum(ml, RunConfig(dtype="float32"), "cuda")
    assert trainer._coo_use_cumsum(ml, RunConfig(dtype="bfloat16"), "cuda")
    assert not trainer._coo_use_cumsum(ml, RunConfig(dtype="float64"), "cuda")
    assert not trainer._coo_use_cumsum(ml, RunConfig(dtype="float32"), "cpu")
    assert not trainer._coo_use_cumsum(sparse, RunConfig(dtype="float32"), "cuda")


@pytest.mark.parametrize("fault", ["unsorted", "duplicate"])
def test_require_row_major_rejects(spec, fault):
    rows, cols = spec.rows.copy(), spec.cols.copy()
    if fault == "unsorted":
        rows[[0, -1]] = rows[[-1, 0]]
        cols[[0, -1]] = cols[[-1, 0]]
    else:
        rows[1], cols[1] = rows[0], cols[0]
    bad = dataclasses.replace(spec, rows=rows, cols=cols)
    for build in (coo.make_coo_inputs, coo.make_coo_seg_inputs):
        with pytest.raises(ValueError, match="row-major"):
            build(bad)


def test_empty_problem_past_the_dense_budget_takes_coo():
    # No ratings and 2 * 12000 * 12000 f64 cells > DENSE_BUDGET_BYTES: the
    # JAX decision (trainer.py:134-137) picks coo, which runs; the factors
    # stay at the glibc init.
    empty = np.zeros(0, np.int32)
    spec = ProblemSpec(iters=2, alpha=1e-3, features=2, users=12_000, items=12_000, rows=empty, cols=empty,
                       vals=np.zeros(0))
    cfg = RunConfig(dtype="float64")
    assert trainer.choose_path(spec, cfg, "cpu") == jax_trainer.choose_path(spec, JaxRunConfig(dtype="float64")) == "coo"
    state = trainer.factorize(spec, cfg, "cpu")
    init = init_factors(spec.users, spec.items, spec.features)
    np.testing.assert_array_equal(state.L, init.L)
    np.testing.assert_array_equal(state.R, init.R)
    out, top1 = trainer.run(spec, cfg, "cpu")
    assert out.count("\n") == spec.users and top1.shape == (spec.users,)
