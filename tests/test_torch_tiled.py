"""The port's tiled plan (recsys_tpu_torch/ops/dense_tiled.py, B5) against
the JAX kernels ``pallas_dense.tiled_deltas``, ``tiled_gd_step`` and
``tiled_train`` (interpret mode on the CPU, as tests/test_pallas.py:56-86
runs them), against the f64 oracle, and the engine's tiled route.

JAX on the CPU ignores the single-pass ``default`` precision and computes
full f32 (tests/test_pallas.py:391-394), so in ``default`` the port is held
against a numpy emulation of the bf16 pass instead: both operands of each
product rounded to bf16 (with ml_dtypes, as jnp does), products summed in
f64.

On the CPU the wrapper runs the plain twin; the CUDA kernel is held
against the twin in tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from recsys_tpu.engine.oracle import factorize_numpy, run_oracle
from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch import convert
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.models.mf import MFState, init_factors
from recsys_tpu_torch.ops import dense_tiled

from helpers import FIXTURES

PRECISIONS = ("highest", "bf16x3", "default")
# (instance, the JAX kernel's bu, bi): k = 10 on 32 x 256, and one k past
# the resident and stream kernels' K <= 256.
SHAPES = {
    "k10": (dict(users=32, items=256, features=10, min_nz_row=2, max_nz_row=40, iters=3, alpha=0.01, seed=11),
            16, 128),
    "k300": (dict(users=16, items=128, features=300, min_nz_row=2, max_nz_row=20, iters=3, alpha=1e-3, seed=5),
             16, 128),
}
# Same math, f32 sums in another order (XLA's dot in interpret mode vs
# torch's matmul): the deltas agree to a few f32 ulps of their largest
# entry.  In `default` an ulp of pred can flip the bf16 rounding of one
# cell's e, which moves that cell's terms by 2^-8 of e; none flips here.
RTOL, ATOL_OF_MAX = 1e-5, 1e-6


def _jax_inputs(name):
    kw, bu, bi = SHAPES[name]
    spec = generate_instance(**kw)
    L, R, (U, I, _) = pallas_dense.pad_factors_lane_major(spec, strip=bi, u_mult=bu)
    A = np.asarray(pallas_dense.device_dense_A(spec, U, I))
    return spec, L, R, A, bu, bi


def _port_inputs(spec, L, R, a_dtype=torch.int8):
    """The JAX tables in the port's tiled layout, and A in its storage."""
    Lp, Rp = convert.from_jax_lane_major(L, R, spec, "cpu")
    return Lp, Rp, dense_tiled.device_dense_A(spec, Lp.shape[0], Rp.shape[0], a_dtype, "cpu")


def _bf16(x):
    import jax.numpy as jnp

    return np.asarray(x, np.float32).astype(jnp.bfloat16).astype(np.float64)


def _numpy_default_deltas(L, R, A):
    """_dl_kernel / _dr_kernel's math with one bf16 pass per product."""
    pred = (_bf16(L) @ _bf16(R).T).astype(np.float32)
    e = _bf16(np.where(A != 0, A - pred, np.float32(0)))
    return (e @ _bf16(R)).astype(np.float32), (e.T @ _bf16(L)).astype(np.float32)


def _jax_deltas(L, R, A, bu, bi, precision):
    if precision == "default":
        return _numpy_default_deltas(L, R, A)
    return pallas_dense.tiled_deltas(L, R, A, bu=bu, bi=bi, precision=precision)


def _close(got, want, rows, k):
    want = np.asarray(want)[:rows, :k]
    np.testing.assert_allclose(got.numpy()[:rows, :k], want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max()))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tiled_deltas_plain_matches_jax(name, precision):
    spec, L, R, A, bu, bi = _jax_inputs(name)
    dLj, dRj = _jax_deltas(L, R, A, bu, bi, precision)
    Lp, Rp, Ap = _port_inputs(spec, L, R)
    dL, dR = dense_tiled.tiled_deltas_plain(Lp, Rp, Ap, precision=precision)
    assert tuple(dL.shape) == tuple(Lp.shape) and tuple(dR.shape) == tuple(Rp.shape)
    _close(dL, dLj, spec.users, spec.features)
    _close(dR, dRj, spec.items, spec.features)
    # The wrapper on CPU tensors is the twin.
    for a, b in zip(dense_tiled.tiled_deltas(Lp, Rp, Ap, precision=precision), (dL, dR)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tiled_train_plain_matches_jax(name, precision):
    spec, L, R, A, bu, bi = _jax_inputs(name)
    alpha2 = np.float32(2 * spec.alpha)
    Ls, Rs = L, R
    for _ in range(spec.iters):
        if precision == "default":
            dL, dR = _numpy_default_deltas(Ls, Rs, A)
            Ls, Rs = Ls + alpha2 * dL, Rs + alpha2 * dR
        else:
            Ls, Rs = pallas_dense.tiled_gd_step(Ls, Rs, A, alpha2, bu=bu, bi=bi, precision=precision)
    Lj, Rj = (Ls, Rs) if precision == "default" else pallas_dense.tiled_train(
        L, R, A, alpha2, iters=spec.iters, bu=bu, bi=bi, precision=precision)
    Lp, Rp, Ap = _port_inputs(spec, L, R)
    kw = dict(alpha2=float(alpha2), precision=precision)
    Lt, Rt = dense_tiled.tiled_train_plain(Lp, Rp, Ap, iters=spec.iters, **kw)
    for want_L, want_R in ((Lj, Rj), (Ls, Rs)):
        _close(Lt, want_L, spec.users, spec.features)
        _close(Rt, want_R, spec.items, spec.features)
    # tiled_gd_step and tiled_train compose the same steps.
    L1, R1 = Lp, Rp
    for _ in range(spec.iters):
        L1, R1 = dense_tiled.tiled_gd_step(L1, R1, Ap, **kw)
    L2, R2 = dense_tiled.tiled_train(Lp, Rp, Ap, iters=spec.iters, **kw)
    assert torch.equal(L1, Lt) and torch.equal(R1, Rt) and torch.equal(L2, Lt) and torch.equal(R2, Rt)


def test_tiled_twin_matches_oracle():
    # test_pallas.py's instance and tolerance (test_tiled_matches_oracle).
    spec = generate_instance(32, 40, 10, 2, 8, iters=3, alpha=0.01, seed=11)
    L, R, (U, I, K) = dense_tiled.pad_factors_lane_major(spec)
    assert (U, I, K) == (128, 128, 32)
    A = dense_tiled.device_dense_A(spec, U, I, torch.int8, "cpu")
    Lp, Rp = dense_tiled.tiled_train(torch.from_numpy(L), torch.from_numpy(R), A, iters=3, alpha2=2 * spec.alpha)
    ref, _ = factorize_numpy(spec)
    np.testing.assert_allclose(Lp[: spec.users, : spec.features].numpy(), ref.L, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(Rp[: spec.items, : spec.features].numpy(), ref.R, rtol=2e-4, atol=2e-5)
    # Padding masks itself: padded rows and columns stay exactly zero.
    assert torch.all(Lp[spec.users:] == 0) and torch.all(Rp[spec.items:] == 0)
    assert torch.all(Lp[:, spec.features:] == 0) and torch.all(Rp[:, spec.features:] == 0)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_a_storage_bit_identical(precision):
    spec = generate_instance(**SHAPES["k300"][0])
    L, R, (U, I, _) = dense_tiled.pad_factors_lane_major(spec)
    outs = [dense_tiled.tiled_train(torch.from_numpy(L), torch.from_numpy(R),
                                    dense_tiled.device_dense_A(spec, U, I, dt, "cpu"),
                                    iters=2, alpha2=2 * spec.alpha, precision=precision)
            for dt in (torch.int8, torch.bfloat16, torch.float32)]
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_device_dense_A_matches_jax(dtype):
    import jax.numpy as jnp

    spec = generate_instance(**SHAPES["k10"][0])
    want = np.asarray(pallas_dense.device_dense_A(spec, 128, 256))
    got = dense_tiled.device_dense_A(spec, 128, 256, getattr(torch, dtype), "cpu")
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (128, 256)
    scale = 0.5 if dtype == "int8" else 1.0  # int8 holds 2x the rating
    np.testing.assert_array_equal(got.to(torch.float32).numpy() * scale, want.astype(np.float32))
    assert jnp.dtype(want.dtype) == jnp.float32


def test_convert_lane_major_round_trips():
    spec = generate_instance(**SHAPES["k300"][0])
    state = init_factors(spec.users, spec.items, spec.features)
    Lj, Rj, _ = pallas_dense.pad_factors_lane_major(spec, strip=128, u_mult=16, state=state)
    L, R = convert.from_jax_lane_major(Lj, Rj, spec, "cpu")
    assert tuple(L.shape) == (128, 320) and tuple(R.shape) == (128, 320) and L.dtype == torch.float32
    Lp, Rp, _ = dense_tiled.pad_factors_lane_major(spec, state=state)
    assert torch.equal(L, torch.from_numpy(Lp)) and torch.equal(R, torch.from_numpy(Rp))
    back = convert.tiled_to_state(L, R, spec)
    np.testing.assert_array_equal(back.L, state.L.astype(np.float32))
    np.testing.assert_array_equal(back.R, state.R.astype(np.float32))


def _shape_only(users, items, k, iters=10):
    """A ProblemSpec with the given dims and one int rating, for the plan."""
    one = np.zeros(1, np.int32)
    return ProblemSpec(iters=iters, alpha=1e-4, features=k, users=users, items=items,
                       rows=one, cols=one, vals=np.ones(1))


def test_dense_plan_takes_tiled_past_the_other_kernels():
    k300 = generate_instance(**SHAPES["k300"][0])
    plan = trainer.dense_plan(k300)
    assert (plan.kind, plan.a_dtype, plan.U, plan.I, plan.K) == ("tiled", torch.int8, 128, 128, 320)
    g = GEN_SPECS["gen-inst1e6-100-700-1-3"]
    big = trainer.dense_plan(_shape_only(g["users"], g["items"], g["features"]))
    assert (big.kind, big.U, big.I, big.K) == ("tiled", 1_000_064, 128, 704)
    assert big.device_bytes <= trainer.DEVICE_BUDGET_BYTES
    # The other kinds keep their shapes.
    assert trainer.dense_plan(load_problem(str(FIXTURES / "instML100k.in"))).kind == "resident"
    g = GEN_SPECS["gen-instML1M"]
    ml1m = _shape_only(g["users"], g["items"], g["features"])
    assert trainer.dense_plan(ml1m).kind == "stream"
    forced = trainer.dense_plan(ml1m, tiled=True)
    assert (forced.kind, forced.K) == ("tiled", 32)
    # Past the tiled kernel's K, or the device budget, no plan fits.
    with pytest.raises(NotImplementedError, match="tiled kernel"):
        trainer.dense_plan(_shape_only(100, 100, dense_tiled.MAX_K + 1))
    with pytest.raises(NotImplementedError, match="no dense plan fits"):
        trainer.dense_plan(_shape_only(4_000_000, 8000, 700))


def test_dr_split_covers_the_users():
    for U, I in ((1_000_064, 128), (6144, 3968), (128, 128), (128, 1 << 20)):
        chunk, S = dense_tiled.dr_split(U, I)
        assert chunk % 32 == 0 and (S - 1) * chunk < U <= S * chunk
    assert dense_tiled.dr_split(1_000_064, 128) == (15_168, 66)
    assert dense_tiled.partial_bytes(128, 128, 32) == 4 * 4 * 128 * 32  # S = 4 chunks of 32 users


@pytest.fixture(scope="module")
def spec300():
    # k = 300 > 256: the auto plan is tiled.
    return generate_instance(40, 130, 300, 2, 12, iters=20, alpha=0.01, seed=21)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_run_tiled_matches_oracle(spec300, precision):
    cfg = RunConfig(dtype="float32", path="pallas", precision=precision)
    assert trainer.dense_plan(spec300).kind == "tiled"
    before = dense_tiled.tiled_deltas.launches
    out, top1 = trainer.run(spec300, cfg, "cpu")
    assert out == run_oracle(spec300)
    assert top1.dtype == np.int32 and top1.shape == (spec300.users,)
    # CPU tensors take the twin: no kernel launch is counted.
    assert dense_tiled.tiled_deltas.launches == before


def test_run_tiled_default_runs_as_highest(spec300):
    run = {p: trainer.run(spec300, RunConfig(dtype="float32", path="pallas", precision=p), "cpu")[0]
           for p in ("highest", "default")}
    assert run["default"] == run["highest"]
    # bfloat16's auto precision is `default`, so it takes the same route.
    assert trainer.run(spec300, RunConfig(dtype="bfloat16", path="pallas"), "cpu")[0] == run["highest"]


def test_run_tiled_forced_matches_other_kinds():
    spec = generate_instance(40, 300, 10, 2, 12, iters=20, alpha=0.01, seed=21)
    cfg = RunConfig(dtype="float32", path="pallas")
    tiled, _ = trainer.run(spec, cfg, "cpu", tiled=True)
    assert tiled == trainer.run(spec, cfg, "cpu")[0] == run_oracle(spec)


def test_factorize_tiled_is_the_twin(spec300):
    cfg = RunConfig(dtype="float32", path="pallas")
    state = trainer.factorize(spec300, cfg, "cpu")
    assert state.L.dtype == np.float32 and state.L.shape == (spec300.users, spec300.features)
    L, R, (U, I, _) = dense_tiled.pad_factors_lane_major(spec300)
    A = dense_tiled.device_dense_A(spec300, U, I, torch.int8, "cpu")
    want = convert.tiled_to_state(*dense_tiled.tiled_train_plain(
        torch.from_numpy(L), torch.from_numpy(R), A, iters=spec300.iters, alpha2=2 * spec300.alpha), spec300)
    np.testing.assert_array_equal(state.L, want.L)
    np.testing.assert_array_equal(state.R, want.R)
    # resumed in two chunks from the first chunk's state: the same factors
    half = dataclasses.replace(spec300, iters=spec300.iters // 2)
    mid = trainer.factorize(half, cfg, "cpu")
    end = trainer.factorize(half, cfg, "cpu", state=mid)
    np.testing.assert_array_equal(end.L, state.L)


def test_recommend_takes_tensors_and_keeps_them_in_place(spec300):
    state = trainer.factorize(spec300, RunConfig(dtype="float32", path="pallas"), "cpu")
    cfg = RunConfig()
    want = trainer.recommend(state, spec300, cfg, "cpu")
    L, R = torch.from_numpy(state.L), torch.from_numpy(state.R)
    assert np.array_equal(trainer.recommend(MFState(L=L, R=R), spec300, cfg, "cpu"), want)
    # Views of the padded tables, as run() hands them over.
    Lp, Rp, _ = dense_tiled.pad_factors_lane_major(spec300, state=state)
    views = convert.tiled_views(torch.from_numpy(Lp), torch.from_numpy(Rp), spec300)
    assert np.array_equal(trainer.recommend(views, spec300, cfg, "cpu"), want)


def test_tiled_wrapper_refuses_what_the_kernel_does_not_take():
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple of 32"):
        dense_tiled.tiled_deltas(z(128, 40), z(128, 40), z(128, 128))
    with pytest.raises(ValueError, match="multiples of 128"):
        dense_tiled.tiled_deltas(z(100, 32), z(128, 32), z(100, 128))
    with pytest.raises(ValueError, match="multiple of 32"):
        dense_tiled.tiled_deltas(z(128, 1056), z(128, 1056), z(128, 128))
    with pytest.raises(ValueError, match="disagree"):
        dense_tiled.tiled_deltas(z(128, 32), z(128, 32), z(256, 128))
    with pytest.raises(ValueError, match="unknown precision"):
        dense_tiled.tiled_deltas(z(128, 32), z(128, 32), z(128, 128), precision="tf32")
    with pytest.raises(ValueError, match="dtypes"):
        dense_tiled.tiled_deltas(z(128, 32, dtype=torch.float64), z(128, 32), z(128, 128))
    # No kernel and no fallback for a device other than cpu/cuda.
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dense_tiled.tiled_deltas(z(128, 32, **meta), z(128, 32, **meta), z(128, 128, **meta))


def _limit_reading(spec, kind, precision, twin_precision, dtype=torch.float32):
    """A B5-vs-twin reading with the twin itself in ``precision`` and
    ``dtype`` standing for the kernel, against the twin in
    ``twin_precision``, and B5's limit for it."""
    if kind == "factor":
        L, R, (U, I, _) = dense_tiled.pad_factors_lane_major(spec)
        L, R = torch.from_numpy(L), torch.from_numpy(R)
        A = dense_tiled.device_dense_A(spec, U, I, torch.int8, "cpu")
        kw = dict(iters=spec.iters, alpha2=2 * spec.alpha)
    else:
        L, R, A = checks.tiled_probe(spec, torch.int8, "cpu")
        kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2)
    got = dense_tiled.tiled_train_plain(L.to(dtype), R.to(dtype), A, precision=precision, **kw)
    want = dense_tiled.tiled_train_plain(L, R, A, precision=twin_precision, **kw)
    if kind == "factor":
        return checks.factor_rel(got, want), checks.TILED_FACTOR_RTOL[twin_precision]
    return checks.update_rel(got, want, L, R), checks.TILED_UPDATE_RTOL[twin_precision]


# The small instance chip_smoke.py holds B5 to, and one at k = 300.
LIMIT_SPECS = {
    "200x300 k10": dict(users=200, items=300, features=10, min_nz_row=2, max_nz_row=30,
                        iters=checks.FACTOR_ITERS, alpha=0.001, seed=5),
    "500x300 k300": dict(users=500, items=300, features=300, min_nz_row=2, max_nz_row=30,
                         iters=checks.FACTOR_ITERS, alpha=1e-3, seed=5),
}


@pytest.mark.parametrize("name", sorted(LIMIT_SPECS))
@pytest.mark.parametrize("kind,precision,twin_precision",
                         [("factor", *c) for c in checks.FACTOR_CONTROLS]
                         + [("update", *c) for c in checks.UPDATE_CONTROLS])
def test_tiled_limits_reject_a_kernel_in_the_wrong_mode(name, kind, precision, twin_precision):
    # A kernel that skipped the bf16 rounding or the split computes the
    # twin of a finer mode: B5's limit must see it.
    rel, limit = _limit_reading(generate_instance(**LIMIT_SPECS[name]), kind, precision, twin_precision)
    assert rel > 3 * limit, (rel, limit)


# Not the update at k = 300: there the CPU twin's long f32 sums read
# 5.4e-5 against its f64 run, within 3x of the bf16x3 control (1.4e-4),
# so on the CPU that reading cannot tell the modes apart.  On the card the
# kernel's per-lane sums and butterfly, and cuBLAS, sum in trees: B5 read
# 8.6e-6 against the twin at K = 704 (PERF.md, "Findings").
@pytest.mark.parametrize("name,kind", [("200x300 k10", "factor"), ("200x300 k10", "update"),
                                       ("500x300 k300", "factor")])
def test_tiled_limits_pass_a_resummed_twin(name, kind):
    # The twin in f64 against the twin in f32 differs by f32 rounding
    # alone, as a kernel summing in another order does.
    rel, limit = _limit_reading(generate_instance(**LIMIT_SPECS[name]), kind, "highest", "highest",
                                dtype=torch.float64)
    assert rel < limit / 3, (rel, limit)
