"""The port's streamed kernels and resident training (B2, B3, B4, B6 of
recsys_tpu_torch/ops/dense_fused.py and dense_stream.py) against the JAX
kernels ``pallas_dense.resident_train``, ``stream_train`` and
``stream_top1`` (interpret mode on the CPU, as tests/test_pallas.py runs
them), against each other, and the plan that picks between them.

On the CPU the wrappers run the plain twins; the CUDA kernels are held
against the twins in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.config import RunConfig as JaxRunConfig
from recsys_tpu.engine import trainer as jax_trainer
from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.ops import dense_fused, dense_stream

from helpers import FIXTURES

SPECS = {
    "32x40": dict(users=32, items=40, features=10, min_nz_row=2, max_nz_row=8, iters=5, alpha=0.01, seed=11),
    # 700 items -> 768: the JAX kernels walk 6 strips of 128 (test_pallas.py:173).
    "32x700": dict(users=32, items=700, features=8, min_nz_row=2, max_nz_row=8, iters=4, alpha=0.01, seed=7),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_inputs(name):
    spec = generate_instance(**SPECS[name])
    Lt, Rt, A, _ = pallas_dense.pad_for_pallas(spec, strip=128)
    return spec, Lt, Rt, A


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("kind", ["resident", "stream"])
def test_train_plain_matches_jax(name, precision, kind):
    spec, Lt, Rt, A = _jax_inputs(name)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    jax_fn = pallas_dense.resident_train if kind == "resident" else pallas_dense.stream_train
    port_fn = dense_fused.resident_train if kind == "resident" else dense_stream.stream_train
    Lj, Rj = jax_fn(Lt, Rt, A, strip=128, **kw)
    Lp, Rp = port_fn(_t(Lt), _t(Rt), _t(A), **kw)
    # Same math, f32 sums in another order (XLA's dot vs torch's matmul):
    # agreement to a few f32 ulps of the factors.
    np.testing.assert_allclose(Lp.numpy(), np.asarray(Lj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=1e-5, atol=1e-7)
    # The top-1 from the JAX factors is the JAX stream_top1's.
    top = dense_stream.stream_top1(_t(Lj), _t(Rj), _t(A), precision=precision, items_true=spec.items)
    want = pallas_dense.stream_top1(Lj, Rj, A, strip=128, precision=precision, items_true=spec.items)
    np.testing.assert_array_equal(top.numpy(), np.asarray(want))


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_stream_top1_plain_matches_jax(precision):
    spec, Lt, Rt, A = _jax_inputs("32x700")
    rng = np.random.default_rng(1)  # factors far from the initial ones
    Lt = (Lt + 0.1 * rng.standard_normal(Lt.shape) * (Lt != 0)).astype(np.float32)
    Rt = (Rt + 0.1 * rng.standard_normal(Rt.shape) * (Rt != 0)).astype(np.float32)
    want = pallas_dense.stream_top1(Lt, Rt, A, strip=128, precision=precision, items_true=spec.items)
    got = dense_stream.stream_top1_plain(_t(Lt), _t(Rt), _t(A), precision=precision, items_true=spec.items)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, Lt.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_stream_train_top1_is_train_then_top1(precision):
    spec, Lt, Rt, A = _jax_inputs("32x700")
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    Lf, Rf, tf = dense_stream.stream_train_top1(_t(Lt), _t(Rt), _t(A), items_true=spec.items, **kw)
    Ls, Rs = dense_stream.stream_train_plain(_t(Lt), _t(Rt), _t(A), **kw)
    ts = dense_stream.stream_top1_plain(Ls, Rs, _t(A), precision=precision, items_true=spec.items)
    assert torch.equal(Lf, Ls) and torch.equal(Rf, Rs) and torch.equal(tf, ts)
    # and B2's factors are B1's, as the card asserts bit for bit
    L1, R1, t1 = dense_fused.resident_train_top1(_t(Lt), _t(Rt), _t(A), items_true=spec.items, **kw)
    L2, R2 = dense_fused.resident_train(_t(Lt), _t(Rt), _t(A), **kw)
    assert torch.equal(L1, L2) and torch.equal(R1, R2) and torch.equal(t1, ts)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_a_storage_bit_identical(precision):
    spec = generate_instance(**SPECS["32x40"])
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision, items_true=spec.items)
    outs = [dense_stream.stream_train_top1(_t(Lt), _t(Rt), dense_fused.device_dense_AT(spec, U, I, dt, "cpu"), **kw)
            for dt in (torch.int8, torch.bfloat16, torch.float32)]
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_tie_break_lowest_index():
    K, U = 8, 128
    ones, zeros = torch.ones((K, U)), torch.zeros((U, U))
    want = torch.zeros((1, U), dtype=torch.int32)
    assert torch.equal(dense_stream.stream_top1(ones, ones, zeros, items_true=U), want)
    assert torch.equal(dense_stream.stream_train_top1(ones, ones, zeros, iters=0, alpha2=0.0, items_true=U)[2], want)
    # rated cells and items past items_true never win
    A = zeros.clone()
    A[0, :] = 1.0
    top = dense_stream.stream_top1(ones, ones, A, items_true=100)
    assert torch.equal(top, torch.ones((1, U), dtype=torch.int32))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ok = dict(items_true=128)
    z = torch.zeros
    with pytest.raises(ValueError, match="multiples of 128"):
        dense_stream.stream_top1(z(8, 100), z(8, 128), z(128, 100), **ok)
    with pytest.raises(ValueError, match="unknown precision"):
        dense_stream.stream_train(z(8, 128), z(8, 128), z(128, 128), iters=1, alpha2=0.1, precision="tf32")
    meta = dict(device="meta")
    for call in (lambda a: dense_stream.stream_train(*a, iters=1, alpha2=0.1),
                 lambda a: dense_stream.stream_top1(*a, **ok),
                 lambda a: dense_stream.stream_train_top1(*a, iters=1, alpha2=0.1, **ok),
                 lambda a: dense_fused.resident_train(*a, iters=1, alpha2=0.1)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call((z(8, 128, **meta), z(8, 128, **meta), z(128, 128, **meta)))


def _shape_only(users, items, k, iters=3000):
    """A ProblemSpec with the given dims and one int rating, for the plan."""
    one = np.zeros(1, np.int32)
    return ProblemSpec(iters=iters, alpha=1e-4, features=k, users=users, items=items,
                       rows=one, cols=one, vals=np.ones(1))


def test_dense_plan_kinds():
    ml100k = load_problem(str(FIXTURES / "instML100k.in"))
    plan = trainer.dense_plan(ml100k)
    assert (plan.kind, plan.a_dtype, plan.U, plan.I, plan.K) == ("resident", torch.int8, 1024, 1792, 32)
    g = GEN_SPECS["gen-instML1M"]
    ml1m = _shape_only(g["users"], g["items"], g["features"])
    plan = trainer.dense_plan(ml1m)
    assert (plan.kind, plan.U, plan.I, plan.K) == ("stream", 6144, 3968, 32)
    assert plan.U * plan.I > trainer.RESIDENT_A_MAX_BYTES >= 1024 * 1792
    assert plan.device_bytes <= trainer.DEVICE_BUDGET_BYTES
    # either kind can be forced
    assert trainer.dense_plan(ml1m, a_max_bytes=1 << 40).kind == "resident"
    assert trainer.dense_plan(ml100k, a_max_bytes=0).kind == "stream"


def test_stream_working_set_under_the_resident_kernels():
    # The step's working set at gen-instML1M (csrc/dense_stream.cu header):
    # int8 A^T once, the partials and six factor tables, against B1's.
    K, U, I = 32, 6144, 3968
    G, C, chunk, S = dense_stream.stream_split(K, U, I)
    assert (G, C, S) == (1, 16, 9) and chunk % 32 == 0 and (S - 1) * chunk < I <= S * chunk
    tables = 3 * 4 * K * (U + I)  # input, output and ping-pong, each side
    stream = U * I + dense_stream.stream_partial_bytes(K, U, I) + tables
    chunk_l, s_l = dense_fused._split(U, I, 1, 2 * dense_stream.H100_SMS)
    chunk_r, s_r = dense_fused._split(I, U, 1, 2 * dense_stream.H100_SMS)
    resident = U * I + 4 * K * (s_l * U + s_r * I) + tables
    assert (stream, resident) == (36_864_000, 37_552_128)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_run_stream_forced_matches_jax(precision):
    spec = generate_instance(40, 300, 10, 2, 12, iters=20, alpha=0.01, seed=21)
    out, top1 = trainer.run(spec, RunConfig(dtype="float32", path="pallas", precision=precision), "cpu", a_max_bytes=0)
    want, _ = jax_trainer.run(spec, JaxRunConfig(dtype="float32", path="pallas", precision=precision))
    assert out == want
    resident, _ = trainer.run(spec, RunConfig(dtype="float32", path="pallas", precision=precision), "cpu")
    assert resident == out
