"""The port's fused dense GD + top-1 (recsys_tpu_torch/ops/dense_fused.py)
against the JAX kernel ``pallas_dense.resident_train_top1`` (interpret
mode on the CPU, as tests/test_pallas.py runs it) and against itself.

On the CPU the wrapper runs the plain torch twin; the CUDA kernel is
held against the twin in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.io.generator import generate_instance
from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_fused

SPECS = {
    "32x40": dict(users=32, items=40, features=10, min_nz_row=2, max_nz_row=8, iters=5, alpha=0.01, seed=11),
    # 700 items -> 768: the JAX kernel walks 6 strips (its fori_loop branch).
    "32x700": dict(users=32, items=700, features=8, min_nz_row=2, max_nz_row=8, iters=4, alpha=0.01, seed=7),
}


@pytest.fixture(scope="module")
def small_spec():
    return generate_instance(**SPECS["32x40"])


def _port(Lt, Rt, A, spec, precision="highest", iters=None):
    return dense_fused.resident_train_top1(
        torch.from_numpy(np.ascontiguousarray(Lt)), torch.from_numpy(np.ascontiguousarray(Rt)),
        A if isinstance(A, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(A)),
        iters=spec.iters if iters is None else iters, alpha2=2 * spec.alpha,
        precision=precision, items_true=spec.items,
    )


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_matches_jax_resident_train_top1(name, precision):
    spec = generate_instance(**SPECS[name])
    Lt, Rt, A, (U, I, K) = pallas_dense.pad_for_pallas(spec, strip=128)
    Lj, Rj, tj = pallas_dense.resident_train_top1(
        Lt, Rt, A, iters=spec.iters, alpha2=2 * spec.alpha, strip=128,
        precision=precision, items_true=spec.items,
    )
    Lp, Rp, tp = _port(Lt, Rt, A, spec, precision)
    # Same math, f32 sums in a different order (XLA's dot vs torch's
    # matmul): agreement to a few f32 ulps of the factors.
    np.testing.assert_allclose(Lp.numpy(), np.asarray(Lj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (1, U)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_a_storage_bit_identical(small_spec, precision):
    """int8 (2x rating, exact x0.5), bf16 and f32 A give the same bits."""
    spec = small_spec
    assert dense_fused.vals_int8_exact(spec) and dense_fused.vals_bf16_exact(spec)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    outs = [
        _port(Lt, Rt, dense_fused.device_dense_AT(spec, U, I, dt, "cpu"), spec, precision)
        for dt in (torch.int8, torch.bfloat16, torch.float32)
    ]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_padding_stays_exactly_zero(small_spec):
    spec = small_spec
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    assert (K, U, I) == (16, 128, 128)  # k=10 -> 16, users/items -> 128
    A = dense_fused.device_dense_AT(spec, U, I, torch.int8, "cpu")
    Lp, Rp, top = _port(Lt, Rt, A, spec)
    assert torch.all(Lp[:, spec.users:] == 0) and torch.all(Rp[:, spec.items:] == 0)
    assert torch.all(Lp[spec.features:] == 0) and torch.all(Rp[spec.features:] == 0)
    # Padded items never win the top-1.
    assert int(top.max()) < spec.items


def test_top1_tie_break_lowest_index():
    # All-equal factors: every prediction ties; the lowest item index wins.
    U = I = 128
    K = 8
    _, _, top = dense_fused.resident_train_top1(
        torch.ones((K, U)), torch.ones((K, I)), torch.zeros((I, U)),
        iters=0, alpha2=0.0, items_true=I,
    )
    assert torch.equal(top, torch.zeros((1, U), dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_device_dense_AT_matches_jax(small_spec, dtype):
    import jax.numpy as jnp

    U, I = 128, 128
    want = np.asarray(pallas_dense.device_dense_AT(small_spec, U, I, dtype=getattr(jnp, dtype)))
    got = dense_fused.device_dense_AT(small_spec, U, I, getattr(torch, dtype), "cpu")
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (I, U)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want.astype(np.float32))


def test_value_gates_match_jax():
    import dataclasses

    base = generate_instance(8, 8, 4, 1, 3, iters=1, alpha=0.01, seed=3)
    cases = {
        "stars": base,
        "quarter": dataclasses.replace(base, vals=base.vals + 0.25),
        "big": dataclasses.replace(base, vals=base.vals * 100.0),
        "fine": dataclasses.replace(base, vals=base.vals + 1e-3),
        "zero": dataclasses.replace(base, vals=base.vals * 0.0),
    }
    for name, spec in cases.items():
        for fn in ("vals_int8_exact", "vals_bf16_exact", "mask_is_implicit"):
            assert getattr(dense_fused, fn)(spec) == getattr(pallas_dense, fn)(spec), (name, fn)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ok = dict(iters=1, alpha2=0.1, items_true=128)
    with pytest.raises(ValueError, match="K a multiple of 8"):
        dense_fused.resident_train_top1(torch.zeros(264, 128), torch.zeros(264, 128), torch.zeros(128, 128), **ok)
    with pytest.raises(ValueError, match="multiples of 128"):
        dense_fused.resident_train_top1(torch.zeros(8, 100), torch.zeros(8, 128), torch.zeros(128, 100), **ok)
    with pytest.raises(ValueError, match="unknown precision"):
        dense_fused.resident_train_top1(torch.zeros(8, 128), torch.zeros(8, 128), torch.zeros(128, 128),
                                        precision="tf32", **ok)
    # No kernel and no fallback for a device other than cpu/cuda.
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dense_fused.resident_train_top1(torch.zeros(8, 128, **meta), torch.zeros(8, 128, **meta),
                                        torch.zeros(128, 128, **meta), **ok)


@pytest.fixture(scope="module")
def spec200():
    # The small instance chip_smoke.py holds the kernel to on the card.
    return generate_instance(200, 300, 10, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)


def _reading(spec, kind, precision, twin_precision, dtype=torch.float32):
    """A kernel-vs-twin reading, with the wrapper (the twin itself on the
    CPU) in ``precision`` and ``dtype`` against the twin in ``twin_precision``."""
    if kind == "factor":
        Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
        Lt, Rt = torch.from_numpy(Lt), torch.from_numpy(Rt)
        A = dense_fused.device_dense_AT(spec, U, I, torch.int8, "cpu")
        kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, items_true=spec.items)
    else:
        Lt, Rt, A = checks.precision_probe(spec, torch.int8, "cpu")
        kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2, items_true=spec.items)
    # The wrapper takes f32 only; in f64 the twin is called directly.
    run = dense_fused.resident_train_top1 if dtype == torch.float32 else dense_fused.resident_train_top1_plain
    got = run(Lt.to(dtype), Rt.to(dtype), A, precision=precision, **kw)
    want = dense_fused.resident_train_top1_plain(Lt, Rt, A, precision=twin_precision, **kw)
    if kind == "factor":
        return checks.factor_rel(got, want), checks.FACTOR_RTOL[twin_precision]
    return checks.update_rel(got, want, Lt, Rt), checks.UPDATE_RTOL[twin_precision]


@pytest.mark.parametrize("kind,precision,twin_precision",
                         [("factor", *c) for c in checks.FACTOR_CONTROLS]
                         + [("update", *c) for c in checks.UPDATE_CONTROLS])
def test_check_limits_reject_a_kernel_in_the_wrong_mode(spec200, kind, precision, twin_precision):
    # A kernel that skipped the bf16 rounding or the split computes the
    # twin of a finer mode: the card's limit must see it.
    rel, limit = _reading(spec200, kind, precision, twin_precision)
    assert rel > 3 * limit, (rel, limit)


@pytest.mark.parametrize("kind", ["factor", "update"])
def test_check_limits_pass_a_resummed_twin(spec200, kind):
    # The twin in f64 against the twin in f32 differs by f32 rounding
    # alone, as a kernel summing in another order does.
    rel, limit = _reading(spec200, kind, "highest", "highest", dtype=torch.float64)
    assert rel < limit / 3, (rel, limit)
