"""The port's precision helpers (recsys_tpu_torch/ops/precision.py) against
the JAX kernels' ``_bsplit`` / ``_dot`` (recsys_tpu/ops/pallas_dense.py).

Inputs are made with numpy from a seed and handed to both packages as
numpy f32.  JAX on the CPU ignores the single-pass ``default`` precision
(it computes full f32, tests/test_pallas.py:391-394), so the port's
``default`` is held against a numpy emulation of bf16 rounding instead.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.engine.oracle import factorize_numpy
from recsys_tpu.io.generator import generate_instance
from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch.ops import dense_fused, precision

DIMS = (((1,), (0,)), ((), ()))  # plain (M, C) x (C, N)


def _operands(seed=0, m=48, c=96, n=40):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, c)).astype(np.float32),
            rng.standard_normal((c, n)).astype(np.float32))


def _bf16_round_numpy(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16, kept as f32 (bit emulation)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_bsplit_matches_jax_bitwise():
    a, _ = _operands(1)
    hi_j, lo_j = pallas_dense._bsplit(a)
    hi_t, lo_t = precision.bsplit(torch.from_numpy(a))
    # Same two roundings on the same f32 values: identical bits.
    np.testing.assert_array_equal(np.asarray(hi_j, np.float32), hi_t.numpy())
    np.testing.assert_array_equal(np.asarray(lo_j, np.float32), lo_t.numpy())


@pytest.mark.parametrize("mode", ["highest", "bf16x3"])
def test_dot_matches_jax(mode):
    a, b = _operands(2)
    want = np.asarray(pallas_dense._dot(a, b, DIMS, mode), np.float32)
    got = precision.dot(torch.from_numpy(a), torch.from_numpy(b), mode).numpy()
    # Both sum 96 f32 products (exact bf16 products in bf16x3) in different
    # orders: a few f32 ulps of the ~10-magnitude sums.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dot_default_is_one_bf16_pass():
    a, b = _operands(3)
    # Products of bf16 values are exact; the f64 sum is the exact result
    # the port's f32 accumulation approximates.
    want = _bf16_round_numpy(a).astype(np.float64) @ _bf16_round_numpy(b).astype(np.float64)
    got = precision.dot(torch.from_numpy(a), torch.from_numpy(b), "default").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # And it is genuinely coarser than the true f32 product.
    full = a.astype(np.float64) @ b.astype(np.float64)
    assert np.max(np.abs(got - full)) > 1e-3


def test_accuracy_ladder_on_the_port():
    """err(highest) <= err(bf16x3) < err(default)/4 against the f64 oracle,
    through the port's plain twin (5 GD steps)."""
    spec = generate_instance(32, 40, 10, 2, 8, iters=5, alpha=0.01, seed=11)
    ref, _ = factorize_numpy(spec)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, torch.float32, "cpu")

    def err(mode):
        Ltp, _, _ = dense_fused.resident_train_top1(
            torch.from_numpy(Lt), torch.from_numpy(Rt), A, iters=5,
            alpha2=2 * spec.alpha, precision=mode, items_true=spec.items,
        )
        L = Ltp.numpy()[: spec.features, : spec.users].T
        return float(np.max(np.abs(L - ref.L)))

    e_hi, e_3, e_lo = err("highest"), err("bf16x3"), err("default")
    assert e_hi <= e_3 < e_lo / 4, (e_hi, e_3, e_lo)
    assert 0 < e_3 < 1e-3
