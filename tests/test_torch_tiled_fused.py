"""B5's fused tiled step (recsys_tpu_torch/ops/dense_tiled.py ``tiled_step``,
``tiled_gd_step``, ``tiled_train``) on the CPU: the twin route against the
JAX ``pallas_dense.tiled_train`` in interpret mode, the caller's factors
left alone, the device bytes the plan counts, and the wrapper's refusals.

The kernel itself runs only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold it equal in raw bits to B5's raw deltas followed by the
torch update (``tiled_train_deltas``).
"""

import numpy as np
import pytest
import torch

from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch import convert
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance
from recsys_tpu_torch.ops import dense_tiled

# The JAX kernel's tiles (bu, bi) and its shape: k = 300 > 256, the tiled
# plan's own kind.
K300 = dict(users=16, items=128, features=300, min_nz_row=2, max_nz_row=20, iters=3, alpha=1e-3, seed=5)
BU, BI = 16, 128
# test_torch_tiled.py's tolerance: the same math, f32 sums in another order
# (XLA's dot in interpret mode vs torch's matmul).
RTOL, ATOL_OF_MAX = 1e-5, 1e-6


def _inputs(spec, a_dtype=torch.int8):
    L, R, (U, I, _) = dense_tiled.pad_factors_lane_major(spec)
    return torch.from_numpy(L), torch.from_numpy(R), dense_tiled.device_dense_A(spec, U, I, a_dtype, "cpu")


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_tiled_train_matches_jax_after_ping_pong(precision):
    # JAX on the CPU computes `default` as full f32 (test_torch_tiled.py
    # holds that mode against a numpy bf16 pass), so the two f32 modes.
    spec = generate_instance(**K300)
    Lj, Rj, (U, I, _) = pallas_dense.pad_factors_lane_major(spec, strip=BI, u_mult=BU)
    Aj = np.asarray(pallas_dense.device_dense_A(spec, U, I))
    alpha2 = np.float32(2 * spec.alpha)
    want = pallas_dense.tiled_train(Lj, Rj, Aj, alpha2, iters=spec.iters, bu=BU, bi=BI, precision=precision)
    L, R = convert.from_jax_lane_major(Lj, Rj, spec, "cpu")
    A = dense_tiled.device_dense_A(spec, L.shape[0], R.shape[0], torch.int8, "cpu")
    kw = dict(iters=spec.iters, alpha2=float(alpha2), precision=precision)
    got = dense_tiled.tiled_train(L, R, A, **kw)
    for g, w, rows in zip(got, want, (spec.users, spec.items)):
        w = np.asarray(w)[:rows, : spec.features]
        np.testing.assert_allclose(g.numpy()[:rows, : spec.features], w, rtol=RTOL,
                                   atol=ATOL_OF_MAX * float(np.abs(w).max()))
    # The twin route is the composition step by step, bit for bit.
    base = dense_tiled.tiled_train_deltas(L, R, A, **kw)
    assert all(torch.equal(g, b) for g, b in zip(got, base))


@pytest.mark.parametrize("entry", ["tiled_train", "tiled_gd_step", "tiled_train_deltas"])
def test_tiled_entries_leave_the_callers_factors(entry):
    spec = generate_instance(**K300)
    L, R, A = _inputs(spec)
    L0, R0 = L.clone(), R.clone()
    kw = dict(alpha2=2 * spec.alpha)
    if entry != "tiled_gd_step":
        kw["iters"] = 3
    Ln, Rn = getattr(dense_tiled, entry)(L, R, A, **kw)
    assert torch.equal(L, L0) and torch.equal(R, R0)
    assert Ln.data_ptr() != L.data_ptr() and Rn.data_ptr() != R.data_ptr()
    assert not torch.equal(Ln, L0)


@pytest.mark.parametrize("iters", [1, 2, 5])
def test_train_buffers_are_what_the_plan_counts(iters):
    spec = generate_instance(40, 130, 300, 2, 12, iters=iters, alpha=0.01, seed=21)
    plan = trainer.dense_plan(spec, tiled=True)
    L, R, A = _inputs(spec, plan.a_dtype)
    At, (chunk, S, part), sets = dense_tiled.train_buffers(L, R, A, iters)
    assert len(sets) == min(iters, 2) and tuple(At.shape) == (plan.I, plan.U)
    assert (S - 1) * chunk < plan.U <= S * chunk and (part is None) == (S == 1)
    held = [L, R, A, At, *(t for s in sets for t in s)] + ([part] if part is not None else [])
    nbytes = sum(t.numel() * t.element_size() for t in held)
    two_sets = nbytes + (2 - len(sets)) * (L.numel() + R.numel()) * 4
    assert two_sets == dense_tiled.train_bytes(plan.U, plan.I, plan.K, plan.a_dtype)
    top1 = 8 * spec.users * trainer._top1_block(spec, trainer.RunConfig.block_items)
    assert plan.device_bytes == two_sets + top1


def test_plan_bytes_at_gen_inst1e6():
    g = GEN_SPECS["gen-inst1e6-100-700-1-3"]
    one = np.zeros(1, np.int32)
    spec = trainer.ProblemSpec(iters=10, alpha=1e-4, features=g["features"], users=g["users"], items=g["items"],
                               rows=one, cols=one, vals=np.ones(1))
    plan = trainer.dense_plan(spec)
    U, I, K = plan.U, plan.I, plan.K
    # int8 A and A^T, L and R in and two sets out, 66 dR chunks of 15,168 users.
    assert (plan.kind, plan.a_dtype, U, I, K) == ("tiled", torch.int8, 1_000_064, 128, 704)
    assert dense_tiled.train_bytes(U, I, K, torch.int8) == 2 * U * I + 3 * 4 * K * (U + I) + 4 * 66 * I * K
    # Its A line is 128 B: the engine streams it through the ring.
    assert dense_tiled.step_form(K, I, torch.int8) == "ring"
    assert dense_tiled.ring_bytes(K, I, torch.int8) == 8 * 4 * (4 * 704 + 128)


def test_step_form_by_shape():
    # gen-instML1M forced tiled: a 3968-cell A line fills the ring; warp.
    assert dense_tiled.step_form(32, 3968, torch.int8) == "warp"
    assert dense_tiled.step_form(32, 1024, torch.int8) == "ring"
    assert dense_tiled.step_form(32, 256, torch.float32) == "ring"
    assert dense_tiled.step_form(32, 384, torch.float32) == "warp"
    # K = 1024 with a 1 KB line still fits a block's shared memory.
    assert dense_tiled.ring_bytes(1024, 256, torch.float32) <= dense_tiled._SMEM_MAX
    assert dense_tiled.step_form(1024, 256, torch.float32) == "ring"


def test_tiled_step_refuses_what_the_kernel_does_not_take():
    z = torch.zeros
    L, R, A = z(128, 32), z(128, 32), z(128, 128)
    kw = dict(alpha2=1e-3)
    with pytest.raises(ValueError, match="multiple of 32"):
        dense_tiled.tiled_step(z(128, 40), z(128, 40), A, z(128, 40), z(128, 40), **kw)
    with pytest.raises(ValueError, match="Lout must be"):
        dense_tiled.tiled_step(L, R, A, z(256, 32), z(128, 32), **kw)
    with pytest.raises(ValueError, match="Rout must be"):
        dense_tiled.tiled_step(L, R, A, z(128, 32), z(128, 32, dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="Lout must be"):
        dense_tiled.tiled_step(L, R, A, z(32, 128).t(), z(128, 32), **kw)
    with pytest.raises(ValueError, match="share memory"):
        dense_tiled.tiled_step(L, R, A, L, z(128, 32), **kw)
    with pytest.raises(ValueError, match="share memory"):
        dense_tiled.tiled_step(L, R, A, z(128, 32), R[:], **kw)
    with pytest.raises(ValueError, match="unknown form"):
        dense_tiled.tiled_step(L, R, A, z(128, 32), z(128, 32), form="tma", **kw)
    with pytest.raises(ValueError, match="unknown precision"):
        dense_tiled.tiled_step(L, R, A, z(128, 32), z(128, 32), precision="tf32", **kw)
    # The ring needs its stages in one block's shared memory.
    big_R, big_A = z(1024, 1024), z(128, 1024)
    with pytest.raises(ValueError, match="ring form needs"):
        dense_tiled.tiled_step(z(128, 1024), big_R, big_A, z(128, 1024), z(1024, 1024), form="ring", **kw)
    # No kernel for CPU or meta tensors, and no fallback: the CPU's step
    # is tiled_gd_step's twin.
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        dense_tiled.tiled_step(L, R, A, z(128, 32), z(128, 32), **kw)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dense_tiled.tiled_step(z(128, 32, **meta), z(128, 32, **meta), z(128, 128, **meta),
                               z(128, 32, **meta), z(128, 32, **meta), **kw)
    assert dense_tiled.tiled_step.launches == 0


def test_clocks_probe_marks_the_current_source():
    # probes/tiled_clocks.py marks a copy of csrc/dense_tiled.cu by text
    # substitution: each anchor must be there exactly once.
    from recsys_tpu_torch.probes import tiled_clocks

    src = tiled_clocks.instrumented_source()
    assert src.count("clock64()") == 8 and 'extern "C" int rs_set_marks' in src
