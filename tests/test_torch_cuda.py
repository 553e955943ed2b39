"""The port's CUDA kernels on the card: held against their plain torch
twins and against each other, and the main paths through them against
the golden output.

These tests need an NVIDIA card and skip without one.  The machine with
the card has no jax, and tests/conftest.py imports it, so run them there
without the conftest::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import pathlib

import pytest
import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.ops import dense_fused, dense_stream, dense_tiled

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
# The readings and their limits are in recsys_tpu_torch/testing.py.


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_kernel_matches_plain_twin(precision):
    dev = _cuda()
    spec = generate_instance(200, 300, 10, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, torch.int8, dev)
    Lt, Rt = torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision, items_true=spec.items)
    before = dense_fused.resident_train_top1.launches
    Lk, Rk, tk = dense_fused.resident_train_top1(Lt, Rt, A, **kw)
    Lp, Rp, tp = dense_fused.resident_train_top1_plain(Lt, Rt, A, **kw)
    torch.cuda.synchronize()
    assert dense_fused.resident_train_top1.launches == before + 1
    assert checks.factor_rel((Lk, Rk), (Lp, Rp)) <= checks.FACTOR_RTOL[precision]
    assert torch.equal(tk, tp)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,twin_precision",
                         [(p, p) for p in ("highest", "bf16x3", "default")] + list(checks.UPDATE_CONTROLS))
def test_kernel_update_on_precision_probe(precision, twin_precision):
    # Same mode: within the limit.  A control (kernel in a finer mode than
    # the twin): beyond it, so the limit would catch a kernel that skipped
    # the mode's rounding.
    dev = _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    Lt, Rt, A = checks.precision_probe(spec, torch.int8, dev)
    kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2, items_true=spec.items)
    got = dense_fused.resident_train_top1(Lt, Rt, A, precision=precision, **kw)
    want = dense_fused.resident_train_top1_plain(Lt, Rt, A, precision=twin_precision, **kw)
    rel = checks.update_rel(got, want, Lt, Rt)
    limit = checks.UPDATE_RTOL[twin_precision]
    assert rel <= limit if precision == twin_precision else rel > limit


@pytest.mark.cuda
def test_run_instml100k_matches_golden():
    _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    assert trainer.choose_path(spec, RunConfig(dtype="float32"), "cuda") == "pallas"
    before = dense_fused.resident_train_top1.launches
    out, _ = trainer.run(spec, RunConfig(dtype="float32"), "cuda")
    assert dense_fused.resident_train_top1.launches == before + 1
    assert out == (FIXTURES / "instML100k.out").read_text()


def _small_inputs(dev, a_dtype=torch.int8):
    spec = generate_instance(200, 300, 10, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, a_dtype, dev)
    return spec, torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev), A


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_resident_train_is_b1_and_matches_twin(precision):
    dev = _cuda()
    spec, Lt, Rt, A = _small_inputs(dev)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    before = dense_fused.resident_train.launches
    L2, R2 = dense_fused.resident_train(Lt, Rt, A, **kw)
    L1, R1, _ = dense_fused.resident_train_top1(Lt, Rt, A, items_true=spec.items, **kw)
    twin = dense_fused.resident_train_plain(Lt, Rt, A, **kw)
    torch.cuda.synchronize()
    assert dense_fused.resident_train.launches == before + 1
    assert torch.equal(L2, L1) and torch.equal(R2, R1)
    assert checks.factor_rel((L2, R2), twin) <= checks.FACTOR_RTOL[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_stream_kernels_match_twins(precision, a_dtype):
    dev = _cuda()
    spec, Lt, Rt, A = _small_inputs(dev, a_dtype)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    counts = [f.launches for f in (dense_stream.stream_train, dense_stream.stream_top1, dense_stream.stream_train_top1)]
    L3, R3 = dense_stream.stream_train(Lt, Rt, A, **kw)
    top = dense_stream.stream_top1(L3, R3, A, precision=precision, items_true=spec.items)
    L6, R6, top6 = dense_stream.stream_train_top1(Lt, Rt, A, items_true=spec.items, **kw)
    twin = dense_stream.stream_train_plain(Lt, Rt, A, **kw)
    b1_top = dense_fused.resident_train_top1(L3, R3, A, iters=0, alpha2=0.0, precision=precision,
                                             items_true=spec.items)[2]
    torch.cuda.synchronize()
    assert [f.launches for f in (dense_stream.stream_train, dense_stream.stream_top1,
                                 dense_stream.stream_train_top1)] == [c + 1 for c in counts]
    assert checks.factor_rel((L3, R3), twin) <= checks.FACTOR_RTOL[precision]
    assert torch.equal(top, dense_stream.stream_top1_plain(L3, R3, A, precision=precision, items_true=spec.items))
    assert torch.equal(top, b1_top)
    assert torch.equal(L6, L3) and torch.equal(R6, R3) and torch.equal(top6, top)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,twin_precision",
                         [(p, p) for p in ("highest", "bf16x3", "default")] + list(checks.UPDATE_CONTROLS))
def test_stream_update_on_precision_probe(precision, twin_precision):
    dev = _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    Lt, Rt, A = checks.precision_probe(spec, torch.int8, dev)
    kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2)
    got = dense_stream.stream_train(Lt, Rt, A, precision=precision, **kw)
    want = dense_stream.stream_train_plain(Lt, Rt, A, precision=twin_precision, **kw)
    rel = checks.update_rel(got, want, Lt, Rt)
    limit = checks.UPDATE_RTOL[twin_precision]
    assert rel <= limit if precision == twin_precision else rel > limit


@pytest.mark.cuda
def test_run_instml100k_stream_forced_matches_golden():
    _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    before = dense_stream.stream_train.launches, dense_stream.stream_top1.launches
    out, _ = trainer.run(spec, RunConfig(dtype="float32"), "cuda", a_max_bytes=0)
    assert (dense_stream.stream_train.launches, dense_stream.stream_top1.launches) == (before[0] + 1, before[1] + 1)
    assert out == (FIXTURES / "instML100k.out").read_text()


@pytest.mark.cuda
def test_factorize_recommend_instml100k_matches_golden():
    _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    cfg = RunConfig(dtype="float32")
    before = dense_fused.resident_train.launches
    state = trainer.factorize(spec, cfg, "cuda")
    assert dense_fused.resident_train.launches == before + 1
    from recsys_tpu_torch.io.writers import format_recommendations

    top1 = trainer.recommend(state, spec, cfg, "cuda")
    assert format_recommendations(top1, spec.rated_counts(), spec.items) == (FIXTURES / "instML100k.out").read_text()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [40, 256])
def test_wide_factors_match_twins(k):
    # K > 32 spreads a column over G = 2 .. 8 lanes in every kernel.
    dev = _cuda()
    spec = generate_instance(150, 260, k, 2, 20, iters=5, alpha=1e-4, seed=3)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, torch.int8, dev)
    Lt, Rt = torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision="highest")
    twin = dense_stream.stream_train_plain(Lt, Rt, A, **kw)
    for got in (dense_stream.stream_train(Lt, Rt, A, **kw), dense_fused.resident_train(Lt, Rt, A, **kw)):
        assert checks.factor_rel(got, twin) <= checks.FACTOR_RTOL["highest"]
    top = dense_stream.stream_top1(*twin, A, items_true=spec.items)
    assert torch.equal(top, dense_stream.stream_top1_plain(*twin, A, items_true=spec.items))


# k = 300 > 256: the tiled plan's own shape.
_K300 = dict(users=500, items=300, features=300, min_nz_row=2, max_nz_row=30, iters=checks.FACTOR_ITERS,
             alpha=1e-3, seed=5)


def _tiled_inputs(dev, spec, a_dtype=torch.int8):
    L, R, (U, I, K) = dense_tiled.pad_factors_lane_major(spec)
    A = dense_tiled.device_dense_A(spec, U, I, a_dtype, dev)
    return torch.from_numpy(L).to(dev), torch.from_numpy(R).to(dev), A


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_tiled_kernel_matches_twin(precision, a_dtype):
    dev = _cuda()
    spec = generate_instance(**_K300)
    L, R, A = _tiled_inputs(dev, spec, a_dtype)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    before = dense_tiled.tiled_deltas.launches
    got = dense_tiled.tiled_train(L, R, A, **kw)
    twin = dense_tiled.tiled_train_plain(L, R, A, **kw)
    again = dense_tiled.tiled_train(L, R, A, **kw)
    torch.cuda.synchronize()
    assert dense_tiled.tiled_deltas.launches == before + 2 * spec.iters
    assert checks.factor_rel(got, twin) <= checks.TILED_FACTOR_RTOL[precision]
    # No float atomics: two runs give the same bits.
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # Padding masks itself.
    assert torch.all(got[0][spec.users:] == 0) and torch.all(got[1][:, spec.features:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,twin_precision",
                         [(p, p) for p in ("highest", "bf16x3", "default")] + list(checks.UPDATE_CONTROLS))
def test_tiled_update_on_precision_probe(precision, twin_precision):
    dev = _cuda()
    spec = generate_instance(**_K300)
    L, R, A = checks.tiled_probe(spec, torch.int8, dev)
    got = dense_tiled.tiled_gd_step(L, R, A, alpha2=checks.PROBE_ALPHA2, precision=precision)
    want = dense_tiled.tiled_train_plain(L, R, A, iters=1, alpha2=checks.PROBE_ALPHA2, precision=twin_precision)
    rel = checks.update_rel(got, want, L, R)
    limit = checks.TILED_UPDATE_RTOL[twin_precision]
    assert rel <= limit if precision == twin_precision else rel > limit


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 700, 1000])
def test_tiled_widths_match_twin(k):
    # K = 32, 704 (gen-inst1e6's width) and 1024, the kernel's widest.
    dev = _cuda()
    spec = generate_instance(2000, 100, k, 1, 3, iters=5, alpha=1e-5, seed=42)
    L, R, A = _tiled_inputs(dev, spec)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision="highest")
    got = dense_tiled.tiled_train(L, R, A, **kw)
    assert checks.factor_rel(got, dense_tiled.tiled_train_plain(L, R, A, **kw)) <= checks.TILED_FACTOR_RTOL["highest"]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_run_tiled_matches_oracle_on_card(precision):
    from recsys_tpu_torch.engine.oracle import run_oracle

    _cuda()
    spec = generate_instance(40, 130, 300, 2, 12, iters=20, alpha=0.01, seed=21)
    before = dense_tiled.tiled_deltas.launches
    out, _ = trainer.run(spec, RunConfig(dtype="float32", path="pallas", precision=precision), "cuda")
    assert dense_tiled.tiled_deltas.launches == before + spec.iters
    assert out == run_oracle(spec)
