"""The port's CUDA kernels on the card: held against their plain torch
twins, against each other and against digests of their raw output, and
the main paths through them against the golden output.

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


def _check_digest(key, *tensors):
    """The raw bits of ``tensors`` against ``DIGESTS[key]`` (the table's
    comment says where the digests come from)."""
    assert checks.factor_digest(tensors) == DIGESTS[key], key


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


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _small(k, a_dtype, dev):
    """(spec, Lt, Rt, A^T) of the small spec at ``k`` factors on ``dev``."""
    spec = generate_instance(200, 300, k, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, a_dtype, dev)
    return spec, torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev), A


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
    before = dense_tiled.tiled_step.launches
    got = dense_tiled.tiled_train(L, R, A, **kw)
    twin = dense_tiled.tiled_train_plain(L, R, A, **kw)
    again = dense_tiled.tiled_train(L, R, A, **kw)
    torch.cuda.synchronize()
    assert dense_tiled.tiled_step.launches == before + 2 * spec.iters
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
    before = dense_tiled.tiled_step.launches, dense_tiled.tiled_deltas.launches
    out, _ = trainer.run(spec, RunConfig(dtype="float32", path="pallas", precision=precision), "cuda")
    # The engine takes the fused step once a step, never the raw deltas.
    assert (dense_tiled.tiled_step.launches, dense_tiled.tiled_deltas.launches) == (before[0] + spec.iters,
                                                                                   before[1])
    assert out == run_oracle(spec)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["warp", "ring"])
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_tiled_fused_step_keeps_the_composition_bits(precision, a_dtype, form):
    # The fused step against B5's raw deltas and the torch update, in raw
    # bits (a -0.0 against +0.0 fails), in each form of its L pass.
    dev = _cuda()
    spec = generate_instance(**_K300)
    L, R, A = _tiled_inputs(dev, spec, a_dtype)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    before = dense_tiled.tiled_deltas.launches
    base = dense_tiled.tiled_train_deltas(L, R, A, **kw)
    assert dense_tiled.tiled_deltas.launches == before + spec.iters
    L0, R0 = L.clone(), R.clone()
    got = dense_tiled.tiled_train(L, R, A, form=form, **kw)
    torch.cuda.synchronize()
    assert checks.same_bits(got, base)
    assert torch.equal(L, L0) and torch.equal(R, R0)
    one = dense_tiled.tiled_gd_step(L, R, A, alpha2=kw["alpha2"], precision=precision, form=form)
    assert checks.same_bits(one, dense_tiled.tiled_train_deltas(L, R, A, **{**kw, "iters": 1}))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 700, 1000])
@pytest.mark.parametrize("form", ["warp", "ring"])
def test_tiled_fused_step_two_runs_same_bits(form, k):
    # K = 32, 704 and 1024; no float atomics in any launch.
    dev = _cuda()
    spec = generate_instance(2000, 100, k, 1, 3, iters=5, alpha=1e-5, seed=42)
    L, R, A = _tiled_inputs(dev, spec)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, form=form)
    first, second = dense_tiled.tiled_train(L, R, A, **kw), dense_tiled.tiled_train(L, R, A, **kw)
    assert checks.same_bits(first, second)
    assert checks.same_bits(first, dense_tiled.tiled_train_deltas(L, R, A, iters=spec.iters, alpha2=kw["alpha2"]))


def _bell_spec(k, stored_zero=False):
    # Rows of 1 to 45 ratings: warps that take several narrow rows and
    # warps that walk a wide row in groups of 32 slots.
    import dataclasses

    spec = generate_instance(120, 90, k, 1, 45, iters=4, alpha=1e-4, seed=k)
    if stored_zero:
        vals = spec.vals.copy()
        vals[::7] = 0.0
        spec = dataclasses.replace(spec, vals=vals)
    return spec


def _bell_inputs(spec, dtype, dev):
    import numpy as np

    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell

    data = bell.make_bell_inputs(spec, dtype)
    L, R = bell.pad_factors_for_bell(init_factors(spec.users, spec.items, spec.features), data, dtype)
    return data, torch.from_numpy(L).to(dev), torch.from_numpy(R).to(dev), bell.device_tables(data.tables, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [10, 30, 320, 704, 1024])
def test_bell_kernel_equals_twin_bit_for_bit(k, dtype):
    import numpy as np

    from recsys_tpu_torch.io import _native
    from recsys_tpu_torch.ops import bell

    dev = _cuda()
    for stored_zero in (False, True):
        spec = _bell_spec(k, stored_zero)
        data, L, R, t = _bell_inputs(spec, getattr(np, dtype), dev)
        a2 = 2.0 * spec.alpha
        before = bell.bell_side_update.launches
        got = bell.bell_train(L, R, t, a2, data.meta, spec.iters)
        again = bell.bell_train(L, R, t, a2, data.meta, spec.iters)
        # The route's form: the inputs are one of the two buffers a side.
        donated = bell.bell_train(L.clone(), R.clone(), t, a2, data.meta, spec.iters, donate=True)
        odd = bell.bell_train(L.clone(), R.clone(), t, a2, data.meta, spec.iters - 1, donate=True)
        twin = bell.bell_train_plain(L, R, t, a2, data.meta, spec.iters)
        twin_odd = bell.bell_train_plain(L, R, t, a2, data.meta, spec.iters - 1)
        torch.cuda.synchronize()
        assert bell.bell_side_update.launches == before + 4 * spec.iters - 1  # one launch a step
        for g, a, d, w in zip(got, again, donated, twin):
            assert torch.equal(g, w)  # the twin's order, bit for bit
            assert torch.equal(g, a)  # no atomics: two runs give the same bits
            assert torch.equal(d, g)
        assert all(torch.equal(o, w) for o, w in zip(odd, twin_odd))
        if dtype == "float64":
            from recsys_tpu_torch.models.mf import init_factors

            st = init_factors(spec.users, spec.items, spec.features)
            want = _native.serial_gd(spec, st.L.copy(), st.R.copy())
            Lo, Ro = bell.unpermute_factors(got[0].cpu().numpy(), got[1].cpu().numpy(), data)
            assert np.array_equal(Lo, want[0]) and np.array_equal(Ro, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 7, 8, 30, 100, 700])
def test_bell_bf16_kernel_equals_twin_in_both_forms(k):
    # The bf16 instance: the JAX package's rounding points in the twin's
    # order, so bit for bit in the block form (the hub row's 1500 slots,
    # at least bell.WIDE_MIN) and in the warp form alone; the two
    # controls differ.  The block form copies a bf16 row in pieces of 2
    # bytes at k = 3 and 7, 16 at k = 8, 4 at k = 30 and 8 at k = 100, 700.
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell

    dev = _cuda()
    for spec in (checks.hub_spec(k), _bell_spec(k, stored_zero=True)):
        init = init_factors(spec.users, spec.items, spec.features)
        data, L, R, t = bell.bell_tensors(spec, init, torch.bfloat16, dev)
        a2 = 2.0 * spec.alpha
        assert L.dtype == torch.bfloat16 and t.uvals.dtype == torch.bfloat16
        before = bell.bell_side_update.launches
        got = bell.bell_train(L, R, t, a2, data.meta, spec.iters)
        warp = bell.bell_train(L, R, t, a2, data.meta, spec.iters, wide=bell.WARP_FORM)
        again = bell.bell_train(L, R, t, a2, data.meta, spec.iters)
        twin = bell.bell_train_plain(L, R, t, a2, data.meta, spec.iters)
        torch.cuda.synchronize()
        assert bell.bell_side_update.launches == before + 3 * spec.iters  # one launch a step
        assert checks.same_bits(got, twin) and checks.same_bits(warp, twin) and checks.same_bits(got, again)
        if spec.users == 300:  # the hub spec: its widest row takes a block
            assert bell.side_warps(data.meta.user).blocks > 0
        for control in (checks.bell_bf16_f32_inside_train, checks.bell_bf16_row_acc_train):
            assert checks.bit_share(control(L, R, t, a2, data.meta, spec.iters), twin) < 1.0


@pytest.mark.cuda
def test_run_bf16_takes_bell_and_holds_agreement():
    from recsys_tpu_torch.ops import bell

    dev = _cuda()
    spec = load_problem(str(FIXTURES / "gen-inst100000-1000-20-1-3.in"))
    cfg = RunConfig(dtype="bfloat16")
    assert trainer.choose_path(spec, cfg, dev) == "bell"
    before = bell.bell_side_update.launches
    out, _ = trainer.run(spec, cfg, dev)
    assert bell.bell_side_update.launches == before + spec.iters  # one launch a step
    want = (FIXTURES / "gen-inst100000-1000-20-1-3.out").read_text().splitlines()
    got = out.splitlines()
    assert len(got) == len(want)
    assert sum(a == b for a, b in zip(got, want)) / len(want) >= 0.98  # the JAX package reads 0.99553


@pytest.mark.cuda
def test_run_instml100k_f64_takes_bell_and_matches_golden():
    from recsys_tpu_torch.ops import bell

    _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    cfg = RunConfig(dtype="float64")
    assert trainer.choose_path(spec, cfg, "cuda") == "bell"
    before = bell.bell_side_update.launches
    out, _ = trainer.run(spec, cfg, "cuda")
    assert bell.bell_side_update.launches == before + spec.iters  # one launch a step
    assert out == (FIXTURES / "instML100k.out").read_text()


@pytest.mark.cuda
def test_p2_kernels_match_twins():
    from recsys_tpu_torch.ops import gather
    from recsys_tpu_torch.probes import mosaic_gather

    dev = _cuda()
    table, idx, vals = mosaic_gather.inputs(dev)
    before = gather.gather_rows.launches, gather.gather_err_grad.launches
    rows = gather.gather_rows(table, idx)
    fused = gather.gather_err_grad(table, idx, vals, mosaic_gather.BLK)
    torch.cuda.synchronize()
    assert (gather.gather_rows.launches, gather.gather_err_grad.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(rows, table.index_select(0, idx.long()))
    twin = gather.gather_err_grad_plain(table, idx, vals, mosaic_gather.BLK)
    assert float((fused - twin).abs().max()) <= checks.GATHER_ERR_GRAD_RTOL * float(twin.abs().max())
    # The kernel moves float4s: other widths raise, never fall back.
    with pytest.raises(ValueError, match="K % 4"):
        gather.gather_rows(table[:, :5].contiguous(), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [30, 100, 128, 700])
@pytest.mark.parametrize("S", [176_128, 1001])
def test_gather_err_grad_grouped_keeps_the_direct_bits(K, S):
    # Two slots a warp through K = 512, one at K = 700; an S that is no
    # multiple of the group leaves a ragged last group.  The digests are the
    # form it replaced (a warp a slot)'s bits.
    from recsys_tpu_torch.ops import gather
    from recsys_tpu_torch.probes import mosaic_gather

    dev = _cuda()
    table, idx, vals = mosaic_gather.inputs(dev, mosaic_gather.N, K, S)
    before = gather.gather_err_grad.launches
    got = gather.gather_err_grad(table, idx, vals, mosaic_gather.BLK)
    again = gather.gather_err_grad(table, idx, vals, mosaic_gather.BLK)
    twin = gather.gather_err_grad_plain(table, idx, vals, mosaic_gather.BLK)
    torch.cuda.synchronize()
    assert checks.same_bits(got, again)
    _check_digest(f"gather_err_grad K{K} S{S}", got)
    assert float((got - twin).abs().max()) <= checks.GATHER_ERR_GRAD_RTOL * float(twin.abs().max())
    assert gather.gather_err_grad.launches == before + 2
    with pytest.raises(ValueError, match="K="):
        gather.gather_err_grad(torch.zeros((8, gather.MAX_K + 4), device=dev), idx[:4].remainder(8), vals[:4], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512), (8, 2048), (5, 1000), (24, 8192), (8, 32768), (1, 58112)])
def test_lane_gather_equals_twin_bit_for_bit(shape):
    import numpy as np

    from recsys_tpu_torch.ops import lane
    from recsys_tpu_torch.probes import gather as probe

    assert shape[1] <= lane.GATHER_MAX_W
    dev = _cuda()
    tab, idx = probe.gather_inputs(*shape, dev, np.random.default_rng(0))
    before = lane.lane_gather_loop.launches
    # Full-width and broadcast indices; all in one bank, and all one address
    # (the schedule's overflow: a bucket past its rounds).
    for ix in (idx, idx[:1].expand_as(idx).contiguous(), idx // 32 * 32, torch.zeros_like(idx)):
        got = lane.lane_gather_loop(tab, ix, 7)
        torch.cuda.synchronize()
        assert checks.same_bits(got, lane.lane_gather_loop_plain(tab, ix, 7))
    assert lane.lane_gather_loop.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512), (4, 96), (3, 1056), (2, 3040), (3, 8192), (2, 32768), (8, 32768)])
def test_lane_cumsum_within_limit_and_control_rejected(shape):
    import numpy as np

    from recsys_tpu_torch.ops import lane

    dev = _cuda()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32)).to(dev)
    before = lane.lane_cumsum_loop.launches
    got = lane.lane_cumsum_loop(x, 5)
    twin = lane.lane_cumsum_loop_plain(x, 5)
    torch.cuda.synchronize()
    assert lane.lane_cumsum_loop.launches == before + 1
    # The kernel sums in its own order: equal to it in raw bits, and within
    # the limit of torch's order.
    assert checks.same_bits(got, lane.lane_cumsum_loop_order_plain(x, 5))
    scale = float(twin.abs().max())
    assert float((got - twin).abs().max()) <= checks.LANE_CUMSUM_RTOL * scale
    assert float((checks.lane_cumsum_dropped(x) - twin).abs().max()) > checks.LANE_CUMSUM_RTOL * scale
    assert torch.equal(got, lane.lane_cumsum_loop(x, 5))


@pytest.mark.cuda
def test_lane_cumsum_every_cluster_size_keeps_the_bits():
    import numpy as np

    from recsys_tpu_torch.ops import _build, lane
    from recsys_tpu_torch.ops.dense_fused import _ptrs
    from recsys_tpu_torch.ops.dense_stream import _sms, _stream

    dev = _cuda()
    rng = np.random.default_rng(3)
    # Shapes at which the plan picks each cluster size it allows.
    sizes = set()
    for S, W in ((4, 96), (2, 64), (24, 8192), (8, 32768)):
        x = torch.from_numpy(rng.standard_normal((S, W)).astype(np.float32)).to(dev)
        sizes.add(lane.cumsum_cluster_plan(S, W, _sms(dev))[2])
        assert checks.same_bits(lane.lane_cumsum_loop(x, 3), lane.lane_cumsum_loop_order_plain(x, 3))
    assert sizes == {1, 2, 4, 8}
    # The entry refuses a cluster it does not take: 16 blocks (past the
    # portable size), or blocks of 512 threads of 32 elements; nothing runs.
    x = torch.from_numpy(rng.standard_normal((3, 32768)).astype(np.float32)).to(dev)
    out = torch.zeros_like(x)
    for C in (16, 2):
        with torch.cuda.device(dev):
            rc = _build.load().rs_lane_cumsum_loop(*_ptrs(x, out), 3, 32768, C, 3, None, _stream(dev))
        assert rc != 0
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [8, 50])
def test_stream_v2_equals_b3_and_matches_twin(a_dtype, k):
    from recsys_tpu_torch.ops import stream_v2
    from recsys_tpu_torch.probes import stream_v2 as probe

    dev = _cuda()
    spec = generate_instance(40, 700, k, 2, 8, iters=5, alpha=0.01, seed=7)
    Lt, Rt, Rp, A, At = probe.inputs(spec, probe.SMALL_STRIP, dev, a_dtype)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, strip=probe.SMALL_STRIP)
    before = stream_v2.stream_v2_train.launches
    got = stream_v2.stream_v2_train(Lt, Rp, A, **kw)
    b3 = dense_stream.stream_train(Lt, Rt, At, iters=spec.iters, alpha2=2 * spec.alpha)
    torch.cuda.synchronize()
    assert stream_v2.stream_v2_train.launches == before + 1
    assert torch.equal(got[0], b3[0]) and torch.equal(got[1], stream_v2.pack_R(b3[1], probe.SMALL_STRIP))
    twin = stream_v2.stream_v2_train_plain(Lt, Rp, A, **kw)
    assert checks.factor_rel(got, twin) <= checks.STREAM_V2_RTOL
    assert checks.factor_rel(checks.stream_v2_default(Lt, Rp, A, **kw), twin) > checks.STREAM_V2_RTOL


@pytest.mark.cuda
def test_device_glibc_stream_equals_host():
    import numpy as np

    from recsys_tpu_torch.io.glibc_random import GlibcRandom
    from recsys_tpu_torch.ops import device_rng

    dev = _cuda()
    st = device_rng.DeviceGlibcStream(0, block=1000, device=dev)
    words = torch.cat([st.raw32(3517), st.raw32(1311)]).cpu()
    np.testing.assert_array_equal((words >> 1).numpy(), GlibcRandom(0).raw(3517 + 1311))
    L, R = device_rng.device_init_factors(37, 23, 6, device=dev, block=100)
    Lc, Rc = device_rng.device_init_factors(37, 23, 6, block=100)
    assert torch.equal(L.cpu(), Lc) and torch.equal(R.cpu(), Rc)


# (n,): a stream shorter than one segment, either side of a segment and of
# a block's span (256 segments of 1024 draws), and ragged over many blocks.
GLIBC_COUNTS = [1, 5, 1023, 1024, 1025, 262143, 262145, 3 * 262144 + 12345]
# (users, items, k): k = 1, odd k, the L/R split inside a segment
# (users * k not a multiple of 1024), R longer than L, one segment in all.
GLIBC_SHAPES = [(1, 1, 1), (37, 23, 6), (1000, 7, 13), (3, 501, 7), (300, 100, 700), (2000, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", GLIBC_COUNTS)
def test_glibc_kernel_words_equal_the_host_generator(n):
    import numpy as np

    from recsys_tpu_torch.io.glibc_random import GlibcRandom
    from recsys_tpu_torch.ops import device_rng

    dev = _cuda()
    before = device_rng.glibc_stream.launches
    words = device_rng.glibc_stream(n, device=dev)
    torch.cuda.synchronize()
    assert device_rng.glibc_stream.launches == before + 1
    assert words.dtype == torch.int64 and words.shape == (n,)
    twin = device_rng.glibc_stream(n, block=1000)
    assert torch.equal(words.cpu(), twin)
    np.testing.assert_array_equal((words.cpu() >> 1).numpy(), GlibcRandom(0).raw(n))


@pytest.mark.cuda
@pytest.mark.parametrize("users,items,k", GLIBC_SHAPES)
def test_glibc_kernel_factors_equal_the_twins_bits(users, items, k):
    from recsys_tpu_torch.ops import device_rng

    dev = _cuda()
    before = device_rng.glibc_stream.launches
    L, R = device_rng.device_init_factors(users, items, k, device=dev)
    torch.cuda.synchronize()
    assert device_rng.glibc_stream.launches == before + 1
    Lc, Rc = device_rng.device_init_factors(users, items, k, block=1000)
    assert L.shape == Lc.shape and R.shape == Rc.shape and R.stride() == Rc.stride()
    assert checks.same_bits(L.cpu(), Lc) and checks.same_bits(R.cpu(), Rc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_coo_route_two_runs_same_bits_and_golden(dtype):
    _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    cfg = RunConfig(dtype=dtype, path="coo")
    assert trainer._coo_use_cumsum(spec, cfg, "cuda") == (dtype == "float32")
    a = trainer.factorize(spec, cfg, "cuda")
    b = trainer.factorize(spec, cfg, "cuda")
    import numpy as np

    assert np.array_equal(a.L, b.L) and np.array_equal(a.R, b.R)
    out, _ = trainer.run(spec, cfg, "cuda")
    want = (FIXTURES / "instML100k.out").read_text().splitlines()
    got = out.splitlines()
    assert len(got) == len(want) and sum(x == y for x, y in zip(got, want)) / len(want) >= 0.99


@pytest.mark.cuda
def test_run_coo_f64_matches_golden_on_card():
    _cuda()
    spec = load_problem(str(FIXTURES / "inst30-40-10-2-10.in"))
    out, _ = trainer.run(spec, RunConfig(dtype="float64", path="coo"), "cuda")
    assert out == (FIXTURES / "inst30-40-10-2-10.out").read_text()


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("k", [30, 40])
def test_sparse_stream_equals_dense_bit_for_bit(k, precision, a_dtype):
    # B3's walk of the rated cells keeps the dense pass's order of sums: the
    # digests are the dense pass's bits, at k = 30 (G = 1) and k = 40 (G = 2).
    dev = _cuda()
    spec, Lt, Rt, A = _small(k, a_dtype, dev)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    before = dense_stream.stream_train.launches
    got = dense_stream.stream_train(Lt, Rt, A, **kw)
    again = dense_stream.stream_train(Lt, Rt, A, **kw)
    twin = dense_stream.stream_train_plain(Lt, Rt, A, **kw)
    torch.cuda.synchronize()
    assert dense_stream.stream_train.launches == before + 2
    assert checks.same_bits(got, again)
    _check_digest(f"stream k{k} {precision} {_name(a_dtype)}", *got)
    assert checks.factor_rel(got, twin) <= checks.FACTOR_RTOL[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("spec_name", ["k30", "k704 stored zeros", "hub k30", "hub k700"])
def test_bell_block_form_equals_warp_form(spec_name, dtype):
    # Low thresholds send the small specs' buckets to the block form; the
    # hub specs hold one row far wider than the rest.
    import numpy as np

    from recsys_tpu_torch.ops import bell

    dev = _cuda()
    spec = {"k30": lambda: _bell_spec(30), "k704 stored zeros": lambda: _bell_spec(704, True),
            "hub k30": lambda: checks.hub_spec(30), "hub k700": lambda: checks.hub_spec(700, 1)}[spec_name]()
    data, L, R, t = _bell_inputs(spec, getattr(np, dtype), dev)
    a2 = 2.0 * spec.alpha
    warp = bell.bell_train(L, R, t, a2, data.meta, spec.iters, wide=bell.WARP_FORM)
    twin = bell.bell_train_plain(L, R, t, a2, data.meta, spec.iters)
    widest = max(w for side in (data.meta.user, data.meta.item) for *_, w in side.bounds)
    for wide in (1, 16, bell.WIDE_MIN):
        # A threshold at or under the widest bucket sends its rows to blocks.
        blocks = bell.side_warps(data.meta.user, wide).blocks + bell.side_warps(data.meta.item, wide).blocks
        assert (blocks > 0) == (widest >= wide)
        got = bell.bell_train(L, R, t, a2, data.meta, spec.iters, wide=wide)
        torch.cuda.synchronize()
        assert checks.same_bits(got, warp)
        assert checks.same_bits(got, twin)
    # One side update in the block form, through the single-launch wrapper.
    one = bell.bell_side_update(L, R, t.ucols, t.uvals, data.meta.user, a2, wide=1)
    assert checks.same_bits(one, bell.bell_side_update_plain(L, R, t.ucols, t.uvals, data.meta.user, a2))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_sparse_stream_with_empty_last_segments(precision):
    # The last user block and the last 100 items hold no rated cell, so the
    # walk's last segments are empty and start at nnz, the tables' end.
    dev = _cuda()
    g = torch.Generator().manual_seed(3)
    At = torch.zeros((384, 256), dtype=torch.int8)
    rated = torch.rand((284, 128), generator=g) < 0.05
    At[:284, :128] = torch.randint(1, 11, rated.shape, generator=g, dtype=torch.int8) * rated
    Lt, Rt = (0.1 * torch.rand((32, n), generator=g) for n in (256, 384))
    At, Lt, Rt = At.to(dev), Lt.to(dev), Rt.to(dev)
    kw = dict(iters=4, alpha2=0.002, precision=precision)
    got = dense_stream.stream_train(Lt, Rt, At, **kw)
    again = dense_stream.stream_train(Lt, Rt, At, **kw)
    torch.cuda.synchronize()
    assert checks.same_bits(got, again)
    _check_digest(f"stream empty segments {precision}", *got)
    assert checks.factor_rel(got, dense_stream.stream_train_plain(Lt, Rt, At, **kw)) <= checks.FACTOR_RTOL[precision]


def _resident(Lt, Rt, A, kw, items_true, split=None):
    """B1 twice and B2 once, one walk between them: (B1's (Lt', Rt', top1),
    the second run's, B2's (Lt', Rt'))."""
    walk = dense_fused.resident_walk(A, Lt.shape[0], split)
    top = dict(items_true=items_true, split=split)
    b1 = dense_fused.resident_train_top1(Lt, Rt, A, **kw, **top, walk=walk)
    again = dense_fused.resident_train_top1(Lt, Rt, A, **kw, **top, walk=walk)
    b2 = dense_fused.resident_train(Lt, Rt, A, **kw, walk=walk, split=split)
    torch.cuda.synchronize()
    return b1, again, b2


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("k", [10, 40, 64])
def test_sparse_resident_equals_dense_bit_for_bit(k, precision, a_dtype):
    # B1's and B2's walk of the rated cells keeps the dense walk's order of
    # sums: the digests are the dense walk's raw bits, at k = 10 (G = 1) and
    # k = 40 and 64 (G = 2).
    dev = _cuda()
    spec, Lt, Rt, A = _small(k, a_dtype, dev)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    wrappers = (dense_fused.resident_train_top1, dense_fused.resident_train)
    before = [f.launches for f in wrappers]
    b1, again, b2 = _resident(Lt, Rt, A, kw, spec.items)
    # Each wrapper counts one a call: two B1 calls, one B2.
    assert [f.launches for f in wrappers] == [before[0] + 2, before[1] + 1]
    assert checks.same_bits(b1, again)
    _check_digest(f"resident k{k} {precision} {_name(a_dtype)}", *b1)
    assert checks.same_bits(b2, b1[:2])  # B2 = B1's factors
    # B4 on B1's factors is B1's top-1.
    assert torch.equal(dense_stream.stream_top1(*b1[:2], A, precision=precision, items_true=spec.items), b1[2])
    twin = dense_fused.resident_train_plain(Lt, Rt, A, **kw)
    assert checks.factor_rel(b1[:2], twin) <= checks.FACTOR_RTOL[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_sparse_resident_equals_dense_at_instml100k_shape(precision):
    dev = _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, torch.int8, dev)
    Lt, Rt = torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev)
    kw = dict(iters=checks.FACTOR_ITERS, alpha2=2 * spec.alpha, precision=precision)
    b1, again, b2 = _resident(Lt, Rt, A, kw, spec.items)
    assert checks.same_bits(b1, again)
    _check_digest(f"resident instML100k {precision}", *b1)
    assert checks.same_bits(b2, b1[:2])
    assert checks.factor_rel(b1[:2], dense_fused.resident_train_plain(Lt, Rt, A, **kw)) <= checks.FACTOR_RTOL[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_sparse_resident_with_empty_columns_chunks_and_last_segments(precision):
    # User 5, users 156 on, one item chunk and items 284 on hold no rated
    # cell (tests/test_torch_resident_sparse.py::_edge_At): those partials
    # are +0, and the last segments start at nnz, the tables' end.
    dev = _cuda()
    g = torch.Generator().manual_seed(3)
    At = torch.zeros((384, 256), dtype=torch.int8)
    rated = torch.rand((284, 156), generator=g) < 0.08
    At[:284, :156] = torch.randint(1, 11, rated.shape, generator=g, dtype=torch.int8) * rated
    At[:, 5] = 0
    At[64:128] = 0
    Lt, Rt = (0.1 * torch.rand((32, n), generator=g) for n in (256, 384))
    At, Lt, Rt = At.to(dev), Lt.to(dev), Rt.to(dev)
    kw = dict(iters=4, alpha2=0.002, precision=precision)
    b1, again, b2 = _resident(Lt, Rt, At, kw, 284, split=(64, 6, 64, 4))
    assert checks.same_bits(b1, again)
    _check_digest(f"resident empty columns {precision}", *b1)
    assert checks.same_bits(b2, b1[:2])
    assert torch.equal(b2[0][:, 5], Lt[:, 5]) and torch.equal(b2[1][:, 64:128], Rt[:, 64:128])


def _trained(spec, dev, precision, a_dtype):
    """(Lt, Rt, At): the padded glibc factors after ``FACTOR_ITERS`` steps
    of B3 in ``precision``, and A^T in ``a_dtype``."""
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, dev)
    Lt, Rt = torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev)
    Lt, Rt = dense_stream.stream_train(Lt, Rt, At, iters=checks.FACTOR_ITERS, alpha2=2.0 * spec.alpha,
                                       precision=precision)
    return Lt, Rt, At


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("k", [10, 40, 256])
def test_tiled_top1_equals_dense_bit_for_bit(k, precision, a_dtype):
    # B4 keeps the scores of the form it replaced (a thread a user): the
    # digests are that form's raw bits of each user's index and best score,
    # at G = 1, 2 and 8 lanes' worth of K.
    dev = _cuda()
    spec = generate_instance(200, 300, k, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)
    Lt, Rt, At = _trained(spec, dev, precision, a_dtype)
    before = dense_stream.stream_top1.launches
    kw = dict(precision=precision, items_true=spec.items)
    got = dense_stream.stream_top1_scores(Lt, Rt, At, **kw)
    again = dense_stream.stream_top1_scores(Lt, Rt, At, **kw)
    torch.cuda.synchronize()
    assert dense_stream.stream_top1.launches == before + 2
    assert torch.equal(got[0], again[0]) and checks.same_bits(got[1], again[1])
    _check_digest(f"top1 k{k} {precision} {_name(a_dtype)}", *got)
    assert torch.equal(dense_stream.stream_top1(Lt, Rt, At, **kw), got[0])
    assert torch.equal(got[0], dense_stream.stream_top1_plain(Lt, Rt, At, **kw))


@pytest.mark.cuda
def test_top1_forms_on_ties_padding_and_rated_bests():
    dev = _cuda()
    K, U = 8, 128
    ones, zeros = torch.ones((K, U), device=dev), torch.zeros((U, U), device=dev)
    top, best = dense_stream.stream_top1_scores(ones, ones, zeros, items_true=U)
    assert bool((top == 0).all()) and bool((best == K).all())
    g = torch.Generator().manual_seed(4)
    Lt, Rt = torch.rand((40, 256), generator=g).to(dev), torch.rand((40, 384), generator=g).to(dev)
    Rt[:, 300:] += 5.0  # the highest scores lie past items_true
    At = torch.zeros((384, 256), dtype=torch.int8, device=dev)
    first = dense_stream.stream_top1_plain(Lt, Rt, At, items_true=300)[0].long()
    At[first, torch.arange(256, device=dev)] = 6  # each user's best unrated cell becomes rated
    top, _ = dense_stream.stream_top1_scores(Lt, Rt, At, items_true=300)
    torch.cuda.synchronize()
    assert int(top.max()) < 300 and not bool((top[0].long() == first).any())
    assert torch.equal(top, dense_stream.stream_top1_plain(Lt, Rt, At, items_true=300))


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [8, 40])
def test_stream_v2_sparse_equals_dense_and_b3_dense(a_dtype, k):
    # P3 keeps B3's bits (a cross-kernel identity in raw bits) and the dense
    # form's it replaced (the digests).
    from recsys_tpu_torch.ops import stream_v2
    from recsys_tpu_torch.probes import stream_v2 as probe

    dev = _cuda()
    spec = generate_instance(40, 700, k, 2, 8, iters=checks.FACTOR_ITERS, alpha=0.01, seed=7)
    Lt, Rt, Rp, A, At = probe.inputs(spec, probe.SMALL_STRIP, dev, a_dtype)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, strip=probe.SMALL_STRIP)
    before = stream_v2.stream_v2_train.launches
    walk = stream_v2.v2_walk(A, Lt.shape[0])
    got = stream_v2.stream_v2_train(Lt, Rp, A, walk=walk, **kw)
    again = stream_v2.stream_v2_train(Lt, Rp, A, walk=walk, **kw)
    b3 = dense_stream.stream_train(Lt, Rt, At, iters=spec.iters, alpha2=2 * spec.alpha)
    torch.cuda.synchronize()
    assert stream_v2.stream_v2_train.launches == before + 2
    assert checks.same_bits(got, again)
    _check_digest(f"stream_v2 k{k} {_name(a_dtype)}", *got)
    assert checks.same_bits(got, (b3[0], stream_v2.pack_R(b3[1], probe.SMALL_STRIP)))
    other = stream_v2.v2_walk(A, Lt.shape[0], sms=1)
    if other.split != walk.split:
        with pytest.raises(ValueError, match="split"):
            stream_v2.stream_v2_train(Lt, Rp, A, walk=other, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_bell_side_delta_matches_twin_bits(dtype):
    # The delta form of bell_side_update, both forms, on every shard of a
    # 2x4 checkerboard with hub rows of ~375 slots a shard (the block form).
    import numpy as np

    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell

    dev = _cuda()
    spec = checks.hub_spec(30)
    data = bell.make_sharded_bell(spec, 2, 4, np.float64)
    m, a2 = data.meta, 2 * spec.alpha
    Lp, Rp = (torch.from_numpy(x).to(dev, dtype) for x in
              bell.pad_factors_sharded_bell(init_factors(spec.users, spec.items, spec.features), data, np.float64))
    before = bell.bell_side_delta.launches
    for ub in range(2):
        for ib in range(4):
            t = bell.shard_tables(data.tables, ub, ib, dev, dtype)
            l, r = Lp[ub * (m.u_blk + 1):(ub + 1) * (m.u_blk + 1)], Rp[ib * (m.i_blk + 1):(ib + 1) * (m.i_blk + 1)]
            for own, other, cols, vals, side in ((l, r, t.ucols, t.uvals, m.user), (r, l, t.irows, t.ivals, m.item)):
                twin = bell.bell_side_delta_plain(own, other, cols, vals, side, a2)
                for wide in (bell.WIDE_MIN, bell.WARP_FORM):
                    got = bell.bell_side_delta(own, other, cols, vals, side, a2, wide=wide)
                    torch.cuda.synchronize()
                    assert checks.same_bits(got, twin)
    assert bell.bell_side_delta.launches == before + 2 * 2 * 8


@pytest.mark.cuda
def test_sharded_tiled_route_launches_tiled_deltas():
    # The sharded tiled route runs B5's raw deltas once a shard and step.
    from recsys_tpu_torch.parallel import engine as par

    dev = _cuda()
    spec = generate_instance(32, 40, 10, 2, 8, iters=7, alpha=0.01, seed=11)
    cfg = RunConfig(dtype="float32", mesh_shape=(2, 2))
    before = dense_tiled.tiled_deltas.launches
    got, mesh = par.factorize_sharded(spec, cfg, device=dev)
    torch.cuda.synchronize()
    assert par.sharded_route(spec, cfg, mesh) == "tiled"
    assert dense_tiled.tiled_deltas.launches == before + 7 * 4
    want, _ = par.factorize_sharded(spec, cfg, device="cpu")
    assert checks.factor_rel((got.L, got.R), (want.L.to(dev), want.R.to(dev))) <= checks.TILED_FACTOR_RTOL["highest"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,path", [("float32", "auto"), ("float64", "bell")])
def test_world_of_one_rank_over_nccl_keeps_the_bits(dtype, path):
    # One rank over NCCL on the card: the multi-process mesh's gathers run
    # over the world of one; the factors equal the one-process engine's.
    from recsys_tpu_torch.parallel import engine as par
    from recsys_tpu_torch.parallel import launch, multihost

    dev = _cuda()
    spec = generate_instance(40, 60, 6, 1, 8, iters=12, alpha=0.01, seed=5)
    cfg = RunConfig(dtype=dtype, path=path, mesh_shape=(2, 2))
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, device=torch.device("cuda", 0))
    try:
        state, mesh = multihost.factorize_multihost(spec, cfg, device=torch.device("cuda", 0))
        assert mesh.groups is not None
        digest = checks.factor_digest(state)
    finally:
        multihost.shutdown()
    want, _ = par.factorize_sharded(spec, cfg, device=dev)
    assert digest == checks.factor_digest(want)


@pytest.mark.cuda
def test_two_ranks_over_gloo_on_one_card_keep_the_bits():
    # Two ranks share the card over gloo (NCCL refuses two ranks on one GPU).
    import json

    from recsys_tpu_torch.parallel import engine as par
    from recsys_tpu_torch.parallel import launch

    dev = _cuda()
    gen = [40, 60, 6, 1, 8, 12, 0.01, 5]
    cases = [{"name": f"{dtype} {path}", "gen": gen, "dtype": dtype, "path": path, "mesh": [2, 2]}
             for dtype, path in (("float32", "auto"), ("float64", "bell"))]
    lines = launch.rank_lines(launch.spawn(2, ["--device", "cuda:0", "--backend", "gloo", "--cases",
                                               json.dumps(cases)], 300))
    spec = generate_instance(*gen[:5], iters=gen[5], alpha=gen[6], seed=gen[7])
    for case in cases:
        want, _ = par.factorize_sharded(spec, launch.case_config(case), device=dev)
        got = {x["factors_sha256"] for rank in lines for x in rank if x["case"] == case["name"]}
        assert got == {checks.factor_digest(want)}


# checks.factor_digest of each engine form's raw output in the tests above
# (the case's key), read on an NVIDIA H100 80GB HBM3 from kernels that were
# shown equal in raw bits to the forms they replaced, which the repository
# no longer holds (PERF.md section 6): the dense walks of B1, B2 and B3, B4's
# thread-a-user form, P3's dense form and P2's warp-a-slot form.
DIGESTS = {
    "gather_err_grad K100 S1001": "e372e3cdb0b4edfa6e879e0229ae9a3079d56626705e151e3671ddf36977ceb2",
    "gather_err_grad K100 S176128": "da56163d296824c2d3ec8db99fbea8898b3e6e69eb429770016126f769114c91",
    "gather_err_grad K128 S1001": "634c28b4d50a7004f8db3de3a29bb643e796f9e33753500495eb55d3627b662c",
    "gather_err_grad K128 S176128": "3faea478b419f982bfca5f07ade5b635dc7155c8ace0ed0c84325636502f1900",
    "gather_err_grad K30 S1001": "d0c945741be3798457b2598548252f90445614f67062f443c0912e72211620ff",
    "gather_err_grad K30 S176128": "42590cf005af1bff9320741358acb4c31401f3a3584160b2a57e0e3a5ce27d0a",
    "gather_err_grad K700 S1001": "ce2e679ce36039247e5bd7aaba696a3fcdd20bb654c1d99457ac9a3a7cd89958",
    "gather_err_grad K700 S176128": "4bd453ecbdeead9833c18cb2ac746ca0ae1cd5a6ec4a33ccab7e9366ed87d3bb",
    "resident empty columns bf16x3": "cf7be2f491a3d0dc98d855549c41e112ed3d7e4303fc801a3122658f6195abc9",
    "resident empty columns default": "ed7e00d9f85b001909201d9a12d629471f05a33600003ae3e6daabce2dbad025",
    "resident empty columns highest": "51a75c555dc6baeaa8550c84c96ba5d84c4fdd5c81b5b79aa37a311daa4bf7e1",
    "resident instML100k bf16x3": "c47848061844d8921fb0a55c699d56d86da98391f8670018f2986e22faf80aaf",
    "resident instML100k default": "66ed7c02b7a8b664afe83290050e3b2c0b98006c0ca679d5b0d1ff180a485595",
    "resident instML100k highest": "71dfc4b1039cef604d75e4f7deb318177deaa70fccb7ea89fa6f0b0d0f92385e",
    "resident k10 bf16x3 bfloat16": "38ad1a4a0eed35a62fc4e947b249a5dda76bc866055b45daf2a5d3c63dba727f",
    "resident k10 bf16x3 float32": "38ad1a4a0eed35a62fc4e947b249a5dda76bc866055b45daf2a5d3c63dba727f",
    "resident k10 bf16x3 int8": "38ad1a4a0eed35a62fc4e947b249a5dda76bc866055b45daf2a5d3c63dba727f",
    "resident k10 default bfloat16": "93cf06f21a91128d53d5295098fb4f99b05515ec592799004eaa5a302d9211f5",
    "resident k10 default float32": "93cf06f21a91128d53d5295098fb4f99b05515ec592799004eaa5a302d9211f5",
    "resident k10 default int8": "93cf06f21a91128d53d5295098fb4f99b05515ec592799004eaa5a302d9211f5",
    "resident k10 highest bfloat16": "754c585ff04bf6611981bad23060ae0bb9ccc314c9a5855a925d77dd008a32ad",
    "resident k10 highest float32": "754c585ff04bf6611981bad23060ae0bb9ccc314c9a5855a925d77dd008a32ad",
    "resident k10 highest int8": "754c585ff04bf6611981bad23060ae0bb9ccc314c9a5855a925d77dd008a32ad",
    "resident k40 bf16x3 bfloat16": "dec1b8304424980d2f175832f65aeca0c747bed1788bca0555418e35bb6a36ea",
    "resident k40 bf16x3 float32": "dec1b8304424980d2f175832f65aeca0c747bed1788bca0555418e35bb6a36ea",
    "resident k40 bf16x3 int8": "dec1b8304424980d2f175832f65aeca0c747bed1788bca0555418e35bb6a36ea",
    "resident k40 default bfloat16": "a10fdc88a08f9397367317fdd54601c26c614dcac92eb03bc3e50ea7afa9665f",
    "resident k40 default float32": "a10fdc88a08f9397367317fdd54601c26c614dcac92eb03bc3e50ea7afa9665f",
    "resident k40 default int8": "a10fdc88a08f9397367317fdd54601c26c614dcac92eb03bc3e50ea7afa9665f",
    "resident k40 highest bfloat16": "476b598315ff3b5cad783009d6046b602647836bc6dce64a0153123f44b33557",
    "resident k40 highest float32": "476b598315ff3b5cad783009d6046b602647836bc6dce64a0153123f44b33557",
    "resident k40 highest int8": "476b598315ff3b5cad783009d6046b602647836bc6dce64a0153123f44b33557",
    "resident k64 bf16x3 bfloat16": "6f96a7b5c6d663c9e7b3d8e19f688b50128833ded249d5586de182025bfe595e",
    "resident k64 bf16x3 float32": "6f96a7b5c6d663c9e7b3d8e19f688b50128833ded249d5586de182025bfe595e",
    "resident k64 bf16x3 int8": "6f96a7b5c6d663c9e7b3d8e19f688b50128833ded249d5586de182025bfe595e",
    "resident k64 default bfloat16": "8c2f8f36c0400e5e79692176fb214dea01810c8b71953c3f7e1aec130c0c3641",
    "resident k64 default float32": "8c2f8f36c0400e5e79692176fb214dea01810c8b71953c3f7e1aec130c0c3641",
    "resident k64 default int8": "8c2f8f36c0400e5e79692176fb214dea01810c8b71953c3f7e1aec130c0c3641",
    "resident k64 highest bfloat16": "a66ff220c9120d7ff5eec088fbce21da2706ed77463a98bc413cd2427c7e1510",
    "resident k64 highest float32": "a66ff220c9120d7ff5eec088fbce21da2706ed77463a98bc413cd2427c7e1510",
    "resident k64 highest int8": "a66ff220c9120d7ff5eec088fbce21da2706ed77463a98bc413cd2427c7e1510",
    "stream empty segments bf16x3": "58210de17f80efd17145c91f71a2c471597d8d6b5245b0ae2fa91afe5b73764d",
    "stream empty segments default": "b24e28f4ab4da88cfd895a4d327f2439b0363c051cbacc53d7879c0cc1a19ee6",
    "stream empty segments highest": "d899b6bab4ff4b2b5966c45d78d855c3ab7e73603c374e2f403549b662eeafd0",
    "stream k30 bf16x3 bfloat16": "6117a07d916cc41fcdb182a58746e9163c5e3d2bd1da63085f52003504c96d20",
    "stream k30 bf16x3 float32": "6117a07d916cc41fcdb182a58746e9163c5e3d2bd1da63085f52003504c96d20",
    "stream k30 bf16x3 int8": "6117a07d916cc41fcdb182a58746e9163c5e3d2bd1da63085f52003504c96d20",
    "stream k30 default bfloat16": "300395dd82f928a47e7a3fc7fedbd1f9f522c7ec509d5630e3fbc476d079f4cc",
    "stream k30 default float32": "300395dd82f928a47e7a3fc7fedbd1f9f522c7ec509d5630e3fbc476d079f4cc",
    "stream k30 default int8": "300395dd82f928a47e7a3fc7fedbd1f9f522c7ec509d5630e3fbc476d079f4cc",
    "stream k30 highest bfloat16": "c88399c8aa5c6bc60df6c97e25e08d94eee1b3ce4e88c0ced676c996ca761790",
    "stream k30 highest float32": "c88399c8aa5c6bc60df6c97e25e08d94eee1b3ce4e88c0ced676c996ca761790",
    "stream k30 highest int8": "c88399c8aa5c6bc60df6c97e25e08d94eee1b3ce4e88c0ced676c996ca761790",
    "stream k40 bf16x3 bfloat16": "c0ff625f8db47108bb6ae36b849d1139dbb961cce29b5c3dba889f7a6b0a28e2",
    "stream k40 bf16x3 float32": "c0ff625f8db47108bb6ae36b849d1139dbb961cce29b5c3dba889f7a6b0a28e2",
    "stream k40 bf16x3 int8": "c0ff625f8db47108bb6ae36b849d1139dbb961cce29b5c3dba889f7a6b0a28e2",
    "stream k40 default bfloat16": "157c5a79e0bd4cb5fb1ce0dc1e78414f65d1c817513908b421b654a7048c31b7",
    "stream k40 default float32": "157c5a79e0bd4cb5fb1ce0dc1e78414f65d1c817513908b421b654a7048c31b7",
    "stream k40 default int8": "157c5a79e0bd4cb5fb1ce0dc1e78414f65d1c817513908b421b654a7048c31b7",
    "stream k40 highest bfloat16": "9818dca9edc767c741a15652ca32d5295fa1f6ef4f0f444935d66b554497ecf8",
    "stream k40 highest float32": "9818dca9edc767c741a15652ca32d5295fa1f6ef4f0f444935d66b554497ecf8",
    "stream k40 highest int8": "9818dca9edc767c741a15652ca32d5295fa1f6ef4f0f444935d66b554497ecf8",
    "stream_v2 k40 bfloat16": "37e9969b3c080dfb3484056496a27bd0a2ccf746c604405fc05a8e4070de94fb",
    "stream_v2 k40 float32": "37e9969b3c080dfb3484056496a27bd0a2ccf746c604405fc05a8e4070de94fb",
    "stream_v2 k40 int8": "37e9969b3c080dfb3484056496a27bd0a2ccf746c604405fc05a8e4070de94fb",
    "stream_v2 k8 bfloat16": "31cc85ece9ab212804ba3446dd8bb900941eba724300276a98c78758af87959e",
    "stream_v2 k8 float32": "31cc85ece9ab212804ba3446dd8bb900941eba724300276a98c78758af87959e",
    "stream_v2 k8 int8": "31cc85ece9ab212804ba3446dd8bb900941eba724300276a98c78758af87959e",
    "top1 k10 bf16x3 bfloat16": "99a5223987ffad3352167f01c826f2b8a9a92a55b421647114afcef7f7b4a47c",
    "top1 k10 bf16x3 float32": "99a5223987ffad3352167f01c826f2b8a9a92a55b421647114afcef7f7b4a47c",
    "top1 k10 bf16x3 int8": "99a5223987ffad3352167f01c826f2b8a9a92a55b421647114afcef7f7b4a47c",
    "top1 k10 default bfloat16": "d2a6ccccb8ba0c235d8e3c4075197a798a12b2711b106a1cfa144cd9378337ff",
    "top1 k10 default float32": "d2a6ccccb8ba0c235d8e3c4075197a798a12b2711b106a1cfa144cd9378337ff",
    "top1 k10 default int8": "d2a6ccccb8ba0c235d8e3c4075197a798a12b2711b106a1cfa144cd9378337ff",
    "top1 k10 highest bfloat16": "84b866917768366f17b62a230e0e6b062e283f23c5218186b33d72f30d4d07f5",
    "top1 k10 highest float32": "84b866917768366f17b62a230e0e6b062e283f23c5218186b33d72f30d4d07f5",
    "top1 k10 highest int8": "84b866917768366f17b62a230e0e6b062e283f23c5218186b33d72f30d4d07f5",
    "top1 k256 bf16x3 bfloat16": "c887a8e20bce3303525aa92a8cc6167cadd9e469a3e71e5af557a59770e1abaf",
    "top1 k256 bf16x3 float32": "c887a8e20bce3303525aa92a8cc6167cadd9e469a3e71e5af557a59770e1abaf",
    "top1 k256 bf16x3 int8": "c887a8e20bce3303525aa92a8cc6167cadd9e469a3e71e5af557a59770e1abaf",
    "top1 k256 default bfloat16": "1276ef9962e181e194e00f3a1dc71a7ad554f32af7986c608bae72056cc8235b",
    "top1 k256 default float32": "1276ef9962e181e194e00f3a1dc71a7ad554f32af7986c608bae72056cc8235b",
    "top1 k256 default int8": "1276ef9962e181e194e00f3a1dc71a7ad554f32af7986c608bae72056cc8235b",
    "top1 k256 highest bfloat16": "fc018669950752e3d424684ed45583276c2d19fc1550247c3b42f76de8ba1bb6",
    "top1 k256 highest float32": "fc018669950752e3d424684ed45583276c2d19fc1550247c3b42f76de8ba1bb6",
    "top1 k256 highest int8": "fc018669950752e3d424684ed45583276c2d19fc1550247c3b42f76de8ba1bb6",
    "top1 k40 bf16x3 bfloat16": "b5d458c6236d5f3c8d15b57e9441834dfddab1ddbbef4347bdacb0ac0c311d06",
    "top1 k40 bf16x3 float32": "b5d458c6236d5f3c8d15b57e9441834dfddab1ddbbef4347bdacb0ac0c311d06",
    "top1 k40 bf16x3 int8": "b5d458c6236d5f3c8d15b57e9441834dfddab1ddbbef4347bdacb0ac0c311d06",
    "top1 k40 default bfloat16": "6e0f0dfcfe030fc5ad2aee1b9fb0e49190dd4efc2456a06c670d70f7b957dc69",
    "top1 k40 default float32": "6e0f0dfcfe030fc5ad2aee1b9fb0e49190dd4efc2456a06c670d70f7b957dc69",
    "top1 k40 default int8": "6e0f0dfcfe030fc5ad2aee1b9fb0e49190dd4efc2456a06c670d70f7b957dc69",
    "top1 k40 highest bfloat16": "342d6ec9de06b0422d63d32a2bfadf4b0ac4a521d49c9cdeadc909691f7f2e14",
    "top1 k40 highest float32": "342d6ec9de06b0422d63d32a2bfadf4b0ac4a521d49c9cdeadc909691f7f2e14",
    "top1 k40 highest int8": "342d6ec9de06b0422d63d32a2bfadf4b0ac4a521d49c9cdeadc909691f7f2e14",
}
