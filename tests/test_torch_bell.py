"""The port's BELL route (recsys_tpu_torch/ops/bell.py, ops/dense.py, the
engine's ``bell`` and ``dense`` routes) and P2's functions
(ops/gather.py, probes/mosaic_gather.py) against the JAX package, the
native serial engine and the golden outputs, on the CPU.

On the CPU the wrappers run their plain twins; the CUDA kernels are held
against the twins in tests/test_torch_cuda.py and chip_smoke.py.

The port's BELL step follows the reference's order, so in f64 it is held
to ``_native.serial_gd`` bit for bit.  The JAX BELL sums each row's change
over its slots first and then adds it: against it the limits are
tests/test_bell.py's (1e-12 / 1e-14 in f64, 3e-5 / 3e-6 in f32).
"""

import ast
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from helpers import FIXTURES, read_golden
from recsys_tpu.config import RunConfig as JaxRunConfig
from recsys_tpu.engine import trainer as jax_trainer
from recsys_tpu.ops import bell as jax_bell
from recsys_tpu_torch import cli, convert
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io import _native
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.models.mf import MFState, init_factors
from recsys_tpu_torch.ops import bell, dense, device_rng, gather
from recsys_tpu_torch.probes import mosaic_gather


def _power_law():
    # Skewed degrees on both sides (tests/test_bell.py:105).
    rng = np.random.default_rng(0)
    users, items = 64, 48
    cells = [(u, i) for u in range(users) for i in range(items)
             if rng.random() < (0.8 / (1 + u)) + (0.4 / (1 + i))]
    return ProblemSpec(iters=6, alpha=0.005, features=5, users=users, items=items,
                       rows=np.array([c[0] for c in cells], np.int32),
                       cols=np.array([c[1] for c in cells], np.int32),
                       vals=rng.uniform(1, 5, len(cells)))


def _stored_zero():
    # A stored rating of 0 is a real entry: the BELL route has no implicit mask.
    spec = generate_instance(40, 90, 6, 2, 9, iters=5, alpha=0.01, seed=3)
    vals = spec.vals.copy()
    vals[::5] = 0.0
    return dataclasses.replace(spec, vals=vals)


SPECS = {
    "sparse": lambda: generate_instance(60, 200, 8, 2, 5, iters=10, alpha=0.01, seed=9),  # test_bell.py:26
    "power_law": _power_law,
    "hyper_sparse": lambda: generate_instance(50, 5000, 3, 1, 2, iters=4, alpha=0.001, seed=4),  # test_bell.py:91
    "stored_zero": _stored_zero,
    "inst200-10000": lambda: load_problem(str(FIXTURES / "inst200-10000-50-100-300.in")),
}


# Steps of the bitwise readings: 5, and inst200-10000's 3 (its rows are
# 328 slots wide).
def _bitwise_spec(name):
    return dataclasses.replace(SPECS[name](), iters=3 if name == "inst200-10000" else 5)


def _host_factors(spec, dtype):
    """(BellData, L, R) of the port: the degree-permuted glibc init with its zero rows, as tensors."""
    data = bell.make_bell_inputs(spec, dtype)
    L, R = bell.pad_factors_for_bell(init_factors(spec.users, spec.items, spec.features), data, dtype)
    return data, torch.from_numpy(L), torch.from_numpy(R)


def _tensors(tables):
    return bell.BellTables(*(torch.from_numpy(np.ascontiguousarray(t)) for t in tables))


def _serial(spec):
    st = init_factors(spec.users, spec.items, spec.features)
    out = _native.serial_gd(spec, st.L.copy(), st.R.copy())
    assert out is not None, "the native library must build here"
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("name", ["sparse", "power_law", "hyper_sparse"])
def test_make_bell_inputs_equals_jax(name, builder, dtype, monkeypatch):
    spec = SPECS[name]()
    if builder == "numpy":
        monkeypatch.setattr(_native, "bell_side_tables", lambda *a, **k: None)
    got, want = bell.make_bell_inputs(spec, dtype), jax_bell.make_bell_inputs(spec, dtype)
    assert got.meta == want.meta
    for g, w in [(got.user_perm, want.user_perm), (got.item_perm, want.item_perm),
                 (got.inv_user_perm, want.inv_user_perm), (got.inv_item_perm, want.inv_item_perm),
                 (got.tables.ucols, want.tables.ucols), (got.tables.irows, want.tables.irows)]:
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for flat, views, bounds in [(got.tables.uvals, want.tables.uvals, got.meta.user.bounds),
                                (got.tables.ivals, want.tables.ivals, got.meta.item.bounds)]:
        assert flat.dtype == np.dtype(dtype)
        assert len(bounds) == len(views)
        np.testing.assert_array_equal(flat, np.concatenate([v.reshape(-1) for v in views]))
        for (b0, b1, w), v in zip(bounds, views):
            assert v.shape == (w, b1 - b0)
    assert bell.bell_side_slots(spec) == jax_bell.bell_side_slots(spec)
    assert bell.bell_slot_ratio(spec) == jax_bell.bell_slot_ratio(spec)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_padding_round_trip_equals_jax(dtype):
    spec = SPECS["hyper_sparse"]()
    data, L, R = _host_factors(spec, dtype)
    jd = jax_bell.make_bell_inputs(spec, dtype)
    jL, jR = jax_bell.pad_factors_for_bell(init_factors(spec.users, spec.items, spec.features), jd, dtype)
    cL, cR = convert.from_jax_bell(jL, jR, "cpu")
    assert cL.dtype == L.dtype and torch.equal(cL, L) and torch.equal(cR, R)
    assert torch.all(L[-1] == 0) and torch.all(R[-1] == 0)
    back = convert.bell_to_state(L, R, data)
    init = init_factors(spec.users, spec.items, spec.features)
    np.testing.assert_array_equal(back.L, init.L.astype(dtype))
    np.testing.assert_array_equal(back.R, init.R.astype(dtype))


@pytest.mark.parametrize("name", list(SPECS))
def test_f64_twin_equals_serial_gd_bit_for_bit(name):
    spec = _bitwise_spec(name)
    data, L, R = _host_factors(spec, np.float64)
    Lp, Rp = bell.bell_train_plain(L, R, _tensors(data.tables), 2.0 * spec.alpha, data.meta, spec.iters)
    got = convert.bell_to_state(Lp, Rp, data)
    want = _serial(spec)
    np.testing.assert_array_equal(got.L, want[0])
    np.testing.assert_array_equal(got.R, want[1])
    # Zero rows and rows of degree 0 never move.
    assert torch.all(Lp[-1] == 0) and torch.all(Rp[-1] == 0)
    assert torch.equal(Rp[data.meta.item.n_nz:], R[data.meta.item.n_nz:])


def test_sum_then_add_control_differs():
    # JAX's order computes the same sums in another order: the bitwise
    # reading above must be able to reject it.
    differ = []
    for name in SPECS:
        spec = _bitwise_spec(name)
        data, L, R = _host_factors(spec, np.float64)
        Lc, Rc = checks.bell_sum_then_add_train(L, R, _tensors(data.tables), 2.0 * spec.alpha, data.meta,
                                                spec.iters)
        got, want = convert.bell_to_state(Lc, Rc, data), _serial(spec)
        differ.append(not (np.array_equal(got.L, want[0]) and np.array_equal(got.R, want[1])))
        np.testing.assert_allclose(got.L, want[0], rtol=1e-12, atol=1e-14)
    assert differ[-1], "the control must differ on inst200-10000's wide rows"


@pytest.mark.parametrize("name", ["sparse", "power_law", "hyper_sparse"])
@pytest.mark.parametrize("dtype,rtol,atol", [("float64", 1e-12, 1e-14), ("float32", 3e-5, 3e-6)])
def test_twin_matches_jax_bell(name, dtype, rtol, atol):
    spec = SPECS[name]()
    np_dtype = np.dtype(dtype)
    jd = jax_bell.make_bell_inputs(spec, np_dtype)
    jL, jR = jax_bell.pad_factors_for_bell(init_factors(spec.users, spec.items, spec.features), jd, np_dtype)
    L, R = convert.from_jax_bell(jL, jR, "cpu")
    data = bell.make_bell_inputs(spec, np_dtype)
    Lp, Rp = bell.bell_train(L, R, _tensors(data.tables), 2.0 * spec.alpha, data.meta, spec.iters)
    got = convert.bell_to_state(Lp, Rp, jd)
    want = jax_trainer.factorize(spec, JaxRunConfig(dtype=dtype, path="bell"))
    assert got.L.dtype == np_dtype
    np.testing.assert_allclose(got.L, np.asarray(want.L), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.R, np.asarray(want.R), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_factorize_bell_route(dtype):
    spec = SPECS["power_law"]()
    st = trainer.factorize(spec, RunConfig(dtype=dtype, path="bell"), "cpu")
    assert st.L.dtype == np.dtype(dtype) and st.L.shape == (spec.users, spec.features)
    if dtype == "float64":
        want = _serial(spec)
        np.testing.assert_array_equal(st.L, want[0])
        np.testing.assert_array_equal(st.R, want[1])
    else:
        want = jax_trainer.factorize(spec, JaxRunConfig(dtype=dtype, path="bell"))
        np.testing.assert_allclose(st.L, np.asarray(want.L), rtol=3e-5, atol=3e-6)


def test_run_bell_f64_matches_golden():
    spec = load_problem(str(FIXTURES / "inst30-40-10-2-10.in"))
    out, top1 = trainer.run(spec, RunConfig(dtype="float64", path="bell"), "cpu")
    assert out == read_golden("inst30-40-10-2-10")
    assert top1.dtype == np.int32


@pytest.mark.slow
def test_run_bell_f64_matches_golden_inst500():
    # 10,000 iterations of the twin: about 90 s on the CPU.
    spec = load_problem(str(FIXTURES / "inst500-500-20-2-100.in"))
    out, _ = trainer.run(spec, RunConfig(dtype="float64", path="bell"), "cpu")
    assert out == read_golden("inst500-500-20-2-100")


def test_run_bell_f32_matches_jax():
    spec = generate_instance(60, 200, 8, 2, 5, iters=30, alpha=0.01, seed=9)
    out, _ = trainer.run(spec, RunConfig(dtype="float32", path="bell"), "cpu")
    want, _ = jax_trainer.run(spec, JaxRunConfig(dtype="float32", path="bell"))
    assert out == want


def test_cli_f64_bell_route():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["run", str(FIXTURES / "inst0.in"), "--device", "cpu", "--dtype", "float64",
                       "--path", "bell", "--no-time"])
    assert rc == 0 and buf.getvalue() == read_golden("inst0")


@pytest.mark.parametrize("dtype,rtol,atol", [("float64", 1e-12, 1e-14), ("float32", 3e-5, 3e-6)])
def test_dense_route_matches_jax(dtype, rtol, atol):
    spec = SPECS["sparse"]()
    got = trainer.factorize(spec, RunConfig(dtype=dtype, path="dense"), "cpu")
    want = jax_trainer.factorize(spec, JaxRunConfig(dtype=dtype, path="dense"))
    assert got.L.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got.L, np.asarray(want.L), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.R, np.asarray(want.R), rtol=rtol, atol=atol)
    out, _ = trainer.run(spec, RunConfig(dtype=dtype, path="dense"), "cpu")
    assert out == jax_trainer.run(spec, JaxRunConfig(dtype=dtype, path="dense"))[0]


def test_dense_inputs_equal_jax():
    from recsys_tpu.ops.dense import make_dense_inputs

    spec = SPECS["stored_zero"]()
    for got, want in zip(dense.make_dense_inputs(spec, np.float64), make_dense_inputs(spec, jnp.float64)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_choose_path_takes_bell_on_the_card():
    # Computed only: no card is needed to decide.
    ml = load_problem(str(FIXTURES / "instML100k.in"))
    assert trainer.choose_path(ml, RunConfig(dtype="float64"), "cuda") == "bell"
    assert trainer.choose_path(ml, RunConfig(dtype="float64"), "cpu") == jax_trainer.choose_path(
        ml, JaxRunConfig(dtype="float64")) == "bell"
    # gen-inst1e6-100-700-1-3's shape and degrees (1,000,000 users of 1-3
    # ratings over 100 items), not its values: BELL in f64, and in f32
    # past the transfer budget on the card.
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(1_000_000, dtype=np.int32), rng.integers(1, 4, 1_000_000))
    cols = rng.integers(0, 100, len(rows)).astype(np.int32)
    spec = ProblemSpec(iters=3, alpha=1e-5, features=700, users=1_000_000, items=100, rows=rows, cols=cols,
                       vals=np.ones(len(rows)))
    assert trainer.choose_path(spec, RunConfig(dtype="float64"), "cuda") == "bell"
    assert trainer.choose_path(spec, RunConfig(dtype="float32"), "cuda") == "bell"
    assert trainer.choose_path(spec, RunConfig(dtype="bfloat16"), "cuda") == "bell"


@pytest.mark.parametrize("name", ["sparse", "stored_zero"])
def test_run_bf16_bell_matches_jax(name):
    # bf16 on the bell route: the reference's output format, and the JAX
    # package's own bf16 run line for line; factorize's factors (float32
    # arrays holding bf16 values) equal the JAX package's bit for bit, and
    # recommend() on them gives run()'s top-1.
    spec = dataclasses.replace(SPECS[name](), iters=30)
    out, top1 = trainer.run(spec, RunConfig(dtype="bfloat16", path="bell"), "cpu")
    want, _ = jax_trainer.run(spec, JaxRunConfig(dtype="bfloat16", path="bell"))
    assert len(out.splitlines()) == spec.users and top1.dtype == np.int32
    assert all(line.split()[0].isdigit() for line in out.splitlines())
    assert out == want
    st = trainer.factorize(spec, RunConfig(dtype="bfloat16", path="bell"), "cpu")
    js = jax_trainer.factorize(spec, JaxRunConfig(dtype="bfloat16", path="bell"))
    assert st.L.dtype == np.float32
    # recommend() scores factorize()'s float32 arrays in bf16, as run() does.
    np.testing.assert_array_equal(trainer.recommend(st, spec, RunConfig(dtype="bfloat16", path="bell"), "cpu"), top1)
    np.testing.assert_array_equal(st.L, np.asarray(js.L).astype(np.float32))
    np.testing.assert_array_equal(st.R, np.asarray(js.R).astype(np.float32))


# The bf16 readings against the JAX package's bf16 BELL step: the published
# instances on which the JAX package itself reads 0.4475 and 0.1038 argmax
# agreement in bf16 (tests/bf16_bell_readings.py), cut to 3 steps.
BF16_STEPS = 3


def _bf16_inputs(name):
    """(spec, meta, L, R, tables) of the port in bf16 at ``name`` and the
    JAX package's factors after ``BF16_STEPS`` bf16 steps from the same
    init, as bf16 tensors."""
    spec = dataclasses.replace(load_problem(str(FIXTURES / f"{name}.in")), iters=BF16_STEPS)
    data = bell.make_bell_inputs(spec, np.float32)
    L, R = (torch.from_numpy(x).bfloat16() for x in bell.pad_factors_for_bell(
        init_factors(spec.users, spec.items, spec.features), data, np.float32))
    jd = jax_bell.make_bell_inputs(spec, jnp.bfloat16)
    jL, jR = jax_bell.pad_factors_for_bell(init_factors(spec.users, spec.items, spec.features), jd, jnp.bfloat16)
    assert checks.same_bits((L, R), tuple(torch.from_numpy(np.asarray(x).astype(np.float32)).bfloat16()
                                          for x in (jL, jR)))
    jt = jax.tree.map(jnp.asarray, jd.tables)
    for got, want in ((data.tables.uvals, jd.tables.uvals), (data.tables.ivals, jd.tables.ivals)):
        flat = np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in want])
        assert np.array_equal(torch.from_numpy(got).bfloat16().float().numpy(), flat)
    jLn, jRn = jax_trainer._train_bell(jnp.asarray(jL), jnp.asarray(jR), jt,
                                       jnp.asarray(2.0 * spec.alpha, jnp.bfloat16), spec.iters, jd.meta)
    want = tuple(torch.from_numpy(np.asarray(x).astype(np.float32)).bfloat16() for x in (jLn, jRn))
    return spec, data.meta, L, R, bell.device_tables(data.tables, "cpu", torch.bfloat16), want


@pytest.mark.parametrize("name", ["inst400-50000-30-200-500", "inst50000-5000-100-2-5"])
def test_bf16_twin_matches_jax_bell_step(name):
    spec, meta, L, R, t, want = _bf16_inputs(name)
    got = bell.bell_train(L, R, t, 2.0 * spec.alpha, meta, spec.iters)
    assert got[0].dtype == torch.bfloat16
    share, ulps = checks.bit_share(got, want), checks.bf16_ulps(got, want)
    assert share >= checks.BF16_JAX_SHARE and ulps <= checks.BF16_JAX_ULPS, (share, ulps)
    # The zero rows stay zero.
    assert torch.all(got[0][-1] == 0) and torch.all(got[1][-1] == 0)


@pytest.mark.parametrize("name", ["inst400-50000-30-200-500", "inst50000-5000-100-2-5"])
def test_bf16_controls_rejected(name):
    # The f32 step rounded once, and a bf16 accumulator in the f32/f64
    # order: each must fail both limits against the JAX package.
    spec, meta, L, R, t, want = _bf16_inputs(name)
    for control in (checks.bell_bf16_f32_inside_train, checks.bell_bf16_row_acc_train):
        got = control(L, R, t, 2.0 * spec.alpha, meta, spec.iters)
        share, ulps = checks.bit_share(got, want), checks.bf16_ulps(got, want)
        assert share < checks.BF16_JAX_SHARE and ulps > checks.BF16_JAX_ULPS, (control.__name__, share, ulps)


def test_bf16_device_init_matches_jax(monkeypatch):
    # The bf16 device init (the f32 draws rounded to bf16, then the
    # permute and zero row) at a small size: the permute equals the host
    # route's pad of the same draws bit for bit, and the whole bf16 run
    # from the device init equals the JAX package's, whose device init is
    # taken at the same threshold.
    spec = dataclasses.replace(SPECS["power_law"](), iters=3)
    monkeypatch.setattr(trainer, "DEVICE_INIT_MIN_DRAWS", 1)
    monkeypatch.setattr(jax_trainer, "DEVICE_INIT_MIN_DRAWS", 1)
    assert trainer._device_init(spec, RunConfig(dtype="bfloat16"), None)
    assert not trainer._device_init(spec, RunConfig(dtype="float64"), None)
    data = bell.make_bell_inputs(spec, np.float32)
    Ld, Rd = device_rng.device_init_factors(spec.users, spec.items, spec.features, device="cpu")
    L0 = trainer._permute_pad(Ld.to(torch.bfloat16), data.user_perm)
    Lh, _ = bell.pad_factors_for_bell(MFState(Ld.numpy(), Rd.numpy()), data, np.float32)
    assert checks.same_bits(L0, torch.from_numpy(Lh).bfloat16())
    # Against the host glibc init: the draws' float steps differ by up to 2 f32 ulps.
    Lg, _ = bell.pad_factors_for_bell(init_factors(spec.users, spec.items, spec.features), data, np.float32)
    assert checks.bf16_ulps((L0,), (torch.from_numpy(Lg).bfloat16(),)) <= 1
    st = trainer.factorize(spec, RunConfig(dtype="bfloat16", path="bell"), "cpu")
    js = jax_trainer.factorize(spec, JaxRunConfig(dtype="bfloat16", path="bell"))
    np.testing.assert_array_equal(st.L, np.asarray(js.L).astype(np.float32))
    np.testing.assert_array_equal(st.R, np.asarray(js.R).astype(np.float32))


def test_kernel_wrapper_refuses_what_it_does_not_take():
    spec = SPECS["sparse"]()
    data, L, R = _host_factors(spec, np.float64)
    t = _tensors(data.tables)
    a2 = 2.0 * spec.alpha
    with pytest.raises(ValueError, match="snapshot"):
        bell.bell_side_update(L, R, t.ucols, t.uvals, data.meta.user, a2, out=L)
    with pytest.raises(ValueError, match="dtypes"):
        bell.bell_side_update(L.float(), R, t.ucols, t.uvals, data.meta.user, a2)
    with pytest.raises(ValueError, match="shapes"):
        bell.bell_side_update(R, L, t.ucols, t.uvals, data.meta.user, a2)
    wide = torch.zeros((L.shape[0], bell.MAX_K + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="k="):
        bell.bell_side_update(wide, torch.zeros((R.shape[0], bell.MAX_K + 1), dtype=torch.float64),
                              t.ucols, t.uvals, data.meta.user, a2)
    # A tensor on neither the CPU nor a CUDA card: no kernel, no twin.
    meta = [x.to("meta") for x in (L, R, t.ucols, t.uvals)]
    with pytest.raises(ValueError, match="no kernel"):
        bell.bell_side_update(*meta, data.meta.user, a2)
    before = bell.bell_side_update.launches
    bell.bell_gd_step(L, R, t, a2, data.meta)  # the twin, on the CPU: no launch counted
    assert bell.bell_side_update.launches == before


def test_gd_step_is_one_train_step():
    spec = SPECS["power_law"]()
    data, L, R = _host_factors(spec, np.float64)
    t = _tensors(data.tables)
    step = bell.bell_gd_step(L, R, t, 2.0 * spec.alpha, data.meta)
    train = bell.bell_train(L, R, t, 2.0 * spec.alpha, data.meta, 1)
    assert torch.equal(step[0], train[0]) and torch.equal(step[1], train[1])
    out = torch.empty_like(L)
    out[data.meta.user.n_nz:] = L[data.meta.user.n_nz:]
    assert torch.equal(bell.bell_side_update(L, R, t.ucols, t.uvals, data.meta.user, 2.0 * spec.alpha, out=out),
                       step[0])


# ---------------------------------------------------------------------
# P2: the TPU probe's kernels, interpret mode, against the port's twins
# ---------------------------------------------------------------------

P2_N, P2_K, P2_S, P2_BLK = 300, 16, 512, 128


def _p2_kernels():
    """``p1_kernel``..``p4_kernel`` of scripts/probe_mosaic_gather.py, taken
    from its source (importing it would run its TPU benchmark) and bound
    to this test's small BLK."""
    path = FIXTURES.parent.parent / "scripts" / "probe_mosaic_gather.py"
    tree = ast.parse(path.read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in ("p1_kernel", "p2_kernel",
                                                                                   "p3_kernel", "p4_kernel")]
    assert len(fns) == 4
    ns = {"jax": jax, "jnp": jnp, "BLK": P2_BLK}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _p2_call(kernel, ins, table):
    # pcall (probe_mosaic_gather.py:94) in interpret mode on the CPU.
    specs = [pl.BlockSpec((P2_BLK,), lambda i: (i,))] * len(ins) + [pl.BlockSpec((P2_N, P2_K), lambda i: (0, 0))]
    return np.asarray(pl.pallas_call(
        kernel, grid=(P2_S // P2_BLK,), in_specs=specs,
        out_specs=pl.BlockSpec((P2_BLK, P2_K), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((P2_S, P2_K), jnp.float32), interpret=True,
    )(*ins, table))


@pytest.mark.parametrize("variant", ["p1", "p2", "p3", "p4"])
def test_p2_twins_match_jax_kernels(variant):
    table, idx, vals = mosaic_gather.inputs("cpu", P2_N, P2_K, P2_S)
    kern = _p2_kernels()[f"{variant}_kernel"]
    if variant == "p4":
        want = _p2_call(kern, (jnp.asarray(idx.numpy()), jnp.asarray(vals.numpy())), jnp.asarray(table.numpy()))
        got = gather.gather_err_grad(table, idx, vals, P2_BLK).numpy()
        # Same products, the K-term dot summed in another f32 order.
        assert np.abs(got - want).max() <= checks.GATHER_ERR_GRAD_RTOL * np.abs(want).max()
    else:
        want = _p2_call(kern, (jnp.asarray(idx.numpy()),), jnp.asarray(table.numpy()))
        np.testing.assert_array_equal(gather.gather_rows(table, idx).numpy(), want)


def test_p2_probe_loop_on_the_cpu():
    table, idx, vals = mosaic_gather.inputs("cpu", P2_N, P2_K, P2_S)
    errs = mosaic_gather.check_kernels(table, idx, vals, P2_BLK)
    assert errs["gather_rows"] == 0.0 and errs["gather_err_grad"] == 0.0  # both twins on the CPU
    fns = mosaic_gather.steps(idx, vals, P2_BLK)
    sums = {name: mosaic_gather.loop(fns[name], table, inner=3) for name in mosaic_gather.VARIANTS}
    for name in ("p1", "p2", "p3"):
        assert torch.equal(sums[name], sums["xla"])
    assert torch.isfinite(sums["p4"]).all()
    with pytest.raises(ValueError, match="blk"):
        gather.gather_err_grad(table, idx, vals, P2_N + 1)


def test_gather_err_grad_forms_on_the_cpu():
    # The kernel's wrapper takes the twin on the CPU, uncounted.
    table, idx, vals = mosaic_gather.inputs("cpu", P2_N, P2_K, P2_S)
    before = gather.gather_err_grad.launches
    want = gather.gather_err_grad_plain(table, idx, vals, P2_BLK)
    assert torch.equal(gather.gather_err_grad(table, idx, vals, P2_BLK), want)
    assert gather.gather_err_grad.launches == before
