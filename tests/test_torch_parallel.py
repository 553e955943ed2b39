"""The port's sharded engine (``recsys_tpu_torch/parallel``) against the
JAX package's (``recsys_tpu/parallel``) on the CPU.

The JAX side runs as ``tests/test_parallel.py`` runs it: on the 8 virtual
CPU devices of ``tests/conftest.py``, Pallas in interpret mode.  The port
puts every shard of its mesh on the CPU, where each kernel wrapper runs its
plain twin.  Inputs come from the fixtures or from numpy with a seed.
Tolerances are the JAX tests' own: f64 rtol 1e-11, atol 1e-12; f32 rtol
3e-4, atol 3e-5 (the two engines sum in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import FIXTURES, read_golden
from recsys_tpu.config import ProblemSpec as JaxSpec
from recsys_tpu.config import RunConfig as JaxConfig
from recsys_tpu.ops import bell as jax_bell
from recsys_tpu.parallel import engine as jax_par
from recsys_tpu.parallel import mesh as jax_mesh
from recsys_tpu.parallel import sharding as jax_shp
from recsys_tpu_torch import cli, convert
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.engine.oracle import top1_numpy
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.models.mf import MFState, init_factors
from recsys_tpu_torch.ops import bell
from recsys_tpu_torch.parallel import engine as par
from recsys_tpu_torch.parallel import mesh as pmesh
from recsys_tpu_torch.parallel import sharding as shp
from recsys_tpu_torch.parallel import step

CPU = torch.device("cpu")
SHAPES = [(2, 4), (4, 2), (8, 1), (1, 8), (2, 3)]
# route: (dtype, path) that takes it in both engines on the CPU.
ROUTES = {
    "dense": ("float64", "dense"),
    "coo": ("float64", "coo"),
    "coo_seg": ("float32", "coo"),
    "bell": ("float64", "bell"),
    "tiled": ("float32", "auto"),
}
TOL = {"float64": dict(rtol=1e-11, atol=1e-12), "float32": dict(rtol=3e-4, atol=3e-5)}


def _spec(inst="inst30-40-10-2-10", iters=None):
    spec = load_problem(FIXTURES / f"{inst}.in")
    return spec if iters is None else dataclasses.replace(spec, iters=iters)


def _jax_spec(spec):
    return JaxSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})


def _jax_mesh(shape):
    return jax_mesh.make_mesh(0, 0, shape=shape, devices=jax.devices()[: shape[0] * shape[1]])


def _mesh(shape):
    return pmesh.make_mesh(0, 0, shape=shape, device="cpu")


def _hub_spec():
    """User 0 rates 200 of 300 items: past the rated-table cap, so the
    top-1 takes the dense-mask branch (the JAX dryrun's hub instance)."""
    rng = np.random.default_rng(13)
    rows, cols = [0] * 200, list(range(200))
    for u in range(1, 40):
        cs = np.unique(rng.integers(0, 300, size=4))
        rows += [u] * len(cs)
        cols += list(cs)
    vals = rng.integers(1, 6, size=len(rows)).astype(np.float64)
    return ProblemSpec(iters=3, alpha=0.02, features=4, users=40, items=300,
                       rows=np.array(rows, np.int32), cols=np.array(cols, np.int32), vals=vals)


@pytest.mark.parametrize("n,users,items", [(8, 1000, 1000), (8, 1000, 1_000_000), (8, 1_000_000, 100),
                                           (4, 1_000_000, 100), (6, 30, 40), (12, 943, 1682)])
def test_balanced_grid_matches_jax(n, users, items):
    assert pmesh.balanced_grid(n, users, items) == jax_mesh.balanced_grid(n, users, items)


def test_make_mesh_places_shards():
    mesh = pmesh.make_mesh(30, 40, devices=["cpu"] * 6)
    assert mesh.shape == jax_mesh.balanced_grid(6, 30, 40)
    assert all(d == CPU for _, _, d in mesh.shards())
    with pytest.raises(ValueError):
        pmesh.make_mesh(30, 40, shape=(2, 3), devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        pmesh.make_mesh(30, 40)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharding_helpers_match_jax(shape):
    """Every host helper of ``sharding`` gives the JAX function's arrays exactly."""
    spec, hub = _spec(), _hub_spec()
    pu, pi = shape
    for s in (spec, hub):
        js = _jax_spec(s)
        for dt in (np.float32, np.float64):
            for mine, theirs in ((shp.bucket_coo(s, pu, pi, dt), jax_shp.bucket_coo(js, pu, pi, dt)),
                                 (shp.bucket_coo_seg(s, pu, pi, dt), jax_shp.bucket_coo_seg(js, pu, pi, dt))):
                assert mine[1:] == theirs[1:]
                for a, b in zip(mine[0], theirs[0]):
                    np.testing.assert_array_equal(a, b)
                    assert a.dtype == b.dtype
            for a, b in zip(shp.dense_blocks(s, pu, pi, dt), jax_shp.dense_blocks(js, pu, pi, dt)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(shp.rated_mask_padded(s, pu, pi), jax_shp.rated_mask_padded(js, pu, pi))
        np.testing.assert_array_equal(shp.rated_mask_padded(s, pu, pi, 64, 512),
                                      jax_shp.rated_mask_padded(js, pu, pi, 64, 512))
    state = init_factors(spec.users, spec.items, spec.features)
    for a, b in zip(shp.pad_factors(state.L, state.R, pu, pi), jax_shp.pad_factors(state.L, state.R, pu, pi)):
        np.testing.assert_array_equal(a, b)
    for n, q, t in ((30, 8, 256), (943, 128, 128), (1682, 128, 512), (100_000, 8, 256)):
        assert shp.pallas_block_dims(n, pu, q, t) == jax_shp.pallas_block_dims(n, pu, q, t)
        assert shp.pad_up(n, pi) == jax_shp.pad_up(n, pi)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_bell_tables_match_jax(shape):
    """``make_sharded_bell``'s bounds, tables and permutations, the laid-out
    factors and both gather maps equal the JAX package's (its per-bucket
    value tables flattened per shard, as the port keeps them)."""
    pu, pi = shape
    spec = generate_instance(40, 500, 6, 1, 30, iters=2, alpha=0.01, seed=5)
    for dt in (np.float32, np.float64):
        mine, theirs = bell.make_sharded_bell(spec, pu, pi, dt), jax_bell.make_sharded_bell(_jax_spec(spec), pu, pi, dt)
        assert mine.meta._asdict().keys() == theirs.meta._asdict().keys()
        assert tuple(mine.meta) == tuple(theirs.meta)
        for name in ("user_perm", "item_perm", "inv_user_perm", "inv_item_perm"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
        t, j = mine.tables, theirs.tables
        np.testing.assert_array_equal(t.ucols, j.ucols)
        np.testing.assert_array_equal(t.irows, j.irows)
        for flat, parts in ((t.uvals, j.uvals), (t.ivals, j.ivals)):
            np.testing.assert_array_equal(flat, np.concatenate([v.reshape(pu, pi, -1) for v in parts], axis=2))
            assert flat.dtype == dt
        state = init_factors(spec.users, spec.items, spec.features)
        for a, b in zip(bell.pad_factors_sharded_bell(state, mine, dt), jax_bell.pad_factors_sharded_bell(state, theirs, dt)):
            np.testing.assert_array_equal(a, b)
        Lp, Rp = bell.pad_factors_sharded_bell(state, mine, dt)
        for a, b in zip(bell.unpermute_factors_sharded(Lp, Rp, mine), jax_bell.unpermute_factors_sharded(Lp, Rp, theirs)):
            np.testing.assert_array_equal(a, b)
        m = mine.meta
        np.testing.assert_array_equal(bell.sharded_lay_index(mine.user_perm, m.u_blk, pu),
                                      jax_bell.sharded_lay_index(theirs.user_perm, m.u_blk, pu))
        np.testing.assert_array_equal(bell.sharded_unpermute_index(mine.inv_item_perm, m.i_blk, pi * m.i_blk),
                                      jax_bell.sharded_unpermute_index(theirs.inv_item_perm, m.i_blk, pi * m.i_blk))


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_bell_side_delta_plain_matches_jax_delta_side(dtype):
    """The delta form's twin against JAX ``_delta_side`` (jitted, as the
    sharded step runs it: XLA keeps the bf16 multiply-reduces in f32) on
    every shard of a (2, 3) checkerboard, both sides, hub rows of up to 300
    slots among them: f64 rtol 1e-12, f32 1e-6, bf16 within one bf16 ulp."""
    spec = checks.hub_spec(6, users=60, items=400, hub=300)
    pu, pi = 2, 3
    tdt = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float64": jnp.float64, "float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    data = bell.make_sharded_bell(spec, pu, pi, bell.HOST_DTYPE[tdt])
    m = data.meta
    L, R = (torch.from_numpy(x).to(tdt) for x in
            bell.pad_factors_sharded_bell(init_factors(spec.users, spec.items, spec.features), data, bell.HOST_DTYPE[tdt]))
    alpha2 = 2.0 * spec.alpha
    a2_jax = jnp.asarray(alpha2, jdt)
    for ub in range(pu):
        for ib in range(pi):
            t = bell.shard_tables(data.tables, ub, ib, CPU, tdt)
            l, r = L[ub * (m.u_blk + 1):(ub + 1) * (m.u_blk + 1)], R[ib * (m.i_blk + 1):(ib + 1) * (m.i_blk + 1)]
            for own, other, cols, vals, side in ((l, r, t.ucols, t.uvals, m.user), (r, l, t.irows, t.ivals, m.item)):
                got = bell.bell_side_delta_plain(own, other, cols, vals, side, alpha2)
                assert got.dtype == tdt and got.shape == (side.n_nz, own.shape[1])
                vt, off = [], 0
                for (b0, b1, w) in side.bounds:
                    vt.append(jnp.asarray(vals[off:off + w * (b1 - b0)].float().numpy()).astype(jdt).reshape(w, b1 - b0))
                    off += w * (b1 - b0)
                want = jax.jit(jax_bell._delta_side, static_argnums=4)(jnp.asarray(own.float().numpy() if dtype == "bfloat16" else own.numpy()).astype(jdt),
                                            jnp.asarray(other.float().numpy() if dtype == "bfloat16" else other.numpy()).astype(jdt),
                                            jnp.asarray(cols.numpy()), tuple(vt), side.bounds, a2_jax)
                if dtype == "bfloat16":
                    assert checks.bf16_ulps([got], [torch.from_numpy(np.asarray(want, np.float32)).bfloat16()]) <= 1
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12 if dtype == "float64" else 1e-6,
                                               atol=0)


_SINGLE = {}


def _single(route):
    """The port's single-device factors of the route's (dtype, path) (the
    tiled route's single-device counterpart is the dense step)."""
    if route not in _SINGLE:
        dtype, path = ROUTES[route]
        _SINGLE[route] = trainer.factorize(_spec(iters=50), RunConfig(dtype=dtype, path="dense" if path == "auto" else path),
                                           "cpu")
    return _SINGLE[route]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_factorize_sharded_matches_jax_and_single_device(route, shape):
    """inst30-40-10-2-10 at 50 steps: the port's sharded factors against the
    JAX sharded engine's on the same mesh shape and against the port's
    single-device engine, on every route; every shape pads (30 and 40 are
    no multiples of 8 or 3)."""
    spec = _spec(iters=50)
    dtype, path = ROUTES[route]
    cfg = RunConfig(dtype=dtype, path=path)
    mesh = _mesh(shape)
    assert par.sharded_route(spec, cfg, mesh) == route
    got, _ = par.factorize_sharded(spec, cfg, mesh=mesh)
    theirs, _ = jax_par.factorize_sharded(_jax_spec(spec), JaxConfig(dtype=dtype, path=path), mesh=_jax_mesh(shape))
    mine = convert.sharded_to_state(got.L, got.R, spec)
    want = convert.sharded_to_state(theirs.L, theirs.R, spec)
    single = _single(route)
    for a, b, c in ((mine.L, want.L, single.L), (mine.R, want.R, single.R)):
        np.testing.assert_allclose(a, b, **TOL[dtype])
        np.testing.assert_allclose(a, np.asarray(c), **TOL[dtype])


def test_start_from_the_jax_engines_state():
    """``convert`` carries the JAX sharded engine's padded factors into the
    port's layout: training on from them matches the JAX engine trained on
    from the same state."""
    spec = _spec(iters=20)
    for dtype, path in (("float64", "bell"), ("float32", "auto")):
        theirs, _ = jax_par.factorize_sharded(_jax_spec(spec), JaxConfig(dtype=dtype, path=path), mesh=_jax_mesh((2, 4)))
        state = convert.sharded_to_state(theirs.L, theirs.R, spec)
        again, _ = jax_par.factorize_sharded(_jax_spec(spec), JaxConfig(dtype=dtype, path=path), state=state,
                                             mesh=_jax_mesh((2, 4)))
        got, _ = par.factorize_sharded(spec, RunConfig(dtype=dtype, path=path), state=state, mesh=_mesh((2, 4)))
        L, R = convert.from_jax_sharded(again.L, again.R, spec, got.L.shape[0], got.R.shape[0], got.L.shape[1], CPU)
        np.testing.assert_allclose(got.L.numpy(), L.numpy(), **TOL[dtype])
        np.testing.assert_allclose(got.R.numpy(), R.numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype,path", [("float64", "bell"), ("float32", "bell"), ("float32", "auto"),
                                        ("float32", "coo")])
def test_sharded_runs_are_deterministic(dtype, path):
    """Two runs on one mesh give the same bits."""
    spec, mesh = _spec(iters=30), _mesh((2, 3))
    a, _ = par.factorize_sharded(spec, RunConfig(dtype=dtype, path=path), mesh=mesh)
    b, _ = par.factorize_sharded(spec, RunConfig(dtype=dtype, path=path), mesh=mesh)
    assert checks.same_bits(a.L, b.L) and checks.same_bits(a.R, b.R)


@pytest.mark.parametrize("inst,path,shape", [("inst0", "auto", (2, 4)), ("inst30-40-10-2-10", "dense", (2, 2))])
def test_sharded_golden_end_to_end(inst, path, shape):
    """The whole run on a mesh in f64 against the golden .out: inst0 (3 x 5,
    padded) on its auto route (``bell``) on 2x4, inst30-40-10-2-10's 20,000
    steps on ``dense`` on 2x2 (its auto route, ``bell``, is the JAX test's;
    its CPU twin takes minutes there and is held to JAX's above)."""
    spec = _spec(inst)
    cfg = RunConfig(dtype="float64", path=path, mesh_shape=shape)
    out, _ = trainer.run(spec, cfg, "cpu")
    assert out == read_golden(inst)


def test_sharded_top1_tie_break_across_shards():
    """All-equal predictions and no ratings: every user gets item 0, the
    lowest index, across 8 item blocks."""
    spec = _spec()
    spec_unrated = dataclasses.replace(spec, rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
                                       vals=np.zeros(0, np.float64))
    L, R = shp.pad_factors(np.ones((spec.users, spec.features)), np.ones((spec.items, spec.features)), 1, 8)
    state = MFState(L=torch.from_numpy(L).float(), R=torch.from_numpy(R).float())
    top1 = par.recommend_sharded(state, spec_unrated, _mesh((1, 8)))
    np.testing.assert_array_equal(top1, np.zeros(spec.users, np.int32))


@pytest.mark.parametrize("which", ["rated-table", "dense-mask"])
@pytest.mark.parametrize("shape", [(2, 4), (2, 3)])
def test_sharded_top1_branches(which, shape):
    """Both masking branches of the sharded top-1 on the same factors: the
    numpy oracle's answer, and the JAX sharded top-1's."""
    spec = _hub_spec() if which == "dense-mask" else generate_instance(40, 300, 4, 1, 6, iters=3, alpha=0.02, seed=3)
    max_rated = int(np.bincount(spec.rows).max())
    assert (max_rated > max(spec.items // 8, 128)) == (which == "dense-mask")
    state = init_factors(spec.users, spec.items, spec.features)
    pu, pi = shape
    L, R = shp.pad_factors(state.L, state.R, pu, pi)
    got = par.recommend_sharded(MFState(torch.from_numpy(L), torch.from_numpy(R)), spec, _mesh(shape))
    np.testing.assert_array_equal(got, top1_numpy(state.L, state.R, spec))
    jmesh = _jax_mesh(shape)
    from recsys_tpu.models.mf import MFState as JaxState

    want = jax_par.recommend_sharded(JaxState(L=jnp.asarray(L), R=jnp.asarray(R)), _jax_spec(spec), jmesh)
    np.testing.assert_array_equal(got, want)


def test_dryrun_on_the_cpu():
    par.dryrun(8, device="cpu")


def test_dryrun_catches_a_dropped_reduction(monkeypatch):
    """Each shard keeping its own partial (the psum dropped, as in JAX's
    ``test_dryrun_catches_dropped_psum``) must fail the dryrun."""
    monkeypatch.setattr(step, "axis_sum", lambda parts, devices: [parts[0].to(d) for d in devices])
    with pytest.raises(AssertionError):
        par.dryrun(8, device="cpu")


def test_sharded_bell_device_init_matches_host_init(monkeypatch):
    """With the draw threshold at 0 the f32 checkerboard BELL draws its
    factors on the device and lays them into blocks by ``index_select``;
    the result agrees with the host init's run (JAX's tolerance: the two
    float steps differ by up to ~2 f32 ulp)."""
    spec = generate_instance(24, 36, 4, 1, 4, iters=3, alpha=0.01, seed=5)
    cfg, mesh = RunConfig(dtype="float32", path="bell"), _mesh((2, 4))
    host, _ = par.factorize_sharded(spec, cfg, mesh=mesh)
    monkeypatch.setattr(trainer, "DEVICE_INIT_MIN_DRAWS", 0)
    assert trainer._device_init(spec, cfg, None)
    dev, _ = par.factorize_sharded(spec, cfg, mesh=mesh)
    np.testing.assert_allclose(dev.L.numpy(), host.L.numpy(), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(dev.R.numpy(), host.R.numpy(), rtol=2e-4, atol=2e-6)


def test_factorize_with_a_mesh_returns_true_shapes():
    """``trainer.factorize`` with ``mesh_shape`` hands over to the sharded
    engine and returns host factors at the true shapes."""
    spec = _spec(iters=50)
    state = trainer.factorize(spec, RunConfig(dtype="float64", path="bell", mesh_shape=(2, 4)), "cpu")
    assert state.L.shape == (spec.users, spec.features) and state.R.shape == (spec.items, spec.features)
    np.testing.assert_allclose(state.L, np.asarray(_single("bell").L), **TOL["float64"])


def test_cli_mesh_matches_golden(capsys):
    assert cli.main(["run", str(FIXTURES / "inst0.in"), "--device", "cpu", "--mesh", "1x2", "--no-time"]) == 0
    assert capsys.readouterr().out == read_golden("inst0")


def test_cli_refuses_mesh_with_checkpoint(tmp_path, capsys):
    rc = cli.main(["run", str(FIXTURES / "inst0.in"), "--device", "cpu", "--mesh", "2x2",
                   "--checkpoint", str(tmp_path / "ck.npz")])
    assert rc == 2
    assert "--mesh with --checkpoint" in capsys.readouterr().err
    assert not (tmp_path / "ck.npz").exists()
