"""The port's multi-process layer (``recsys_tpu_torch/parallel/multihost.py``)
on the CPU: in one process against the one-process sharded engine and the
JAX package's ``multihost.run`` (its 8 virtual CPU devices), and in real
processes over gloo (``parallel/launch.py``: one rank a process, a free
port of 127.0.0.1 each run, a timeout on every wait) against the
one-process engine bit for bit.

Inputs are fixtures or seeded generated instances, small: a sharded BELL
twin step costs ~1,000 torch ops on the CPU.  Bit for bit means the sha256
of the whole factors' raw bytes (``testing.factor_digest``) and of the
output text.
"""

import hashlib
import json
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import FIXTURES, read_golden
from recsys_tpu.config import ProblemSpec as JaxSpec
from recsys_tpu.config import RunConfig as JaxConfig
from recsys_tpu.parallel import multihost as jax_multihost
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.parallel import engine as par
from recsys_tpu_torch.parallel import launch, multihost
from recsys_tpu_torch.parallel.mesh import make_mesh
from recsys_tpu_torch.testing import factor_digest

# One-process routes: (dtype, path) that takes each sharded route.
ROUTES = {
    "tiled": ("float32", "auto"),
    "bell-f64": ("float64", "bell"),
    "bell-f32": ("float32", "bell"),
    "coo": ("float64", "coo"),
    "coo_seg": ("float32", "coo"),
    "dense": ("float64", "dense"),
}
# Multi-process layouts: ranks and mesh (one shard a rank on 2x2, two a
# rank on 2x3, where a mesh row's group holds 2 shards of one rank and 1 of
# another), and the routes each runs.
LAYOUTS = {"2-ranks-2x2": (2, (2, 2)), "4-ranks-2x2": (4, (2, 2)), "3-ranks-2x3": (3, (2, 3))}
PROC_ROUTES = {"tiled": ("float32", "auto"), "bell": ("float64", "bell"), "coo_seg": ("float32", "coo")}
GEN = [30, 40, 6, 1, 6, 20, 0.01, 3]  # generate_instance's arguments, iters, alpha, seed
RANKS_TIMEOUT = 150


def _gen():
    return generate_instance(*GEN[:5], iters=GEN[5], alpha=GEN[6], seed=GEN[7])


def test_initialize_without_arguments_is_a_noop(monkeypatch):
    """No arguments: single process, no socket opened, no group joined."""
    def refuse(*a, **k):
        raise AssertionError("initialize() opened a socket or a process group")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    multihost.initialize()
    assert not dist.is_initialized()


def test_initialize_needs_every_argument():
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize("127.0.0.1:1", device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("route", list(ROUTES))
def test_single_process_equals_the_sharded_engine(route):
    """In one process ``multihost.run`` is the one-process sharded engine:
    the same route, factors, top-1 and text, bit for bit, on a 2x3 mesh."""
    dtype, path = ROUTES[route]
    spec = generate_instance(30, 40, 6, 1, 6, iters=8, alpha=0.01, seed=3)
    cfg = RunConfig(dtype=dtype, path=path, mesh_shape=(2, 3))
    mesh = multihost.world_mesh(spec, cfg, "cpu")
    assert mesh.groups is None and len(mesh.shards()) == 6
    assert par.sharded_route(spec, cfg, mesh) == route.split("-")[0]
    state, _ = multihost.factorize_multihost(spec, cfg, device="cpu")
    want, _ = par.factorize_sharded(spec, cfg, device="cpu")
    assert factor_digest(state) == factor_digest(want)
    out, top1 = multihost.run(spec, cfg, "cpu")
    out_sh, top1_sh = par.run(spec, cfg, "cpu")
    np.testing.assert_array_equal(top1, top1_sh)
    assert out == out_sh


@pytest.mark.parametrize("mesh_shape", [None, (2, 4)])
def test_inst0_f64_golden(mesh_shape):
    out, _ = multihost.run(load_problem(FIXTURES / "inst0.in"), RunConfig(dtype="float64", mesh_shape=mesh_shape),
                           "cpu")
    assert out == read_golden("inst0")


@pytest.mark.parametrize("path", ["auto", "coo"])
def test_matches_jax_multihost_on_2x4(path):
    """The same text as the JAX package's ``multihost.run`` on its 8 CPU
    devices, on a 2x4 mesh in f64, at 30 steps."""
    spec = generate_instance(40, 60, 6, 1, 8, iters=30, alpha=0.01, seed=5)
    out, top1 = multihost.run(spec, RunConfig(dtype="float64", path=path, mesh_shape=(2, 4)), "cpu")
    jspec = JaxSpec(iters=spec.iters, alpha=spec.alpha, features=spec.features, users=spec.users, items=spec.items,
                    rows=spec.rows, cols=spec.cols, vals=spec.vals)
    want, want_top1 = jax_multihost.run(jspec, JaxConfig(dtype="float64", path=path, mesh_shape=(2, 4)))
    assert out == want
    np.testing.assert_array_equal(top1, want_top1)


_RANKS: dict = {}


def _ranks_run(layout):
    """Each rank's ``RANK`` lines of one gloo run of ``layout`` over
    ``PROC_ROUTES`` (and, on 2 ranks, inst0 f64 against its golden),
    run once for the module."""
    if layout not in _RANKS:
        ranks, shape = LAYOUTS[layout]
        cases = [{"name": route, "gen": GEN, "dtype": dtype, "path": path, "mesh": list(shape)}
                 for route, (dtype, path) in PROC_ROUTES.items()]
        if ranks == 2:
            cases.append({"name": "inst0", "input": str(FIXTURES / "inst0.in"), "dtype": "float64",
                          "golden": str(FIXTURES / "inst0.out"), "mesh": list(shape)})
        results = launch.spawn(ranks, ["--device", "cpu", "--cases", json.dumps(cases)], RANKS_TIMEOUT)
        _RANKS[layout] = launch.rank_lines(results)
    return _RANKS[layout]


@pytest.mark.parametrize("route", list(PROC_ROUTES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_equal_one_process_bit_for_bit(layout, route):
    """Every rank's whole factors and text equal the one-process engine's
    on the same mesh, and every rank took the route and its own shards."""
    ranks, shape = LAYOUTS[layout]
    lines = [next(x for x in rank if x["case"] == route) for rank in _ranks_run(layout)]
    assert [x["rank"] for x in lines] == list(range(ranks))
    per_rank = shape[0] * shape[1] // ranks
    runs = [[(ub * shape[1] + ib) // per_rank for ib in range(shape[1])] for ub in range(shape[0])]
    assert all(x["route"] == route and x["owners"] == runs for x in lines)
    dtype, path = PROC_ROUTES[route]
    spec = _gen()
    cfg = RunConfig(dtype=dtype, path=path, mesh_shape=shape)
    state, mesh = par.factorize_sharded(spec, cfg, mesh=make_mesh(0, 0, shape, device="cpu"))
    out = par.run(spec, cfg, "cpu")[0]
    assert {x["factors_sha256"] for x in lines} == {factor_digest(state)}
    assert {x["text_sha256"] for x in lines} == {hashlib.sha256(out.encode()).hexdigest()}


def test_two_ranks_inst0_f64_golden():
    lines = [next(x for x in rank if x["case"] == "inst0") for rank in _ranks_run("2-ranks-2x2")]
    assert [x["golden"] for x in lines] == [True, True]


def test_a_failed_rank_fails_the_run(tmp_path):
    cases = json.dumps([{"name": "missing", "input": str(tmp_path / "none.in"), "dtype": "float64",
                         "mesh": [1, 2]}])
    results = launch.spawn(2, ["--device", "cpu", "--cases", cases], RANKS_TIMEOUT)
    assert any(rc != 0 for rc, _, _ in results)
    with pytest.raises(RuntimeError, match="exited with"):
        launch.rank_lines(results)


def test_ranks_past_their_timeout_are_ended():
    cases = json.dumps([{"name": "inst0", "input": str(FIXTURES / "inst0.in"), "dtype": "float64",
                         "mesh": [1, 2]}])
    with pytest.raises(TimeoutError):
        launch.spawn(2, ["--device", "cpu", "--cases", cases], 0.1)


def test_a_rank_that_imported_jax_fails():
    """This test process imported jax: the ranks' closing check refuses it
    (the ranks above passed it)."""
    with pytest.raises(RuntimeError, match="jax"):
        launch.check_no_jax()


def test_a_world_mesh_needs_the_world():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh(0, 0, (2, 3), device="cpu", world=(3, 2))


@pytest.mark.parametrize("route", list(PROC_ROUTES))
def test_world_of_one_rank_in_process(route):
    """A gloo world of one rank in this process: the process groups are
    made, the whole-table and top-1 gathers run over the world, and the
    bits are the one process's."""
    dtype, path = PROC_ROUTES[route]
    spec, cfg = _gen(), RunConfig(dtype=dtype, path=path, mesh_shape=(2, 3))
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, device="cpu")
    try:
        mesh = multihost.world_mesh(spec, cfg, "cpu")
        assert mesh.groups is not None and len(mesh.groups) == 2 + 3
        state, _ = multihost.factorize_multihost(spec, cfg, mesh=mesh)
        out, top1 = multihost.run(spec, cfg, "cpu")
    finally:
        multihost.shutdown()
    want, _ = par.factorize_sharded(spec, cfg, device="cpu")
    assert factor_digest(state) == factor_digest(want)
    assert out == par.run(spec, cfg, "cpu")[0]
