"""The port's scaling model (``recsys_tpu_torch/bench/scaling.py``):
``comm_volume_bytes`` against the bytes the sharded engine's exchange
(``parallel/step.py::_exchange``) moves, and ``measure_mesh`` on the CPU.

The exchange is read from the view of each rank of a (pu, pi) mesh of one
shard a rank: the rank's own shard alone on the CPU, its row and column
groups by rank list, and ``torch.distributed.all_gather`` replaced by a
counter that hands the rank's own stack back in every slot.  Training one
iteration and two, the difference is one iteration's exchange: the final
gather of the whole tables cancels out."""

import pytest
import torch

from recsys_tpu_torch.bench import scaling
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.parallel import engine
from recsys_tpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS, Mesh

CPU = torch.device("cpu")
# (config, the sharded route it takes on the CPU)
CASES = {
    "tiled": (RunConfig(dtype="float32"), "tiled"),
    "bell f64": (RunConfig(dtype="float64", path="bell"), "bell"),
    "bell bf16": (RunConfig(dtype="bfloat16", path="bell"), "bell"),
    "dense f64": (RunConfig(dtype="float64", path="dense"), "dense"),
    "coo f64": (RunConfig(dtype="float64", path="coo"), "coo"),
    "coo_seg f32": (RunConfig(dtype="float32", path="coo"), "coo_seg"),
}


def _rank_mesh(pu: int, pi: int, rank: int) -> Mesh:
    """Rank ``rank``'s view of a (pu, pi) mesh of one shard a rank, with
    every row's and column's group as its rank list."""
    owners = tuple(tuple(ub * pi + ib for ib in range(pi)) for ub in range(pu))
    devices = tuple(tuple(CPU if r == rank else None for r in row) for row in owners)
    mesh = Mesh(devices, owners, rank)
    groups = {(AXIS_USERS, ub): (mesh.holders(AXIS_USERS, ub), None) for ub in range(pu)}
    groups.update({(AXIS_ITEMS, ib): (mesh.holders(AXIS_ITEMS, ib), None) for ib in range(pi)})
    return mesh._replace(groups=groups)


def _received(monkeypatch, spec, cfg, mesh, world: int) -> int:
    """Bytes this rank receives over a ``factorize_sharded`` run."""
    import torch.distributed as dist

    got = [0]

    def all_gather(bufs, raw, group=None):
        for b in bufs:
            b.copy_(raw)
        got[0] += (len(bufs) - 1) * raw.numel() * raw.element_size()

    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    engine.factorize_sharded(spec, cfg, mesh=mesh)
    return got[0]


@pytest.mark.parametrize("shape", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
@pytest.mark.parametrize("case", list(CASES))
def test_comm_volume_is_what_the_exchange_moves(monkeypatch, case, shape):
    """Every rank receives, per iteration, exactly ``comm_volume_bytes`` of
    ``exchange_shape``'s partials: (pi - 1) ΔL blocks of its mesh row and
    (pu - 1) ΔR blocks of its column."""
    import dataclasses

    cfg, route = CASES[case]
    pu, pi = shape
    spec = generate_instance(26, 33, 5, 2, 7, iters=1, alpha=0.01, seed=3)
    assert engine.sharded_route(spec, cfg, _rank_mesh(pu, pi, 0)) == route
    u_rows, i_rows, cols, es = scaling.exchange_shape(spec, cfg, pu, pi, CPU)
    want = scaling.comm_volume_bytes(u_rows, i_rows, cols, pu, pi, es)
    assert want > 0
    for rank in range(pu * pi):
        mesh = _rank_mesh(pu, pi, rank)
        one = _received(monkeypatch, spec, cfg, mesh, pu * pi)
        two = _received(monkeypatch, dataclasses.replace(spec, iters=2), cfg, mesh, pu * pi)
        assert two - one == want, (rank, two - one, want)


def test_comm_volume_law():
    """(pi - 1) u-side and (pu - 1) i-side partials; nothing on one card."""
    assert scaling.comm_volume_bytes(100, 40, 8, 1, 1, 4) == 0
    assert scaling.comm_volume_bytes(100, 40, 8, 2, 3, 4) == (2 * 100 + 1 * 40) * 8 * 4
    assert scaling.comm_volume_bytes(100, 40, 8, 4, 1, 8) == 3 * 40 * 8 * 8


def test_measure_mesh_one_row_per_shape():
    spec = generate_instance(20, 28, 4, 1, 6, iters=3, alpha=0.01, seed=9)
    shapes = [(1, 1), (2, 1), (2, 2)]
    rows = scaling.measure_mesh(spec, RunConfig(dtype="float32"), shapes, "cpu", repeats=2)
    assert [(pu, pi) for pu, pi, *_ in rows] == shapes
    assert all(w > 0 and spread >= 0 and route == "tiled" for _, _, w, spread, route in rows)


def test_projection_uses_the_exchange_and_the_roofline():
    """compute = the roofline floor over the cards; exchange = the law's
    bytes over NVLink's data-sheet rate."""
    from recsys_tpu_torch.bench.roofline import train_cost_model

    spec = generate_instance(60, 80, 8, 2, 9, iters=5, alpha=0.01, seed=4)
    cfg = RunConfig(dtype="float64", path="bell")
    compute, comm, serial, overlap = scaling.projected_efficiency(spec, cfg, "bell", 2, 2, CPU)
    assert compute == pytest.approx(train_cost_model(spec, cfg, "bell")[1] / 4)
    u_rows, i_rows, cols, es = scaling.exchange_shape(spec, cfg, 2, 2, CPU)
    assert comm == pytest.approx(scaling.comm_volume_bytes(u_rows, i_rows, cols, 2, 2, es) / 450e9)
    assert serial == pytest.approx(compute / (compute + comm)) and serial <= overlap <= 1.0
    assert scaling.projected_efficiency(spec, cfg, "host", 2, 2, CPU) is None
