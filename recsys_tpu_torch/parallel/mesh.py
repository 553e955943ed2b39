"""2-D mesh of shards with the balanced-grid heuristic (port of
``recsys_tpu/parallel/mesh.py``).

JAX runs the sharded engine over a ('u', 'i') device mesh; the port keeps
that shape as a (pu, pi) grid of shards, each with an owning rank and a
``torch.device``.  In one process (``make_mesh`` without ``world``) rank 0
owns every shard: by default all sit on the run's device (the tests' CPU,
or one H100), and a caller may pass one device per shard to spread them
over several cards.  Placement on several cards is written but not
verified (the machine it was measured on has one card).

With ``world=(ranks, shards a rank)`` the mesh spans the processes of a
``torch.distributed`` group (``parallel/multihost.py``): shards go to ranks
in row-major contiguous runs, as JAX orders a global mesh's devices by
process, each rank sees only its own shards' devices, and the process
groups of every mesh row and column are made once, on every rank in the
same order.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple

import torch

AXIS_USERS = "u"
AXIS_ITEMS = "i"
# How long a collective of a multi-process mesh waits for a lost rank
# before it fails (process groups of ``make_mesh`` and ``multihost.initialize``).
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def balanced_grid(n_devices: int, users: int, items: int) -> tuple[int, int]:
    """Pick (pu, pi), pu*pi == n_devices, minimizing users/pu + items/pi
    (JAX ``mesh.py:28``)."""
    best = None
    for pu in range(1, n_devices + 1):
        if n_devices % pu:
            continue
        pi = n_devices // pu
        cost = users / pu + items / pi
        if best is None or cost < best[0]:
            best = (cost, pu, pi)
    return best[1], best[2]


class Mesh(NamedTuple):
    """``devices[ub][ib]``: the device of shard (ub, ib) if this rank owns
    it, else None; ``owners[ub][ib]``: the shard's rank; ``groups``: None in
    one process, else {(axis, b): (ranks, process group)} of every mesh row
    ('u', ub) and column ('i', ib), its ranks ascending."""

    devices: tuple[tuple[torch.device | None, ...], ...]
    owners: tuple[tuple[int, ...], ...]
    rank: int = 0
    groups: dict | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def home(self) -> torch.device:
        """The device of this rank's first shard: where the engine keeps
        whole tables (shard (0, 0)'s in one process)."""
        return next(d for _, _, d in self.shards())

    def shards(self):
        """(ub, ib, device) of every shard this rank owns, row by row."""
        return [(ub, ib, d) for ub, row in enumerate(self.devices) for ib, d in enumerate(row) if d is not None]

    def line(self, axis: str, b: int) -> list[int]:
        """The ranks of the shards that read block b of an ``axis`` table
        (mesh row b for 'u', column b for 'i'), in ascending shard order."""
        return list(self.owners[b]) if axis == AXIS_USERS else [row[b] for row in self.owners]

    def holders(self, axis: str, b: int) -> list[int]:
        """The distinct ranks of ``line(axis, b)``, ascending."""
        return sorted(set(self.line(axis, b)))


def _with_groups(mesh: Mesh) -> Mesh:
    """``mesh`` with the process group of every mesh row, then every
    column, made on every rank in this order (``dist.new_group`` is
    collective: every rank makes every group)."""
    import torch.distributed as dist

    keys = [(AXIS_USERS, ub) for ub in range(mesh.shape[0])] + [(AXIS_ITEMS, ib) for ib in range(mesh.shape[1])]
    groups = {}
    for axis, b in keys:
        ranks = mesh.holders(axis, b)
        groups[axis, b] = (ranks, dist.new_group(ranks=ranks, timeout=COLLECTIVE_TIMEOUT))
    return mesh._replace(groups=groups)


def make_mesh(users: int, items: int, shape: tuple[int, int] | None = None, devices=None,
              device="cuda", world: tuple[int, int] | None = None) -> Mesh:
    """The (pu, pi) mesh.  In one process ``devices`` is one device a shard
    (row by row), or None to put ``shape``'s shards all on ``device``;
    without a shape ``balanced_grid`` picks one over ``len(devices)`` shards.
    ``world=(ranks, shards a rank)`` spans the initialized
    ``torch.distributed`` world: this rank's shards on ``device``, ``shape``
    (if given) holding ranks x shards a rank shards, else ``balanced_grid``'s."""
    if world is not None:
        return _world_mesh(users, items, shape, device, *world)
    if devices is None:
        if shape is None:
            raise ValueError("give the mesh's shape, or one device a shard")
        devices = [device] * (shape[0] * shape[1])
    devices = [_checked(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = balanced_grid(n, users, items)
    pu, pi = shape
    if pu < 1 or pi < 1 or pu * pi != n:
        raise ValueError(f"mesh {tuple(shape)} does not match {n} shard devices")
    return Mesh(tuple(tuple(devices[ub * pi:(ub + 1) * pi]) for ub in range(pu)), ((0,) * pi,) * pu)


def _checked(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return d


def _world_mesh(users: int, items: int, shape, device, ranks: int, per_rank: int) -> Mesh:
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != ranks:
        raise RuntimeError(f"a mesh over {ranks} ranks needs a torch.distributed world of {ranks} "
                           "(multihost.initialize)")
    if shape is None:
        shape = balanced_grid(ranks * per_rank, users, items)
    pu, pi = shape
    if pu < 1 or pi < 1 or pu * pi != ranks * per_rank:
        raise ValueError(f"mesh {tuple(shape)} does not hold {ranks} ranks x {per_rank} shards")
    device, rank = _checked(device), dist.get_rank()
    owners = tuple(tuple((ub * pi + ib) // per_rank for ib in range(pi)) for ub in range(pu))
    devices = tuple(tuple(device if r == rank else None for r in row) for row in owners)
    return _with_groups(Mesh(devices, owners, rank))
