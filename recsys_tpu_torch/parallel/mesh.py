"""2-D mesh of shards with the balanced-grid heuristic (port of
``recsys_tpu/parallel/mesh.py``).

JAX runs the sharded engine from one controller over a ('u', 'i') device
mesh; the port keeps that shape as a (pu, pi) grid of ``torch.device``s,
one a shard.  Several shards may name one device: by default every shard
sits on the run's device (the tests' CPU, or one H100), and a caller may
pass one device per shard to spread them over several cards.  Placement on
several cards is written but not verified (the machine it was measured on
has one card).  Nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

AXIS_USERS = "u"
AXIS_ITEMS = "i"


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
    """``devices[ub][ib]``: the device of shard (ub, ib)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def home(self) -> torch.device:
        """Shard (0, 0)'s device: where the engine keeps whole tables."""
        return self.devices[0][0]

    def shards(self):
        """(ub, ib, device) of every shard, row by row."""
        return [(ub, ib, d) for ub, row in enumerate(self.devices) for ib, d in enumerate(row)]


def make_mesh(users: int, items: int, shape: tuple[int, int] | None = None, devices=None,
              device="cuda") -> Mesh:
    """The (pu, pi) mesh: ``devices`` is one device a shard (row by row),
    or None to put ``shape``'s shards all on ``device``.  Without a shape,
    ``balanced_grid`` picks one over ``len(devices)`` shards."""
    if devices is None:
        if shape is None:
            raise ValueError("give the mesh's shape, or one device a shard")
        devices = [device] * (shape[0] * shape[1])
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = balanced_grid(n, users, items)
    pu, pi = shape
    if pu < 1 or pi < 1 or pu * pi != n:
        raise ValueError(f"mesh {tuple(shape)} does not match {n} shard devices")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return Mesh(tuple(tuple(devices[ub * pi:(ub + 1) * pi]) for ub in range(pu)))
