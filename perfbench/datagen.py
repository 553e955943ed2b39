"""The cells' data, made from ``--seed``.  A configuration's
``data.recipe`` names a module ``perfbench/recipes/<recipe>.py`` whose
``make(cfg, seed, root, device)`` returns the :class:`Instance`; the
recipe is found by name (``registry.recipe``), so a configuration that
needs a new recipe adds a file and edits none.

The ``.in`` writer and reader here are the benchmark's own, so nothing
the program derives from its input reaches the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class Instance:
    """One problem: the ``.in`` header and its ratings, sorted row-major."""

    iters: int
    alpha: float
    features: int
    users: int
    items: int
    rows: np.ndarray  # int64[nnz]
    cols: np.ndarray  # int64[nnz]
    vals: np.ndarray  # float64[nnz]

    @property
    def nnz(self) -> int:
        return int(self.rows.size)


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """numpy's generator for ``seed`` (any whole number, negative or past
    64 bits included)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def read_checked(root: str, rel: str, sha256: str) -> bytes:
    """The bytes of ``root/rel``, refused unless their sha256 is ``sha256``."""
    with open(os.path.join(root, rel), "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise ValueError(f"{rel}: sha256 {got} is not the configuration's {sha256}")
    return data


def parse_in(data: bytes) -> Instance:
    """A ``.in`` payload: iters, alpha, k, ``users items nnz``, then the
    ``row col value`` lines."""
    head = data.split(b"\n", 4)
    iters, alpha, k = int(head[0]), float(head[1]), int(head[2])
    users, items, nnz = (int(t) for t in head[3].split())
    body = np.array(head[4].split()[: 3 * nnz], dtype=np.float64).reshape(nnz, 3)
    return Instance(iters, alpha, k, users, items, body[:, 0].astype(np.int64), body[:, 1].astype(np.int64),
                    body[:, 2].copy())


def format_in(inst: Instance) -> str:
    """The ``.in`` text of ``inst`` (values printed with one decimal, as the
    MovieLens fixtures carry them)."""
    head = f"{inst.iters}\n{inst.alpha}\n{inst.features}\n{inst.users} {inst.items} {inst.nnz}\n"
    return head + "".join(f"{r} {c} {v:.1f}\n" for r, c, v in
                          zip(inst.rows.tolist(), inst.cols.tolist(), inst.vals.tolist()))


def sorted_row_major(items: int, rows, cols, vals) -> tuple:
    """The ratings in row-major order."""
    order = np.argsort(rows * items + cols, kind="stable")
    return rows[order], cols[order], vals[order]


def check_header(cfg: dict, inst: Instance) -> None:
    want = (cfg["iters"], cfg["alpha"], cfg["features"], cfg["users"], cfg["items"], cfg["ratings"])
    got = (inst.iters, inst.alpha, inst.features, inst.users, inst.items, inst.nnz)
    if want != got:
        raise ValueError(f"data {got} is not the configuration's {want}")


def make(cfg: dict, seed: int, root: str, device: str = "cpu") -> Instance:
    """The configuration's data for ``seed``, made by its recipe."""
    from perfbench import registry

    inst = registry.recipe(cfg["data"]["recipe"], root)(cfg, seed, root, device)
    check_header(cfg, inst)
    return inst
