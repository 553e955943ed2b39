"""Recipe ``uniform_rows``: an instance after the reference's naming
convention ``inst<users>-<items>-<k>-<min>-<max>``, where every user rates
between ``data.min_user_ratings`` and ``data.max_user_ratings`` distinct
items, with exactly the configuration's ``ratings`` in all (see ``make``)."""

from __future__ import annotations

import numpy as np

from perfbench.datagen import Instance, rng_for, sorted_row_major


def exact_counts(users: int, total: int, lo: int, hi: int, rng) -> np.ndarray:
    """``users`` counts, each uniform over ``lo``-``hi``, then nudged by 1 at
    seeded users, each kept within ``lo``-``hi``, until they sum to ``total``."""
    if not lo * users <= total <= hi * users:
        raise ValueError(f"{total} ratings do not fit {users} users of {lo}-{hi} each")
    deg = rng.integers(lo, hi + 1, users)
    while (diff := total - int(deg.sum())) != 0:
        room = np.flatnonzero(deg < hi) if diff > 0 else np.flatnonzero(deg > lo)
        deg[rng.choice(room, size=min(abs(diff), room.size), replace=False)] += 1 if diff > 0 else -1
    return deg


def distinct_items(users: int, items: int, n: int, rng) -> np.ndarray:
    """(users, n) items, distinct along each row and each row a uniform
    draw without replacement: pick ``j`` is uniform over the ``items - j``
    items not picked yet, shifted past the earlier picks in ascending order."""
    picks = np.empty((users, n), dtype=np.int64)
    for j in range(n):
        c = rng.integers(0, items - j, users)
        for p in np.sort(picks[:, :j], axis=1).T:
            c += c >= p
        picks[:, j] = c
    return picks


def make(cfg: dict, seed: int, root: str, device: str = "cpu") -> Instance:
    """The configuration's instance for ``seed``:

    1. each user's count of ratings is uniform over the data's
       ``min_user_ratings``-``max_user_ratings``, then nudged to sum to
       exactly ``ratings`` (``exact_counts``);
    2. a user's items are the first of its count of distinct uniform picks
       (``distinct_items``);
    3. values are uniform over 1-5; the ratings are sorted row-major.
    """
    d = cfg["data"]
    users, items, lo, hi = cfg["users"], cfg["items"], d["min_user_ratings"], d["max_user_ratings"]
    rng = rng_for(seed)
    deg = exact_counts(users, cfg["ratings"], lo, hi, rng)
    keep = np.arange(hi)[None, :] < deg[:, None]
    cols = distinct_items(users, items, hi, rng)[keep]
    rows = np.repeat(np.arange(users, dtype=np.int64), deg)
    vals = rng.integers(1, 6, rows.size).astype(np.float64)
    rows, cols, vals = sorted_row_major(items, rows, cols, vals)
    return Instance(cfg["iters"], cfg["alpha"], cfg["features"], users, items, rows, cols, vals)
