"""Recipe ``movielens_skew``: a MovieLens-shaped matrix at the
configuration's counts, with user degrees and item popularity resampled
from a source file's empirical degree curves (see ``make``)."""

from __future__ import annotations

import numpy as np

from perfbench.datagen import Instance, parse_in, read_checked, rng_for, sorted_row_major


def _fix_total(d: np.ndarray, total: int, lo: int, hi: int, rng) -> np.ndarray:
    """Add or take 1 from seeded rows, within [lo, hi], until ``d`` sums to ``total``."""
    while (diff := total - int(d.sum())) != 0:
        ok = np.flatnonzero(d < hi) if diff > 0 else np.flatnonzero(d > lo)
        pick = rng.choice(ok, size=min(abs(diff), ok.size), replace=False)
        d[pick] += 1 if diff > 0 else -1
    return d


def make(cfg: dict, seed: int, root: str, device: str = "cpu") -> Instance:
    """A MovieLens-shaped matrix at ``cfg``'s counts, from ``seed``:

    1. user degrees: ``users`` draws from the source's user degrees, scaled
       to sum to ``ratings``, at least ``min_user_ratings`` and at most
       ``rated_items`` each;
    2. ``rated_items`` ids of ``items`` hold ratings (a seeded choice), each
       with a popularity drawn from the source's item degrees;
    3. each user rates its degree's worth of distinct items, drawn without
       replacement in proportion to popularity (the smallest keys of
       Exp(1) / popularity, sorted on ``device`` from a generator seeded
       there);
    4. an item left with no rating takes one from a seeded user's most
       rated item that has two or more, so every chosen id holds a rating;
    5. values from the source's histogram of values; sorted row-major.
    """
    import torch

    d = cfg["data"]
    src = parse_in(read_checked(root, d["degrees_from"], d["sha256"]))
    users, items, n_items, total, lo = (cfg["users"], cfg["items"], d["rated_items"], cfg["ratings"],
                                        d["min_user_ratings"])
    rng = rng_for(seed)
    src_u = np.bincount(src.rows, minlength=src.users)
    src_i = np.bincount(src.cols, minlength=src.items)
    src_i = src_i[src_i > 0]
    deg = rng.choice(src_u, size=users).astype(np.float64)
    deg = np.clip(np.rint(deg * (total / deg.sum())), lo, n_items).astype(np.int64)
    deg = _fix_total(deg, total, lo, n_items, rng)
    ids = np.sort(rng.choice(items, size=n_items, replace=False))
    pop = rng.choice(src_i, size=n_items).astype(np.float64)

    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    w = torch.from_numpy(pop).to(device)
    degs = torch.from_numpy(deg).to(device)
    rows_l, cols_l = [], []
    for u0 in range(0, users, 1024):
        u1 = min(u0 + 1024, users)
        keys = torch.empty((u1 - u0, n_items), dtype=torch.float64, device=device).exponential_(generator=gen) / w
        order = keys.argsort(dim=1)
        take = torch.arange(n_items, device=device)[None, :] < degs[u0:u1, None]
        cols_l.append(order[take].cpu())
        rows_l.append(torch.repeat_interleave(torch.arange(u0, u1), degs[u0:u1].cpu()))
    rows = torch.cat(rows_l).numpy().astype(np.int64)
    cols = torch.cat(cols_l).numpy().astype(np.int64)

    counts = np.bincount(cols, minlength=n_items)
    starts = np.concatenate(([0], np.cumsum(deg)))
    order = rng.permutation(users)
    pos = 0
    for j in np.flatnonzero(counts == 0):
        while True:
            u = order[pos % users]
            pos += 1
            seg = slice(starts[u], starts[u + 1])
            its = cols[seg]
            if (its == j).any():
                continue
            t = starts[u] + int(np.argmax(counts[its]))
            if counts[cols[t]] < 2:
                continue
            counts[cols[t]] -= 1
            cols[t] = j
            counts[j] += 1
            break

    hist = np.bincount(np.rint(src.vals).astype(np.int64))
    levels = np.flatnonzero(hist)
    vals = rng.choice(levels, size=total, p=hist[levels] / hist.sum()).astype(np.float64)
    rows, cols, vals = sorted_row_major(items, rows, ids[cols], vals)
    return Instance(cfg["iters"], cfg["alpha"], cfg["features"], users, items, rows, cols, vals)
