"""Recipe ``fixture_relabel``: a ratings file of the reference's ``.in``
format (``data.file``), checked against its sha256 (``data.sha256``).
Seed 0 keeps its labels; any other seed relabels users and items by
seeded permutations and sorts row-major again.  Every rating is kept."""

from __future__ import annotations

import dataclasses

from perfbench.datagen import Instance, check_header, parse_in, read_checked, rng_for, sorted_row_major


def make(cfg: dict, seed: int, root: str, device: str = "cpu") -> Instance:
    src = parse_in(read_checked(root, cfg["data"]["file"], cfg["data"]["sha256"]))
    check_header(cfg, src)
    if seed == 0:
        return src
    rng = rng_for(seed)
    pu, pi = rng.permutation(src.users), rng.permutation(src.items)
    rows, cols, vals = sorted_row_major(src.items, pu[src.rows], pi[src.cols], src.vals)
    return dataclasses.replace(src, rows=rows, cols=cols, vals=vals)
