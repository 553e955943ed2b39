"""Checkerboard decomposition: padding and COO bucketing for the 2-D mesh,
a copy of ``recsys_tpu/parallel/sharding.py`` (host numpy; each function
gives the JAX function's arrays exactly).

A is cut into pu x pi blocks, L into pu row blocks (read by every shard of
its mesh row), R into pi row blocks (every shard of its mesh column).
Users and items are padded up to mesh-axis multiples; padded factor rows
start at zero and receive zero gradient, padded item columns count as
rated.  COO entries are bucketed by owning shard, each bucket padded to the
largest with weight-0 entries, so every shard runs the same shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from recsys_tpu_torch.config import ProblemSpec


def pad_up(n: int, parts: int) -> int:
    return -(-n // parts) * parts


class CooShards(NamedTuple):
    """Per-shard COO buckets, shape (pu, pi, cap) each; local indices."""

    rows: np.ndarray  # int32, row index local to the u-block
    cols: np.ndarray  # int32, col index local to the i-block
    vals: np.ndarray  # dtype; 0.0 on padding
    weight: np.ndarray  # dtype; 1.0 real, 0.0 padding
    perm: np.ndarray  # int32, within-bucket col-major sort permutation
    cols_sorted: np.ndarray  # int32 == cols[perm] per bucket


def bucket_coo(spec: ProblemSpec, pu: int, pi: int, dtype=np.float32) -> tuple[CooShards, int, int]:
    """Bucket entries by owning (u-block, i-block) shard (JAX :49); returns
    (shards, u_block, i_block), the blocks the padded per-shard extents.
    A bucket keeps the file's row-major order; padding entries (row 0,
    col 0, weight 0) follow its real ones."""
    u_blk = pad_up(spec.users, pu) // pu
    i_blk = pad_up(spec.items, pi) // pi
    ou = spec.rows // u_blk
    oi = spec.cols // i_blk
    flat_owner = ou * pi + oi
    order = np.argsort(flat_owner, kind="stable")
    counts = np.bincount(flat_owner, minlength=pu * pi)
    cap = max(int(counts.max()), 1)

    def padded(arr, fill):
        out = np.full((pu * pi, cap), fill, dtype=arr.dtype)
        srt = arr[order]
        off = 0
        for b in range(pu * pi):
            c = counts[b]
            out[b, :c] = srt[off: off + c]
            off += c
        return out

    rows_b = padded((spec.rows - ou * u_blk).astype(np.int32), 0)
    cols_b = padded((spec.cols - oi * i_blk).astype(np.int32), 0)
    vals_b = padded(spec.vals.astype(dtype), 0)
    w_b = padded(np.ones(spec.nnz, dtype=dtype), 0)
    perm = np.empty((pu * pi, cap), dtype=np.int32)
    cols_sorted = np.empty((pu * pi, cap), dtype=np.int32)
    for b in range(pu * pi):
        p = np.argsort(cols_b[b], kind="stable").astype(np.int32)
        perm[b] = p
        cols_sorted[b] = cols_b[b][p]
    shape = (pu, pi, cap)
    return (
        CooShards(*(x.reshape(shape) for x in (rows_b, cols_b, vals_b, w_b, perm, cols_sorted))),
        u_blk,
        i_blk,
    )


class CooSegShards(NamedTuple):
    """Per-shard dual-sorted COO and segment boundaries of the prefix-sum
    step.  Entry arrays (pu, pi, cap); boundary arrays (pu, pi, blk+1).
    Padding entries carry weight 0 and sit at the end of each bucket,
    pointing at the last local row/col, so the segments stay in order."""

    rows: np.ndarray  # int32, row-major bucket order, local indices
    cols: np.ndarray
    vals: np.ndarray
    w: np.ndarray
    rows_cs: np.ndarray  # col-major bucket order
    cols_cs: np.ndarray
    vals_cs: np.ndarray
    w_cs: np.ndarray
    row_start: np.ndarray  # int32 (pu, pi, u_blk+1)
    col_start: np.ndarray  # int32 (pu, pi, i_blk+1)


def bucket_coo_seg(spec: ProblemSpec, pu: int, pi: int, dtype=np.float32) -> tuple[CooSegShards, int, int]:
    """Bucket entries by owning shard in both sort orders, with each
    bucket's segment boundaries (JAX :124)."""
    u_blk = pad_up(spec.users, pu) // pu
    i_blk = pad_up(spec.items, pi) // pi
    ou = spec.rows // u_blk
    oi = spec.cols // i_blk
    owner = ou * pi + oi
    nb = pu * pi
    counts = np.bincount(owner, minlength=nb)
    cap = max(int(counts.max()), 1)
    rows_l = (spec.rows - ou * u_blk).astype(np.int32)
    cols_l = (spec.cols - oi * i_blk).astype(np.int32)

    def bucketize(order_keys, pad_row, pad_col):
        order = np.lexsort(order_keys + (owner,))
        rows_b = np.full((nb, cap), pad_row, np.int32)
        cols_b = np.full((nb, cap), pad_col, np.int32)
        vals_b = np.zeros((nb, cap), dtype)
        w_b = np.zeros((nb, cap), dtype)
        off = 0
        for b in range(nb):
            c = counts[b]
            sl = order[off: off + c]
            rows_b[b, :c] = rows_l[sl]
            cols_b[b, :c] = cols_l[sl]
            vals_b[b, :c] = spec.vals[sl]
            w_b[b, :c] = 1.0
            off += c
        return rows_b, cols_b, vals_b, w_b

    rows_r, cols_r, vals_r, w_r = bucketize((spec.cols, spec.rows), u_blk - 1, 0)
    rows_c, cols_c, vals_c, w_c = bucketize((spec.rows, spec.cols), 0, i_blk - 1)
    row_start = np.zeros((nb, u_blk + 1), np.int32)
    col_start = np.zeros((nb, i_blk + 1), np.int32)
    for b in range(nb):
        c = counts[b]
        np.cumsum(np.bincount(rows_r[b, :c], minlength=u_blk), out=row_start[b, 1:])
        np.cumsum(np.bincount(cols_c[b, :c], minlength=i_blk), out=col_start[b, 1:])
    sh3 = (pu, pi, cap)
    return (
        CooSegShards(
            *(x.reshape(sh3) for x in (rows_r, cols_r, vals_r, w_r, rows_c, cols_c, vals_c, w_c)),
            row_start=row_start.reshape(pu, pi, u_blk + 1),
            col_start=col_start.reshape(pu, pi, i_blk + 1),
        ),
        u_blk,
        i_blk,
    )


def pad_factors(L: np.ndarray, R: np.ndarray, pu: int, pi: int):
    """Zero-pad factor tables to mesh-axis multiples (JAX :188)."""
    users, k = L.shape
    items, _ = R.shape
    up, ip = pad_up(users, pu), pad_up(items, pi)
    if up != users:
        L = np.concatenate([L, np.zeros((up - users, k), L.dtype)], axis=0)
    if ip != items:
        R = np.concatenate([R, np.zeros((ip - items, k), R.dtype)], axis=0)
    return L, R


def dense_blocks(spec: ProblemSpec, pu: int, pi: int, dtype=np.float32):
    """Dense A and M padded to (pad_up(users, pu), pad_up(items, pi)) (JAX :201)."""
    up, ip = pad_up(spec.users, pu), pad_up(spec.items, pi)
    a = np.zeros((up, ip), dtype=np.float64)
    a[spec.rows, spec.cols] = spec.vals
    m = np.zeros((up, ip), dtype=np.float64)
    m[spec.rows, spec.cols] = 1.0
    return a.astype(dtype), m.astype(dtype)


def rated_mask_padded(spec: ProblemSpec, pu: int, pi: int, users_pad: int | None = None,
                      items_pad: int | None = None) -> np.ndarray:
    """Bool rated mask padded like ``dense_blocks`` (JAX :211); padded items
    count as rated so they never win the top-1.  Explicit pad dims override
    the mesh multiple (the tiled route pads further)."""
    up = users_pad if users_pad is not None else pad_up(spec.users, pu)
    ip = items_pad if items_pad is not None else pad_up(spec.items, pi)
    m = np.zeros((up, ip), dtype=bool)
    m[spec.rows, spec.cols] = True
    m[:, spec.items:] = True
    return m


def pallas_block_dims(n: int, parts: int, quantum: int, tile: int) -> tuple[int, int, int]:
    """(n_pad, block, tile) (JAX :225): the per-shard block a multiple of
    ``quantum``, and of ``tile`` when larger."""
    blk = pad_up(-(-n // parts), quantum)
    if blk > tile:
        blk = pad_up(blk, tile)
        t = tile
    else:
        t = blk
    return parts * blk, blk, t
