"""The COO step, the sparse route for problems whose dense A does not fit:
the port of ``recsys_tpu/ops/coo.py`` (ROADMAP A7).

The JAX module is plain XLA with no Pallas, so this is plain torch.  Both
forms read the pre-step factors (stable-snapshot semantics,
``matFact.c:38-39``) and gather one L row and one R row per rating:

* ``coo_gd_step`` (:133): the per-entry gradients are summed per row of L
  over the row-sorted entries and per row of R over the ``perm``-sorted
  entries.  The JAX module's ``segment_sum`` becomes
  ``torch.segment_reduce`` over the sorted entries, which sums each
  segment in entry order on both the CPU and the card: no float atomics
  (``index_add_``/``scatter_add_`` would add in a different order on every
  run of the card, and exact f64 takes none), and the same for every
  dtype.
* ``coo_gd_step_cumsum`` (:100): each segment sum as the difference of two
  rows of one prefix sum along the entries, ``S = [0; cumsum(g)]``,
  ``delta[s] = S[start[s+1]] - S[start[s]]``.  It trades the segment
  reduction for one scan and two gathers of boundary rows, at the price
  of O(eps * |S|) cancellation, so the engine takes it only for the
  speed dtypes on the card (``engine/trainer.py::_coo_use_cumsum``).

The builders keep the JAX module's arrays (host numpy) and add what the
segment reduction needs: each row's and each column's entry count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from recsys_tpu_torch.utils.timing import h2d


def require_row_major(spec) -> None:
    """The format invariant every sparse builder relies on (:30): entries
    strictly increasing in (row, col), i.e. row-major with no duplicate
    cells.  Unsorted input would build wrong segments and train silently
    wrong."""
    key = spec.rows.astype(np.int64) * spec.items + spec.cols
    if key.size > 1 and not bool(np.all(np.diff(key) > 0)):
        raise ValueError(
            "entries must be row-major sorted with unique (row, col) cells "
            "(the .in format invariant, reference util.c:29-34)"
        )


class CooData(NamedTuple):
    """COO entries of the segment-sum step (:44), all nnz long but the counts."""

    rows: np.ndarray  # int32[nnz], non-decreasing
    cols: np.ndarray  # int32[nnz]
    vals: np.ndarray  # dtype[nnz]
    perm: np.ndarray  # int32[nnz], argsort by (col, row)
    cols_sorted: np.ndarray  # int32[nnz] == cols[perm], non-decreasing
    row_counts: np.ndarray  # int64[users], entries of each row
    col_counts: np.ndarray  # int64[items], entries of each column


def make_coo_inputs(spec, dtype=np.float32) -> CooData:
    """:54, with each segment's length."""
    require_row_major(spec)
    perm = np.lexsort((spec.rows, spec.cols)).astype(np.int32)
    return CooData(
        rows=spec.rows.astype(np.int32),
        cols=spec.cols.astype(np.int32),
        vals=spec.vals.astype(dtype),
        perm=perm,
        cols_sorted=spec.cols[perm].astype(np.int32),
        row_counts=np.bincount(spec.rows, minlength=spec.users).astype(np.int64),
        col_counts=np.bincount(spec.cols, minlength=spec.items).astype(np.int64),
    )


class CooSegData(NamedTuple):
    """COO arrays in both sort orders and the segment boundaries (:66)."""

    rows: np.ndarray  # int32[nnz] row-major
    cols: np.ndarray
    vals: np.ndarray
    rows_cs: np.ndarray  # int32[nnz] col-major order
    cols_cs: np.ndarray
    vals_cs: np.ndarray
    row_start: np.ndarray  # int32[users+1] entry offsets per row
    col_start: np.ndarray  # int32[items+1] entry offsets per column


def make_coo_seg_inputs(spec, dtype=np.float32) -> CooSegData:
    """:79."""
    require_row_major(spec)
    perm = np.lexsort((spec.rows, spec.cols))
    row_start = np.zeros(spec.users + 1, dtype=np.int32)
    np.cumsum(np.bincount(spec.rows, minlength=spec.users), out=row_start[1:])
    col_start = np.zeros(spec.items + 1, dtype=np.int32)
    np.cumsum(np.bincount(spec.cols, minlength=spec.items), out=col_start[1:])
    return CooSegData(
        rows=spec.rows.astype(np.int32),
        cols=spec.cols.astype(np.int32),
        vals=spec.vals.astype(dtype),
        rows_cs=spec.rows[perm].astype(np.int32),
        cols_cs=spec.cols[perm].astype(np.int32),
        vals_cs=spec.vals[perm].astype(dtype),
        row_start=row_start,
        col_start=col_start,
    )


def to_device(data, device, dtype: torch.dtype):
    """``data`` (either builder's) on ``device``: index arrays as int64, the
    ratings in ``dtype``, each by a ``timing.h2d``."""
    def move(name, x):
        return h2d(np.ascontiguousarray(x), device, dtype if name.startswith("vals") else torch.int64)

    return type(data)(*(move(name, x) for name, x in zip(data._fields, data)))


def _err(L, R, rows, cols, vals, alpha2):
    l, r = L[rows], R[cols]
    return l, r, alpha2 * (vals - torch.sum(l * r, dim=-1))


def _segment_diffs(g, start):
    """Each segment's sum of ``g``'s rows as the difference of two rows of
    ``S = [0; cumsum(g)]`` at ``start`` and ``start[1:]``.  The scan runs
    along the innermost dimension of g's transpose: along the entries of a
    (nnz, k) tensor, the card's scan would walk each of the k columns in
    one thread."""
    S = torch.cumsum(g.T, dim=1)
    S = torch.cat([torch.zeros((S.shape[0], 1), dtype=S.dtype, device=S.device), S], dim=1)
    return (S[:, start[1:]] - S[:, start[:-1]]).T


def coo_gd_step_cumsum(L, R, data: CooSegData, alpha2):
    """One step by prefix sums and boundary differences (:100); ``data``
    from ``to_device``."""
    _, r, err = _err(L, R, data.rows, data.cols, data.vals, alpha2)
    dL = _segment_diffs(err[:, None] * r, data.row_start)
    l2, _, err2 = _err(L, R, data.rows_cs, data.cols_cs, data.vals_cs, alpha2)
    dR = _segment_diffs(err2[:, None] * l2, data.col_start)
    return L + dL, R + dR


def coo_gd_step(L, R, data: CooData, alpha2):
    """One step by sorted segment sums (:133); ``data`` from
    ``to_device``.  err_n = 2a (a_n - <L[i_n], R[j_n]>); dL sums err_n *
    R[j_n] into row i_n, dR err_n * L[i_n] into row j_n, each segment in
    entry order."""
    l, r, err = _err(L, R, data.rows, data.cols, data.vals, alpha2)
    dL = torch.segment_reduce(err[:, None] * r, "sum", lengths=data.row_counts, axis=0, unsafe=True)
    g_r = (err[:, None] * l)[data.perm]
    dR = torch.segment_reduce(g_r, "sum", lengths=data.col_counts, axis=0, unsafe=True)
    return L + dL, R + dR
