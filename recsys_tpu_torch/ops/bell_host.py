"""Host-side BELL slot counting, the part of ``recsys_tpu/ops/bell.py`` that
path selection needs (``choose_path`` compares dense cells with BELL's
padded slots).  Copied so the port never imports the jax module;
the BELL training path itself is not ported yet (ROADMAP A4).

Sources: ``_guarded_buckets`` :132, ``_rows_merged_buckets`` :154,
``_degree_buckets`` :175, ``bell_side_slots`` :301, ``bell_slot_ratio``
:325, and the constants above them.
"""

from __future__ import annotations

import numpy as np

MIN_BUCKET_ROWS = 64
SMALL_SIDE_ENTRIES = 90_000
SMALL_MIN_BUCKET_ROWS = 128
SMALL_SLOT_GUARD = 1.5


def _guarded_buckets(counts_sorted: np.ndarray, min_rows: int) -> list[tuple[int, int, int]]:
    """Half-width-guarded buckets (large sides)."""
    out: list[tuple[int, int, int]] = []
    n = len(counts_sorted)
    start = 0
    while start < n and counts_sorted[start] > 0:
        w = int(counts_sorted[start])
        stop = int(np.searchsorted(-counts_sorted, -w, side="right"))
        # Merge narrow runs in, but never into rows less than half the
        # bucket width: a lone hub row must not pad a long tail.
        while stop - start < min_rows and stop < n and counts_sorted[stop] * 2 >= w:
            nxt = int(counts_sorted[stop])
            stop = int(np.searchsorted(-counts_sorted, -nxt, side="right"))
        out.append((start, stop, w))
        start = stop
    return out


def _rows_merged_buckets(counts_sorted: np.ndarray, min_rows: int) -> list[tuple[int, int, int]]:
    """Merge-by-rows buckets (small sides): absorb runs until ``min_rows``
    rows, then only rows of the bucket's own width."""
    out: list[tuple[int, int, int]] = []
    n = len(counts_sorted)
    start = 0
    while start < n and counts_sorted[start] > 0:
        w = int(counts_sorted[start])
        stop = start
        while stop < n and counts_sorted[stop] > 0 and (
            stop - start < min_rows or int(counts_sorted[stop]) == w
        ):
            stop += 1
        out.append((start, stop, w))
        start = stop
    return out


def _degree_buckets(counts_sorted: np.ndarray, min_rows: int = MIN_BUCKET_ROWS) -> list[tuple[int, int, int]]:
    """Contiguous (start, stop, width) buckets over a non-increasing degree
    sequence: merge-by-rows on small sides (slot-guarded), half-width
    guarded everywhere else."""
    if int(counts_sorted.sum()) <= SMALL_SIDE_ENTRIES:
        merged = _rows_merged_buckets(counts_sorted, SMALL_MIN_BUCKET_ROWS)
        guarded = _guarded_buckets(counts_sorted, min_rows)
        slots = lambda bs: sum(w * (b1 - b0) for (b0, b1, w) in bs)  # noqa: E731
        if slots(merged) <= SMALL_SLOT_GUARD * slots(guarded):
            return merged
        return guarded
    return _guarded_buckets(counts_sorted, min_rows)


def bell_side_slots(spec) -> tuple[int, int]:
    """(user-side, item-side) padded slot counts of the BELL format."""
    sides = []
    for coords, dim in ((spec.rows, spec.users), (spec.cols, spec.items)):
        sc = np.sort(np.bincount(coords, minlength=dim))[::-1]
        sides.append(sum(w * (b1 - b0) for (b0, b1, w) in _degree_buckets(sc)))
    return int(sides[0]), int(sides[1])


def bell_slot_ratio(spec) -> float:
    """Padded-slot overhead of the BELL format (1.0 = no padding)."""
    if spec.nnz == 0:
        return float("inf")
    su, si = bell_side_slots(spec)
    return (su + si) / (2.0 * spec.nnz)
