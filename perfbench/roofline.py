"""The chip's ceilings and the work of one job, priced the same whatever
route computes it.

A frozen copy of ``recsys_tpu_torch/bench/roofline.py`` (``iteration_work``,
``floor_seconds``, ``rated_rows``) at commit 5547fc7, with one change: the
float64 peak is the data sheet's tensor-core rate (67 TFLOP/s) and not the
CUDA-core rate (34), so that no route, however it computes, can read above
the chip.

* An iteration is 6·k FLOP per rating (the prediction once and both
  gradients) and moves A's ratings once (a value in the run's dtype and an
  int32 column index, CSR) plus the rows of L and R that hold a rating, each
  read and written once.
* A job's top-1 is 2·k FLOP per (user, item).
* The floor is ``max(FLOP / peak(dtype), bytes / HBM)``.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet (dense, 700 W).  float32 on the CUDA cores
# (TF32 is a lower precision); bfloat16 and float64 on the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float64": 67e12}
HBM_BYTES_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}


def rated_rows(rows: np.ndarray, cols: np.ndarray, users: int, items: int) -> tuple[int, int]:
    """(users, items) with at least one rating."""
    return (int(np.count_nonzero(np.bincount(rows, minlength=users))),
            int(np.count_nonzero(np.bincount(cols, minlength=items))))


def iteration_work(nnz: int, k: int, rated_users: int, rated_items: int, dtype: str) -> tuple[float, float]:
    """(FLOP, bytes) of one iteration."""
    es = ITEMSIZE[dtype]
    flops = 6.0 * k * nnz
    nbytes = nnz * (es + 4) + 2.0 * (rated_users + rated_items) * k * es
    return flops, nbytes


def floor_seconds(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """(seconds, bound_by): the larger of operations over the dtype's peak
    and bytes over HBM."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def job_flops(nnz: int, k: int, iters: int, users: int, items: int) -> float:
    """FLOP of one whole job: ``iters`` iterations and the top-1."""
    return 6.0 * k * nnz * iters + 2.0 * k * users * items
