"""Output formatting: the stdout contract of the reference binaries.
A copy of ``recsys_tpu/io/writers.py``, kept in the port so that it
imports nothing of the JAX package.

The reference prints one integer per user — the index of the
highest-predicted unrated item — skipping users whose every item is
rated (``matFact.c:10-27``), followed (serial/OMP builds) by a
``time : <seconds>`` line (``benchmark.h:14-23``). Golden ``.out``
fixtures contain only the index lines.
"""

from __future__ import annotations

import numpy as np


def format_recommendations(top1: np.ndarray, rated_counts: np.ndarray, items: int) -> str:
    """Render the recommendation list.

    ``top1[u]`` is the winning item index for user ``u``; users with
    ``rated_counts[u] == items`` have no unrated item and are omitted,
    matching the reference's ``max == -1`` skip (``matFact.c:24``).
    """
    keep = rated_counts < items
    return "".join(f"{int(i)}\n" for i in np.asarray(top1)[keep])


def format_mats_block(name: str, mat: np.ndarray) -> str:
    """Render a matrix in the ``.mats`` debug-dump format
    (``mat2d_print``, ``mat2d.c:50-59``): 6-decimal, row per line."""
    lines = [name]
    for row in np.atleast_2d(mat):
        lines.append(" ".join(f"{v:.6f}" for v in row) + " ")
    return "\n".join(lines) + "\n"
