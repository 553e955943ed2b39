"""Output formatting: the stdout contract of the reference binaries,
kept in the port so that it imports nothing of the JAX package.
``format_recommendations`` returns the bytes of
``recsys_tpu/io/writers.py``'s by one native pass over the users
(``csrc/recsys_format.c``), or by its numpy twin where the library is
missing; ``format_mats_block`` is a copy.

The reference prints one integer per user — the index of the
highest-predicted unrated item — skipping users whose every item is
rated (``matFact.c:10-27``), followed (serial/OMP builds) by a
``time : <seconds>`` line (``benchmark.h:14-23``). Golden ``.out``
fixtures contain only the index lines.
"""

from __future__ import annotations

import numpy as np

from recsys_tpu_torch.io import _native
from recsys_tpu_torch.utils.timing import count


def format_recommendations(top1: np.ndarray, rated_counts: np.ndarray, items: int) -> str:
    """Render the recommendation list.

    ``top1[u]`` is the winning item index for user ``u``; users with
    ``rated_counts[u] == items`` have no unrated item and are omitted,
    matching the reference's ``max == -1`` skip (``matFact.c:24``).
    Counts ``format_native``: 1 where the native entry wrote the list, 0
    where the numpy twin did.
    """
    top1, rated_counts = np.asarray(top1), np.asarray(rated_counts)
    if top1.shape != rated_counts.shape or top1.ndim != 1:
        raise ValueError(f"top1 {top1.shape} and rated_counts {rated_counts.shape} differ")
    text = _native.format_top1(top1, rated_counts, items)
    count("format_native", int(text is not None))
    return _format_numpy(top1, rated_counts, items) if text is None else text


def _format_numpy(top1: np.ndarray, rated_counts: np.ndarray, items: int) -> str:
    """``format_recommendations`` without the native library: each kept
    user's row of a fixed-width character matrix (sign, digits, newline),
    its leading zeros and a positive value's sign column dropped by a mask."""
    v = top1[rated_counts < items]
    if not v.size:
        return ""
    neg = v < 0
    mag = np.where(neg, (~v).astype(np.uint64) + np.uint64(1), v.astype(np.uint64))
    width = len(str(int(mag.max())))
    pow10 = np.uint64(10) ** np.arange(width - 1, -1, -1, dtype=np.uint64)
    chars = np.empty((v.size, width + 2), np.uint8)
    chars[:, 0] = ord("-")
    chars[:, 1:-1] = mag[:, None] // pow10 % np.uint64(10) + np.uint64(ord("0"))
    chars[:, -1] = ord("\n")
    digits = 1 + (mag[:, None] >= pow10[None, :-1]).sum(axis=1)
    show = np.empty(chars.shape, bool)
    show[:, 0] = neg
    show[:, 1:-1] = np.arange(width)[None, :] >= (width - digits)[:, None]
    show[:, -1] = True
    return chars[show].tobytes().decode("ascii")


def format_mats_block(name: str, mat: np.ndarray) -> str:
    """Render a matrix in the ``.mats`` debug-dump format
    (``mat2d_print``, ``mat2d.c:50-59``): 6-decimal, row per line."""
    lines = [name]
    for row in np.atleast_2d(mat):
        lines.append(" ".join(f"{v:.6f}" for v in row) + " ")
    return "\n".join(lines) + "\n"
