"""The reference's initial factors: glibc ``srandom(0)`` + ``random()``
(TYPE_3, the additive generator with lags 31 and 3), ``RAND01 / k``, all of
L row-major and then R as (k x items) row-major (``mat2d.c:61-72``,
``matFact.c:113-120``).

A frozen copy of the arithmetic of ``recsys_tpu_torch/io/glibc_random.py``
and ``recsys_tpu_torch/models/mf.py`` at commit 5547fc7, written again in
plain Python so that the reference imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647
_DISCARD = 310


def random_words(n: int, seed: int = 0) -> np.ndarray:
    """The first ``n`` outputs of glibc ``random()`` after ``srandom(seed)``."""
    r = [1 if seed == 0 else seed]
    for i in range(1, 31):
        r.append((16807 * r[i - 1]) % 2147483647)
    r += r[0:3]
    x = r
    for i in range(34, 34 + _DISCARD + n):
        x.append((x[i - 31] + x[i - 3]) & 0xFFFFFFFF)
    return np.array(x[34 + _DISCARD:], dtype=np.int64) >> 1


def initial_factors(users: int, items: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(L (users, k), R (items, k)) in float64, as the reference draws them."""
    draws = random_words((users + items) * k) / RAND_MAX / k
    L = draws[: users * k].reshape(users, k)
    R = draws[users * k:].reshape(k, items).T.copy()
    return L, R
