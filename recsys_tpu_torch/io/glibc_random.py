"""Host-side recreation of glibc ``random()`` (TYPE_3 lagged Fibonacci):
a copy of ``recsys_tpu/io/glibc_random.py``, kept in the port so that it
imports nothing of the JAX package.

The reference initializes its factor matrices with ``srandom(0)`` +
``random()/RAND_MAX`` (``mat2d.c:61-72``, ``mat2d.h:4``). Matching its
golden fixtures bit-for-bit therefore requires reproducing glibc's
default generator exactly:

* seed 0 is coerced to 1;
* state seeded by the LCG ``r[i] = 16807 * r[i-1] mod (2^31 - 1)`` for
  i in 1..30 (glibc computes this with the Schrage hi/lo split, which is
  equivalent to the plain 64-bit mod for the positive values involved);
* ``r[31..33] = r[0..2]``;
* additive recurrence ``x[i] = (x[i-31] + x[i-3]) mod 2^32``;
* output is ``x[i] >> 1``; the first 310 outputs are discarded.

This module is pure host-side numpy (the sequence is inherently
sequential); a C fast path for very large draws lives in
``recsys_tpu_torch/csrc/recsys_native.c`` and is used automatically when built. The
device never sees this generator — factors are generated on host in the
reference's exact global order (all of L, then R feature-major,
``matFact.c:113-120``) and then sharded, so determinism is preserved
under any mesh shape.
"""

from __future__ import annotations

import numpy as np

RAND_MAX = 2147483647
_LAG_SHORT = 3
_LAG_LONG = 31
_DISCARD = 310


def _seed_state(seed: int) -> np.ndarray:
    """Initial 34-word state after srandom(seed)."""
    if seed == 0:
        seed = 1
    r = np.zeros(34, dtype=np.uint64)
    r[0] = seed
    for i in range(1, 31):
        r[i] = (16807 * int(r[i - 1])) % 2147483647
    r[31:34] = r[0:3]
    return r


class GlibcRandom:
    """Streaming generator of glibc random() outputs.

    Keeps a rolling window so arbitrarily long sequences can be drawn in
    chunks without materializing the whole history (needed for the
    checkerboard init path, which draws L and R blocks in order).
    """

    def __init__(self, seed: int = 0):
        init = _seed_state(seed)
        # Warm-up: run the recurrence 310 steps past the initial state.
        # Keep the last 34 values as the live window.
        warm = np.zeros(34 + _DISCARD, dtype=np.uint64)
        warm[:34] = init
        for i in range(34, 34 + _DISCARD):
            warm[i] = (warm[i - _LAG_LONG] + warm[i - _LAG_SHORT]) & 0xFFFFFFFF
        self._window = warm[-34:].copy()

    def raw(self, n: int) -> np.ndarray:
        """Next ``n`` outputs of random() as int64 in [0, 2^31)."""
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        buf = np.empty(34 + n, dtype=np.uint64)
        buf[:34] = self._window
        # The recurrence has lags 31 and 3: elements i, i+1, i+2 depend only
        # on values at least 3 back, so generate 3 per numpy step.
        i = 34
        end = 34 + n
        while i < end:
            m = min(3, end - i)
            buf[i : i + m] = (
                buf[i - _LAG_LONG : i - _LAG_LONG + m] + buf[i - _LAG_SHORT : i - _LAG_SHORT + m]
            ) & np.uint64(0xFFFFFFFF)
            i += m
        self._window = buf[-34:].copy()
        return (buf[34:] >> np.uint64(1)).astype(np.int64)

    def rand01(self, n: int) -> np.ndarray:
        """Next ``n`` draws of RAND01 = random()/RAND_MAX (float64)."""
        return self.raw(n) / RAND_MAX


def rand01_sequence(n: int, seed: int = 0) -> np.ndarray:
    """First ``n`` RAND01 draws after srandom(seed). Uses the native C
    fast path when available (large n), else numpy."""
    native = _native_rand01(n, seed)
    if native is not None:
        return native
    return GlibcRandom(seed).rand01(n)


def _native_rand01(n: int, seed: int):
    try:
        from recsys_tpu_torch.io import _native
    except Exception:
        return None
    return _native.rand01(n, seed)
