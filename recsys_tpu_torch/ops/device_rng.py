"""The glibc ``random()`` stream drawn on the device: the port of
``recsys_tpu/ops/device_rng.py`` (ROADMAP A8).

The TYPE_3 recurrence x[i] = (x[i-31] + x[i-3]) mod 2^32 is linear over
Z/2^32, so a block of B outputs is an integer combination of the 34-word
state window: ``out = C . s (mod 2^32)``, where row p of C gives x[t+p]
from x[t-34 .. t-1] (``_block_coeffs``, built once per stream).  A
block is then 34 scalar-times-row products on the device, and
the next block's state is the block's last 34 words.  The integers equal
the host generator's bit for bit.

torch has no uint32 arithmetic, so the words live in int64 and every
result is reduced mod 2^32 with an explicit mask.  A product of two
32-bit words does not fit in int64, so each state word is split into
16-bit halves: ``C . s = C . s_lo + 2^16 (C . s_hi)``, where each
product is below 2^48 and a sum of 34 of them below 2^54, and
``2^16 (C . s_hi) mod 2^32 = ((C . s_hi) mod 2^16) << 16``.  ``>>`` of a
masked, non-negative int64 is the logical shift of the 32-bit word.

The float step is the JAX module's to the bit (its :79): ``f32(x >> 1)``
times ``f32(1 / (RAND_MAX * k))``, the scale rounded once from f64.  The
host divides in f64 and casts instead, so the two differ by up to ~2 f32
ulp; the engine takes this stream only above ``DEVICE_INIT_MIN_DRAWS``
(``engine/trainer.py``), far from every byte-exact golden.

Each function takes an explicit ``device``; on the CPU the same torch ops
run there.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.io.glibc_random import RAND_MAX, GlibcRandom

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
# Draws per block.  A block costs 77 kernels whatever its size, so larger
# blocks launch less: on an H100, 2^27 draws took 0.860 / 0.206 / 0.087 s
# at blocks of 2^18 / 2^20 / 2^22 (PERF.md).  The (34, block) int64 table
# of 2^22 is 1.14 GB, freed with the stream.
DEFAULT_BLOCK = 1 << 22
# Positions of the coefficient table built by the recurrence on the host;
# the rest comes by doubling on the device.
_HOST_ROWS = 1024

def _mul_mod32(X: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(X @ T) mod 2^32 for int64 matrices of values below 2^32, exactly:
    with 16-bit halves, ``X @ T = Xl @ Tl + 2^16 (Xh @ Tl + Xl @ Th) (mod
    2^32)``, and each f64 product of 34-term sums of products below 2^32
    stays below 2^39, an exact integer in f64 whatever the order."""
    f64 = torch.float64
    Xl, Xh, Tl, Th = ((M & _MASK16).to(f64) if lo else (M >> 16).to(f64) for M, lo in
                      ((X, True), (X, False), (T, True), (T, False)))
    low = (Xl @ Tl).to(torch.int64)
    mid = (Xh @ Tl + Xl @ Th).to(torch.int64)
    return (low + ((mid & _MASK16) << 16)) & _MASK32


def _block_coeffs(block: int, device="cpu") -> torch.Tensor:
    """(34, block) int64 of values mod 2^32 on ``device``: row j holds, for
    each of the block's positions p, the coefficient of state word j in
    x[t+p] (``device_rng.py:39``, transposed so each state word's row is
    contiguous).  The first positions come from the recurrence on the
    host, three at a time (its shortest lag is 3); then the table doubles
    on the device: with T the (34, 34) rows of the last 34 positions, the
    positions n + q are the positions q times T."""
    n0 = min(block, _HOST_ROWS)
    rows = np.zeros((34 + n0, 34), np.uint64)
    rows[:34] = np.eye(34, dtype=np.uint64)
    i, end = 34, 34 + n0
    while i < end:
        m = min(3, end - i)
        rows[i : i + m] = (rows[i - 31 : i - 31 + m] + rows[i - 3 : i - 3 + m]) & np.uint64(_MASK32)
        i += m
    P = torch.from_numpy(rows[34:].astype(np.int64)).to(device)  # (positions, 34)
    while P.shape[0] < block:
        P = torch.cat([P, _mul_mod32(P[: block - P.shape[0]], P[-34:])])
    return P.T.contiguous()


def _gen_block(C: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The block's words (n,) int64 in [0, 2^32) from the (34,) int64
    state ``s`` and the coefficient rows ``C`` (34, n) (``_gen_blocks``'
    body, :57-62)."""
    s_lo, s_hi = s & _MASK16, s >> 16
    lo = torch.zeros(C.shape[1], dtype=torch.int64, device=C.device)
    hi = torch.zeros_like(lo)
    for j in range(34):
        lo.addcmul_(C[j], s_lo[j])
        hi.addcmul_(C[j], s_hi[j])
    return (lo + ((hi & _MASK16) << 16)) & _MASK32


class DeviceGlibcStream:
    """Sequential draws on ``device`` (``device_rng.py:68``); the state
    carries across calls, so L and R are drawn in the reference's global
    order."""

    def __init__(self, seed: int = 0, block: int = DEFAULT_BLOCK, device="cpu"):
        self.block = block
        self.device = torch.device(device)
        self._state = torch.from_numpy(GlibcRandom(seed)._window.astype(np.int64)).to(self.device)
        self._C = _block_coeffs(block, self.device)

    def _blocks(self, n: int):
        """(start, words) of each block of the next ``n`` words x (int64 in
        [0, 2^32), before the ``>> 1`` of ``random()``); the state moves on
        as each block is taken."""
        for start in range(0, n, self.block):
            words = _gen_block(self._C[:, : min(self.block, n - start)], self._state)
            self._state = torch.cat([self._state, words])[-34:]
            yield start, words

    def raw32(self, n: int) -> torch.Tensor:
        """The next ``n`` words x."""
        out = torch.empty(n, dtype=torch.int64, device=self.device)
        for start, words in self._blocks(n):
            out[start : start + words.numel()] = words
        return out

    def rand01_over(self, n: int, divisor: float) -> torch.Tensor:
        """Next ``n`` draws of RAND01/divisor as f32 (``device_rng.py:77``):
        ``f32(x >> 1) * f32(1 / (RAND_MAX * divisor))``."""
        scale = torch.tensor(1.0 / (float(RAND_MAX) * divisor), dtype=torch.float32, device=self.device)
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        for start, words in self._blocks(n):
            torch.mul((words >> 1).to(torch.float32), scale, out=out[start : start + words.numel()])
        return out


def device_init_factors(users: int, items: int, features: int, seed: int = 0, *, device="cpu",
                        block: int = DEFAULT_BLOCK):
    """The glibc initial factors drawn on ``device`` in f32: L (users, k)
    and R (items, k) in ``models.mf.init_factors``' draw order, all of L
    row-major, then R as (k, items) transposed (``device_rng.py:95``).  R
    is a transposed view.  The block is cut to the draws needed, which
    changes no word."""
    st = DeviceGlibcStream(seed, max(1, min(block, (users + items) * features)), device)
    k = features
    L = st.rand01_over(users * k, float(k)).reshape(users, k)
    R = st.rand01_over(k * items, float(k)).reshape(k, items).T
    return L, R
