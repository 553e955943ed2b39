"""The glibc ``random()`` stream drawn on the device: the port of
``recsys_tpu/ops/device_rng.py`` (ROADMAP A8).

The TYPE_3 recurrence x[i] = (x[i-31] + x[i-3]) mod 2^32 is linear over
Z/2^32.  ``glibc_stream`` draws the first n words after ``srandom(seed)``
by one hand-written kernel on a CUDA device (``csrc/glibc_init.cu``): each
thread jumps to its own segment of the stream with the matrices
``jump_matrices`` builds once a process (the window ahead of position p is
J_p times the seed's window), then runs the recurrence in registers and
writes each draw once.  ``plan_windows`` is the kernel's jump phase in
numpy.  On the CPU it takes the plain twin, ``DeviceGlibcStream``, and any
other device raises.  Both give the host generator's words bit for bit.

The twin's formulation: a block of B outputs is an integer combination of
the 34-word state window, ``out = C . s (mod 2^32)``, where row p of C
gives x[t+p] from x[t-34 .. t-1] (``_block_coeffs``, built once per
stream).  A block is then 34 scalar-times-row products, and the next
block's state is the block's last 34 words.  torch has no uint32
arithmetic, so the words live in int64 and every result is reduced mod
2^32 with an explicit mask.  A product of two 32-bit words does not fit in
int64, so each state word is split into 16-bit halves: ``C . s = C . s_lo
+ 2^16 (C . s_hi)``, where each product is below 2^48 and a sum of 34 of
them below 2^54, and ``2^16 (C . s_hi) mod 2^32 = ((C . s_hi) mod 2^16) <<
16``.  ``>>`` of a masked, non-negative int64 is the logical shift of the
32-bit word.

The float step is the JAX module's to the bit (its :79): ``f32(x >> 1)``
times ``f32(1 / (RAND_MAX * k))``, the scale rounded once from f64; the
kernel multiplies with ``__fmul_rn``, so its floats equal the twin's.  The
host divides in f64 and casts instead, so the two differ by up to ~2 f32
ulp; the engine takes this stream only above ``DEVICE_INIT_MIN_DRAWS``
(``engine/trainer.py``), far from every byte-exact golden.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from recsys_tpu_torch.io.glibc_random import RAND_MAX, GlibcRandom
from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import _ptrs, _stream

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
# The twin's draws per block.  A block costs 77 torch ops whatever its size;
# the (34, block) int64 table of 2^22 is 1.14 GB, freed with the stream.
DEFAULT_BLOCK = 1 << 22
# Positions of the coefficient table built by the recurrence on the host;
# the rest comes by doubling on the device.
_HOST_ROWS = 1024
# The kernel's plan (csrc/glibc_init.cu SEG, LOG_T): draws a thread, log2
# of the threads a block; and the jump matrices it is given, enough for
# 2^(JUMPS - LOG_THREADS) blocks.
SEGMENT = 1024
LOG_THREADS = 8
JUMPS = 40


def _coeff_rows(positions: int) -> np.ndarray:
    """(34 + positions, 34) uint64 of values below 2^32: row 34 + p gives
    x[t+p] as a combination of the window x[t-34 .. t-1], whose words are
    the first 34 unit rows; by the recurrence on the host, three rows at a
    time (its shortest lag is 3)."""
    rows = np.zeros((34 + positions, 34), np.uint64)
    rows[:34] = np.eye(34, dtype=np.uint64)
    i, end = 34, 34 + positions
    while i < end:
        m = min(3, end - i)
        rows[i : i + m] = (rows[i - 31 : i - 31 + m] + rows[i - 3 : i - 3 + m]) & np.uint64(_MASK32)
        i += m
    return rows


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
    contiguous).  The first positions come from ``_coeff_rows``; then the
    table doubles on the device: with T the (34, 34) rows of the last 34
    positions, the positions n + q are the positions q times T."""
    P = torch.from_numpy(_coeff_rows(min(block, _HOST_ROWS))[34:].astype(np.int64)).to(device)  # (positions, 34)
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


def _window(seed: int) -> np.ndarray:
    """(34,) uint64: the words x[-34 .. -1] ahead of the first draw after
    ``srandom(seed)``."""
    return GlibcRandom(seed)._window.astype(np.uint64)


class DeviceGlibcStream:
    """Sequential draws on ``device`` (``device_rng.py:68``); the state
    carries across calls, so L and R are drawn in the reference's global
    order."""

    def __init__(self, seed: int = 0, block: int = DEFAULT_BLOCK, device="cpu"):
        self.block = block
        self.device = torch.device(device)
        self._state = torch.from_numpy(_window(seed).astype(np.int64)).to(self.device)
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


@functools.cache
def jump_matrices(segment: int, count: int) -> np.ndarray:
    """(count, 34, 34) uint64 of values below 2^32: entry e moves a window
    on by ``segment * 2^e`` draws, each the square of the one before.
    numpy's uint64 products wrap mod 2^64, which is exact mod 2^32 after
    the mask.  They depend on neither the seed nor the shape, and are
    built once a process."""
    out = np.empty((count, 34, 34), np.uint64)
    out[0] = _coeff_rows(segment)[segment:]  # the window ahead of position segment
    for e in range(1, count):
        out[e] = (out[e - 1] @ out[e - 1]) & np.uint64(_MASK32)
    out.flags.writeable = False  # shared by every caller
    return out


def plan_windows(seed: int, n: int, segment: int = SEGMENT, log_threads: int = LOG_THREADS) -> np.ndarray:
    """(segments, 34) uint64: the window ahead of each ``segment``-draw
    segment of the first ``n`` draws, made as the kernel makes them: block
    b (``2^log_threads`` segments) jumps from the seed's window by the
    matrices of b's set bits, then its segments' windows double, round e
    making those of segments [2^e, 2^(e+1)) from those of [0, 2^e)."""
    threads = 1 << log_threads
    segments = -(-n // segment)
    blocks = -(-segments // threads)
    J = jump_matrices(segment, log_threads + max(1, (blocks - 1).bit_length()))
    mask, seed_window = np.uint64(_MASK32), _window(seed)
    out = np.empty((blocks * threads, 34), np.uint64)
    for b in range(blocks):
        win = out[b * threads : (b + 1) * threads]
        win[0] = seed_window
        for e in range(b.bit_length()):
            if b >> e & 1:
                win[0] = (J[log_threads + e] @ win[0]) & mask
        for e in range(log_threads):
            h = 1 << e
            win[h : 2 * h] = (win[:h] @ J[e].T) & mask
    return out[:segments]


@functools.cache
def _jump_table(device: torch.device) -> torch.Tensor:
    """The kernel's ``jump_matrices(SEGMENT, JUMPS)`` on ``device``, rows
    padded to 36 words for 16-byte loads; uploaded once a process."""
    J = np.zeros((JUMPS, 34, 36), np.uint32)
    J[:, :, :34] = jump_matrices(SEGMENT, JUMPS)
    return torch.from_numpy(J.view(np.int32)).to(device)


def glibc_stream(n: int, seed: int = 0, *, divisor: float | None = None, device="cpu",
                 block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The first ``n`` draws after ``srandom(seed)`` on ``device``: with
    ``divisor``, RAND01/divisor as f32, ``f32(x >> 1) * f32(1 / (RAND_MAX *
    divisor))`` (``device_rng.py:77``); without, the words x as int64 in
    [0, 2^32) (before the ``>> 1`` of ``random()``).  A CPU device takes
    the twin (``DeviceGlibcStream`` at ``block``, cut to ``n``); a CUDA
    device one launch of ``rs_glibc_init``, counted in ``.launches``; any
    other device raises."""
    device = torch.device(device)
    if device.type == "cpu":
        st = DeviceGlibcStream(seed, max(1, min(block, n)), device)
        return st.raw32(n) if divisor is None else st.rand01_over(n, divisor)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(n, dtype=torch.float32 if divisor is not None else torch.int32, device=device)
    if n == 0:
        return out.long() if divisor is None else out
    scale = np.float32(1.0 / (float(RAND_MAX) * divisor)) if divisor is not None else np.float32(0)
    window = (ctypes.c_uint32 * 34)(*(int(x) for x in _window(seed)))
    with torch.cuda.device(device):
        rc = _build.load().rs_glibc_init(*_ptrs(_jump_table(device)), JUMPS, SEGMENT, LOG_THREADS,
                                         ctypes.c_void_p(ctypes.addressof(window)), *_ptrs(out), n, float(scale),
                                         int(divisor is None), _stream(device))
    if rc != 0:
        raise RuntimeError(f"rs_glibc_init failed: CUDA error {rc}")
    glibc_stream.launches += 1
    return out.long() & _MASK32 if divisor is None else out


glibc_stream.launches = 0


def device_init_factors(users: int, items: int, features: int, seed: int = 0, *, device="cpu",
                        block: int = DEFAULT_BLOCK):
    """The glibc initial factors drawn on ``device`` in f32 by one
    ``glibc_stream``: L (users, k) and R (items, k) in
    ``models.mf.init_factors``' draw order, all of L row-major, then R as
    (k, items) transposed (``device_rng.py:95``).  Both are views of the one
    stream, R a transposed one.  ``block`` is the CPU twin's."""
    k = features
    draws = glibc_stream((users + items) * k, seed, divisor=float(k), device=device, block=block)
    return draws[: users * k].view(users, k), draws[users * k :].view(k, items).T
