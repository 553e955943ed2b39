"""The reference's initial factors: glibc ``srandom(0)`` + ``random()``
(TYPE_3, the additive generator with lags 31 and 3), ``RAND01 / k``, all of
L row-major and then R as (k x items) row-major (``mat2d.c:61-72``,
``matFact.c:113-120``).

The arithmetic is that of ``recsys_tpu_torch/io/glibc_random.py``,
``models/mf.py`` and ``ops/device_rng.py`` at commit 4eed30a, written again
here so that the reference imports nothing of the program.

The recurrence x[i] = (x[i-31] + x[i-3]) mod 2^32 is linear, so a block of
B words is an integer matrix times the 34-word state window before it,
mod 2^32: row j of ``C`` (34, B) holds the coefficient of state word j in
each of the block's words (``_coeffs``).  torch has no uint32 arithmetic,
so the words live in int64, and the product is taken in float64 over
16-bit halves (``_mul_mod32``), where every sum is an integer below 2^39
and so exact in any order.  The next block's state is the block's last 34
words.  The stream runs on whatever device it is given,
so the reference draws its 1M x 700 factors on the card; its words equal
``random_words_loop``'s, the recurrence word by word, which the tests hold
it against.
"""

from __future__ import annotations

import numpy as np
import torch

RAND_MAX = 2147483647
_DISCARD = 310
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
# Words a block: a block is three matrix-vector products over its table,
# whose two (34, block) float64 halves take 2.3 GB on a card at 2^22.  On
# the host the table's build dominates, and 2^16 is fastest (5M words in
# 0.13 s, against 6.5 s at 2^22 and 1.8 s word by word).
CARD_BLOCK = 1 << 22
HOST_BLOCK = 1 << 16
# Positions of the table that the recurrence fills on the host; the rest
# comes by doubling (``_coeffs``).
_HOST_ROWS = 1024


def _recurrence(n: int, seed: int) -> list[int]:
    """x[0 .. 344 + n): the seeded window, the 310 discarded words, then
    ``n`` words, in Python integers."""
    x = [1 if seed == 0 else seed]
    for i in range(1, 31):
        x.append((16807 * x[i - 1]) % 2147483647)
    x += x[0:3]
    for i in range(34, 34 + _DISCARD + n):
        x.append((x[i - 31] + x[i - 3]) & _MASK32)
    return x


def random_words_loop(n: int, seed: int = 0) -> np.ndarray:
    """The first ``n`` outputs of ``random()`` after ``srandom(seed)``, word
    by word: the oracle of the tests."""
    return np.array(_recurrence(n, seed)[34 + _DISCARD:], dtype=np.int64) >> 1


def _halves(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The low and high 16 bits of int64 words below 2^32, as float64."""
    return (M & _MASK16).to(torch.float64), (M >> 16).to(torch.float64)


def _mul_mod32(X: torch.Tensor, Tl: torch.Tensor, Th: torch.Tensor) -> torch.Tensor:
    """(X @ T) mod 2^32 for int64 ``X`` of values below 2^32 and ``T`` of 34
    rows, given as its halves ``Tl``, ``Th``: ``Xl Tl + 2^16 (Xh Tl + Xl
    Th)``, float64 products whose sums of 34 terms stay below 2^39, exact
    in any order."""
    Xl, Xh = _halves(X)
    r = X.shape[0]
    both = torch.cat([Xl, Xh]) @ Tl
    low = both[:r].to(torch.int64)
    mid = (both[r:] + Xl @ Th).to(torch.int64)
    return (low + ((mid & _MASK16) << 16)) & _MASK32


def _coeffs(block: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The halves (``_halves``) of C (34, block): column p gives word p of a
    block from the 34 state words before it.  The first positions come
    from the recurrence on the host, three at a time; then the table
    doubles: with T the rows of its last 34 positions, position m + q is
    position q times T."""
    n0 = min(block, _HOST_ROWS)
    rows = np.zeros((34 + n0, 34), np.uint64)
    rows[:34] = np.eye(34, dtype=np.uint64)
    for i in range(34, 34 + n0, 3):
        m = min(3, 34 + n0 - i)
        rows[i:i + m] = (rows[i - 31:i - 31 + m] + rows[i - 3:i - 3 + m]) & np.uint64(_MASK32)
    P = torch.from_numpy(rows[34:].astype(np.int64)).to(device)
    while P.shape[0] < block:
        P = torch.cat([P, _mul_mod32(P[:block - P.shape[0]], *_halves(P[-34:]))])
    return _halves(P.T.contiguous())


def _blocks(n: int, seed: int = 0, device="cpu"):
    """(start, outputs) of the first ``n`` outputs of ``random()`` after
    ``srandom(seed)``, a block at a time: int64 tensors on ``device``."""
    if n <= 0:
        return
    device = torch.device(device)
    block = HOST_BLOCK if device.type == "cpu" else CARD_BLOCK
    Cl, Ch = _coeffs(min(block, n), device)
    s = torch.tensor([_recurrence(0, seed)[-34:]], dtype=torch.int64, device=device)
    for start in range(0, n, Cl.shape[1]):
        m = min(Cl.shape[1], n - start)
        x = _mul_mod32(s, Cl[:, :m], Ch[:, :m])
        s = torch.cat([s, x], dim=1)[:, -34:]
        yield start, x[0] >> 1


def words(n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """The first ``n`` outputs of ``random()`` after ``srandom(seed)``, int64
    on ``device``."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    for start, w in _blocks(n, seed, device):
        out[start:start + w.numel()] = w
    return out


def random_words(n: int, seed: int = 0) -> np.ndarray:
    """The first ``n`` outputs of glibc ``random()`` after ``srandom(seed)``."""
    return words(n, seed, "cpu").numpy()


def initial_factors(users: int, items: int, k: int, device=None):
    """(L (users, k), R (items, k)) in float64, as the reference draws them:
    numpy arrays, or with ``device`` torch tensors made there, block by
    block, each draw ``float64(word) / RAND_MAX / k``.  The divisors are
    tensors on the device: a card divides by a host scalar as a product
    with its reciprocal, which is not the quotient."""
    dev = torch.device("cpu" if device is None else device)
    draws = torch.empty((users + items) * k, dtype=torch.float64, device=dev)
    rand_max = torch.tensor(float(RAND_MAX), dtype=torch.float64, device=dev)
    kk = torch.tensor(float(k), dtype=torch.float64, device=dev)
    for start, w in _blocks(draws.numel(), 0, dev):
        part = draws[start:start + w.numel()]
        torch.div(w.to(torch.float64), rand_max, out=part)
        part.div_(kk)
    L = draws[:users * k].view(users, k)
    R = draws[users * k:].view(k, items).T.contiguous()
    return (L.numpy(), R.numpy()) if device is None else (L, R)
