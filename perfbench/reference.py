"""The plain reference: the reference binaries' function in dense torch.

Full-batch gradient descent from the glibc initial factors (``glibc.py``,
drawn on the device the reference runs on), every gradient reading the
pre-iteration snapshots (``matFact.c:38-53``)::

    E = M * (A - L R^T)
    L' = L + 2a E R
    R' = R + 2a E^T L

then each user's highest-scoring unrated item, ties to the lowest index
(``matFact.c:10-27``).  It imports nothing of ``recsys_tpu_torch``: it
reads the benchmark's own ``Instance``, draws its own initial factors, and
sees the program's output only to judge it (``judge.py``).  Float32 runs
with TF32 off unless ``tf32`` asks for it (the control): on a card by
cuBLAS's TF32 products, on the CPU, which has none, by rounding each
product's operands to TF32's 10-bit mantissa (nearest, ties away) before
an f32 product.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import glibc


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def dense_inputs(inst, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, M): the ratings as a dense (users, items) matrix and its mask."""
    A = torch.zeros((inst.users, inst.items), dtype=dtype, device=device)
    M = torch.zeros((inst.users, inst.items), dtype=torch.bool, device=device)
    r, c = torch.from_numpy(inst.rows).to(device), torch.from_numpy(inst.cols).to(device)
    A[r, c] = torch.from_numpy(inst.vals).to(device=device, dtype=dtype)
    M[r, c] = True
    return A, M


def solve(inst, device="cpu", dtype=torch.float64, tf32: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The trained (L, R) on ``device`` in ``dtype``."""
    L, R = glibc.initial_factors(inst.users, inst.items, inst.features, device=device)
    L, R = L.to(dtype), R.to(dtype)
    A, M = dense_inputs(inst, device, dtype)
    a2 = 2.0 * inst.alpha
    t = tf32_round if tf32 and torch.device(device).type == "cpu" else (lambda x: x)
    with _tf32(tf32), torch.no_grad():
        for _ in range(inst.iters):
            E = torch.where(M, A - t(L) @ t(R).T, 0.0)
            L, R = L + a2 * (t(E) @ t(R)), R + a2 * (t(E).T @ t(L))
    return L, R


def scores(L: torch.Tensor, R: torch.Tensor, inst) -> np.ndarray:
    """(users, items) float64 scores L R^T with every rated cell at -inf."""
    B = (L.double() @ R.double().T)
    B[torch.from_numpy(inst.rows).to(B.device), torch.from_numpy(inst.cols).to(B.device)] = -float("inf")
    return B.cpu().numpy()


def top1(B: np.ndarray) -> np.ndarray:
    """Each user's first highest-scoring unrated item."""
    return np.argmax(B, axis=1)


def listed_users(inst) -> np.ndarray:
    """The users the output lists: those with an unrated item."""
    return np.flatnonzero(np.bincount(inst.rows, minlength=inst.users) < inst.items)


def format_top1(t: np.ndarray, inst) -> str:
    """The reference binaries' stdout payload: one item a listed user."""
    return "".join(f"{int(t[u])}\n" for u in listed_users(inst))
