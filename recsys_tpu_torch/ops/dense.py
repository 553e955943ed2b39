"""Dense masked-matmul GD step, the ``dense`` route: the port of
``recsys_tpu/ops/dense.py`` (``make_dense_inputs`` :28, ``dense_gd_step``
:40).  The JAX module leaves its three products to XLA, outside any Pallas
kernel, so here they are ``torch.matmul``: on a CUDA device in f64 they
are DGEMMs, and in f32 they run with TF32 off.  ``dense_gd_step_weighted``
(:52), the sharded form, waits for ROADMAP A9.

    E  = M * (A - L.R^T)
    L' = L + 2a * E.R
    R' = R + 2a * E^T.L     (reading the old L, matFact.c:38-39)
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.ops.dense_fused import exact_f32


def make_dense_inputs(spec, dtype=np.float32):
    """Host dense A (ratings, 0 elsewhere) and mask M in ``dtype`` (numpy)."""
    from recsys_tpu_torch.utils.hostmem import hugepage_zeros

    a = hugepage_zeros((spec.users, spec.items), dtype)
    a[spec.rows, spec.cols] = spec.vals
    m = hugepage_zeros((spec.users, spec.items), dtype)
    m[spec.rows, spec.cols] = 1.0
    return a, m


def dense_gd_step(L, R, A, M, alpha2: float):
    """One GD step; ``alpha2 = 2 * alpha``.  Returns (L', R')."""
    a2 = torch.tensor(alpha2, dtype=L.dtype, device=L.device)  # alpha2 in the compute dtype, as JAX's
    with exact_f32(L.device):
        E = M * (A - L @ R.T)
        return L + a2 * (E @ R), R + a2 * (E.T @ L)


def dense_train(L, R, A, M, alpha2: float, iters: int):
    """``iters`` dense steps (``trainer._train_dense``)."""
    for _ in range(iters):
        L, R = dense_gd_step(L, R, A, M, alpha2)
    return L, R
