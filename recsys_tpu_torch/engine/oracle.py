"""Numpy float64 oracle engine: a copy of ``recsys_tpu/engine/oracle.py``,
kept in the port so that it imports nothing of the JAX package.

Plays the role of the reference's serial driver (``matFact.c:29-59``) in
our test pyramid: every JAX/Pallas/sharded path is validated against it,
and it itself is validated against the reference's golden fixtures
(``samples/*.out``) and per-iteration dumps (``samples/inst{0,1,2}.mats``).

The update rule is the matrix form of the reference's entry loop
(``matFact.c:41-53``). Because every per-entry gradient there reads the
*stable* pre-iteration snapshots (``matFact.c:38-39``) and updates
accumulate additively, the loop is exactly full-batch GD::

    E = M ⊙ (A − L·Rᵀ)
    L += 2α · E · R
    R += 2α · Eᵀ · L        (reading the old L)

so a dense masked-matmul formulation is mathematically identical — not
an approximation — and is what every device path here uses. In float64
it tracks the reference trajectory to printed precision.
"""

from __future__ import annotations

import numpy as np

from recsys_tpu_torch.config import ProblemSpec
from recsys_tpu_torch.models.mf import MFState, init_factors


def gd_step_dense(L, R, A, M, alpha):
    """One full-batch GD step in dense form (float64 host math)."""
    E = np.where(M, A - L @ R.T, 0.0)
    L_new = L + (2.0 * alpha) * (E @ R)
    R_new = R + (2.0 * alpha) * (E.T @ L)
    return L_new, R_new


def factorize_numpy(spec: ProblemSpec, state: MFState | None = None, record: int = 0):
    """Run the full GD loop on host.

    Returns (final_state, trajectory) where trajectory is a list of
    (L, R) snapshots *after* each of the first ``record`` iterations
    (matching the ``Iter=n`` blocks of the ``.mats`` dumps).
    """
    if state is None:
        state = init_factors(spec.users, spec.items, spec.features)
    L = state.L.astype(np.float64).copy()
    R = state.R.astype(np.float64).copy()
    A = spec.dense()
    M = spec.mask()
    traj = []
    for it in range(spec.iters):
        L, R = gd_step_dense(L, R, A, M, spec.alpha)
        if it < record:
            traj.append((L.copy(), R.copy()))
    return MFState(L=L, R=R), traj


def top1_numpy(L: np.ndarray, R: np.ndarray, spec: ProblemSpec) -> np.ndarray:
    """Top-1 unrated item per user from final factors.

    Reproduces ``print_output`` (``matFact.c:10-27``): rated items are
    excluded; ties break to the lowest item index (numpy argmax picks the
    first maximum, same as the reference's strictly-greater scan).
    Users with every item rated get an arbitrary value here; the writer
    drops them via rated_counts (``matFact.c:24``).
    """
    B = L @ R.T
    B[spec.rows, spec.cols] = -np.inf
    return np.argmax(B, axis=1).astype(np.int32)


def dump_mats(spec: ProblemSpec, record: int = 5) -> str:
    """Reproduce the reference's debug ``.mats`` dump byte-for-byte.

    Layout (``samples/inst0.mats``, produced by a since-removed debug
    print mode built on ``mat2d_print``, ``mat2d.c:50-59``): the initial
    A, L, R, B; then for each of the first ``record`` iterations
    ``Iter=n`` with L, R, B; then ``Final:`` with the post-training
    L, R, B. R is printed in its generated (k × items) orientation
    (``matFact.c:115``), i.e. transposed relative to our storage.
    """
    from recsys_tpu_torch.io.writers import format_mats_block as blk

    state = init_factors(spec.users, spec.items, spec.features)
    A = spec.dense()
    out = [
        blk("Initial matrix A", A),
        blk("Initial matrix L", state.L),
        blk("Initial matrix R", state.R.T),
        blk("Initial matrix B", state.L @ state.R.T),
    ]
    final, traj = factorize_numpy(spec, state=state, record=min(record, spec.iters))
    for n, (L, R) in enumerate(traj):
        out.append(f"Iter={n}\n")
        out.append(blk("Matrix L", L))
        out.append(blk("Matrix R", R.T))
        out.append(blk("Matrix B", L @ R.T))
    out.append("Final:\n")
    out.append(blk("Matrix L", np.asarray(final.L)))
    out.append(blk("Matrix R", np.asarray(final.R).T))
    out.append(blk("Matrix B", np.asarray(final.L) @ np.asarray(final.R).T))
    return "".join(out)


def run_oracle(spec: ProblemSpec) -> str:
    """End-to-end oracle run producing the stdout payload (no time line)."""
    from recsys_tpu_torch.io.writers import format_recommendations

    state, _ = factorize_numpy(spec)
    top1 = top1_numpy(np.asarray(state.L), np.asarray(state.R), spec)
    return format_recommendations(top1, spec.rated_counts(), spec.items)
