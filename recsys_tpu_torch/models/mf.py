"""Matrix-factorization model state and deterministic initialization.
A copy of ``recsys_tpu/models/mf.py``, kept in the port so that it
imports nothing of the JAX package.

The model is two dense factor tables: L (users × k) and R (items × k);
predictions are ``L @ R.T``. R is stored transposed relative to how it
is generated, exactly as the reference does (``matFact.c:113-120``:
fill R_init (k × items) then transpose to (items × k)).

Initialization contract (``mat2d.c:61-72``): srandom(0); fill all of L
row-major with RAND01/k; then fill R_init (k × items) row-major with
RAND01/k. The *global draw order* is the determinism contract — the MPI
reference goes to great lengths to preserve it while scattering blocks
(``matFact-mpi.c:459-515``). We sidestep that entirely: factors are
generated once on host in that exact order and then device_put with
whatever sharding the mesh dictates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from recsys_tpu_torch.io.glibc_random import rand01_sequence


class MFState(NamedTuple):
    """Factor tables. L: (users, k); R: (items, k) (stored transposed)."""

    L: "np.ndarray"
    R: "np.ndarray"


def init_factors(users: int, items: int, features: int, seed: int = 0) -> MFState:
    """Deterministic glibc-random initial factors, float64 on host.

    Returns L (users × k) and R (items × k). R is the transpose of the
    generated (k × items) R_init, so ``R[j, f] == draw(k*users + f*items + j)``.
    """
    from recsys_tpu_torch.utils.hostmem import hugepage_empty

    k = features
    draws = rand01_sequence(users * k + k * items, seed=seed)
    draws /= k  # in place: no second GB-scale buffer at 1M-user shapes
    L = draws[: users * k].reshape(users, k)
    R = hugepage_empty((items, k), np.float64)
    R[...] = draws[users * k :].reshape(k, items).T
    return MFState(L=L, R=R)
