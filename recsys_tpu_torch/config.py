"""Problem/config datatypes: a copy of ``recsys_tpu/config.py``, kept
in the port so that it imports nothing of the JAX package.

TPU-native analogue of the reference's metadata structs
(``datatypes.h:4-43``: ``dataset_info``, ``input_info``): a frozen
dataclass carrying the hyperparameters from the ``.in`` header plus the
COO arrays, instead of per-rank local-dims bookkeeping (local shapes are
derived from the mesh by the sharding layer, not stored).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """One matrix-factorization problem instance.

    Mirrors the ``.in`` file header (reference ``matFact.c:79-105``):
    ``iters``, ``alpha``, ``features`` (latent dim k), matrix dims, and
    the observed entries as device-friendly COO arrays sorted row-major
    (row ascending, column ascending within a row — an invariant of the
    input format the reference relies on and we preserve).
    """

    iters: int
    alpha: float
    features: int
    users: int
    items: int
    rows: np.ndarray  # int32[nnz]
    cols: np.ndarray  # int32[nnz]
    vals: np.ndarray  # float64[nnz]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def __post_init__(self):
        assert self.rows.shape == self.cols.shape == self.vals.shape

    def dense(self, dtype=np.float64) -> np.ndarray:
        """Materialize the dense ratings matrix A (zeros at unobserved)."""
        a = np.zeros((self.users, self.items), dtype=dtype)
        a[self.rows, self.cols] = self.vals.astype(dtype)
        return a

    def mask(self) -> np.ndarray:
        """Boolean observation mask M (True where rated)."""
        m = np.zeros((self.users, self.items), dtype=bool)
        m[self.rows, self.cols] = True
        return m

    def rated_counts(self) -> np.ndarray:
        """Number of rated items per user (int32[users])."""
        return np.bincount(self.rows, minlength=self.users).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution options orthogonal to the problem itself.

    The reference's knobs were compile-time defines and env vars
    (``-DREDUCTION``, ``OMP_NUM_THREADS``); here they are runtime flags.
    """

    dtype: str = "float32"  # compute dtype: float32 | float64 | bfloat16
    path: str = "auto"  # auto | dense | bell | coo | pallas
    # MXU pass count for the f32 dense kernels: "auto" maps float32 ->
    # "highest" (true f32, 6 passes) and bfloat16 -> "default" (1 pass);
    # "bf16x3" selects the 3-pass split product (~16-bit mantissa, ~2x
    # "highest"'s matmul throughput — ops/pallas_dense._dot).
    precision: str = "auto"  # auto | highest | bf16x3 | default
    mesh_shape: Optional[tuple] = None  # (users_axis, items_axis) override
    donate: bool = True
    block_items: int = 4096  # item-block size for the streaming top-1
