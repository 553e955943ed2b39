"""Checkpoint / resume of factorization state: the port of
``recsys_tpu/utils/checkpoint.py``.

The archive is the JAX package's: one ``.npz`` with the keys ``L``
(users, k), ``R`` (items, k) and ``completed_iters``, so a checkpoint
either package wrote resumes in the other.  ``run_with_checkpoints``
trains in chunks of ``every`` iterations through the port's
``trainer.factorize`` and snapshots the host factors between chunks.
Every training route's step is a function of the factors alone, so the
chunked run gives the unchunked run's factors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np

from recsys_tpu_torch.models.mf import MFState


class Checkpoint(NamedTuple):
    state: MFState
    completed_iters: int


def save(path: str, state: MFState, completed_iters: int) -> None:
    """Atomically snapshot (L, R, completed_iters)."""
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, L=np.asarray(state.L), R=np.asarray(state.R), completed_iters=np.int64(completed_iters))
    os.replace(tmp, path)


def load(path: str) -> Checkpoint:
    with np.load(path) as z:
        return Checkpoint(state=MFState(L=z["L"], R=z["R"]), completed_iters=int(z["completed_iters"]))


def run_with_checkpoints(spec, cfg, path: str, every: int, device) -> MFState:
    """Factorize on ``device`` with a snapshot every ``every`` iterations,
    resuming from ``path`` if it exists.  Returns the final host MFState."""
    from recsys_tpu_torch.engine import trainer

    if every <= 0:
        raise ValueError(f"checkpoint interval must be positive, got {every}")
    done, state = 0, None
    if os.path.exists(path):
        state, done = load(path)
    while done < spec.iters:
        chunk = min(every, spec.iters - done)
        state = trainer.factorize(dataclasses.replace(spec, iters=chunk), cfg, device, state=state)
        done += chunk
        save(path, state, done)
    return state
