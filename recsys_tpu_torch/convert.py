"""Factor tables between the JAX package's layouts and the port's tensors.

The JAX fused kernels take K-major numpy f32 tables Lt (K, U) / Rt (K, I);
``factorize`` returns an ``MFState`` of (users, k) / (items, k) arrays.
These helpers move either form, or a checkpoint file of either package,
onto a device as the port's padded K-major f32 tensors and back, so a
test can hand the same factors to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.models.mf import MFState
from recsys_tpu_torch.ops.dense_fused import pad_factors_for_pallas


def from_jax_kmajor(Lt, Rt, device) -> tuple[torch.Tensor, torch.Tensor]:
    """K-major (K, U) / (K, I) arrays (numpy or anything ``np.asarray``
    takes) -> contiguous f32 tensors on ``device``."""
    def move(x):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x), np.float32)).to(device)

    return move(Lt), move(Rt)


def from_state(state: MFState, spec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(L (users, k), R (items, k)) -> zero-padded K-major f32 (Lt, Rt)
    on ``device``, in the layout ``engine.trainer.dense_plan`` gives."""
    Lt, Rt, _ = pad_factors_for_pallas(spec, state=state)
    return from_jax_kmajor(Lt, Rt, device)


def to_state(Lt: torch.Tensor, Rt: torch.Tensor, spec) -> MFState:
    """Padded K-major tensors -> an ``MFState`` of host f32 arrays at the
    true (users, k) / (items, k) shapes."""
    k = spec.features
    L = Lt[:k, : spec.users].T.cpu().numpy()
    R = Rt[:k, : spec.items].T.cpu().numpy()
    return MFState(L=np.ascontiguousarray(L), R=np.ascontiguousarray(R))


def from_checkpoint(path: str, spec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A checkpoint ``.npz`` that either package wrote (keys ``L``, ``R``,
    ``completed_iters``) -> zero-padded K-major f32 (Lt, Rt) on ``device``,
    ready for the port's kernels."""
    from recsys_tpu_torch.utils.checkpoint import load

    return from_state(load(path).state, spec, device)
