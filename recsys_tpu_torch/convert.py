"""Factor tables between the JAX package's layouts and the port's tensors.

The JAX fused kernels take K-major numpy f32 tables Lt (K, U) / Rt (K, I),
its tiled kernels lane-major L (U, K128) / R (I, K128); ``factorize``
returns an ``MFState`` of (users, k) / (items, k) arrays.  These helpers
move any of these forms, or a checkpoint file of either package, onto a
device as the port's padded f32 tensors (K-major for the resident and
stream kernels, lane-major for the tiled one) and back, so a test can hand
the same factors to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.models.mf import MFState
from recsys_tpu_torch.ops.dense_fused import pad_factors_for_pallas
from recsys_tpu_torch.ops.dense_tiled import pad_factors_lane_major


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


def from_jax_lane_major(L, R, spec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tiled kernels' zero-padded lane-major (U', K128) / (I', K128)
    tables (``pallas_dense.pad_factors_lane_major``'s output, numpy or
    anything ``np.asarray`` takes) -> the port's tiled layout
    (``dense_tiled.pad_factors_lane_major``) as f32 tensors on ``device``."""
    k = spec.features
    state = MFState(L=np.asarray(L)[: spec.users, :k], R=np.asarray(R)[: spec.items, :k])
    Lp, Rp, _ = pad_factors_lane_major(spec, state=state)
    return torch.from_numpy(Lp).to(device), torch.from_numpy(Rp).to(device)


def tiled_views(L: torch.Tensor, R: torch.Tensor, spec) -> MFState:
    """The port's tiled tables -> an ``MFState`` of views at the true
    (users, k) / (items, k) shapes, left where the tensors are."""
    k = spec.features
    return MFState(L=L[: spec.users, :k], R=R[: spec.items, :k])


def tiled_to_state(L: torch.Tensor, R: torch.Tensor, spec) -> MFState:
    """The port's tiled tables -> an ``MFState`` of host f32 arrays at the
    true (users, k) / (items, k) shapes."""
    return MFState(*(np.ascontiguousarray(x.cpu().numpy()) for x in tiled_views(L, R, spec)))


def from_checkpoint(path: str, spec, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A checkpoint ``.npz`` that either package wrote (keys ``L``, ``R``,
    ``completed_iters``) -> zero-padded K-major f32 (Lt, Rt) on ``device``,
    ready for the port's kernels."""
    from recsys_tpu_torch.utils.checkpoint import load

    return from_state(load(path).state, spec, device)
