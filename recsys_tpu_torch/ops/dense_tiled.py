"""Tiled dense GD: the port of ``recsys_tpu/ops/pallas_dense.py``'s tiled
section, the dense route for factors wider than the resident and stream
kernels take.

The JAX module's ``tiled_deltas`` (:566) computes the raw gradient sums
(dL, dR) of one stable-snapshot step in two Pallas calls (``_dl_kernel``
:538 at :578, ``_dr_kernel`` :552 at :594), recomputing the error tile in
each so the users x items error never reaches HBM; ``tiled_gd_step`` (:614)
applies ``L + 2a*dL`` outside the kernel and ``tiled_train`` (:704) loops it.
The same deltas are the sharded engine's per-shard step
(``parallel/step.py:106``), which sums them across the mesh before applying.

Here ``tiled_deltas`` (B5) is hand-written CUDA (``csrc/dense_tiled.cu``),
with the plain torch twin ``tiled_deltas_plain`` of ``_dl_kernel`` /
``_dr_kernel``'s math; ``tiled_gd_step`` and ``tiled_train`` are the JAX
module's host compositions, and ``tiled_train_plain`` is the twin's.  The
wrapper picks by the tensors' device: the plain twin for CPU tensors, the
kernel for CUDA tensors, and an error for anything the kernel does not take
-- never a fallback.

Layout, the port's own (the JAX kernels' (U, K128) lanes and bu/bi tiles
are TPU VMEM facts): lane-major f32 L (U, K), R (I, K) and A (U, I) in its
most compact exact storage (int8 at 2x the rating, bf16 or f32, as
``dense_fused.device_dense_AT``), U and I padded to 128 and K to 32, up to
``MAX_K``.  Padding masks itself: A is 0 there, so those entries stay 0.
Host helpers: ``pad_factors_lane_major`` (:778) and ``device_dense_A``
(:854).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import (
    _A_KIND,
    _PRECISION_CODE,
    _kernel_device,
    _ptrs,
    device_dense_AT,
    exact_f32,
    load_at,
    round_up,
)
from recsys_tpu_torch.ops.dense_stream import H100_SMS, _sms, _stream
from recsys_tpu_torch.ops.precision import dot, maybe_split, transpose

# Widest K the kernel takes: a warp holds a factor row, at most 32 values a
# lane (csrc/dense_tiled.cu, KPL).
MAX_K = 1024
# K is padded to a multiple of one value per lane.
K_ALIGN = 32
# Warps of the dR pass per SM that the split of the users aims for.
_DR_WARPS_PER_SM = 64


def pad_factors_lane_major(spec, state=None):
    """Zero-padded lane-major f32 (L (U, K), R (I, K), (U, I, K)) on the
    host: U and I rounded up to 128, K to 32.  ``state`` defaults to the
    glibc initial factors (``init_factors``)."""
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.utils.hostmem import hugepage_zeros

    U = round_up(spec.users, 128)
    I = round_up(spec.items, 128)
    K = round_up(spec.features, K_ALIGN)
    if state is None:
        state = init_factors(spec.users, spec.items, spec.features)
    L = hugepage_zeros((U, K), np.float32)
    L[: spec.users, : spec.features] = state.L
    R = hugepage_zeros((I, K), np.float32)
    R[: spec.items, : spec.features] = state.R
    return L, R, (U, I, K)


def device_dense_A(spec, U: int, I: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Zero-padded dense A (U, I) in its storage dtype on ``device``:
    ``dense_fused.device_dense_AT`` of the transposed ratings (int8 holds
    2x the rating)."""
    transposed = dataclasses.replace(spec, users=spec.items, items=spec.users, rows=spec.cols, cols=spec.rows)
    return device_dense_AT(transposed, I, U, dtype, device)


def dr_split(U: int, I: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(chunk, S): the dR pass cuts the U users into S chunks of ``chunk``
    (a multiple of 32), one warp per (item, chunk), so the pass has about
    ``_DR_WARPS_PER_SM`` warps per SM."""
    s = max(1, min(U // 32, -(-_DR_WARPS_PER_SM * sms // I)))
    chunk = round_up(-(-U // s), 32)
    return chunk, -(-U // chunk)


def partial_bytes(U: int, I: int, K: int, sms: int = H100_SMS) -> int:
    """Bytes of the dR partial sums (S, I, K) f32; none with one chunk."""
    _, S = dr_split(U, I, sms)
    return 4 * S * I * K if S > 1 else 0


def tiled_deltas_plain(L, R, A, *, precision: str = "highest"):
    """Plain torch twin of ``tiled_deltas``: ``_dl_kernel`` and
    ``_dr_kernel``'s math over the whole matrix at once.  Returns (dL (U,
    K), dR (I, K)).  On CUDA tensors the matmuls run with TF32 off."""
    with exact_f32(L.device):
        a = load_at(A)
        l, r = maybe_split(L, precision), maybe_split(R, precision)
        pred = dot(l, transpose(r), precision)  # (U, I)
        e = maybe_split(torch.where(a != 0, a - pred, 0.0), precision)
        return dot(e, r, precision), dot(transpose(e), l, precision)


def _apply(L, R, dL, dR, alpha2: float):
    """(L + 2a*dL, R + 2a*dR), as ``tiled_gd_step`` :617 rounds it (the
    product, then the sum); the fresh deltas are scaled in place."""
    return L + dL.mul_(alpha2), R + dR.mul_(alpha2)


def tiled_train_plain(L, R, A, *, iters: int, alpha2: float, precision: str = "highest"):
    """Plain torch twin of ``tiled_train``: ``iters`` steps of the twin's
    deltas and the update.  Returns (L', R')."""
    for _ in range(iters):
        L, R = _apply(L, R, *tiled_deltas_plain(L, R, A, precision=precision), alpha2)
    return L, R


def _check(L, R, A, precision):
    if precision not in _PRECISION_CODE:
        raise ValueError(f"unknown precision {precision!r}")
    if L.dim() != 2 or R.dim() != 2 or A.dim() != 2:
        raise ValueError("L, R and A must be 2-D")
    U, K = L.shape
    I = R.shape[0]
    if R.shape[1] != K or tuple(A.shape) != (U, I):
        raise ValueError(f"shapes L {tuple(L.shape)}, R {tuple(R.shape)}, A {tuple(A.shape)} disagree")
    if U % 128 or I % 128 or K % K_ALIGN or not 0 < K <= MAX_K:
        raise ValueError(f"kernel needs U, I multiples of 128 and K a multiple of {K_ALIGN} "
                         f"in [{K_ALIGN}, {MAX_K}]; got K={K} U={U} I={I}")
    if L.dtype != torch.float32 or R.dtype != torch.float32 or A.dtype not in _A_KIND:
        raise ValueError(f"dtypes L {L.dtype}, R {R.dtype}, A {A.dtype} not taken")
    if not (L.is_contiguous() and R.is_contiguous() and A.is_contiguous()):
        raise ValueError("L, R and A must be contiguous")
    if not (L.device == R.device == A.device):
        raise ValueError("L, R and A must be on one device")
    return U, I, K


def tiled_deltas(L, R, A, *, precision: str = "highest", At=None):
    """Raw gradient sums (dL, dR) of one stable-snapshot step, no update
    applied (port of ``pallas_dense.tiled_deltas`` :566, minus the TPU-only
    ``bu``, ``bi`` and ``interpret``).

    L (U, K), R (I, K) f32, A (U, I) int8 (2x rating) / bf16 / f32; U and
    I multiples of 128, K a multiple of 32 up to ``MAX_K``.  ``At`` is A's
    transpose (I, U), which the kernel's dR pass walks; a caller that takes
    many steps passes it once made (``tiled_train`` does), else the wrapper
    makes it.  CPU tensors go to the plain twin; CUDA tensors to the kernel,
    which counts each launch in ``.launches``.
    """
    U, I, K = _check(L, R, A, precision)
    if L.device.type == "cpu":
        return tiled_deltas_plain(L, R, A, precision=precision)
    dev = _kernel_device(L)
    if At is None:
        At = A.t().contiguous()
    elif tuple(At.shape) != (I, U) or At.dtype != A.dtype or At.device != A.device or not At.is_contiguous():
        raise ValueError(f"At must be A's contiguous transpose ({I}, {U}) {A.dtype} on {A.device}")
    lib = _build.load()
    chunk, S = dr_split(U, I, _sms(dev))
    dL = torch.empty((U, K), dtype=torch.float32, device=dev)
    dR = torch.empty((I, K), dtype=torch.float32, device=dev)
    part = torch.empty((S, I, K), dtype=torch.float32, device=dev) if S > 1 else dR
    with torch.cuda.device(dev):
        rc = lib.rs_tiled_deltas(
            ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(At.data_ptr()), _A_KIND[A.dtype],
            *_ptrs(L, R, dL, dR, part), U, I, K, _PRECISION_CODE[precision], chunk, S, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_tiled_deltas failed: CUDA error {rc}")
    tiled_deltas.launches += 1
    return dL, dR


tiled_deltas.launches = 0


def tiled_gd_step(L, R, A, *, alpha2: float, precision: str = "highest", At=None):
    """One GD step (``pallas_dense.tiled_gd_step`` :614): ``tiled_deltas``,
    then ``L + 2a*dL`` and ``R + 2a*dR`` as torch ops.  Returns (L', R')."""
    return _apply(L, R, *tiled_deltas(L, R, A, precision=precision, At=At), alpha2)


def tiled_train(L, R, A, *, iters: int, alpha2: float, precision: str = "highest"):
    """``iters`` GD steps (``pallas_dense.tiled_train`` :704): one
    ``tiled_gd_step``, so one B5 launch, per step, with A's transpose made
    once for all of them on a CUDA device.  Returns (L', R')."""
    At = A.t().contiguous() if A.device.type == "cuda" else None
    for _ in range(iters):
        L, R = tiled_gd_step(L, R, A, alpha2=alpha2, precision=precision, At=At)
    return L, R
