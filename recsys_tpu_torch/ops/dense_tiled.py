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

Here both are hand-written CUDA (``csrc/dense_tiled.cu``):

* ``tiled_deltas`` (B5) returns the raw (dL, dR), for the sharded engine
  and as the baseline; ``tiled_train_deltas`` composes it with the torch
  update ``_apply`` step by step, as this module did before the fused step.
* ``tiled_step`` is the whole step in one call of three launches: the L
  pass writes L' = L + a2*dL and the R reduction writes R' = R + a2*dR,
  so dL and dR never reach device memory.  It keeps the composition's
  bits (the product rounded, then the sum, a2 = alpha2 in f32).  Its L
  pass has two forms (``FORMS``): ``ring``, persistent, streaming L rows
  and A lines through shared memory, and ``warp``, a warp per user as in
  B5; ``step_form`` picks one for a shape.
* ``tiled_gd_step`` returns new tensors from one ``tiled_step``;
  ``tiled_train`` allocates two sets of next factors once per run and
  steps between them, never writing the caller's tensors.

The plain torch twins are ``tiled_deltas_plain`` (``_dl_kernel`` /
``_dr_kernel``'s math) and ``tiled_train_plain``.  The wrappers pick by the
tensors' device: the plain twin for CPU tensors, the kernel for CUDA
tensors, and an error for anything the kernel does not take -- never a
fallback.

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
# The fused step's forms of the L pass (csrc/dense_tiled.cu, Form).
FORMS = {"warp": 0, "ring": 1}
# The ring form's stages a warp and warps a block (RING, WARPS), and the
# shared memory a block may take on an H100.
_RING, _WARPS, _SMEM_MAX = 4, 8, 232_448
# The longest A line (bytes) the engine streams through the ring.
RING_MAX_A_BYTES = 1024


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


def _transpose_for(A, At, U, I):
    """A's transpose (I, U) for the dR pass: made here, or checked."""
    if At is None:
        return A.t().contiguous()
    if tuple(At.shape) != (I, U) or At.dtype != A.dtype or At.device != A.device or not At.is_contiguous():
        raise ValueError(f"At must be A's contiguous transpose ({I}, {U}) {A.dtype} on {A.device}")
    return At


def tiled_deltas(L, R, A, *, precision: str = "highest", At=None):
    """Raw gradient sums (dL, dR) of one stable-snapshot step, no update
    applied (port of ``pallas_dense.tiled_deltas`` :566, minus the TPU-only
    ``bu``, ``bi`` and ``interpret``).

    L (U, K), R (I, K) f32, A (U, I) int8 (2x rating) / bf16 / f32; U and
    I multiples of 128, K a multiple of 32 up to ``MAX_K``.  ``At`` is A's
    transpose (I, U), which the kernel's dR pass walks; a caller that takes
    many steps passes it once made, else the wrapper makes it.  CPU tensors
    go to the plain twin; CUDA tensors to the kernel, which counts each
    launch in ``.launches``.
    """
    U, I, K = _check(L, R, A, precision)
    if L.device.type == "cpu":
        return tiled_deltas_plain(L, R, A, precision=precision)
    dev = _kernel_device(L)
    At = _transpose_for(A, At, U, I)
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


def ring_bytes(K: int, I: int, a_dtype: torch.dtype) -> int:
    """Shared memory a block of the ring form takes: ``_RING`` stages of an
    L row (4*K bytes) and an A line (I cells) for each of its warps."""
    return _WARPS * _RING * (4 * K + I * torch.empty((), dtype=a_dtype).element_size())


def step_form(K: int, I: int, a_dtype: torch.dtype) -> str:
    """The L pass's form for a shape: ``ring`` while an A line takes at
    most ``RING_MAX_A_BYTES``, else ``warp`` (long lines fill the ring with
    A and leave no room for users ahead)."""
    a_line = I * torch.empty((), dtype=a_dtype).element_size()
    return "ring" if a_line <= RING_MAX_A_BYTES and ring_bytes(K, I, a_dtype) <= _SMEM_MAX else "warp"


def step_buffers(U: int, I: int, K: int, device) -> tuple:
    """The fused step's (chunk, S, scratch) on ``device``: the dR split
    and partial sums (S, I, K), or None with one chunk (the dR pass then
    writes R' itself).  Off the card the split is an H100's."""
    device = torch.device(device)
    chunk, S = dr_split(U, I, _sms(device) if device.type == "cuda" else H100_SMS)
    part = torch.empty((S, I, K), dtype=torch.float32, device=device) if S > 1 else None
    return chunk, S, part


def train_buffers(L, R, A, iters: int) -> tuple:
    """What ``tiled_train`` allocates once for a run, on L's device: A's
    transpose, ``step_buffers`` and the sets of next factors (two, or one
    for a single step)."""
    U, K = L.shape
    sets = [(torch.empty_like(L), torch.empty_like(R)) for _ in range(min(iters, 2))]
    return A.t().contiguous(), step_buffers(U, R.shape[0], K, L.device), sets


def train_bytes(U: int, I: int, K: int, a_dtype: torch.dtype, sms: int = H100_SMS) -> int:
    """Device bytes of a ``tiled_train`` run of two steps or more: A and
    its transpose, L and R as given, ``train_buffers``' two sets of next
    factors and the dR partial sums (``partial_bytes``)."""
    a_bytes = torch.empty((), dtype=a_dtype).element_size()
    return 2 * a_bytes * U * I + 3 * 4 * K * (U + I) + partial_bytes(U, I, K, sms)


def tiled_step(L, R, A, Lout, Rout, *, alpha2: float, precision: str = "highest", At=None, form: str = "auto",
               scratch=None):
    """One fused step on the card: L' = L + a2*dL into ``Lout`` and R' = R +
    a2*dR into ``Rout``, bit for bit ``tiled_deltas`` then ``_apply``, in
    three launches (the L pass, the dR pass, the R reduction; two with one
    dR chunk).  ``Lout`` and ``Rout`` are contiguous f32 tensors of L's and
    R's shapes on their device that share no memory with L or R.
    ``form``: ``warp``, ``ring`` or ``auto`` (``step_form``).  ``At`` as
    ``tiled_deltas``; ``scratch`` is ``step_buffers``' result, made here if
    not given.  CUDA tensors only (the CPU's step is ``tiled_gd_step``'s
    twin); counts each call in ``.launches``.  Returns (Lout, Rout)."""
    U, I, K = _check(L, R, A, precision)
    for name, out, like in (("Lout", Lout, L), ("Rout", Rout, R)):
        if (out.shape != like.shape or out.dtype != torch.float32 or out.device != L.device
                or not out.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 {tuple(like.shape)} tensor on {L.device}")
    for out in (Lout, Rout):
        for inp in (L, R):
            if _overlaps(out, inp):
                raise ValueError("Lout and Rout must not share memory with L or R")
    if form == "auto":
        form = step_form(K, I, A.dtype)
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {sorted(FORMS)} or 'auto'")
    if form == "ring" and ring_bytes(K, I, A.dtype) > _SMEM_MAX:
        raise ValueError(f"the ring form needs {ring_bytes(K, I, A.dtype)} B of shared memory a block "
                         f"at K={K} I={I} {A.dtype}; at most {_SMEM_MAX}")
    dev = _kernel_device(L)
    At = _transpose_for(A, At, U, I)
    chunk, S, part = scratch if scratch is not None else step_buffers(U, I, K, dev)
    if not ((S - 1) * chunk < U <= S * chunk and (part is None if S == 1 else tuple(part.shape) == (S, I, K))):
        raise ValueError(f"scratch (chunk {chunk}, S {S}) is not a dR split of U={U} I={I} K={K}")
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rs_tiled_step(
            ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(At.data_ptr()), _A_KIND[A.dtype],
            *_ptrs(L, R, Lout, Rout), ctypes.c_void_p(part.data_ptr() if part is not None else 0),
            U, I, K, _PRECISION_CODE[precision], chunk, S, float(alpha2), FORMS[form], _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_tiled_step ({form}) failed: CUDA error {rc}")
    tiled_step.launches += 1
    return Lout, Rout


tiled_step.launches = 0


def _overlaps(a, b) -> bool:
    """Whether two tensors' bytes overlap (tensors without storage, as on
    the meta device, never do)."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return bool(a0 and b0) and a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def tiled_gd_step(L, R, A, *, alpha2: float, precision: str = "highest", At=None, form: str = "auto"):
    """One GD step (``pallas_dense.tiled_gd_step`` :614) into new tensors:
    one ``tiled_step`` on CUDA tensors, the twin's deltas and ``_apply`` on
    CPU tensors.  L and R are not changed.  Returns (L', R')."""
    _check(L, R, A, precision)
    if L.device.type == "cpu":
        return _apply(L, R, *tiled_deltas_plain(L, R, A, precision=precision), alpha2)
    return tiled_step(L, R, A, torch.empty_like(L), torch.empty_like(R), alpha2=alpha2, precision=precision,
                      At=At, form=form)


def tiled_train(L, R, A, *, iters: int, alpha2: float, precision: str = "highest", form: str = "auto"):
    """``iters`` GD steps (``pallas_dense.tiled_train`` :704).  On CUDA
    tensors: one ``tiled_step`` a step, A's transpose, the dR scratch and
    two sets of next factors made once for the run, each step reading one
    set and writing the other, so the caller's L and R are never written
    and nothing factor-sized is allocated per step.  CPU tensors take
    ``tiled_train_plain``.  Returns (L', R')."""
    _check(L, R, A, precision)
    if L.device.type == "cpu":
        return tiled_train_plain(L, R, A, iters=iters, alpha2=alpha2, precision=precision)
    At, scratch, sets = train_buffers(L, R, A, iters)
    for n in range(iters):
        L, R = tiled_step(L, R, A, *sets[n % 2], alpha2=alpha2, precision=precision, At=At, form=form,
                          scratch=scratch)
    return L, R


def tiled_train_deltas(L, R, A, *, iters: int, alpha2: float, precision: str = "highest"):
    """``iters`` steps as this module composed them before the fused step:
    ``tiled_deltas`` (one B5 launch) and then ``_apply`` as torch ops, with
    fresh factors each step.  The baseline the fused step is held to, bit
    for bit and in time.  Returns (L', R')."""
    At = A.t().contiguous() if A.device.type == "cuda" else None
    for _ in range(iters):
        L, R = _apply(L, R, *tiled_deltas(L, R, A, precision=precision, At=At), alpha2)
    return L, R
