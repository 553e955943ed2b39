"""Fused dense full-batch GD + masked top-1: the port of ``recsys_tpu/ops/pallas_dense.py``'s
resident kernels.

The JAX module's resident kernel ``resident_train_top1`` (:662) runs
every GD iteration and the masked top-1 in one Pallas call, with A
stored TRANSPOSED (items x users) and K-major factors Lt (K, U), Rt (K, I);
``resident_train`` (:238) is the same loop without the top-1.  Here both
are hand-written CUDA (``csrc/dense_fused.cu``) behind
``resident_train_top1`` (B1) and ``resident_train`` (B2), with plain torch
twins of the same math.  The wrappers pick by the tensors' device: the
plain twin for CPU tensors, the kernel for CUDA tensors, and an error for
anything the kernel does not take -- never a fallback.

Also here, ported from the same JAX module: the host helpers that build
the kernel's inputs (``round_up`` :52, ``pad_factors_for_pallas`` :751,
``vals_bf16_exact`` :802, ``vals_int8_exact`` :812, ``device_dense_AT``
:828, ``mask_is_implicit`` :889) and the ``_load_at`` (:155) dequant rule.

Gradient math (stable-snapshot semantics of ``matFact.c:38-39``)::

    E  = (A != 0) * (A - L.R^T)
    L' = L + 2a * E.R
    R' = R + 2a * E^T.L     (reading the old L)
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.precision import dot, maybe_split, transpose

# Widest K the kernel takes: a lane holds 32 factor values, and up to 8
# lanes share one output column (csrc/dense_fused.cu, KC and G).
MAX_K = 256
# Reduction columns per shared-memory tile; chunks are multiples of it.
_BR = 32
# Threads per block in every pass of the kernel.
_BLOCK = 128
# Codes of the C entry point's a_kind and precision arguments (enum Prec).
_A_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_PRECISION_CODE = {"highest": 0, "bf16x3": 1, "default": 2}


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_factors_for_pallas(spec, state=None, *, u_mult: int = 128, i_mult: int = 128):
    """Zero-padded K-major f32 (Lt (K, U), Rt (K, I), (U, I, K)) on the
    host: U and I rounded up to the kernel's 128-column blocks, K to 8.
    ``state`` defaults to the glibc initial factors (``init_factors``).
    Padding is self-masking: A is 0 there, so those entries stay 0."""
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.utils.hostmem import hugepage_zeros

    U = round_up(spec.users, u_mult)
    I = round_up(spec.items, i_mult)
    K = round_up(spec.features, 8)
    if state is None:
        state = init_factors(spec.users, spec.items, spec.features)
    Lt = hugepage_zeros((K, U), np.float32)
    Lt[: spec.features, : spec.users] = state.L.T
    Rt = hugepage_zeros((K, I), np.float32)
    Rt[: spec.features, : spec.items] = state.R.T
    return Lt, Rt, (U, I, K)


def vals_bf16_exact(spec) -> bool:
    """True when every rating survives an f64 -> bf16 -> f64 round trip,
    so A can be stored bf16 with the error math still exact in f32."""
    v = torch.from_numpy(np.asarray(spec.vals, np.float64))
    return bool(torch.equal(v.to(torch.bfloat16).to(torch.float64), v))


def vals_int8_exact(spec) -> bool:
    """True when every rating is a non-zero multiple of 0.5 within
    [-63.5, 63.5]: A then stores 2x the rating as int8 and the kernel
    dequantises by an exact x0.5.  Non-zero keeps the implicit mask
    recoverable (int8 0 stays the padding sentinel)."""
    v = np.asarray(spec.vals, np.float64) * 2.0
    if v.size == 0:
        return True
    return bool(np.all(v == np.round(v)) and np.all(np.abs(v) <= 127) and np.all(v != 0))


def mask_is_implicit(spec) -> bool:
    """True when every rating is non-zero, so (A != 0) recovers the mask."""
    return bool(np.all(spec.vals != 0.0))


def device_dense_AT(spec, U: int, I: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Zero-padded TRANSPOSED dense A (I, U) in its storage dtype, built
    on the host and moved to ``device`` in one copy.  int8 holds 2x the
    rating (see ``vals_int8_exact``)."""
    from recsys_tpu_torch.utils.hostmem import hugepage_zeros

    if dtype == torch.int8:
        a = hugepage_zeros((I, U), np.int8)
        a[spec.cols, spec.rows] = np.round(np.asarray(spec.vals, np.float64) * 2.0).astype(np.int8)
        return torch.from_numpy(a).to(device)
    a = hugepage_zeros((I, U), np.float32)
    a[spec.cols, spec.rows] = spec.vals
    return torch.from_numpy(a).to(dtype).to(device)


def load_at(At: torch.Tensor) -> torch.Tensor:
    """A^T as f32 from its storage dtype (``_load_at`` :155): int8 holds
    2x the rating and x0.5 is exact, so every storage dtype yields the
    same f32 values."""
    a = At.to(torch.float32)
    if At.dtype == torch.int8:
        a = a * 0.5
    return a


@contextlib.contextmanager
def exact_f32(device):
    """True f32 matmuls for the plain twins: on a CUDA device TF32 is off
    for the block and the process-wide flag is restored after."""
    if torch.device(device).type != "cuda":
        yield
        return
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def resident_train_top1_plain(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest", items_true: int):
    """Plain torch twin of the kernel: ``iters`` GD steps, then the masked
    top-1.  Returns (Lt', Rt', top1 (1, U) int32).  On CUDA tensors the
    matmuls run with TF32 off ("highest" is true f32)."""
    with exact_f32(Lt.device):
        Lt, Rt = plain_train(Lt, Rt, At, iters, alpha2, precision)
        return Lt, Rt, plain_top1(Lt, Rt, At, precision, items_true)


def resident_train_plain(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest"):
    """Plain torch twin of ``resident_train``: the steps of
    ``resident_train_top1_plain`` without the top-1.  Returns (Lt', Rt')."""
    with exact_f32(Lt.device):
        return plain_train(Lt, Rt, At, iters, alpha2, precision)


def plain_train(Lt, Rt, At, iters, alpha2, precision):
    """``iters`` stable-snapshot GD steps in plain torch, the function every
    training kernel of the port computes (B1, B2, B3)."""
    a = load_at(At)
    rated = a != 0
    for _ in range(iters):
        rt = maybe_split(Rt, precision)
        lt = maybe_split(Lt, precision)
        pred = dot(transpose(rt), lt, precision)  # (I, U)
        e = maybe_split(torch.where(rated, a - pred, 0.0), precision)
        dLt = dot(rt, e, precision)  # (K, U)
        dRt = dot(lt, transpose(e), precision)  # (K, I)
        Lt = Lt + alpha2 * dLt
        Rt = Rt + alpha2 * dRt
    return Lt, Rt


def plain_top1(Lt, Rt, At, precision, items_true):
    """The masked top-1 from final factors in plain torch (B1's last pass,
    B4): (1, U) int32, rated cells and items at or past ``items_true`` at
    -inf, lowest index on ties."""
    a = load_at(At)
    b = dot(Rt.T, Lt, precision)
    item = torch.arange(b.shape[0], device=b.device)[:, None]
    b = torch.where((a != 0) | (item >= items_true), -torch.inf, b)
    # argmax returns the first maximum: the lowest-index tie-break.
    return torch.argmax(b, dim=0).to(torch.int32)[None, :]


def _lanes_per_column(K: int) -> int:
    for G in (1, 2, 4, 8):
        if K <= 32 * G:
            return G
    raise ValueError(f"K={K} exceeds the kernel's MAX_K={MAX_K}")


def _split(n_own: int, m_red: int, G: int, target_blocks: int) -> tuple[int, int]:
    """(chunk, S): the reduction over ``m_red`` columns is cut into S
    chunks of ``chunk`` columns so one side's pass has about
    ``target_blocks`` blocks (U = 1024 users alone would fill 8)."""
    col_blocks = n_own * G // _BLOCK
    s = max(1, min(m_red // _BR, -(-target_blocks // col_blocks)))
    chunk = round_up(-(-m_red // s), _BR)
    return chunk, -(-m_red // chunk)


def _check(Lt, Rt, At, precision):
    if precision not in _PRECISION_CODE:
        raise ValueError(f"unknown precision {precision!r}")
    if Lt.dim() != 2 or Rt.dim() != 2 or At.dim() != 2:
        raise ValueError("Lt, Rt and At must be 2-D")
    K, U = Lt.shape
    I = Rt.shape[1]
    if Rt.shape[0] != K or tuple(At.shape) != (I, U):
        raise ValueError(f"shapes Lt {tuple(Lt.shape)}, Rt {tuple(Rt.shape)}, At {tuple(At.shape)} disagree")
    if U % 128 or I % 128 or K % 8 or K > MAX_K or K == 0:
        raise ValueError(f"kernel needs U, I multiples of 128 and K a multiple of 8 in [8, {MAX_K}]; got K={K} U={U} I={I}")
    if Lt.dtype != torch.float32 or Rt.dtype != torch.float32 or At.dtype not in _A_KIND:
        raise ValueError(f"dtypes Lt {Lt.dtype}, Rt {Rt.dtype}, At {At.dtype} not taken")
    if not (Lt.is_contiguous() and Rt.is_contiguous() and At.is_contiguous()):
        raise ValueError("Lt, Rt and At must be contiguous")
    if not (Lt.device == Rt.device == At.device):
        raise ValueError("Lt, Rt and At must be on one device")
    return K, U, I


def _resident_buffers(K, U, I, dev):
    """((chunk_l, s_l, chunk_r, s_r), (Lt_out, Rt_out, Lt_tmp, Rt_tmp,
    part_l, part_r)) of B1 and B2: each gradient side's reduction split so
    its pass has about two blocks per SM."""
    G = _lanes_per_column(K)
    target = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    chunk_l, s_l = _split(U, I, G, target)
    chunk_r, s_r = _split(I, U, G, target)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    bufs = (f32(K, U), f32(K, I), f32(K, U), f32(K, I), f32(s_l, K, U), f32(s_r, K, I))
    return (chunk_l, s_l, chunk_r, s_r), bufs


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _kernel_device(Lt):
    if Lt.device.type != "cuda":
        raise ValueError(f"no kernel for device {Lt.device}")
    return Lt.device


def resident_train_top1(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest", items_true: int):
    """``iters`` stable-snapshot GD steps plus the masked top-1 (port of
    ``pallas_dense.resident_train_top1`` :662, minus the TPU-only
    ``strip`` and ``interpret``).

    Lt (K, U), Rt (K, I) f32, At (I, U) int8 (2x rating) / bf16 / f32;
    U and I multiples of 128, K a multiple of 8 up to ``MAX_K``.  Items
    at or past ``items_true`` never win the top-1.  Returns (Lt', Rt',
    top1 (1, U) int32).  CPU tensors go to the plain twin; CUDA tensors
    to the kernel, which counts each launch in ``.launches``.
    """
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return resident_train_top1_plain(
            Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision, items_true=items_true
        )
    dev = _kernel_device(Lt)
    lib = _build.load()
    split, bufs = _resident_buffers(K, U, I, dev)
    # The top-1 pass walks the items in the dl side's chunks.
    top_val = torch.empty((split[1], U), dtype=torch.float32, device=dev)
    top_idx = torch.empty((split[1], U), dtype=torch.int32, device=dev)
    top1 = torch.empty((1, U), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rs_resident_train_top1(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *bufs, top_val, top_idx, top1),
            K, U, I, _lanes_per_column(K), iters, float(alpha2), _PRECISION_CODE[precision], items_true,
            *split, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"rs_resident_train_top1 failed: CUDA error {rc}")
    resident_train_top1.launches += 1
    return bufs[0], bufs[1], top1


resident_train_top1.launches = 0


def resident_train(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest"):
    """``iters`` stable-snapshot GD steps (port of ``pallas_dense.resident_train``
    :238): B1's kernels without the top-1, so its factors are B1's bit for
    bit.  Same inputs as ``resident_train_top1``; returns (Lt', Rt').  CPU
    tensors go to the plain twin; CUDA tensors to the kernel, which counts
    each launch in ``.launches``."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return resident_train_plain(Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision)
    dev = _kernel_device(Lt)
    lib = _build.load()
    split, bufs = _resident_buffers(K, U, I, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rs_resident_train(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *bufs),
            K, U, I, _lanes_per_column(K), iters, float(alpha2), _PRECISION_CODE[precision],
            *split, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"rs_resident_train failed: CUDA error {rc}")
    resident_train.launches += 1
    return bufs[0], bufs[1]


resident_train.launches = 0
