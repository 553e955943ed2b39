"""The function of the TPU probe P3, ``scripts/probe_stream_v2.py``
(``stream_v2_train`` :89, body ``_v2_kernel`` :48), hand-written in CUDA:
``iters`` full GD steps on A (U, n * strip) with the R table packed strip
by strip, Rp (n * K, strip).

``stream_v2_train`` walks the rated cells alone: B3's walk
(``csrc/dense_stream.cu``, ``sparse_pass`` with R in the packed layout,
``rs_stream_v2_sparse_train``) over the tables of A^T (``v2_walk``, B3's
``walk_tables`` of ``A.T``).

The layout is the TPU kernel's own contract, A (U, n * strip) as its
BlockSpec reads it (:90, :108), built by ``dense_tiled.device_dense_A``.
The script's drivers no longer fit that kernel (its docstring, :4-9:
``check_bitwise`` passes the stream kernel's A^T (I, U), ``time_shape``
``device_dense_AT``); the port follows the kernel.

It keeps B3's order of sums (``csrc/dense_stream.cu``), so from the same
factors it gives ``dense_stream.stream_train``'s result, packed, bit for
bit.  Only ``precision="highest"`` (true f32, no TF32) exists, the
script's default and the only one its drivers use; others raise.  The twin
``stream_v2_train_plain`` walks the strips as ``_v2_kernel`` does.  The
wrapper picks by the tensors' device: the twin for CPU tensors, the kernel
for CUDA tensors (each launch counted in ``.launches``), and an error for
anything the kernel does not take.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import (
    _A_KIND,
    H100_SMS,
    MAX_K,
    _kernel_device,
    _ptrs,
    exact_f32,
    load_at,
    sub_strip,
)
from recsys_tpu_torch.ops.dense_stream import Walk, _sms, _stream, _walk_for, stream_split, walk_tables


def pack_R(Rt, strip: int):
    """(K, I) -> (I / strip * K, strip): strip s of Rt as rows s*K .. s*K + K-1
    (``pack_R`` :125)."""
    K, I = Rt.shape
    n = I // strip
    return Rt.reshape(K, n, strip).transpose(0, 1).reshape(n * K, strip).contiguous()


def unpack_R(Rp, K: int):
    """(n * K, strip) -> (K, n * strip), ``pack_R``'s inverse (``unpack_R`` :134)."""
    SK, strip = Rp.shape
    n = SK // K
    return Rp.reshape(n, K, strip).transpose(0, 1).reshape(K, n * strip).contiguous()


def _check(Lt, Rp, A, strip, precision):
    if precision != "highest":
        raise ValueError(f"stream_v2_train computes in 'highest' only, got {precision!r}")
    if Lt.dim() != 2 or Rp.dim() != 2 or A.dim() != 2:
        raise ValueError("Lt, Rp and A must be 2-D")
    K, U = Lt.shape
    if strip < 1 or Rp.shape[1] != strip or Rp.shape[0] % K:
        raise ValueError(f"Rp {tuple(Rp.shape)} is not a packed (n*K, strip={strip}) table for K={K}")
    I = Rp.shape[0] // K * strip
    if tuple(A.shape) != (U, I):
        raise ValueError(f"A {tuple(A.shape)} must be (U, n*strip) = {(U, I)}")
    if Lt.dtype != torch.float32 or Rp.dtype != torch.float32 or A.dtype not in _A_KIND:
        raise ValueError(f"dtypes Lt {Lt.dtype}, Rp {Rp.dtype}, A {A.dtype} not taken")
    if not (Lt.is_contiguous() and Rp.is_contiguous() and A.is_contiguous()):
        raise ValueError("Lt, Rp and A must be contiguous")
    if not (Lt.device == Rp.device == A.device):
        raise ValueError("Lt, Rp and A must be on one device")
    return K, U, I


def stream_v2_train_plain(Lt, Rp, A, *, iters: int, alpha2: float, strip: int, precision: str = "highest"):
    """Twin of ``stream_v2_train``: ``_v2_kernel``'s strip walk in torch ops
    (true f32 matmuls).  Returns (Lt', Rp')."""
    K, U, I = _check(Lt, Rp, A, strip, precision)
    a = load_at(A)
    with exact_f32(Lt.device):
        for _ in range(iters):
            dLt = torch.zeros_like(Lt)
            dRp = torch.empty_like(Rp)
            for s in range(I // strip):
                rt = Rp[s * K : (s + 1) * K]
                a_s = a[:, s * strip : (s + 1) * strip]
                pred = Lt.T @ rt
                e = torch.where(a_s != 0, a_s - pred, 0.0)
                dLt += rt @ e.T
                dRp[s * K : (s + 1) * K] = Lt @ e
            Lt, Rp = Lt + alpha2 * dLt, Rp + alpha2 * dRp
    return Lt, Rp


def v2_walk(A, K: int, sms: int | None = None) -> Walk:
    """The walk's tables for A (U, I): B3's ``walk_tables`` of A^T (a view,
    no copy) at ``stream_split``'s split for ``sms`` SMs (default: A's
    card, or an H100's on the CPU)."""
    U, I = A.shape
    if sms is None:
        sms = _sms(A.device) if A.device.type == "cuda" else H100_SMS
    split = stream_split(K, U, I, sms)
    return walk_tables(A.T, split, sub_strip(split[0]))


def _kernel_shape(Lt, K, U, I):
    dev = _kernel_device(Lt)
    if U % 128 or I % 32 or K % 8 or K > MAX_K:
        raise ValueError(f"the kernel needs U % 128 == 0, n*strip % 32 == 0 and K a multiple of 8 up to "
                         f"{MAX_K}; got K={K} U={U} I={I}")
    return dev, stream_split(K, U, I, _sms(dev))


def _buffers(K, U, Rp, G, C, S, dev):
    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (f32(K, U), f32(*Rp.shape), f32(K, U), f32(*Rp.shape))  # Lt_out, Rp_out, Lt_tmp, Rp_tmp
    return outs, (f32(S, K, U), f32(U * G // (128 * C), Rp.numel()))


def stream_v2_train(Lt, Rp, A, *, iters: int, alpha2: float, strip: int, precision: str = "highest",
                    walk: Walk | None = None):
    """``iters`` stable-snapshot GD steps on Lt (K, U) f32, the packed Rp
    (n*K, strip) f32 and A (U, n*strip) int8 (2x the rating), bf16 or f32,
    the rated cells alone walked on the card.  On a card U is a multiple of
    128, K of 8 up to ``dense_fused.MAX_K``, and n*strip of 32.  ``walk`` is ``v2_walk(A,
    K)`` built ahead (outside a timed window), else the call builds it; a
    walk of another split raises.  Returns (Lt', Rp')."""
    K, U, I = _check(Lt, Rp, A, strip, precision)
    if Lt.device.type == "cpu":
        if walk is not None:
            _walk_for(walk, A.T, K, stream_split(K, U, I))
        return stream_v2_train_plain(Lt, Rp, A, iters=iters, alpha2=alpha2, strip=strip)
    dev, (G, C, chunk, S) = _kernel_shape(Lt, K, U, I)
    walk = _walk_for(walk, A.T, K, (G, C, chunk, S))
    outs, parts = _buffers(K, U, Rp, G, C, S, dev)
    with torch.cuda.device(dev):
        rc = _build.load().rs_stream_v2_sparse_train(
            *_ptrs(*walk.tables), walk.cap, *_ptrs(Lt, Rp, *outs, *parts),
            K, U, I, strip, G, C, iters, float(alpha2), chunk, S, walk.sub, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_v2_sparse_train failed: CUDA error {rc}")
    stream_v2_train.launches += 1
    return outs[0], outs[1]


stream_v2_train.launches = 0
