"""Streamed dense full-batch GD and the standalone masked top-1: the port
of ``recsys_tpu/ops/pallas_dense.py``'s stream kernels.

The JAX module streams A^T from HBM one (strip, U) block per grid step
while the factors stay in VMEM (``_stream_call`` :372).  Its entry points
and their counterparts here:

* ``stream_train`` (:420, B3): ``iters`` GD steps.  CUDA kernel
  ``csrc/dense_stream.cu`` (``rs_stream_train``): one read of each A^T tile
  per step feeds both gradient sides.
* ``stream_top1`` (:473, B4): the masked top-1 from final factors.  CUDA
  kernel ``top1_pass`` + ``top1_reduce`` of ``csrc/dense_fused.cu`` behind
  their own entry (``rs_stream_top1``), so from the same factors it is B1's
  top-1 bit for bit.
* ``stream_train_top1`` (:433, B6): B3's steps, then B4's pass, in one host
  call (``rs_stream_train_top1``).

Each has a plain torch twin of the same math.  The wrappers take the plain
twin for CPU tensors and the kernel for CUDA tensors, and raise for
anything else: never a fallback.  Inputs as ``dense_fused``: Lt (K, U),
Rt (K, I) f32, At (I, U) int8 (2x rating) / bf16 / f32; U and I multiples
of 128, K a multiple of 8 up to ``dense_fused.MAX_K``.
"""

from __future__ import annotations

import ctypes

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import (
    _A_KIND,
    _PRECISION_CODE,
    _check,
    _kernel_device,
    _lanes_per_column,
    _ptrs,
    _split,
    exact_f32,
    plain_top1,
    plain_train,
    round_up,
)

# Items per strip of the stream kernel (csrc/dense_stream.cu, BR).
_BR = 32
# Blocks along users that share an item chunk and sum their dRt tiles in
# shared memory (a thread-block cluster), at most.  Hopper runs clusters
# of 16 (8 is the portable size); 16 halves part_r at gen-instML1M.
_MAX_CLUSTER = 16
# SMs of an H100 SXM, for the partial-buffer sizes the plan counts before
# any device is chosen.
H100_SMS = 132
# Blocks of the stream kernel's grid per SM.  At gen-instML1M, 3 took a
# step from 262 to 215 us against 2 (4: 192 us, but 11.7 MB of partials)
# on an H100 80GB HBM3 at 700 W (PERF.md).
_BLOCKS_PER_SM = 3
_GRID = (_BLOCKS_PER_SM, _MAX_CLUSTER)


def stream_split(K: int, U: int, I: int, sms: int = H100_SMS,
                 grid: tuple[int, int] = _GRID) -> tuple[int, int, int, int]:
    """(G, C, chunk, S) of the stream kernel: G lanes per user column, C
    blocks per cluster, the item chunk each block walks and the number S
    of chunks, chosen so the grid has about ``grid[0]`` blocks per SM in
    clusters of at most ``grid[1]``."""
    blocks_per_sm, max_cluster = grid
    G = _lanes_per_column(K)
    col_blocks = U * G // 128
    C = next(c for c in (16, 8, 4, 2, 1) if c <= max_cluster and col_blocks % c == 0)
    s = max(1, min(I // _BR, -(-blocks_per_sm * sms // col_blocks)))
    chunk = round_up(-(-I // s), _BR)
    return G, C, chunk, -(-I // chunk)


def stream_partial_bytes(K: int, U: int, I: int, sms: int = H100_SMS,
                         grid: tuple[int, int] = _GRID) -> int:
    """Bytes of the stream kernel's partial sums: part_l (S, K, U) and
    part_r (U*G / (128*C), K, I), f32."""
    G, C, _, S = stream_split(K, U, I, sms, grid)
    return 4 * K * (S * U + U * G // (128 * C) * I)


def stream_train_plain(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest"):
    """Plain torch twin of ``stream_train``: the GD steps every training
    kernel of the port computes.  Returns (Lt', Rt')."""
    with exact_f32(Lt.device):
        return plain_train(Lt, Rt, At, iters, alpha2, precision)


def stream_top1_plain(Lt, Rt, At, *, precision: str = "highest", items_true: int):
    """Plain torch twin of ``stream_top1``: (1, U) int32."""
    with exact_f32(Lt.device):
        return plain_top1(Lt, Rt, At, precision, items_true)


def stream_train_top1_plain(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest", items_true: int):
    """Plain torch twin of ``stream_train_top1``: ``stream_train_plain``
    then ``stream_top1_plain``.  Returns (Lt', Rt', top1)."""
    Lt, Rt = stream_train_plain(Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision)
    return Lt, Rt, stream_top1_plain(Lt, Rt, At, precision=precision, items_true=items_true)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _train_buffers(K, U, I, dev, grid=_GRID):
    G, C, chunk, S = stream_split(K, U, I, _sms(dev), grid)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (f32(K, U), f32(K, I), f32(K, U), f32(K, I))  # Lt_out, Rt_out, Lt_tmp, Rt_tmp
    parts = (f32(S, K, U), f32(U * G // (128 * C), K, I))
    return (G, C, chunk, S), outs, parts


def _top1_buffers(K, U, I, dev):
    G = _lanes_per_column(K)
    chunk, S = _split(U, I, G, 2 * _sms(dev))  # the dl side's chunks, as B1
    top_val = torch.empty((S, U), dtype=torch.float32, device=dev)
    top_idx = torch.empty((S, U), dtype=torch.int32, device=dev)
    top1 = torch.empty((1, U), dtype=torch.int32, device=dev)
    return (chunk, S), (top_val, top_idx, top1)


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def stream_train(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest",
                 grid: tuple[int, int] = _GRID):
    """``iters`` stable-snapshot GD steps with A^T read once per step (port
    of ``pallas_dense.stream_train`` :420).  Returns (Lt', Rt').  CPU
    tensors go to the plain twin; CUDA tensors to the kernel, which counts
    each launch in ``.launches``.  ``grid`` (blocks per SM, largest
    cluster) sizes the kernel's grid; the engine keeps the default, and
    ``probes/stream_grid.py`` sweeps it."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return stream_train_plain(Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision)
    dev = _kernel_device(Lt)
    lib = _build.load()
    (G, C, chunk, S), outs, parts = _train_buffers(K, U, I, dev, grid)
    with torch.cuda.device(dev):
        rc = lib.rs_stream_train(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *outs, *parts),
            K, U, I, G, C, iters, float(alpha2), _PRECISION_CODE[precision], chunk, S, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_train failed: CUDA error {rc}")
    stream_train.launches += 1
    return outs[0], outs[1]


def stream_top1(Lt, Rt, At, *, precision: str = "highest", items_true: int):
    """The masked top-1 from final factors (port of
    ``pallas_dense.stream_top1`` :473): (1, U) int32, rated cells and items
    at or past ``items_true`` never win, lowest index on ties.  CPU tensors
    go to the plain twin; CUDA tensors to the kernel (``.launches``)."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return stream_top1_plain(Lt, Rt, At, precision=precision, items_true=items_true)
    dev = _kernel_device(Lt)
    lib = _build.load()
    (chunk, S), tops = _top1_buffers(K, U, I, dev)
    with torch.cuda.device(dev):
        rc = lib.rs_stream_top1(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *tops),
            K, U, I, _lanes_per_column(K), _PRECISION_CODE[precision], items_true, chunk, S,
            _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_top1 failed: CUDA error {rc}")
    stream_top1.launches += 1
    return tops[2]


def stream_train_top1(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest", items_true: int):
    """``stream_train`` then ``stream_top1`` in one host call (port of
    ``pallas_dense.stream_train_top1`` :433).  Returns (Lt', Rt', top1),
    bit for bit the two calls'.  CPU tensors go to the plain twin; CUDA
    tensors to the kernel (``.launches``)."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return stream_train_top1_plain(Lt, Rt, At, iters=iters, alpha2=alpha2,
                                       precision=precision, items_true=items_true)
    dev = _kernel_device(Lt)
    lib = _build.load()
    (G, C, chunk, S), outs, parts = _train_buffers(K, U, I, dev)
    (top_chunk, top_S), tops = _top1_buffers(K, U, I, dev)
    with torch.cuda.device(dev):
        rc = lib.rs_stream_train_top1(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *outs, *parts, *tops),
            K, U, I, G, C, iters, float(alpha2), _PRECISION_CODE[precision], items_true,
            chunk, S, top_chunk, top_S, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_train_top1 failed: CUDA error {rc}")
    stream_train_top1.launches += 1
    return outs[0], outs[1], tops[2]


stream_train.launches = 0
stream_top1.launches = 0
stream_train_top1.launches = 0

