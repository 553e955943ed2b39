"""The functions of the TPU probe P2, ``scripts/probe_mosaic_gather.py``
(``pcall`` :94, call :100), hand-written in CUDA (``csrc/bell.cu``):

* ``gather_rows`` -- ``out[s] = table[idx[s]]``, the function of the
  probe's ``p1_kernel``, ``p2_kernel`` and ``p3_kernel`` (:118-133), three
  Mosaic lowerings of one row gather;
* ``gather_err_grad`` -- ``p4_kernel`` (:139) as the probe wrote it: the
  same gather fused with the BELL error and gradient math against a
  stand-in partner, ``fo = 0.5 * table[s mod blk]``,
  ``err = 0.001 * (vals[s] - <fo, g>)``, ``out[s] = err * g``.

``gather_err_grad`` takes two consecutive slots a warp (one above
K = 512), its rows kept in registers, with streaming stores.

The engine form of ``p4_kernel`` is the BELL step (``ops/bell.py::bell_train``);
these serve the probe ``probes/mosaic_gather.py``.  Each has a plain
torch twin.  The wrappers pick by the tensors' device: the twin for CPU
tensors, the kernel for CUDA tensors (each launch counted in
``.launches``), and an error for anything the kernel does not take.
Indices are not range-checked on the card: they are the caller's, as in
the probe.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import _kernel_device, _ptrs
from recsys_tpu_torch.ops.dense_stream import _stream


def _check(table, idx, vals=None):
    if table.dim() != 2 or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous 2-D float32 tensor, got {table.dtype} {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"idx must be a contiguous 1-D int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    if vals is not None and (tuple(vals.shape) != tuple(idx.shape) or vals.dtype != torch.float32
                             or not vals.is_contiguous()):
        raise ValueError("vals must be a contiguous float32 tensor shaped like idx")
    if idx.device != table.device or (vals is not None and vals.device != table.device):
        raise ValueError("tensors must be on one device")
    if idx.shape[0] == 0 or table.shape[1] == 0:
        raise ValueError("empty gather")


def gather_rows_plain(table, idx):
    """Twin of ``gather_rows``."""
    return table[idx.long()]


def gather_rows(table, idx):
    """(S, K) rows ``table[idx]`` of a float32 (N, K) table; on a card the
    kernel moves a float4 a thread, so K must be a multiple of 4 and the
    table 16-byte aligned."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    dev = _kernel_device(table)
    if table.shape[1] % 4 or table.data_ptr() % 16:
        raise ValueError(f"the kernel takes K % 4 == 0 and a 16-byte aligned table, got K={table.shape[1]}")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.load().rs_gather_rows(*_ptrs(table, idx, out), idx.shape[0], table.shape[1], _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rs_gather_rows failed: CUDA error {rc}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_err_grad_plain(table, idx, vals, blk: int):
    """Twin of ``gather_err_grad``: ``p4_kernel``'s lines, whole arrays."""
    g = table[idx.long()]
    fo = table[torch.arange(idx.shape[0], device=table.device) % blk] * 0.5
    pred = torch.sum(fo * g, dim=-1)
    err = 0.001 * (vals - pred)
    return err[:, None] * g


# The widest row the kernel (csrc/bell.cu, gather_err_grad_grouped) takes:
# 32 values a lane.
MAX_K = 1024


def _err_grad_args(table, idx, vals, blk: int):
    _check(table, idx, vals)
    if not 0 < blk <= table.shape[0]:
        raise ValueError(f"blk={blk} must lie in 1..{table.shape[0]} (the table's rows)")


def gather_err_grad(table, idx, vals, blk: int):
    """(S, K) ``err[s] * table[idx[s]]`` with ``err[s] = 0.001 * (vals[s] -
    <0.5 * table[s mod blk], table[idx[s]]>)``, float32, K <= ``MAX_K``
    on a card.  The kernel sums the dot in another order than the twin:
    the two agree to f32 rounding, not bit for bit."""
    _err_grad_args(table, idx, vals, blk)
    if table.device.type == "cpu":
        return gather_err_grad_plain(table, idx, vals, blk)
    dev = _kernel_device(table)
    if table.shape[1] > MAX_K:
        raise ValueError(f"the kernel takes K <= {MAX_K}, got K={table.shape[1]}")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.load().rs_gather_err_grad(*_ptrs(table, idx, vals, out), idx.shape[0], table.shape[1], blk,
                                              _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rs_gather_err_grad failed: CUDA error {rc}")
    gather_err_grad.launches += 1
    return out


gather_err_grad.launches = 0
