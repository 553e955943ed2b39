"""The functions of the TPU probe P1, ``scripts/probe_gather.py``,
hand-written in CUDA (``csrc/lane.cu``):

* ``lane_gather_loop`` -- ``run_gather`` (:40, body ``gather_kernel`` :29):
  ``out = 0``, then ``t`` times ``out = 0.5 * out + take_along_axis(tab,
  idx, axis=1)``;
* ``lane_cumsum_loop`` -- ``run_cumsum`` (:57, body ``cumsum_kernel`` :48):
  ``t`` times ``out = 0 * out + cumsum(x, axis=1)``, from ``out = 0``.
  The TPU body reads ``out`` before its first write, so its result there
  depends on what the buffer held; the function's result is ``cumsum(x)``
  for any finite start, and the port starts from 0.

Each has a plain torch twin, the ``t``-step loop in torch ops.  The
wrappers pick by the tensors' device: the twin for CPU tensors, the kernel
for CUDA tensors (each launch counted in ``.launches``), and an error for
anything the kernel does not take.  Indices are not range-checked on the
card: they are the caller's, as in the probe.  The gather's kernel equals
its twin bit for bit; the scan sums in another order than ``torch.cumsum``
(``testing.LANE_CUMSUM_RTOL``).
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import _kernel_device, _ptrs
from recsys_tpu_torch.ops.dense_stream import _sms, _stream

# Widest row each kernel takes: the gather keeps a row in shared memory
# (227 KB a block), the scan 32 elements a thread for 1024 threads.
GATHER_MAX_W = 232448 // 4
CUMSUM_MAX_W = 32768


def _check_rows(x, name: str):
    if x.dim() != 2 or not x.is_contiguous() or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{name} must be a non-empty contiguous 2-D tensor, got {tuple(x.shape)}")


def lane_gather_loop_plain(tab, idx, t: int):
    """Twin of ``lane_gather_loop``: ``gather_kernel``'s loop in torch ops."""
    rows = torch.arange(tab.shape[0], device=tab.device)[:, None]
    cols = idx.long()
    out = torch.zeros_like(tab)
    for _ in range(t):
        out = out * 0.5 + tab[rows, cols]
    return out


def lane_gather_loop(tab, idx, t: int):
    """f32 (S, W): ``t`` steps of ``out = 0.5 * out + tab[s, idx[s, w]]``
    from ``out = 0``; tab f32 (S, W), idx int32 (S, W) in [0, W)."""
    _check_rows(tab, "tab")
    if tab.dtype != torch.float32 or idx.dtype != torch.int32 or tuple(idx.shape) != tuple(tab.shape):
        raise ValueError(f"tab must be float32 and idx int32 of its shape, got {tab.dtype} {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not idx.is_contiguous() or idx.device != tab.device or t < 0:
        raise ValueError("idx must be contiguous on tab's device, and t >= 0")
    if tab.device.type == "cpu":
        return lane_gather_loop_plain(tab, idx, t)
    dev = _kernel_device(tab)
    S, W = tab.shape
    if W > GATHER_MAX_W:
        raise ValueError(f"W={W} exceeds the kernel's row of {GATHER_MAX_W} (one row in shared memory)")
    out = torch.empty_like(tab)
    with torch.cuda.device(dev):
        rc = _build.load().rs_lane_gather_loop(*_ptrs(tab, idx, out), S, W, t, _sms(dev), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rs_lane_gather_loop failed: CUDA error {rc}")
    lane_gather_loop.launches += 1
    return out


lane_gather_loop.launches = 0


def lane_cumsum_loop_plain(x, t: int):
    """Twin of ``lane_cumsum_loop``: ``cumsum_kernel``'s loop in torch ops,
    from ``out = 0``."""
    out = torch.zeros_like(x)
    for _ in range(t):
        out = out * 0.0 + torch.cumsum(x, dim=1)
    return out


def lane_cumsum_loop(x, t: int):
    """f32 (S, W): ``t`` steps of ``out = 0 * out + cumsum(x, axis=1)`` from
    ``out = 0``; on a card W is a multiple of 32 up to ``CUMSUM_MAX_W``."""
    _check_rows(x, "x")
    if x.dtype != torch.float32 or t < 0:
        raise ValueError(f"x must be float32 and t >= 0, got {x.dtype}, t={t}")
    if x.device.type == "cpu":
        return lane_cumsum_loop_plain(x, t)
    dev = _kernel_device(x)
    S, W = x.shape
    if W % 32 or W > CUMSUM_MAX_W:
        raise ValueError(f"the kernel takes W a multiple of 32 up to {CUMSUM_MAX_W}, got W={W}")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = _build.load().rs_lane_cumsum_loop(*_ptrs(x, out), S, W, t, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"rs_lane_cumsum_loop failed: CUDA error {rc}")
    lane_cumsum_loop.launches += 1
    return out


lane_cumsum_loop.launches = 0
