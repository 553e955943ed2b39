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

``lane_gather_loop`` gathers on a schedule the block builds on the card
in every launch, free of bank conflicts (``gather_schedule_plain`` is its
algorithm).  ``lane_cumsum_loop`` spreads a row over a thread-block
cluster (``cumsum_cluster_plan``).

Each has a plain torch twin, the ``t``-step loop in torch ops.  The
wrappers pick by the tensors' device: the twin for CPU tensors, the kernel
for CUDA tensors (each launch counted in ``.launches``), and an error for
anything the kernel does not take.  Indices are not range-checked on the
card: they are the caller's, as in the probe.  The gather's kernel equals
its twin bit for bit; the scan's sums in another order than
``torch.cumsum`` (``testing.LANE_CUMSUM_RTOL``), the order of
``lane_cumsum_loop_order_plain``, which it equals in raw bits.
"""

from __future__ import annotations

import ctypes

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import _kernel_device, _ptrs
from recsys_tpu_torch.ops.dense_stream import _sms, _stream

# Widest row each kernel takes: the gather keeps a row in shared memory
# (227 KB a block), the scan 32 elements a thread for 1024 threads.
_SMEM_MAX = 232448
GATHER_MAX_W = _SMEM_MAX // 4
CUMSUM_MAX_W = 32768
# Ints of a block's schedule scratch ahead of its cells (csrc/lane.cu META).
_META = 128


def _check_rows(x, name: str):
    if x.dim() != 2 or not x.is_contiguous() or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{name} must be a non-empty contiguous 2-D tensor, got {tuple(x.shape)}")


def _check_gather(tab, idx, t):
    _check_rows(tab, "tab")
    if tab.dtype != torch.float32 or idx.dtype != torch.int32 or tuple(idx.shape) != tuple(tab.shape):
        raise ValueError(f"tab must be float32 and idx int32 of its shape, got {tab.dtype} {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not idx.is_contiguous() or idx.device != tab.device or t < 0:
        raise ValueError("idx must be contiguous on tab's device, and t >= 0")
    if tab.device.type != "cpu":
        _kernel_device(tab)
        if tab.shape[1] > GATHER_MAX_W:
            raise ValueError(f"W={tab.shape[1]} exceeds the kernel's row of {GATHER_MAX_W} (one row in shared memory)")


def lane_gather_loop_plain(tab, idx, t: int):
    """Twin of ``lane_gather_loop``: ``gather_kernel``'s loop in torch ops."""
    rows = torch.arange(tab.shape[0], device=tab.device)[:, None]
    cols = idx.long()
    out = torch.zeros_like(tab)
    for _ in range(t):
        out = out * 0.5 + tab[rows, cols]
    return out


def gather_plan(S: int, W: int, sms: int) -> tuple[int, int, int, int]:
    """(grid, span, threads, slots) of ``lane_gather_loop``: ``grid`` blocks
    a row, each of ``span`` outputs (about one block per SM in all, at least
    32 outputs a block, at most 8192), ``threads`` threads, each holding
    ``slots`` cells of the schedule: twice the power of two ``per`` of
    outputs a thread would take in order, and at least 4, so the rounds
    allowed are twice a bucket's mean."""
    cpr = max(-(-W // 8192), max(1, min(sms // S, -(-W // 32))))
    span = -(-W // cpr)
    per = 1
    while per * 512 < span:
        per *= 2
    threads = (-(-span // per) + 31) // 32 * 32
    return -(-W // span), span, threads, max(2 * per, 4)


def gather_schedule_plain(idx_span, threads: int, slots: int):
    """The schedule ``lane_gather_loop``'s block builds for its outputs
    0..n-1 with indices ``idx_span``: (cells, rounds).  ``cells`` int64
    (R_CAP, 32), R_CAP = threads / 32 * slots, holds at (r, b) the output
    that lane b reads in round r (slot r // (threads / 32) of warp r mod
    (threads / 32)), or -1.  Output i goes to lane b = idx mod 32 at round
    p, its place in bucket b (here in output order; on the card in the
    atomics' order).  A bucket's outputs beyond R_CAP take the free cells
    of the other lanes, lanes in order, each from the lane's first free
    round.  ``rounds`` is the fullest bucket, or R_CAP where one
    overflowed."""
    idx = idx_span.reshape(-1).long()
    n, cap = idx.numel(), threads // 32 * slots
    if threads % 32 or threads * (slots // 2) < n:
        raise ValueError(f"{threads} threads of {slots} slots cannot schedule {n} outputs")
    bank = idx & 31
    counts = torch.bincount(bank, minlength=32)
    order = torch.argsort(bank, stable=True)
    pos = torch.empty_like(idx)
    pos[order] = torch.arange(n) - (torch.cumsum(counts, 0) - counts)[bank[order]]
    own = counts.clamp(max=cap)
    over, free = counts - own, cap - own
    ovf0, free0 = torch.cumsum(over, 0) - over, torch.cumsum(free, 0) - free
    cells = torch.full((cap, 32), -1, dtype=torch.int64)
    ids = torch.arange(n)
    kept = pos < cap
    cells[pos[kept], bank[kept]] = ids[kept]
    j = ovf0[bank[~kept]] + pos[~kept] - cap
    lane = torch.searchsorted(free0 + free, j, right=True)
    cells[counts[lane] + j - free0[lane], lane] = ids[~kept]
    rounds = cap if int(over.sum()) else int(own.max())
    return cells, rounds


def lane_gather_loop(tab, idx, t: int):
    """f32 (S, W): ``t`` steps of ``out = 0.5 * out + tab[s, idx[s, w]]``
    from ``out = 0``; tab f32 (S, W), idx int32 (S, W) in [0, W).  On a
    card the bank-conflict-free schedule (``gather_plan``)."""
    _check_gather(tab, idx, t)
    if tab.device.type == "cpu":
        return lane_gather_loop_plain(tab, idx, t)
    dev = tab.device
    S, W = tab.shape
    grid, span, threads, slots = gather_plan(S, W, _sms(dev))
    cells = _META + threads * slots
    scratch = None
    if 4 * (W + cells) > _SMEM_MAX:  # the schedule does not fit beside the row
        scratch = torch.empty(S * grid * cells, dtype=torch.int32, device=dev)
    out = torch.empty_like(tab)
    with torch.cuda.device(dev):
        rc = _build.load().rs_lane_gather_loop(
            *_ptrs(tab, idx, out), ctypes.c_void_p(scratch.data_ptr() if scratch is not None else 0),
            S, W, t, grid, span, threads, slots, _stream(dev))
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


def _cumsum_split(W: int) -> tuple[int, int]:
    """(NT, EPT) of the scan: NT = min(W, 1024) threads in all, EPT
    consecutive elements a thread, a power of two with NT * EPT >= W."""
    NT, EPT = min(W, 1024), 1
    while EPT * NT < W:
        EPT *= 2
    return NT, EPT


def cumsum_cluster_plan(S: int, W: int, sms: int) -> tuple[int, int, int]:
    """(NT, EPT, C) of ``lane_cumsum_loop``: ``_cumsum_split``'s NT and EPT,
    and C blocks a row, a cluster: C doubles, up to 8, while it divides
    NT / 32 and S * C stays within the card's ``sms``, and further while a
    block would hold more than 256 threads of two or more elements each
    (their registers: a thread keeps its elements, the next step's and its
    results).  8 is the portable cluster size; 16 read no faster at any
    probe shape on an H100 (PERF.md)."""
    NT, EPT = _cumsum_split(W)
    C = 1
    while C < 8 and (NT // 32) % (2 * C) == 0 and (S * 2 * C <= sms or (EPT > 1 and NT // C > 256)):
        C *= 2
    return NT, EPT, C


def _warp_scan(v):
    """The kernels' five ``__shfl_up_sync`` levels: an inclusive scan over
    the last axis of 32 lanes, each level in f32."""
    lane = torch.arange(32, device=v.device)
    for o in (1, 2, 4, 8, 16):
        y = torch.zeros_like(v)
        y[..., o:] = v[..., :-o]
        v = torch.where(lane >= o, v + y, v)
    return v


def lane_cumsum_loop_order_plain(x, t: int):
    """``lane_cumsum_loop`` in the kernel's order of f32 sums: each thread's EPT elements summed in order from 0, the
    thread totals scanned across the warp, the warp totals (zero past the
    last warp) scanned across 32 lanes, the carry of warp g > 0 (warp g -
    1's inclusive total) added to the thread's exclusive offset, then the
    elements added in turn; ``t`` steps of ``0 * out + run`` from 0."""
    S, W = x.shape
    NT, EPT = _cumsum_split(W)
    xs = torch.zeros(S, NT * EPT, dtype=x.dtype, device=x.device)
    xs[:, :W] = x
    xs = xs.view(S, NT, EPT)
    total = torch.zeros(S, NT, dtype=x.dtype, device=x.device)
    for j in range(EPT):
        total = total + xs[:, :, j]
    incl = _warp_scan(total.view(S, NT // 32, 32))
    excl = torch.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    warps = torch.zeros(S, 32, dtype=x.dtype, device=x.device)
    warps[:, : NT // 32] = incl[..., 31]
    carry = _warp_scan(warps)[:, : NT // 32 - 1, None]
    run = torch.cat([excl[:, :1], carry + excl[:, 1:]], dim=1).reshape(S, NT)
    scan = torch.empty_like(xs)
    for j in range(EPT):
        run = run + xs[:, :, j]
        scan[:, :, j] = run
    scan = scan.reshape(S, NT * EPT)[:, :W]
    out = torch.zeros_like(x)
    for _ in range(t):
        out = out * 0.0 + scan
    return out


def _check_cumsum(x, t):
    _check_rows(x, "x")
    if x.dtype != torch.float32 or t < 0:
        raise ValueError(f"x must be float32 and t >= 0, got {x.dtype}, t={t}")
    if x.device.type != "cpu":
        _kernel_device(x)
        if x.shape[1] % 32 or x.shape[1] > CUMSUM_MAX_W:
            raise ValueError(f"the kernel takes W a multiple of 32 up to {CUMSUM_MAX_W}, got W={x.shape[1]}")


def _cumsum_cluster_call(x, out, t: int, clusters=None) -> tuple[int, int]:
    """(C, the entry's return code) of ``rs_lane_cumsum_loop`` at the plan's
    C; with ``clusters`` (a ctypes int) it only reads the occupancy."""
    S, W = x.shape
    C = cumsum_cluster_plan(S, W, _sms(x.device))[2]
    with torch.cuda.device(x.device):
        return C, _build.load().rs_lane_cumsum_loop(
            *_ptrs(x, out), S, W, C, t, ctypes.byref(clusters) if clusters is not None else None, _stream(x.device))


def lane_cumsum_loop(x, t: int):
    """f32 (S, W): ``t`` steps of ``out = 0 * out + cumsum(x, axis=1)`` from
    ``out = 0``; on a card W is a multiple of 32 up to ``CUMSUM_MAX_W``, a
    row over a cluster of ``cumsum_cluster_plan``'s C blocks."""
    _check_cumsum(x, t)
    if x.device.type == "cpu":
        return lane_cumsum_loop_plain(x, t)
    out = torch.empty_like(x)
    C, rc = _cumsum_cluster_call(x, out, t)
    if rc != 0:
        raise RuntimeError(f"rs_lane_cumsum_loop failed: CUDA error {rc} (C={C})")
    lane_cumsum_loop.launches += 1
    return out


lane_cumsum_loop.launches = 0


def cumsum_clusters(x) -> int:
    """How many of ``lane_cumsum_loop``'s clusters the card holds at once
    for ``x`` (``cudaOccupancyMaxActiveClusters``); launches nothing."""
    _check_cumsum(x, 0)
    n = ctypes.c_int(0)
    C, rc = _cumsum_cluster_call(x, x, 0, n)
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {rc} (C={C})")
    return n.value
