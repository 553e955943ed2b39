"""Streamed dense full-batch GD and the standalone masked top-1: the port
of ``recsys_tpu/ops/pallas_dense.py``'s stream kernels.

The JAX module streams A^T from HBM one (strip, U) block per grid step
while the factors stay in VMEM (``_stream_call`` :372).  Its entry points
and their counterparts here:

* ``stream_train`` (:420, B3): ``iters`` GD steps.  CUDA kernel
  ``csrc/dense_stream.cu`` in its sparse form (``rs_stream_sparse_train``):
  a walk of the rated cells alone over tables that ``walk_tables`` builds
  once per call, bit for bit the dense form's steps.  The dense form
  (``rs_stream_train``: one read of each A^T tile per step feeds both
  gradient sides) stays callable as ``stream_train_dense``, the baseline
  of ``probes/stream_sparse.py``.
* ``stream_top1`` (:473, B4): the masked top-1 from final factors.  CUDA
  kernel ``top1_tiled`` + ``top1_reduce`` of ``csrc/dense_fused.cu`` (the
  tiled form: a block of 64 users walks its item chunk in tiles, each
  thread a register micro-tile of scores) behind their own entry
  (``rs_stream_top1``), so from the same factors it is B1's top-1 bit for
  bit.  The dense form it replaced (``top1_pass``, a thread a user) stays
  callable as ``stream_top1_dense``, the baseline of
  ``probes/top1_tiled.py``; ``stream_top1_scores`` returns each user's
  best score beside the index, in either form, so the two can be held
  equal in raw bits.
* ``stream_train_top1`` (:433, B6): B3's steps (the sparse form), then
  B4's tiled form, in one host call (``rs_stream_train_top1``).

Each has a plain torch twin of the same math.  The wrappers take the plain
twin for CPU tensors and the kernel for CUDA tensors, and raise for
anything else: never a fallback.  Inputs as ``dense_fused``: Lt (K, U),
Rt (K, I) f32, At (I, U) int8 (2x rating) / bf16 / f32; U and I multiples
of 128, K a multiple of 8 up to ``dense_fused.MAX_K``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.precision import cell_prod, pred_cells
from recsys_tpu_torch.ops.dense_fused import (
    _A_KIND,
    _PRECISION_CODE,
    H100_SMS,
    TOP1_FORMS,
    _by_degree,
    _check,
    _kernel_device,
    _lanes_per_column,
    _offsets,
    _ptrs,
    exact_f32,
    load_at,
    plain_top1,
    plain_top1_scores,
    plain_train,
    round_up,
    sub_strip,
    top1_buffers,
    top1_split_for,
)

# Items per strip of the stream kernel (csrc/dense_stream.cu, BR).
_BR = 32
# Blocks along users that share an item chunk and sum their dRt tiles in
# shared memory (a thread-block cluster), at most.  Hopper runs clusters
# of 16 (8 is the portable size); 16 halves part_r at gen-instML1M.
_MAX_CLUSTER = 16
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


def stream_walk_bytes(K: int, U: int, I: int, nnz: int, sms: int = H100_SMS,
                      grid: tuple[int, int] = _GRID) -> int:
    """Device bytes of ``walk_tables``'s output for ``nnz`` rated cells at
    ``stream_split``: four words a cell (u_cell, u_val, i_user, i_cell),
    an offset per (tile, sub-strip, user) and per (tile, item), and an
    order entry per (tile, user) and per (tile, item)."""
    G, C, chunk, S = stream_split(K, U, I, sms, grid)
    BC = 128 // G
    tiles = S * (U // BC)
    subs = -(-chunk // sub_strip(G))
    return 4 * (4 * nnz + tiles * subs * BC + 1 + tiles * BC + 2 * tiles * chunk + 1)


# u_cell packs the user within its block above the item within its chunk.
_CELL_ITEM_BITS = 24


class Walk(NamedTuple):
    """The sparse form's tables for one A^T and split (``walk_tables``).
    A tile is block (cb, si) of the stream grid, numbered si * (U / BC) +
    cb; its cells split into sub-strips of ``sub`` items."""

    u_cell: torch.Tensor  # int32, user order: user in block << 24 | item in chunk
    u_val: torch.Tensor  # f32, user order: the dequantised rating
    u_off: torch.Tensor  # int32 (tiles * subs * BC + 1,): first cell of (tile, sub, user)
    u_order: torch.Tensor  # int32 (tiles * BC,): a tile's users by descending degree
    i_user: torch.Tensor  # int32, item order: user in block
    i_cell: torch.Tensor  # int32, item order: the cell's position in user order
    i_off: torch.Tensor  # int32 (tiles * chunk + 1,): first cell of (tile, item in chunk)
    i_order: torch.Tensor  # int32 (tiles * chunk,): items by descending degree in each sub-strip
    split: tuple  # (G, C, chunk, S) of stream_split
    sub: int  # items per sub-strip
    cap: int  # the most cells of one (tile, sub-strip) segment

    @property
    def tables(self) -> tuple:
        return self[:8]


def walk_tables(At, split: tuple, sub: int) -> Walk:
    """The rated cells of A^T (I, U) as the sparse form walks them, built
    with torch ops on At's device.  ``split`` is ``stream_split``'s (G, C,
    chunk, S): it fixes B3's order of sums, which the tables keep.  User
    order: by (tile, sub-strip, user, item); item order: by (tile, item,
    user), with each cell's position in user order."""
    G, C, chunk, S = split
    I, U = At.shape
    if I >= 1 << _CELL_ITEM_BITS:
        raise ValueError(f"the sparse form takes fewer than 2^{_CELL_ITEM_BITS} items; got {I}")
    BC, dev = 128 // G, At.device
    nb, nsub = U // BC, -(-chunk // sub)
    ntile = S * nb
    r, c = torch.nonzero(At, as_tuple=True)  # (item, user) ascending: item order within a tile
    val = load_at(At[r, c])
    n = r.numel()
    cl, rl = c % BC, r % chunk
    tile = (r // chunk) * nb + c // BC
    user_run = (tile * nsub + rl // sub) * BC + cl
    u_perm = torch.argsort(user_run * chunk + rl)  # unique keys
    pos = torch.empty(n, dtype=torch.int64, device=dev)
    pos[u_perm] = torch.arange(n, device=dev)
    i_perm = torch.sort(tile, stable=True).indices
    udeg = torch.bincount(tile * BC + cl, minlength=ntile * BC).view(ntile, BC)
    ideg = torch.bincount(tile * chunk + rl, minlength=ntile * chunk).view(ntile, chunk)
    strips = (torch.arange(chunk, device=dev) // sub).expand(ntile, chunk)
    u_off = _offsets(user_run, ntile * nsub * BC)
    return Walk(
        u_cell=((cl << _CELL_ITEM_BITS) | rl)[u_perm].to(torch.int32),
        u_val=val[u_perm].contiguous(),
        u_off=u_off,
        u_order=_by_degree(torch.zeros_like(udeg), udeg, n),
        i_user=cl[i_perm].to(torch.int32),
        i_cell=pos[i_perm].to(torch.int32),
        i_off=_offsets(tile * chunk + rl, ntile * chunk),
        i_order=_by_degree(strips, ideg, n),
        split=tuple(split),
        sub=sub,
        cap=int(torch.diff(u_off[::BC]).max()),
    )


def walk_train_plain(Lt, Rt, walk: Walk, *, iters: int, alpha2: float, precision: str = "highest"):
    """Plain torch GD steps over the walk's tables: pred and e per rated
    cell in user order, the dLt partials per item chunk from the user
    order and the dRt partials per cluster from the item order, each
    summed over its partials in ascending order.  The same function as
    ``stream_train_plain``, its sums grouped as the sparse form groups
    them (within a partial, in index_add's order)."""
    G, C, chunk, S = walk.split
    K, U = Lt.shape
    I = Rt.shape[1]
    BC = 128 // G
    nb, nsub = U // BC, -(-chunk // walk.sub)
    dev = Lt.device
    mask = (1 << _CELL_ITEM_BITS) - 1
    runs = torch.repeat_interleave(torch.arange(nb * S * nsub * BC, device=dev), torch.diff(walk.u_off.long()))
    tile = runs // (nsub * BC)
    uc = (tile % nb) * BC + (walk.u_cell.long() >> _CELL_ITEM_BITS)
    ur = (tile // nb) * chunk + (walk.u_cell.long() & mask)
    items = torch.repeat_interleave(torch.arange(nb * S * chunk, device=dev), torch.diff(walk.i_off.long()))
    ic = (items // chunk % nb) * BC + walk.i_user.long()
    ir = (items // (chunk * nb)) * chunk + items % chunk
    cluster = (items // chunk % nb) // C
    part_at = ((tile // nb) * U + uc, cluster * I + ir)
    n_parts = (S, U // (BC * C))

    def summed(x, idx, parts, n):
        part = torch.zeros((K, parts * n), dtype=torch.float32, device=dev).index_add_(1, idx, x)
        part = part.view(K, parts, n)
        total = part[:, 0]
        for s in range(1, parts):
            total = total + part[:, s]
        return total

    with exact_f32(dev):
        for _ in range(iters):
            pred = pred_cells(Rt[:, ur], Lt[:, uc], precision)
            e = walk.u_val - pred
            dLt = summed(cell_prod(Rt[:, ur], e, precision), part_at[0], n_parts[0], U)
            dRt = summed(cell_prod(Lt[:, ic], e[walk.i_cell.long()], precision), part_at[1], n_parts[1], I)
            Lt, Rt = Lt + alpha2 * dLt, Rt + alpha2 * dRt
    return Lt, Rt


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


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def stream_walk(At, K: int, grid: tuple[int, int] = _GRID) -> Walk:
    """The sparse form's tables for A^T on its CUDA device, at the split
    ``stream_train`` takes for K factors and ``grid``.  A caller that builds
    them ahead (the engine, in its ``upload`` phase) passes them to
    ``stream_train`` as ``walk``."""
    I, U = At.shape
    split = stream_split(K, U, I, _sms(At.device), grid)
    return walk_tables(At, split, sub_strip(split[0]))


def _walk_for(walk: Walk | None, At, K: int, split: tuple, grid=_GRID) -> Walk:
    """``walk``, or the tables built now; raises when a given walk was
    built for another split."""
    if walk is None:
        return stream_walk(At, K, grid)
    if tuple(walk.split) != tuple(split):
        raise ValueError(f"the walk was built for split {walk.split}, the kernel takes {split}")
    return walk


def stream_train(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest",
                 grid: tuple[int, int] = _GRID, walk: Walk | None = None):
    """``iters`` stable-snapshot GD steps (port of
    ``pallas_dense.stream_train`` :420), the rated cells alone walked on the
    card, bit for bit ``stream_train_dense``.  Returns (Lt', Rt').  CPU
    tensors go to the plain twin; CUDA tensors to the kernel, which counts
    each launch in ``.launches``.  ``grid`` (blocks per SM, largest
    cluster) sizes the kernel's grid and so its order of sums; the engine
    keeps the default, and ``probes/stream_grid.py`` sweeps it.  ``walk``
    is ``stream_walk(At, K, grid)`` built ahead, else the call builds it."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return stream_train_plain(Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision)
    dev = _kernel_device(Lt)
    lib = _build.load()
    (G, C, chunk, S), outs, parts = _train_buffers(K, U, I, dev, grid)
    walk = _walk_for(walk, At, K, (G, C, chunk, S), grid)
    with torch.cuda.device(dev):
        rc = lib.rs_stream_sparse_train(
            *_ptrs(*walk.tables), walk.cap, *_ptrs(Lt, Rt, *outs, *parts), K, U, I, G, C, iters, float(alpha2),
            _PRECISION_CODE[precision], chunk, S, walk.sub, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_sparse_train failed: CUDA error {rc}")
    stream_train.launches += 1
    return outs[0], outs[1]


def stream_train_dense(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest"):
    """``stream_train`` in its dense form, every (user, item) cell of each
    A^T tile walked (``rs_stream_train``): the baseline the sparse form
    replaced, kept for ``probes/stream_sparse.py`` and P3's probe.  CPU
    tensors go to the plain twin; CUDA tensors to the kernel
    (``.launches``)."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return stream_train_plain(Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision)
    dev = _kernel_device(Lt)
    lib = _build.load()
    (G, C, chunk, S), outs, parts = _train_buffers(K, U, I, dev)
    with torch.cuda.device(dev):
        rc = lib.rs_stream_train(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *outs, *parts),
            K, U, I, G, C, iters, float(alpha2), _PRECISION_CODE[precision], chunk, S, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_train failed: CUDA error {rc}")
    stream_train_dense.launches += 1
    return outs[0], outs[1]


def _top1(Lt, Rt, At, precision, items_true, form, scores):
    """B4 in ``form`` on the card: (top1, best or None)."""
    K, U, I = Lt.shape[0], Lt.shape[1], Rt.shape[1]
    dev = _kernel_device(Lt)
    lib = _build.load()
    chunk, S = top1_split_for(K, U, I, dev, form)
    ops, *tops = top1_buffers(K, U, I, S, dev, precision, form)
    best = torch.empty((1, U), dtype=torch.float32, device=dev) if scores else None
    with torch.cuda.device(dev):
        rc = lib.rs_stream_top1(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, ops, *tops),
            ctypes.c_void_p(best.data_ptr() if scores else 0), K, U, I, _lanes_per_column(K),
            _PRECISION_CODE[precision], items_true, chunk, S, TOP1_FORMS[form], _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_top1 ({form}) failed: CUDA error {rc}")
    (stream_top1 if form == "tiled" else stream_top1_dense).launches += 1
    return tops[2], best


def stream_top1(Lt, Rt, At, *, precision: str = "highest", items_true: int):
    """The masked top-1 from final factors (port of
    ``pallas_dense.stream_top1`` :473): (1, U) int32, rated cells and items
    at or past ``items_true`` never win, lowest index on ties.  The tiled
    form over ``dense_fused.top1_split``'s item chunks.  CPU tensors go to
    the plain twin; CUDA tensors to the kernel (``.launches``)."""
    _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return stream_top1_plain(Lt, Rt, At, precision=precision, items_true=items_true)
    return _top1(Lt, Rt, At, precision, items_true, "tiled", False)[0]


def stream_top1_dense(Lt, Rt, At, *, precision: str = "highest", items_true: int):
    """``stream_top1`` in its dense form (``top1_pass``, a thread a user
    over the dl side's item chunks): the baseline the tiled form replaced,
    kept for ``probes/top1_tiled.py``.  CPU tensors go to the plain twin;
    CUDA tensors to the kernel (``.launches``)."""
    _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        return stream_top1_plain(Lt, Rt, At, precision=precision, items_true=items_true)
    return _top1(Lt, Rt, At, precision, items_true, "dense", False)[0]


def stream_top1_scores(Lt, Rt, At, *, precision: str = "highest", items_true: int, form: str = "tiled"):
    """B4 in ``form`` ("tiled" or "dense") with each user's best score:
    ((1, U) int32, (1, U) f32; -inf where no item can win), so two forms
    can be held equal in raw bits.  A launch counts on the form's wrapper
    (``stream_top1`` or ``stream_top1_dense``).  CPU tensors go to the
    plain twin."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        top1_split_for(K, U, I, Lt.device, form)  # the form checked, though the twin runs
        return plain_top1_scores(Lt, Rt, At, precision, items_true)
    return _top1(Lt, Rt, At, precision, items_true, form, True)


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
    top_chunk, top_S = top1_split_for(K, U, I, dev)
    tops = top1_buffers(K, U, I, top_S, dev, precision)
    walk = stream_walk(At, K)
    with torch.cuda.device(dev):
        rc = lib.rs_stream_train_top1(
            *_ptrs(*walk.tables), walk.cap, *_ptrs(At), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *outs, *parts, *tops),
            K, U, I, G, C, iters, float(alpha2), _PRECISION_CODE[precision], items_true,
            chunk, S, walk.sub, top_chunk, top_S, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_stream_train_top1 failed: CUDA error {rc}")
    stream_train_top1.launches += 1
    return outs[0], outs[1], tops[3]


stream_train.launches = 0
stream_train_dense.launches = 0
stream_top1.launches = 0
stream_top1_dense.launches = 0
stream_train_top1.launches = 0

