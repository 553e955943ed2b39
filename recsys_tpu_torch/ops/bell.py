"""BELL, the degree-bucketed sparse GD step: the port of
``recsys_tpu/ops/bell.py``, the route of every exact-f64 run on a device
and of the speed dtypes past the dense budgets.

Users (and, independently, items) are permuted by descending entry count
and grouped into contiguous buckets of one padded width.  Each side keeps
one flat table of the opposite side's permuted row index per slot and one
of values, the concatenation of every bucket's row-major (w, n) table.
Padding slots index the opposite side's zero row, appended last to each
factor table, and carry value 0.  Host builders, ported as they are:
``_degree_perm`` :190, ``_side_tables`` :199 (the native builder first,
then its numpy form), ``make_bell_inputs`` :265, ``bell_side_slots`` :301,
``bell_slot_ratio`` :325, ``pad_factors_for_bell`` :859 and
``unpermute_factors`` :874.  Here the value tables stay flat; the JAX
package keeps per-bucket (w, n) views of the same bytes.

The step, ``bell_gd_step`` (:628), updates each side from the same
snapshot (L, R) (``matFact.c:38-39``).  The JAX function sums the
gradient over a row's slots and then adds it; this port follows the
reference instead: for every slot of an own row j, in file order,

    e = 2a * (v - <F_own[j], F_other[c]>)     (dot summed f = 0..k-1)
    F_own'[j] += e * F_other[c]               (into the row, slot by slot)

with every product and sum rounded on its own, which is ``rs_serial_gd``'s
order (``csrc/recsys_native.c``).  In f64 the factors are therefore bit
for bit those of the reference binary.  The side update is the fused
gather, error and update of the TPU probe kernel ``p4_kernel``
(``scripts/probe_mosaic_gather.py:139``), hand-written in CUDA
(``csrc/bell.cu``) behind ``bell_side_update``; ``bell_side_update_plain``
is its plain torch twin.  The wrapper picks by the tensors' device: the
twin for CPU tensors, the kernel for CUDA tensors, and an error for
anything the kernel does not take -- never a fallback.  f32, f64 and
bfloat16 are the kernel's types.

bfloat16 computes what the JAX package's bf16 step computes (its
``_delta_side`` :578 and ``bell_gd_step`` :628, as XLA runs them): the
dot of exact f32 products summed in f32 over f and rounded once, each
other elementwise result rounded to bf16, and the row's change summed in
f32 over its slots, rounded, and added to the row once:

    e  = bf(a2 * bf(v - bf(sum_f F_own[j][f] * F_other[c][f])))   (a2 a bf16)
    F_own'[j] = bf(F_own[j] + bf(sum_slots e * F_other[c]))         (f32 sums)

(``bf``: round to the nearest even bf16; a product of two bf16 values is
exact in f32).  The sums run in the f32/f64 order (f = 0..k-1, slots in
file order), so kernel and twin agree bit for bit; against the JAX step
on the CPU see ``tests/test_torch_bell.py``.

The sharded engine's per-shard step (``parallel/step.py:185``) takes each
side's partial from 0 (JAX ``_delta_side``), sums the partials across the
mesh and then adds the sum to the rows: ``bell_side_delta`` is that
partial, the same kernel in its delta form (each row's terms summed from 0
in slot order, the row not added; bf16 rounds the f32 sum once), and
``bell_side_delta_plain`` its twin.  The checkerboard builders
(:653-857) are ported as they are, with the value tables flat per shard.

Not ported: the TPU gather-engine and XLA-fusion workarounds (the chunk
grain ``CHUNK_*``/``_chunk_grain`` :385-409 with its ``WIDE_F64_*`` fault
cap, ``REGATHER_FOR_GRADIENT`` :435, the 3xf32 split gather
``SPLIT_GATHER_F64`` :478-530).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.dense_fused import _kernel_device, _ptrs
from recsys_tpu_torch.ops.dense_stream import _stream
from recsys_tpu_torch.utils.timing import h2d

# Widest k the kernel takes: a warp holds a factor row, at most 32 values
# a lane (csrc/bell.cu, KPL).
MAX_K = 1024


class BellSide(NamedTuple):
    """Static metadata for one side's buckets."""

    bounds: tuple[tuple[int, int, int], ...]  # (start, stop, width) per bucket
    n_nz: int  # rows with >= 1 entry (all updates land in [0, n_nz))
    size: int  # true dimension (users or items)


class BellMeta(NamedTuple):
    user: BellSide
    item: BellSide
    features: int
    nnz: int
    slots: int  # total padded slots, both sides


class BellTables(NamedTuple):
    """Flat per-side tables (numpy on the host, tensors on a device):
    opposite-side row index per slot in permuted space (padding: the zero
    row, index = opposite size) and rating per slot (padding: 0)."""

    ucols: object  # int32 (S_u,)
    uvals: object  # dtype (S_u,)
    irows: object  # int32 (S_i,)
    ivals: object  # dtype (S_i,)


class BellData(NamedTuple):
    meta: BellMeta
    tables: BellTables
    user_perm: np.ndarray  # original user id at permuted position p
    item_perm: np.ndarray
    inv_user_perm: np.ndarray  # permuted position of original user u
    inv_item_perm: np.ndarray


# Bucketing rules, unchanged from the JAX module (:106-129).
MIN_BUCKET_ROWS = 64
SMALL_SIDE_ENTRIES = 90_000
SMALL_MIN_BUCKET_ROWS = 128
SMALL_SLOT_GUARD = 1.5


def _guarded_buckets(counts_sorted: np.ndarray, min_rows: int) -> list[tuple[int, int, int]]:
    """Half-width-guarded buckets (large sides)."""
    out: list[tuple[int, int, int]] = []
    n = len(counts_sorted)
    start = 0
    while start < n and counts_sorted[start] > 0:
        w = int(counts_sorted[start])
        stop = int(np.searchsorted(-counts_sorted, -w, side="right"))
        # Merge narrow runs in, but never into rows less than half the
        # bucket width: a lone hub row must not pad a long tail.
        while stop - start < min_rows and stop < n and counts_sorted[stop] * 2 >= w:
            nxt = int(counts_sorted[stop])
            stop = int(np.searchsorted(-counts_sorted, -nxt, side="right"))
        out.append((start, stop, w))
        start = stop
    return out


def _rows_merged_buckets(counts_sorted: np.ndarray, min_rows: int) -> list[tuple[int, int, int]]:
    """Merge-by-rows buckets (small sides): absorb runs until ``min_rows``
    rows, then only rows of the bucket's own width."""
    out: list[tuple[int, int, int]] = []
    n = len(counts_sorted)
    start = 0
    while start < n and counts_sorted[start] > 0:
        w = int(counts_sorted[start])
        stop = start
        while stop < n and counts_sorted[stop] > 0 and (
            stop - start < min_rows or int(counts_sorted[stop]) == w
        ):
            stop += 1
        out.append((start, stop, w))
        start = stop
    return out


def _degree_buckets(counts_sorted: np.ndarray, min_rows: int = MIN_BUCKET_ROWS) -> list[tuple[int, int, int]]:
    """Contiguous (start, stop, width) buckets over a non-increasing degree
    sequence: merge-by-rows on small sides (slot-guarded), half-width
    guarded everywhere else."""
    if int(counts_sorted.sum()) <= SMALL_SIDE_ENTRIES:
        merged = _rows_merged_buckets(counts_sorted, SMALL_MIN_BUCKET_ROWS)
        guarded = _guarded_buckets(counts_sorted, min_rows)
        slots = lambda bs: sum(w * (b1 - b0) for (b0, b1, w) in bs)  # noqa: E731
        if slots(merged) <= SMALL_SLOT_GUARD * slots(guarded):
            return merged
        return guarded
    return _guarded_buckets(counts_sorted, min_rows)


def _degree_perm(coords: np.ndarray, dim: int):
    """(counts, perm, inv): stable sort of 0..dim-1 by descending entry count."""
    counts = np.bincount(coords, minlength=dim)
    perm = np.argsort(-counts, kind="stable").astype(np.int32)
    inv = np.empty(dim, np.int32)
    inv[perm] = np.arange(dim, dtype=np.int32)
    return counts, perm, inv


def _side_tables(counts: np.ndarray, perm: np.ndarray, inv: np.ndarray,
                 other_dim: int, own: np.ndarray, other: np.ndarray,
                 vals: np.ndarray, inv_other: np.ndarray, dtype):
    """One side's (bounds, n_nz, flat cols, flat vals).

    ``own`` are this side's entry coordinates (grouping key), ``other``
    the opposite coordinates (mapped through ``inv_other`` into permuted
    space; padding slots get index ``other_dim``, the zero row).  The
    native single-pass builder first; the numpy form where it returns
    None (no toolchain)."""
    from recsys_tpu_torch.io import _native

    bounds = _degree_buckets(counts[perm])
    n_nz = bounds[-1][1] if bounds else 0
    nat = _native.bell_side_tables(own, other, vals, inv, inv_other, other_dim, bounds, dtype)
    if nat is not None:
        return tuple(bounds), n_nz, nat[0], nat[1]
    return (tuple(bounds), n_nz, *_side_tables_numpy(counts, perm, inv, other_dim, own, other, vals,
                                                       inv_other, dtype, bounds))


def _side_tables_numpy(counts, perm, inv, other_dim, own, other, vals, inv_other, dtype, bounds):
    """The numpy form of the side builder (bell.py:231-262): entries sorted
    by (permuted own, file order) -- the sort is stable over a row-major
    stream, so a row's slots keep the file's order."""
    from recsys_tpu_torch.utils.hostmem import hugepage_empty, hugepage_zeros

    own_p = inv[own]
    order = np.argsort(own_p, kind="stable")
    own_s = own_p[order]
    other_s = inv_other[other[order]]
    vals_s = vals[order]
    starts = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts[perm], out=starts[1:])
    slot = np.arange(len(own_s), dtype=np.int64) - starts[own_s]
    cols_t, vals_t = [], []
    for (b0, b1, w) in bounds:
        nb = b1 - b0
        ct = hugepage_empty((w, nb), np.int32)
        ct[...] = other_dim  # pad -> zero row
        vt = hugepage_zeros((w, nb), dtype)
        sel = (own_s >= b0) & (own_s < b1)
        ct[slot[sel], own_s[sel] - b0] = other_s[sel]
        vt[slot[sel], own_s[sel] - b0] = vals_s[sel].astype(dtype)
        cols_t.append(ct.reshape(-1))
        vals_t.append(vt.reshape(-1))
    if not cols_t:
        return np.zeros(0, np.int32), np.zeros(0, dtype)
    return np.concatenate(cols_t), np.concatenate(vals_t)


def require_row_major(spec) -> None:
    """Entries strictly increasing in (row, col): the .in format invariant
    the builders rely on (a copy of ``recsys_tpu/ops/coo.py:30``)."""
    key = spec.rows.astype(np.int64) * spec.items + spec.cols
    if key.size > 1 and not bool(np.all(np.diff(key) > 0)):
        raise ValueError(
            "entries must be row-major sorted with unique (row, col) cells "
            "(the .in format invariant, reference util.c:29-34)"
        )


def make_bell_inputs(spec, dtype=np.float32) -> BellData:
    """Host BELL tables of ``spec`` in ``dtype`` (numpy float32/float64)."""
    require_row_major(spec)
    ucounts, uperm, uinv = _degree_perm(spec.rows, spec.users)
    icounts, iperm, iinv = _degree_perm(spec.cols, spec.items)
    ubounds, u_nz, ucols, uvals = _side_tables(
        ucounts, uperm, uinv, spec.items, spec.rows, spec.cols, spec.vals, iinv, dtype
    )
    ibounds, i_nz, irows, ivals = _side_tables(
        icounts, iperm, iinv, spec.users, spec.cols, spec.rows, spec.vals, uinv, dtype
    )
    slots = sum(w * (b1 - b0) for (b0, b1, w) in ubounds + ibounds)
    meta = BellMeta(
        user=BellSide(bounds=ubounds, n_nz=u_nz, size=spec.users),
        item=BellSide(bounds=ibounds, n_nz=i_nz, size=spec.items),
        features=spec.features,
        nnz=spec.nnz,
        slots=slots,
    )
    return BellData(meta=meta, tables=BellTables(ucols, uvals, irows, ivals),
                    user_perm=uperm, item_perm=iperm, inv_user_perm=uinv, inv_item_perm=iinv)


def bell_side_slots(spec) -> tuple[int, int]:
    """(user-side, item-side) padded slot counts of the BELL format."""
    sides = []
    for coords, dim in ((spec.rows, spec.users), (spec.cols, spec.items)):
        sc = np.sort(np.bincount(coords, minlength=dim))[::-1]
        sides.append(sum(w * (b1 - b0) for (b0, b1, w) in _degree_buckets(sc)))
    return int(sides[0]), int(sides[1])


def bell_slot_ratio(spec) -> float:
    """Padded-slot overhead of the BELL format (1.0 = no padding)."""
    if spec.nnz == 0:
        return float("inf")
    su, si = bell_side_slots(spec)
    return (su + si) / (2.0 * spec.nnz)


def pad_factors_for_bell(state, data: BellData, dtype):
    """Host-side: permute the factors into degree order and append the
    zero padding row each side's gathers use (numpy arrays in ``dtype``).
    The permute is a CPU ``index_select`` on all cores; at gen-inst1e6's
    1M x 700 it is several times faster than the JAX module's chunked
    numpy take (PERF.md)."""
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32

    def permuted(F, perm):
        src = torch.from_numpy(np.ascontiguousarray(F)).to(tdtype)  # the cast rounds each value, as numpy's
        out = torch.empty((len(perm) + 1, src.shape[1]), dtype=tdtype)
        out[-1] = 0
        torch.index_select(src, 0, torch.from_numpy(perm.astype(np.int64)), out=out[:-1])
        return out.numpy()

    return permuted(state.L, data.user_perm), permuted(state.R, data.item_perm)


# The host (numpy) dtype a side of each type is built in.  numpy has no
# bf16: a bf16 side is built in f32 and rounded to bf16 by torch.
HOST_DTYPE = {torch.float32: np.float32, torch.float64: np.float64, torch.bfloat16: np.float32}


def bell_tensors(spec, state, dtype: torch.dtype, device):
    """(BellData, L, R, tables) of ``spec`` in ``dtype`` on ``device`` from
    the host factors ``state``: the degree-permuted factors with their zero
    rows and the device tables.  A bf16 side is built in f32 and rounded
    by torch (to nearest even, as the JAX package's ``astype``)."""
    data = make_bell_inputs(spec, HOST_DTYPE[dtype])
    L, R = (torch.from_numpy(x).to(dtype).to(device)
            for x in pad_factors_for_bell(state, data, HOST_DTYPE[dtype]))
    return data, L, R, device_tables(data.tables, device, dtype)


def unpermute_factors(L, R, data: BellData):
    """Back to original row order, dropping the padding rows (numpy)."""
    return (
        np.asarray(L)[:-1][data.inv_user_perm],
        np.asarray(R)[:-1][data.inv_item_perm],
    )


def device_tables(tables: BellTables, device, dtype=None) -> BellTables:
    """The host tables as tensors on ``device``, the value tables cast to
    ``dtype`` when given (numpy has no bf16: a bf16 side's values are built
    in f32 and rounded here, to nearest even as the JAX package's
    ``astype``).  Each copy is a ``timing.h2d``."""
    t = BellTables(*(torch.from_numpy(np.ascontiguousarray(x)) for x in tables))
    if dtype is not None:
        t = t._replace(uvals=t.uvals.to(dtype), ivals=t.ivals.to(dtype))
    return BellTables(*(h2d(x, device) for x in t))


# ---------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------


def _twin_buckets(cols, vals, side: BellSide, pad: int):
    """Per bucket: (b0, b1, w, idx (w, n) int64, vals (w, n), live (w, n, 1)
    bool, False on padding slots), from a side's flat tables; ``pad`` is
    the opposite zero row's index."""
    out, off = [], 0
    for (b0, b1, w) in side.bounds:
        n = b1 - b0
        idx = cols[off:off + w * n].reshape(w, n).long()
        out.append((b0, b1, w, idx, vals[off:off + w * n].reshape(w, n), (idx != pad).unsqueeze(-1)))
        off += w * n
    return out


def _bf(x):
    """f32 ``x`` rounded to the nearest even bf16, kept in f32."""
    return x.bfloat16().float()


def _bucket_terms(F_own, F_other, bucket, a2):
    """(own rows (n, k), terms (w, n, k)) of one bucket: term [s, j] is
    ``e * F_other[c]`` of row j's slot s, and -0.0 on a padding slot
    (x + (-0.0) is x for every x, so it leaves a row as it is: the kernel
    skips it).  The terms are computed in the gathered rows' buffer, so a
    bucket holds at most two (w, n, k) tensors at once.  A bf16 side
    computes in f32 (its products exact), e rounded at each of its steps
    (module docstring)."""
    b0, b1, w, idx, v, live = bucket
    bf16 = F_own.dtype == torch.bfloat16
    fo, g = F_own[b0:b1], F_other[idx]  # g: (w, n, k)
    if bf16:
        fo, g, v = fo.float(), g.float(), v.float()
    prod = fo * g  # every product rounded on its own
    dot = torch.zeros(idx.shape, dtype=fo.dtype, device=F_own.device)
    for f in range(F_own.shape[1]):  # the dot in order f = 0..k-1
        dot = dot + prod[:, :, f]
    del prod
    e = _bf(a2 * _bf(v - _bf(dot))) if bf16 else a2 * (v - dot)
    return fo, g.mul_(e.unsqueeze(-1)).masked_fill_(~live, -0.0)


def _alpha(alpha2: float, dtype) -> float:
    """alpha2 in the step's type, as a Python float: a bf16 step uses it
    rounded to bf16 (the JAX engine's ``asarray(2 * alpha, bf16)``)."""
    return float(torch.tensor(alpha2, dtype=torch.float64).to(dtype)) if dtype == torch.bfloat16 else float(alpha2)


def _side_plain(F_own, F_other, buckets, alpha2, delta: bool = False):
    """Twin of one side's update over prepared buckets (see
    ``bell_side_update_plain``): f32 and f64 add each slot's term into the
    row, bf16 sums the terms from 0 in f32 and adds them once.  ``delta``
    gives the rows' changes alone, (n_nz, k), summed from 0 in slot order
    (bf16: the f32 sum rounded once)."""
    bf16 = F_own.dtype == torch.bfloat16
    a2 = torch.tensor(_alpha(alpha2, F_own.dtype), dtype=torch.float32 if bf16 else F_own.dtype,
                      device=F_own.device)
    n_nz = buckets[-1][1] if buckets else 0
    out = F_own.new_empty((n_nz, F_own.shape[1])) if delta else F_own.clone()
    for bucket in buckets:
        fo, terms = _bucket_terms(F_own, F_other, bucket, a2)
        acc = torch.zeros_like(fo) if bf16 or delta else fo
        for s in range(bucket[2]):  # slots in file order
            acc = acc + terms[s]
        if delta:
            out[bucket[0]:bucket[1]] = acc
        else:
            out[bucket[0]:bucket[1]] = (fo + _bf(acc)).bfloat16() if bf16 else acc
    return out


def bell_side_update_plain(F_own, F_other, cols, vals, side: BellSide, alpha2: float):
    """Plain torch twin of ``bell_side_update``: one side's new factor
    table, vectorised over the slots of a bucket for the dot (k steps on
    (w, n) tensors) and over its rows for the accumulation (w steps on
    (n, k)).  Separate multiplies and adds, so no contraction; padding
    slots leave the row as it is.  A bf16 side computes in f32 with the
    rounding points of the module docstring."""
    return _side_plain(F_own, F_other, _twin_buckets(cols, vals, side, F_other.shape[0] - 1), alpha2)


def bell_side_delta_plain(F_own, F_other, cols, vals, side: BellSide, alpha2: float):
    """Plain torch twin of ``bell_side_delta``: the (n_nz, k) changes of
    one side's rows, each summed from 0 over its slots in file order, with
    the dot, e and terms of ``bell_side_update_plain``; a bf16 side sums in
    f32 and rounds the sum once (JAX ``_delta_side``'s output)."""
    return _side_plain(F_own, F_other, _twin_buckets(cols, vals, side, F_other.shape[0] - 1), alpha2, delta=True)


def bell_gd_step_plain(L, R, tables: BellTables, alpha2: float, meta: BellMeta):
    """Twin of ``bell_gd_step``: both sides from the snapshot (L, R)."""
    return (bell_side_update_plain(L, R, tables.ucols, tables.uvals, meta.user, alpha2),
            bell_side_update_plain(R, L, tables.irows, tables.ivals, meta.item, alpha2))


def bell_train_plain(L, R, tables: BellTables, alpha2: float, meta: BellMeta, iters: int):
    """``iters`` twin steps, the buckets prepared once."""
    ub = _twin_buckets(tables.ucols, tables.uvals, meta.user, meta.item.size)
    ib = _twin_buckets(tables.irows, tables.ivals, meta.item, meta.user.size)
    for _ in range(iters):
        L, R = _side_plain(L, R, ub, alpha2), _side_plain(R, L, ib, alpha2)
    return L, R


# ---------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------


# Rows of a bucket at least this many slots wide take the block form
# (csrc/bell.cu, side_update_wide), narrower ones the warp form.  A width
# above every bucket's (``WARP_FORM``) gives the warp form alone, the
# kernel as it was before the block form.
WIDE_MIN = 128
WARP_FORM = 1 << 62


class SideDesc(NamedTuple):
    """One side's kernel descriptors (``side_warps``): int64 (nb, 6) rows
    of (flat base, first warp or block, b0, n, w, rows per warp)."""

    narrow: object  # buckets narrower than the threshold: warps
    warps: int
    wide: object  # the others: a block a row (rows per warp 1)
    blocks: int


def side_warps(side: BellSide, wide: int = WIDE_MIN) -> SideDesc:
    """The kernel's bucket descriptors for both forms.  A bucket ``wide``
    slots wide or wider gives each of its rows a block; a narrower one
    gives a warp one row when it is at least 32 wide, else as many rows as
    fit 32 of their slots (csrc/bell.cu)."""
    narrow, wide_rows, base, warp0, block0 = [], [], 0, 0, 0
    for (b0, b1, w) in side.bounds:
        n = b1 - b0
        if w >= wide:
            wide_rows.append((base, block0, b0, n, w, 1))
            block0 += n
        else:
            rpw = max(1, 32 // w)
            narrow.append((base, warp0, b0, n, w, rpw))
            warp0 += -(-n // rpw)
        base += w * n
    return SideDesc(np.array(narrow, np.int64).reshape(-1, 6), warp0,
                    np.array(wide_rows, np.int64).reshape(-1, 6), block0)


def _side_desc(side: BellSide, dev, wide: int):
    """``side_warps`` with the descriptors on ``dev``."""
    d = side_warps(side, wide)
    return d._replace(narrow=torch.from_numpy(d.narrow).to(dev), wide=torch.from_numpy(d.wide).to(dev))


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _check(F_own, F_other, cols, vals, side: BellSide):
    if F_own.dim() != 2 or F_other.dim() != 2 or cols.dim() != 1 or vals.dim() != 1:
        raise ValueError("factor tables must be 2-D and the side tables flat")
    k = F_own.shape[1]
    slots = sum(w * (b1 - b0) for (b0, b1, w) in side.bounds)
    if F_own.shape[0] != side.size + 1 or F_other.shape[1] != k or cols.shape[0] != slots \
            or vals.shape[0] != slots:
        raise ValueError(f"shapes own {tuple(F_own.shape)}, other {tuple(F_other.shape)}, tables "
                         f"{tuple(cols.shape)}/{tuple(vals.shape)} disagree with the side ({side.size} rows, "
                         f"{slots} slots)")
    if F_own.dtype not in _DTYPE_CODE or F_other.dtype != F_own.dtype or vals.dtype != F_own.dtype:
        raise ValueError(f"dtypes own {F_own.dtype}, other {F_other.dtype}, vals {vals.dtype}: the kernel "
                         "takes float32, float64 or bfloat16, all alike")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's 1..{MAX_K}")
    if not all(t.is_contiguous() for t in (F_own, F_other, cols, vals)):
        raise ValueError("tables must be contiguous")
    if not (F_own.device == F_other.device == cols.device == vals.device):
        raise ValueError("tables must be on one device")


def bell_side_update(F_own, F_other, cols, vals, side: BellSide, alpha2: float, *, out=None,
                     wide: int = WIDE_MIN):
    """One side of a BELL step: every row of ``side`` with at least one
    entry updated from the snapshot (``F_own``, ``F_other``), slot by slot
    in file order (see the module docstring).  ``F_own`` is (size + 1, k),
    ``F_other`` (other size + 1, k), zero rows last; ``cols``/``vals`` the
    side's flat tables.  Returns the new table: ``out`` when given (its rows
    from ``side.n_nz`` on must already hold ``F_own``'s), else a copy of
    ``F_own`` updated.  CPU tensors go to the plain twin; CUDA tensors to
    the kernel, which counts each launch in ``.launches``: rows of buckets
    ``wide`` slots wide or wider in its block form, the others in its warp
    form (``WARP_FORM``: all in the warp form); the same bits either way."""
    _check(F_own, F_other, cols, vals, side)
    if out is not None and (out.shape != F_own.shape or out.dtype != F_own.dtype or out.device != F_own.device
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous table like F_own")
    if out is not None and out.data_ptr() in (F_own.data_ptr(), F_other.data_ptr()):
        raise ValueError("out must not be F_own or F_other: both are the step's snapshot")
    if F_own.device.type == "cpu":
        new = bell_side_update_plain(F_own, F_other, cols, vals, side, alpha2)
        return new if out is None else out.copy_(new)
    dev = _kernel_device(F_own)
    return _launch(F_own, F_other, cols, vals, alpha2, F_own.clone() if out is None else out,
                   _side_desc(side, dev, wide))


bell_side_update.launches = 0


def _launch(F_own, F_other, cols, vals, alpha2, out, desc, delta: bool = False):
    """One ``rs_bell_side_update`` call (``rs_bell_side_delta`` with
    ``delta``) into ``out`` over the side's descriptors ``desc``
    (``_side_desc``), on tensors already checked; counted in
    ``bell_side_update.launches`` (``bell_side_delta.launches``).  The block
    form's e goes to a scratch table like ``vals``."""
    if desc.warps or desc.blocks:
        dev = out.device
        escr = torch.empty_like(vals) if desc.blocks else vals
        entry = "rs_bell_side_delta" if delta else "rs_bell_side_update"
        with torch.cuda.device(dev):
            rc = getattr(_build.load(), entry)(
                *_ptrs(F_own, F_other, out, cols, vals, desc.narrow), desc.narrow.shape[0], desc.warps,
                *_ptrs(desc.wide), desc.wide.shape[0], desc.blocks, *_ptrs(escr), F_own.shape[1],
                F_other.shape[0] - 1, _alpha(alpha2, F_own.dtype), _DTYPE_CODE[F_own.dtype], _stream(dev),
            )
        if rc != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {rc}")
        (bell_side_delta if delta else bell_side_update).launches += 1
    return out


def side_prep(cols, vals, side: BellSide, pad: int, wide: int = WIDE_MIN):
    """What ``bell_side_delta`` makes for a side's tables on every call,
    made once for a run of many: the twin's buckets for CPU tables (``pad``
    the opposite zero row's index), the kernel's descriptors on the
    tables' CUDA device (``wide`` as ``bell_side_update``'s)."""
    if cols.device.type == "cpu":
        return _twin_buckets(cols, vals, side, pad)
    return _side_desc(side, _kernel_device(cols), wide)


def bell_side_delta(F_own, F_other, cols, vals, side: BellSide, alpha2: float, *, wide: int = WIDE_MIN,
                    prep=None):
    """One side's partial of a sharded BELL step (JAX ``_delta_side``):
    the (side.n_nz, k) changes of the rows with at least one slot, each
    row's terms ``e * F_other[c]`` summed from 0 in file order, the dot and
    e as ``bell_side_update``'s; bf16 rounds the f32 sum once.  Arguments
    as ``bell_side_update``'s; ``prep`` is ``side_prep``'s result for these
    tables, made here if not given.  CPU tensors go to
    ``bell_side_delta_plain``'s arithmetic; CUDA tensors to the kernel's
    delta form, which counts each launch in ``.launches``."""
    _check(F_own, F_other, cols, vals, side)
    if prep is None:
        prep = side_prep(cols, vals, side, F_other.shape[0] - 1, wide)
    if F_own.device.type == "cpu":
        return _side_plain(F_own, F_other, prep, alpha2, delta=True)
    out = F_own.new_empty((side.n_nz, F_own.shape[1]))
    return _launch(F_own, F_other, cols, vals, alpha2, out, prep, delta=True)


bell_side_delta.launches = 0


def bell_gd_step(L, R, tables: BellTables, alpha2: float, meta: BellMeta):
    """One full-batch GD step in BELL form (``bell.py:628``): L (users + 1,
    k) and R (items + 1, k) in degree-permuted order with the zero row
    last; returns new (L, R), both sides from the snapshot (L, R), the
    zero rows and zero-degree rows untouched.  Two ``bell_side_update``
    launches on a CUDA device."""
    return (bell_side_update(L, R, tables.ucols, tables.uvals, meta.user, alpha2),
            bell_side_update(R, L, tables.irows, tables.ivals, meta.item, alpha2))


def bell_train(L, R, tables: BellTables, alpha2: float, meta: BellMeta, iters: int, *, donate: bool = False,
               wide: int = WIDE_MIN):
    """``iters`` BELL steps (``trainer._train_bell``).  On a CUDA device
    the steps alternate between two buffers per side, so rows that never
    change need no copy per step: with ``donate`` the input tensors are one
    of them and are overwritten, else both are copies and the inputs are
    left as they are.  ``wide`` picks each bucket's form as in
    ``bell_side_update``.  The step loop runs in C (``rs_bell_train``), two
    side updates a step counted in ``bell_side_update.launches``.  CPU
    tensors run ``bell_train_plain``."""
    _check(L, R, tables.ucols, tables.uvals, meta.user)
    _check(R, L, tables.irows, tables.ivals, meta.item)
    if L.device.type == "cpu":
        return bell_train_plain(L, R, tables, alpha2, meta, iters)
    dev = _kernel_device(L)
    udesc, idesc = _side_desc(meta.user, dev, wide), _side_desc(meta.item, dev, wide)
    bufs_l = [L.clone(), L] if donate else [L.clone() for _ in range(min(iters, 2))]
    bufs_r = [R.clone(), R] if donate else [R.clone() for _ in range(min(iters, 2))]
    if iters == 0:
        return L, R
    sides = []
    for cols, vals, d in ((tables.ucols, tables.uvals, udesc), (tables.irows, tables.ivals, idesc)):
        escr = torch.empty_like(vals) if d.blocks else vals
        sides += [*_ptrs(cols, vals, d.narrow), d.narrow.shape[0], d.warps, *_ptrs(d.wide), d.wide.shape[0],
                  d.blocks, *_ptrs(escr)]
    with torch.cuda.device(dev):
        rc = _build.load().rs_bell_train(
            *_ptrs(L, R, bufs_l[0], bufs_l[-1], bufs_r[0], bufs_r[-1]), *sides, iters, L.shape[1], meta.user.size, meta.item.size,
            _alpha(alpha2, L.dtype), _DTYPE_CODE[L.dtype], _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_bell_train failed: CUDA error {rc}")
    bell_side_update.launches += iters * sum(1 for d in (udesc, idesc) if d.warps or d.blocks)
    return bufs_l[(iters - 1) % 2], bufs_r[(iters - 1) % 2]


# ---------------------------------------------------------------------
# Sharded BELL: the checkerboard (2-D mesh) form (JAX bell.py:653-857)
# ---------------------------------------------------------------------


class ShardedBellMeta(NamedTuple):
    """Static metadata shared by every shard: bucket shapes are uniform
    across shards, per-shard raggedness is padding slots against the
    per-block zero row."""

    user: BellSide  # bounds/n_nz in block-local row space; size = u_blk
    item: BellSide
    features: int
    u_blk: int  # true rows per user block (the block tables carry +1 zero row)
    i_blk: int
    pu: int
    pi: int


class ShardedBellTables(NamedTuple):
    """Host tables stacked (pu, pi, S): shard (ub, ib) reads its [ub, ib]
    row.  Index and value tables are flat per shard (every bucket's
    row-major (w, n) table in turn; the JAX package keeps the values per
    bucket, (pu, pi, w, n)).  Indices are block-local with ``blk`` (the
    appended zero row) marking padding slots."""

    ucols: np.ndarray  # int32 (pu, pi, S_u)
    uvals: np.ndarray  # dtype (pu, pi, S_u)
    irows: np.ndarray  # int32 (pu, pi, S_i)
    ivals: np.ndarray


class ShardedBellData(NamedTuple):
    meta: ShardedBellMeta
    tables: ShardedBellTables
    user_perm: np.ndarray
    item_perm: np.ndarray
    inv_user_perm: np.ndarray
    inv_item_perm: np.ndarray


def _sharded_side_tables(shard, own_local, other_local, vals, own_blk_dim, other_blk_dim, n_shards, dtype):
    """One side's shard-uniform tables (JAX :689): bucket bounds from the
    non-increasing envelope of the per-row max local degree across every
    shard, always the half-width guarded rule (the envelope is no entry
    count, so the small-side rule does not apply).  Returns (bounds, n_nz,
    flat cols (n_shards, S), flat vals (n_shards, S))."""
    from recsys_tpu_torch.utils.hostmem import hugepage_empty, hugepage_zeros

    key = shard.astype(np.int64) * own_blk_dim + own_local
    d = np.bincount(key, minlength=n_shards * own_blk_dim).reshape(n_shards, own_blk_dim)
    w_need = d.max(axis=0) if len(vals) else np.zeros(own_blk_dim, np.int64)
    env = np.maximum.accumulate(w_need[::-1])[::-1]
    bounds = _guarded_buckets(env, MIN_BUCKET_ROWS)
    n_nz = bounds[-1][1] if bounds else 0

    order = np.argsort(key, kind="stable")  # keeps file order within a row
    key_s = key[order]
    starts = np.zeros(n_shards * own_blk_dim + 1, np.int64)
    np.cumsum(np.bincount(key_s, minlength=n_shards * own_blk_dim), out=starts[1:])
    slot = np.arange(len(key_s), dtype=np.int64) - starts[key_s]
    own_s, shard_s, other_s, vals_s = own_local[order], shard[order], other_local[order], vals[order]

    cols_t, vals_t = [], []
    for (b0, b1, w) in bounds:
        n = b1 - b0
        ct = hugepage_empty((n_shards, w, n), np.int32)
        ct[...] = other_blk_dim  # pad -> zero row
        vt = hugepage_zeros((n_shards, w, n), dtype)
        sel = (own_s >= b0) & (own_s < b1)
        ct[shard_s[sel], slot[sel], own_s[sel] - b0] = other_s[sel]
        vt[shard_s[sel], slot[sel], own_s[sel] - b0] = vals_s[sel].astype(dtype)
        cols_t.append(ct.reshape(n_shards, -1))
        vals_t.append(vt.reshape(n_shards, -1))
    if not cols_t:
        return tuple(bounds), n_nz, np.zeros((n_shards, 0), np.int32), np.zeros((n_shards, 0), dtype)
    return tuple(bounds), n_nz, np.concatenate(cols_t, axis=1), np.concatenate(vals_t, axis=1)


def make_sharded_bell(spec, pu: int, pi: int, dtype=np.float32) -> ShardedBellData:
    """Checkerboard BELL (JAX :742): users and items permuted by GLOBAL
    degree, the permuted spaces cut into pu x pi blocks, and each shard
    given BELL tables over its local entries with shard-uniform shapes."""
    require_row_major(spec)
    _, uperm, uinv = _degree_perm(spec.rows, spec.users)
    _, iperm, iinv = _degree_perm(spec.cols, spec.items)
    u_blk = -(-spec.users // pu)
    i_blk = -(-spec.items // pi)
    up, ip = uinv[spec.rows], iinv[spec.cols]
    ub, ib = up // u_blk, ip // i_blk
    shard = (ub * pi + ib).astype(np.int64)
    ul = (up - ub * u_blk).astype(np.int64)
    il = (ip - ib * i_blk).astype(np.int64)
    ubounds, u_nz, ucols, uvals = _sharded_side_tables(shard, ul, il, spec.vals, u_blk, i_blk, pu * pi, dtype)
    ibounds, i_nz, irows, ivals = _sharded_side_tables(shard, il, ul, spec.vals, i_blk, u_blk, pu * pi, dtype)
    meta = ShardedBellMeta(
        user=BellSide(bounds=ubounds, n_nz=u_nz, size=u_blk),
        item=BellSide(bounds=ibounds, n_nz=i_nz, size=i_blk),
        features=spec.features, u_blk=u_blk, i_blk=i_blk, pu=pu, pi=pi,
    )
    tables = ShardedBellTables(*(x.reshape(pu, pi, -1) for x in (ucols, uvals, irows, ivals)))
    return ShardedBellData(meta=meta, tables=tables, user_perm=uperm, item_perm=iperm,
                           inv_user_perm=uinv, inv_item_perm=iinv)


def shard_tables(tables: ShardedBellTables, ub: int, ib: int, device, dtype=None) -> BellTables:
    """Shard (ub, ib)'s flat tables as ``device_tables`` puts them on
    ``device`` (the values cast to ``dtype`` when given)."""
    return device_tables(BellTables(*(x[ub, ib] for x in tables)), device, dtype)


def pad_factors_sharded_bell(state, data: ShardedBellData, dtype):
    """Degree-permute the factors and lay them out block-strided with one
    appended zero row per block (JAX :791): block b's rows are
    ``[b*(blk+1), (b+1)*(blk+1))``, its zero row last (local index
    ``blk``, the row every padding slot gathers).  numpy in ``dtype``."""
    from recsys_tpu_torch.utils.hostmem import hugepage_zeros

    m = data.meta
    k = state.L.shape[1]

    def lay(F, perm, blocks, blk):
        out = hugepage_zeros((blocks * (blk + 1), k), dtype)
        pos = np.arange(len(perm))
        out[(pos // blk) * (blk + 1) + pos % blk] = np.asarray(F)[perm].astype(dtype)
        return out

    return lay(state.L, data.user_perm, m.pu, m.u_blk), lay(state.R, data.item_perm, m.pi, m.i_blk)


def unpermute_factors_sharded(L, R, data: ShardedBellData):
    """Back to original row order, dropping the per-block zero rows and the
    block padding (JAX :812; numpy)."""
    m = data.meta

    def unlay(F, inv, blk):
        pos = np.arange(len(inv))
        return np.asarray(F)[(pos // blk) * (blk + 1) + pos % blk][inv]

    return unlay(L, data.inv_user_perm, m.u_blk), unlay(R, data.inv_item_perm, m.i_blk)


def sharded_lay_index(perm: np.ndarray, blk: int, blocks: int) -> np.ndarray:
    """int32 (blocks*(blk+1),) gather map (JAX :831) building the
    block-strided permuted layout from factors in original row order; zero
    rows and block padding read index ``len(perm)`` (out of range: the
    caller fills those rows with 0)."""
    dim = len(perm)
    idx = np.full(blocks * (blk + 1), dim, np.int64)
    pos = np.arange(dim, dtype=np.int64)
    idx[(pos // blk) * (blk + 1) + pos % blk] = perm.astype(np.int64)
    return idx.astype(np.int32)


def sharded_unpermute_index(inv_perm: np.ndarray, blk: int, dim_pad: int) -> np.ndarray:
    """int32 (dim_pad,) gather map (JAX :847): row ``r`` of the standard
    padded layout <- the block-strided permuted position of original row
    ``r``; padding rows read block 0's zero row."""
    dim = len(inv_perm)
    idx = np.full(dim_pad, blk, np.int64)
    p = inv_perm.astype(np.int64)
    idx[:dim] = (p // blk) * (blk + 1) + p % blk
    return idx.astype(np.int32)
