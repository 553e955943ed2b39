"""Fused dense full-batch GD + masked top-1: the port of ``recsys_tpu/ops/pallas_dense.py``'s
resident kernels.

The JAX module's resident kernel ``resident_train_top1`` (:662) runs
every GD iteration and the masked top-1 in one Pallas call, with A
stored TRANSPOSED (items x users) and K-major factors Lt (K, U), Rt (K, I);
``resident_train`` (:238) is the same loop without the top-1.  Here both
are hand-written CUDA (``csrc/dense_fused.cu``) behind
``resident_train_top1`` (B1) and ``resident_train`` (B2), with plain torch
twins of the same math.  Their steps run in the sparse form: a walk of the
rated cells alone over tables that ``walk_tables`` builds once per A^T (the
engine builds them in its ``upload`` phase), two launches a step
(``form="loop"``, the engine's ``ENGINE_FORM``) or one persistent launch
for all the steps (``form="persistent"``), bit for bit the dense form at
the same split.  The dense form, every cell of each A^T tile walked, stays
callable as ``resident_train_top1_dense`` and ``resident_train_dense``, the
baseline of ``probes/resident_sparse.py``; ``walk_train_plain`` is a plain
torch walk over the tables.  The wrappers pick by the tensors' device: the plain twin
for CPU tensors, the kernel for CUDA tensors, and an error for anything the
kernel does not take -- never a fallback.

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
from typing import NamedTuple

import numpy as np
import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops.precision import cell_prod, dot, maybe_split, pred_cells, transpose
from recsys_tpu_torch.utils.timing import h2d, span

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
    on the host (the ``densify`` span) and moved to ``device`` in one copy
    (``timing.h2d``).  int8 holds 2x the rating (see ``vals_int8_exact``)."""
    from recsys_tpu_torch.utils.hostmem import hugepage_zeros

    with span("densify"):
        if dtype == torch.int8:
            a = hugepage_zeros((I, U), np.int8)
            a[spec.cols, spec.rows] = np.round(np.asarray(spec.vals, np.float64) * 2.0).astype(np.int8)
        else:
            a = hugepage_zeros((I, U), np.float32)
            a[spec.cols, spec.rows] = spec.vals
            a = torch.from_numpy(a).to(dtype)
    return h2d(a, device)


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


def plain_scores(Lt, Rt, At, precision, items_true):
    """B^T = Rt^T . Lt (I, U) in plain torch with rated cells and items at
    or past ``items_true`` at -inf: what the top-1 maximises."""
    a = load_at(At)
    b = dot(Rt.T, Lt, precision)
    item = torch.arange(b.shape[0], device=b.device)[:, None]
    return torch.where((a != 0) | (item >= items_true), -torch.inf, b)


def plain_top1(Lt, Rt, At, precision, items_true):
    """The masked top-1 from final factors in plain torch (B1's last pass,
    B4): (1, U) int32, rated cells and items at or past ``items_true`` at
    -inf, lowest index on ties."""
    # argmax returns the first maximum: the lowest-index tie-break.
    return torch.argmax(plain_scores(Lt, Rt, At, precision, items_true), dim=0).to(torch.int32)[None, :]


def plain_top1_scores(Lt, Rt, At, precision, items_true):
    """``plain_top1`` and each user's best score: ((1, U) int32, (1, U) f32)."""
    b = plain_scores(Lt, Rt, At, precision, items_true)
    top = torch.argmax(b, dim=0)
    return top.to(torch.int32)[None, :], b.gather(0, top[None, :])


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


# SMs of an H100 SXM, for the splits and byte counts made before any
# device is chosen (the plan, the CPU tests).
H100_SMS = 132
# The form of the sparse steps the engine calls: "loop" (two launches a
# step from the C loop) or "persistent" (every step in one cooperative
# launch).  probes/resident_sparse.py times both in turns; on an H100 80GB
# HBM3 at 700 W the loop form read faster at instML100k in every
# precision (PERF.md §6).
ENGINE_FORM = "loop"
_FORM_CODE = {"persistent": 0, "loop": 1}
# Users of a block of B4's tiled form, and the multiple of items its chunks
# come in (csrc/dense_fused.cu, TBU and TBI_MAX).
TOP1_USERS = 64
TOP1_ITEMS = 64
# Blocks of the tiled top-1 resident on an SM: 80 registers and 32 KB of
# shared memory a block of 256 threads in `highest` (nvcc -Xptxas -v).  Its
# grid aims at one wave of them (four item chunks at gen-instML1M).
_TOP1_BLOCKS_PER_SM = 3
# The top-1's forms (rs_stream_top1's form argument): "tiled" the engine's,
# "dense" the form it replaced, kept as the probe's baseline.
TOP1_FORMS = {"dense": 0, "tiled": 1}
# Operand tables of K * (U + I) floats the tiled top-1 reads from scratch
# (csrc/dense_fused.cu, top1_operands): the factors' bf16 roundings in
# `default`, their hi and lo parts in `bf16x3`; `highest` reads the factors.
_TOP1_OPERANDS = {"highest": 0, "default": 1, "bf16x3": 2}
# A walk's cell word packs the column within its block above the row
# within its chunk.
_CELL_ROW_BITS = 24
# Columns of a sparse-form unit at G = 1 (csrc/dense_fused.cu, UNIT_COLS):
# a unit is UNIT_COLS / G columns of one side over one chunk of the other.
UNIT_COLS = 128


def resident_split(K: int, U: int, I: int, sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """(chunk_l, s_l, chunk_r, s_r) of B1 and B2: each gradient side's
    reduction split so its pass has about two blocks per SM in the dense
    form.  Both forms take it; the sparse form keeps its order of sums."""
    G = _lanes_per_column(K)
    return (*_split(U, I, G, 2 * sms), *_split(I, U, G, 2 * sms))


def sub_strip(G: int) -> int:
    """Rows a block of a sparse form stages at a time (``csrc/dense_fused.cu``
    and ``csrc/dense_stream.cu``, SR): 64, or 32 when a column spans G > 1
    lanes, so shared memory stays under 227 KB at K = 256."""
    return 64 if G == 1 else 32


def top1_split(U: int, I: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(chunk, S) of the tiled top-1: the items cut into S chunks of
    ``chunk`` (a multiple of ``TOP1_ITEMS``) so its grid (U / TOP1_USERS, S)
    fills about one wave of the card's resident blocks."""
    tiles = I // TOP1_ITEMS
    s = max(1, min(tiles, round(_TOP1_BLOCKS_PER_SM * sms / (U // TOP1_USERS))))
    chunk = -(-tiles // s) * TOP1_ITEMS
    return chunk, -(-I // chunk)


def top1_split_for(K: int, U: int, I: int, dev, form: str = "tiled") -> tuple[int, int]:
    """(chunk, S) of a top-1 form on ``dev`` (an H100's on the CPU):
    ``top1_split`` for "tiled", the dl side's chunks (``_split``) for
    "dense"."""
    if form not in TOP1_FORMS:
        raise ValueError(f"unknown top-1 form {form!r}; one of {sorted(TOP1_FORMS)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else H100_SMS
    return top1_split(U, I, sms) if form == "tiled" else _split(U, I, _lanes_per_column(K), 2 * sms)


def top1_bytes(K: int, U: int, I: int, precision: str, sms: int = H100_SMS) -> int:
    """Device bytes of the tiled top-1's buffers (``top1_buffers``) at
    ``top1_split``: its operands, the (S, U) partial bests and indices and
    the (1, U) result."""
    S = top1_split(U, I, sms)[1]
    return 4 * (_TOP1_OPERANDS[precision] * K * (U + I) + 2 * S * U + U)


def top1_buffers(K: int, U: int, I: int, S: int, dev, precision: str, form: str = "tiled"):
    """(ops, top_val, top_idx, top1) of a top-1 over S item chunks: ops
    holds the tiled form's operands (``_TOP1_OPERANDS``; empty in the
    dense form)."""
    n_ops = _TOP1_OPERANDS[precision] * K * (U + I) if form == "tiled" else 0
    return (torch.empty(n_ops, dtype=torch.float32, device=dev),
            torch.empty((S, U), dtype=torch.float32, device=dev),
            torch.empty((S, U), dtype=torch.int32, device=dev),
            torch.empty((1, U), dtype=torch.int32, device=dev))


def _offsets(keys: torch.Tensor, n: int) -> torch.Tensor:
    """int32 (n + 1,) start of each key's run in an order sorted by key."""
    off = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    off[1:] = torch.cumsum(torch.bincount(keys, minlength=n), 0)
    return off.to(torch.int32)


def _by_degree(groups: torch.Tensor, counts: torch.Tensor, n: int) -> torch.Tensor:
    """Within each row of ``groups`` (rows, m), positions ordered by
    (group, descending count, position): the stable sort of a composite
    key."""
    key = groups * (n + 1) + (n - counts)
    return torch.sort(key, dim=1, stable=True).indices.to(torch.int32).reshape(-1)


class Walk(NamedTuple):
    """The sparse form's tables for one A^T and split (``walk_tables``).  Per
    side (``l``: the dl side, user columns over item chunks; ``r``: the dr
    side, item columns over user chunks) a unit is (chunk s, column block
    cb), numbered s * (N / BC) + cb, and its cells split into sub-strips of
    ``sub`` rows: a segment."""

    l_cell: torch.Tensor  # int32 by (segment, column, row): column in block << 24 | row in chunk
    l_val: torch.Tensor  # f32, same order: the dequantised rating
    l_off: torch.Tensor  # int32 (units * nsub * BC + 1,): first cell of (segment, column)
    l_order: torch.Tensor  # int32 (units * BC,): a unit's columns by descending degree
    r_cell: torch.Tensor
    r_val: torch.Tensor
    r_off: torch.Tensor
    r_order: torch.Tensor
    units: torch.Tensor  # int32: every unit (the dl side's, then the dr side's) by descending cell count
    split: tuple  # (G, chunk_l, s_l, chunk_r, s_r)
    shape: tuple  # (I, U) of A^T
    sub: int  # rows per sub-strip
    cap: int  # the most cells of one segment, either side

    @property
    def tables(self) -> tuple:
        return self[:9]


def _side_tables(own, other, val, n_own: int, chunk: int, BC: int, sub: int, S: int):
    """One side's (cell, val, off, order) and its segments' cell counts."""
    ncb, nsub = n_own // BC, -(-chunk // sub)
    units = S * ncb
    cl, rl = own % BC, other % chunk
    unit = (other // chunk) * ncb + own // BC
    run = (unit * nsub + rl // sub) * BC + cl
    perm = torch.argsort(run * chunk + rl)  # unique keys
    off = _offsets(run, units * nsub * BC)
    deg = torch.bincount(unit * BC + cl, minlength=units * BC).view(units, BC)
    order = _by_degree(torch.zeros_like(deg), deg, own.numel())
    cell = ((cl << _CELL_ROW_BITS) | rl)[perm].to(torch.int32)
    return (cell, val[perm].contiguous(), off, order), torch.diff(off[::BC].long())


def walk_tables(At, split: tuple, sub: int) -> Walk:
    """The rated cells of A^T (I, U) as the sparse form walks them, built
    with torch ops on At's device.  ``split`` is (G, chunk_l, s_l, chunk_r,
    s_r), ``resident_split``'s with the lanes a column: it fixes the dense
    form's order of sums, which the tables keep.  Each side's cells run by
    (unit, sub-strip, column, row): a column's cells in a chunk in
    ascending row order, the order of its chain in the dense form."""
    G, chunk_l, s_l, chunk_r, s_r = split
    I, U = At.shape
    if max(U, I) >= 1 << _CELL_ROW_BITS:
        raise ValueError(f"the sparse form takes fewer than 2^{_CELL_ROW_BITS} users and items; got {U}, {I}")
    BC = UNIT_COLS // G
    item, user = torch.nonzero(At, as_tuple=True)
    val = load_at(At[item, user])
    left, seg_l = _side_tables(user, item, val, U, chunk_l, BC, sub, s_l)
    right, seg_r = _side_tables(item, user, val, I, chunk_r, BC, sub, s_r)
    # Every unit's cells (a unit is a run of ceil(chunk / sub) segments).
    cells = torch.cat([seg_l.view(-1, -(-chunk_l // sub)).sum(1), seg_r.view(-1, -(-chunk_r // sub)).sum(1)])
    units = _by_degree(torch.zeros_like(cells)[None], cells[None], item.numel())
    cap = int(torch.cat([seg_l, seg_r]).max())
    return Walk(*left, *right, units=units, split=tuple(split), shape=(I, U), sub=sub, cap=cap)


def walk_bytes(K: int, U: int, I: int, nnz: int, sms: int = H100_SMS) -> int:
    """Device bytes of ``walk_tables``'s output for ``nnz`` rated cells at
    ``resident_split``: per side, a cell word and a value per cell, an
    offset per (segment, column) and a degree rank per (unit, column); and
    the units' order."""
    G = _lanes_per_column(K)
    chunk_l, s_l, chunk_r, s_r = resident_split(K, U, I, sms)
    sub = sub_strip(G)
    runs = U * s_l * -(-chunk_l // sub) + I * s_r * -(-chunk_r // sub)
    units = (U * s_l + I * s_r) // (UNIT_COLS // G)
    return 4 * (2 * 2 * nnz + runs + 2 + U * s_l + I * s_r + units)


def resident_walk(At, K: int, split: tuple | None = None) -> Walk:
    """The sparse form's tables for A^T on its device, at ``split`` (default:
    ``resident_split`` for the device's SMs, or an H100's on the CPU).  A
    caller that builds them ahead (the engine, in its ``upload`` phase)
    passes them to ``resident_train_top1`` and ``resident_train`` as
    ``walk``."""
    I, U = At.shape
    split = _split_for(split, K, U, I, At.device)
    G = _lanes_per_column(K)
    return walk_tables(At, (G, *split), sub_strip(G))


def walk_train_plain(Lt, Rt, walk: Walk, *, iters: int, alpha2: float, precision: str = "highest"):
    """Plain torch GD steps over the walk's tables: per side, pred and e of
    every rated cell, its products summed into the (chunk, column) partial
    (index_add) and the partials summed in ascending chunk order.  The
    function of ``resident_train_plain``, its sums grouped as the sparse
    form groups them.  Returns (Lt', Rt')."""
    G, chunk_l, s_l, chunk_r, s_r = walk.split
    K, U = Lt.shape
    I = Rt.shape[1]
    BC, dev = UNIT_COLS // G, Lt.device
    mask = (1 << _CELL_ROW_BITS) - 1
    sides = []
    for cell, val, off, N, chunk, S in ((walk.l_cell, walk.l_val, walk.l_off, U, chunk_l, s_l),
                                        (walk.r_cell, walk.r_val, walk.r_off, I, chunk_r, s_r)):
        ncb, nsub = N // BC, -(-chunk // walk.sub)
        runs = torch.repeat_interleave(torch.arange(off.numel() - 1, device=dev), torch.diff(off.long()))
        unit = runs // (nsub * BC)
        own = (unit % ncb) * BC + (cell.long() >> _CELL_ROW_BITS)
        other = (unit // ncb) * chunk + (cell.long() & mask)
        sides.append((own, other, (unit // ncb) * N + own, S, N, val))

    def summed(x, idx, parts, n):
        part = torch.zeros((K, parts * n), dtype=torch.float32, device=dev).index_add_(1, idx, x).view(K, parts, n)
        total = part[:, 0]
        for s in range(1, parts):
            total = total + part[:, s]
        return total

    with exact_f32(dev):
        for _ in range(iters):
            new = []
            for (own, other, at, S, N, val), (X, Y) in zip(sides, ((Lt, Rt), (Rt, Lt))):
                y = Y[:, other]
                e = val - pred_cells(y, X[:, own], precision)
                new.append(X + alpha2 * summed(cell_prod(y, e, precision), at, S, N))
            Lt, Rt = new
    return Lt, Rt


def _split_for(split, K: int, U: int, I: int, dev) -> tuple[int, int, int, int]:
    """``split``, checked, or ``resident_split`` for the device's SMs."""
    if split is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else H100_SMS
        return resident_split(K, U, I, sms)
    split = tuple(int(x) for x in split)
    chunk_l, s_l, chunk_r, s_r = split
    if chunk_l % _BR or chunk_r % _BR or chunk_l <= 0 or chunk_r <= 0 \
            or s_l != -(-I // chunk_l) or s_r != -(-U // chunk_r):
        raise ValueError(f"split {split} does not cut I={I}, U={U} into chunks of multiples of {_BR}")
    return split


def _walk_for(walk: Walk | None, At, K: int, split: tuple) -> Walk:
    """``walk``, or the tables built now; raises when a given walk was
    built for another split or shape."""
    G = _lanes_per_column(K)
    if walk is None:
        return walk_tables(At, (G, *split), sub_strip(G))
    if tuple(walk.split) != (G, *split) or tuple(walk.shape) != tuple(At.shape):
        raise ValueError(f"the walk was built for split {walk.split} and A^T {walk.shape}, "
                         f"the kernel takes {(G, *split)} and {tuple(At.shape)}")
    return walk


def _form_code(form: str) -> int:
    if form not in _FORM_CODE:
        raise ValueError(f"unknown form {form!r}; one of {sorted(_FORM_CODE)}")
    return _FORM_CODE[form]


def _resident_buffers(K, U, I, dev, split):
    """(Lt_out, Rt_out, Lt_tmp, Rt_tmp, part_l, part_r) of B1 and B2."""
    chunk_l, s_l, chunk_r, s_r = split

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return f32(K, U), f32(K, I), f32(K, U), f32(K, I), f32(s_l, K, U), f32(s_r, K, I)


def _tickets(dev):
    """The persistent form's two unit counters, zeroed."""
    return torch.zeros(2, dtype=torch.int32, device=dev)


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def _kernel_device(Lt):
    if Lt.device.type != "cuda":
        raise ValueError(f"no kernel for device {Lt.device}")
    return Lt.device


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _cpu_check(At, K, split, walk=None):
    """On the CPU the twin runs; a given split and walk are still checked."""
    if walk is not None or split is not None:
        I, U = At.shape
        split = _split_for(split, K, U, I, At.device)
        if walk is not None:
            _walk_for(walk, At, K, split)


def resident_train_top1(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest", items_true: int,
                        walk: Walk | None = None, split: tuple | None = None, form: str = ENGINE_FORM):
    """``iters`` stable-snapshot GD steps plus the masked top-1 (port of
    ``pallas_dense.resident_train_top1`` :662, minus the TPU-only
    ``strip`` and ``interpret``): the steps in the sparse form, bit for bit
    ``resident_train_top1_dense`` at the same ``split``, then the dense
    top-1.

    Lt (K, U), Rt (K, I) f32, At (I, U) int8 (2x rating) / bf16 / f32;
    U and I multiples of 128, K a multiple of 8 up to ``MAX_K``.  Items
    at or past ``items_true`` never win the top-1.  ``walk`` is
    ``resident_walk(At, K, split)`` built ahead, else the call builds it;
    ``split`` defaults to ``resident_split``; ``form`` is "loop" or
    "persistent".  The top-1 is B4's tiled form (``top1_split``'s chunks).
    Returns (Lt', Rt', top1 (1, U) int32).  CPU tensors go to the plain
    twin; CUDA tensors to the kernel, which counts each launch in
    ``.launches``.
    """
    K, U, I = _check(Lt, Rt, At, precision)
    code = _form_code(form)
    if Lt.device.type == "cpu":
        _cpu_check(At, K, split, walk)
        return resident_train_top1_plain(
            Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision, items_true=items_true
        )
    dev = _kernel_device(Lt)
    lib = _build.load()
    split = _split_for(split, K, U, I, dev)
    walk = _walk_for(walk, At, K, split)
    bufs = _resident_buffers(K, U, I, dev, split)
    top_split = top1_split_for(K, U, I, dev)
    tops = top1_buffers(K, U, I, top_split[1], dev, precision)
    with torch.cuda.device(dev):
        rc = lib.rs_resident_sparse_train_top1(
            *_ptrs(*walk.tables, _tickets(dev)), walk.cap, ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype],
            *_ptrs(Lt, Rt, *bufs, *tops), K, U, I, _lanes_per_column(K), iters, float(alpha2),
            _PRECISION_CODE[precision], items_true, *split, walk.sub, code, *top_split, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_resident_sparse_train_top1 ({form}) failed: CUDA error {rc}")
    resident_train_top1.launches += 1
    return bufs[0], bufs[1], tops[3]


def resident_train(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest",
                   walk: Walk | None = None, split: tuple | None = None, form: str = ENGINE_FORM):
    """``iters`` stable-snapshot GD steps (port of ``pallas_dense.resident_train``
    :238): B1's steps without the top-1, so its factors are B1's bit for
    bit.  Same inputs and keywords as ``resident_train_top1``; returns
    (Lt', Rt').  CPU tensors go to the plain twin; CUDA tensors to the
    kernel, which counts each launch in ``.launches``."""
    K, U, I = _check(Lt, Rt, At, precision)
    code = _form_code(form)
    if Lt.device.type == "cpu":
        _cpu_check(At, K, split, walk)
        return resident_train_plain(Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision)
    dev = _kernel_device(Lt)
    lib = _build.load()
    split = _split_for(split, K, U, I, dev)
    walk = _walk_for(walk, At, K, split)
    bufs = _resident_buffers(K, U, I, dev, split)
    with torch.cuda.device(dev):
        rc = lib.rs_resident_sparse_train(
            *_ptrs(*walk.tables, _tickets(dev)), walk.cap, *_ptrs(Lt, Rt, *bufs), K, U, I, _lanes_per_column(K),
            iters, float(alpha2), _PRECISION_CODE[precision], *split, walk.sub, code, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_resident_sparse_train ({form}) failed: CUDA error {rc}")
    resident_train.launches += 1
    return bufs[0], bufs[1]


def resident_train_top1_dense(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest",
                              items_true: int, split: tuple | None = None):
    """``resident_train_top1`` in its dense form, every cell of each A^T tile
    walked (``grad_pass`` + ``apply_update``, two launches a step): the
    baseline the sparse form replaced, kept for ``probes/resident_sparse.py``.
    CPU tensors go to the plain twin; CUDA tensors to the kernel
    (``.launches``)."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        _cpu_check(At, K, split)
        return resident_train_top1_plain(
            Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision, items_true=items_true
        )
    dev = _kernel_device(Lt)
    lib = _build.load()
    split = _split_for(split, K, U, I, dev)
    bufs = _resident_buffers(K, U, I, dev, split)
    tops = top1_buffers(K, U, I, split[1], dev, precision, "dense")[1:]
    with torch.cuda.device(dev):
        rc = lib.rs_resident_train_top1(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *bufs, *tops),
            K, U, I, _lanes_per_column(K), iters, float(alpha2), _PRECISION_CODE[precision], items_true,
            *split, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_resident_train_top1 failed: CUDA error {rc}")
    resident_train_top1_dense.launches += 1
    return bufs[0], bufs[1], tops[2]


def resident_train_dense(Lt, Rt, At, *, iters: int, alpha2: float, precision: str = "highest",
                         split: tuple | None = None):
    """``resident_train`` in its dense form (``rs_resident_train``): the
    steps of ``resident_train_top1_dense``.  CPU tensors go to the plain
    twin; CUDA tensors to the kernel (``.launches``)."""
    K, U, I = _check(Lt, Rt, At, precision)
    if Lt.device.type == "cpu":
        _cpu_check(At, K, split)
        return resident_train_plain(Lt, Rt, At, iters=iters, alpha2=alpha2, precision=precision)
    dev = _kernel_device(Lt)
    lib = _build.load()
    split = _split_for(split, K, U, I, dev)
    bufs = _resident_buffers(K, U, I, dev, split)
    with torch.cuda.device(dev):
        rc = lib.rs_resident_train(
            ctypes.c_void_p(At.data_ptr()), _A_KIND[At.dtype], *_ptrs(Lt, Rt, *bufs),
            K, U, I, _lanes_per_column(K), iters, float(alpha2), _PRECISION_CODE[precision],
            *split, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"rs_resident_train failed: CUDA error {rc}")
    resident_train_dense.launches += 1
    return bufs[0], bufs[1]


resident_train_top1.launches = 0
resident_train.launches = 0
resident_train_top1_dense.launches = 0
resident_train_dense.launches = 0
