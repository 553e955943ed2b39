"""How the kernels are held against their plain twins: the readings,
their limits and the controls the limits must reject.  Shared
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card, and
checked on the CPU by ``tests/test_torch_dense_fused.py`` and
``tests/test_torch_tiled.py``.

Each reading is max |kernel - twin| over max |twin|, across the two
factor tables:

``factor_rel``
    The factors after 20 GD steps on real ratings.  Kernel and twin sum
    in f32 in different orders, and in ``default`` that difference can
    flip a bf16 rounding of e.  ``bf16x3`` and ``highest`` agree to f32
    noise here, so this reading cannot tell them apart.
``update_rel`` on ``precision_probe`` inputs
    One step from near-fit factors: every rating is 4 and every
    prediction is 4 within about 1%, so e = a - pred loses two digits to
    cancellation and shows the contraction's rounding about 100x larger.
    The reading compares the updates (out - in).  There the three modes
    lie orders of magnitude apart.

A limit sits between the sound readings (kernel and twin in one mode)
and the controls (kernel in one mode, twin in another), with room on
both sides.  A control stands for a kernel that skips the bf16 rounding
of ``default`` or the split of ``bf16x3``, or drops ``highest`` to split
products, and must exceed the limit.

The BELL kernel has no limit: it equals its twin bit for bit, and in f64
``_native.serial_gd``.  Its control is ``bell_sum_then_add_train``.  In
bf16 the twin is held against the JAX package's bf16 step on the CPU by
``BF16_JAX_SHARE`` and ``BF16_JAX_ULPS``, with two controls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from recsys_tpu_torch.ops import dense_fused, dense_tiled

# Set from H100 readings at the instML100k shape (PERF.md, "Tolerances
# from readings"): each limit is 4x or more above the sound readings and
# 4x or more below the controls.  The `default` update limit also leaves
# room for a few bf16 roundings of e that summation order flips (each
# moves one cell's e by 2^-8).
FACTOR_RTOL = {"highest": 1e-6, "bf16x3": 1e-6, "default": 1.5e-5}
UPDATE_RTOL = {"highest": 3e-5, "bf16x3": 5e-6, "default": 5e-3}
# B5's limits, set from H100 readings at the gen-instML1M and
# gen-inst1e6-100-700-1-3 shapes (PERF.md, "Findings"), where its sums over
# K = 704 and over up to 20,000 users per item read larger than the
# limits above allow with 4x room: factor_rel up to 3.9e-7 / 3.9e-7 /
# 6.3e-6 and update_rel up to 8.6e-6 / 6.8e-7 / 1.4e-6 (highest / bf16x3
# / default).  Each limit is 4x or more above those and 4x or more below
# the controls there (factor 1.7e-4; update 0.15, 2.1e-4, 2.1e-4).
TILED_FACTOR_RTOL = {"highest": 2e-6, "bf16x3": 2e-6, "default": 3e-5}
TILED_UPDATE_RTOL = {"highest": 4e-5, "bf16x3": 5e-6, "default": 5e-3}
# (kernel precision, twin precision): readings that must exceed the twin
# precision's limit.
FACTOR_CONTROLS = (("highest", "default"),)
UPDATE_CONTROLS = (("highest", "default"), ("highest", "bf16x3"), ("bf16x3", "highest"))
# Steps of the factor reading; the probe takes one step of this size.
FACTOR_ITERS = 20
PROBE_ALPHA2 = 1.0


def factor_rel(got, want) -> float:
    """max |got - want| over max |want|, across the (Lt, Rt) of two
    ``resident_train_top1`` results (or any two pairs of tensors)."""
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got[:2], want[:2]))
    return err / max(float(w.abs().max()) for w in want[:2])


def update_rel(got, want, Lt, Rt) -> float:
    """``factor_rel`` of the updates: each result minus the inputs (Lt, Rt)."""
    lt, rt = Lt.double(), Rt.double()
    return factor_rel((got[0].double() - lt, got[1].double() - rt), (want[0].double() - lt, want[1].double() - rt))


def precision_probe(spec, a_dtype: torch.dtype, device, *, seed: int = 0, spread: float = 1e-2):
    """(Lt, Rt, At) on ``device`` in ``spec``'s padded shape and rating
    pattern, with every rating 4 and factors s * (1 + spread * N(0, 1)),
    k * s^2 = 4: every prediction is 4 within about ``spread``."""
    r = dense_fused.round_up
    U, I, K = r(spec.users, 128), r(spec.items, 128), r(spec.features, 8)
    At =dense_fused.device_dense_AT(dataclasses.replace(spec, vals=np.full_like(spec.vals, 4.0)),
                                     U, I, a_dtype, device)
    g = torch.Generator().manual_seed(seed)
    k, s = spec.features, (4.0 / spec.features) ** 0.5
    Lt, Rt = torch.zeros((K, U)), torch.zeros((K, I))
    Lt[:k, : spec.users] = s * (1 + spread * torch.randn((k, spec.users), generator=g))
    Rt[:k, : spec.items] = s * (1 + spread * torch.randn((k, spec.items), generator=g))
    return Lt.to(device), Rt.to(device), At


def tiled_probe(spec, a_dtype: torch.dtype, device, *, seed: int = 0, spread: float = 1e-2):
    """``precision_probe``'s inputs in the tiled kernel's layout: (L (U,
    K), R (I, K), A (U, I)) on ``device``, K padded to 32."""
    Lt, Rt, At = precision_probe(spec, a_dtype, "cpu", seed=seed, spread=spread)
    K = dense_fused.round_up(spec.features, dense_tiled.K_ALIGN)
    L, R = torch.zeros((Lt.shape[1], K)), torch.zeros((Rt.shape[1], K))
    L[:, : Lt.shape[0]] = Lt.T
    R[:, : Rt.shape[0]] = Rt.T
    return L.to(device), R.to(device), At.T.contiguous().to(device)


# ``ops/lane.py::lane_cumsum_loop`` against its twin: max |kernel - twin|
# over max |twin|.  Both scan a row of N(0, 1) values in f32 in different
# orders: the kernel a thread's 32 in sequence, then a warp and a block
# carry; ``torch.cumsum`` its own.  A numpy model of the kernel's order
# reads 2.1e-7 to 3.6e-7 of exact f64 at the probe's shapes, and a plain
# sequential f32 scan up to 4.7e-6; the limit sits 4x above that.  Its
# control, ``lane_cumsum_dropped``, moves every later prefix by one
# element, 4.8e-3 to 2.5e-2 at those shapes (my numpy reading).
LANE_CUMSUM_RTOL = 2e-5
# ``ops/stream_v2.py::stream_v2_train`` against its twin, ``factor_rel``
# after ``FACTOR_ITERS`` steps: B3's steps in B3's order of sums, held to
# B3's `highest` limit against a twin that sums in another f32 order.  Its
# control is the twin's step in `default` (``stream_v2_default``).
STREAM_V2_RTOL = FACTOR_RTOL["highest"]


def lane_cumsum_dropped(x):
    """The control of ``LANE_CUMSUM_RTOL``: the scan with x[:, W // 2] left
    out, i.e. every prefix from there on short by that element."""
    keep = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
    keep[x.shape[1] // 2] = False
    return torch.cumsum(torch.where(keep, x, 0.0), dim=1)


def stream_v2_default(Lt, Rp, A, *, iters: int, alpha2: float, strip: int):
    """The control of ``STREAM_V2_RTOL``: P3's steps with `default`'s bf16
    rounding of every product's operands, by B3's twin on the unpacked
    layout, packed again."""
    from recsys_tpu_torch.ops import dense_stream, stream_v2

    K = Lt.shape[0]
    Lt2, Rt2 = dense_stream.stream_train_plain(Lt, stream_v2.unpack_R(Rp, K), A.T.contiguous(), iters=iters,
                                               alpha2=alpha2, precision="default")
    return Lt2, stream_v2.pack_R(Rt2, strip)


# ``ops/gather.py::gather_err_grad`` against its twin at the probe's values
# (N(0, 1) table and ratings, K = 128): max |kernel - twin| over max |twin|.
# The two sum the K products of a slot's dot in different f32 orders.
GATHER_ERR_GRAD_RTOL = 1e-5


def bell_sum_then_add_train(L, R, tables, alpha2: float, meta, iters: int):
    """The control of the bitwise BELL readings: ``bell.bell_train_plain``
    with the JAX package's order (``recsys_tpu/ops/bell.py:556``, :639),
    each row's change summed over its slots first and added to the row
    once.  It computes the same sums in another order, so in f64 it must
    differ from ``_native.serial_gd`` in at least one bit where the
    reference order matches it."""
    from recsys_tpu_torch.ops import bell

    ub = bell._twin_buckets(tables.ucols, tables.uvals, meta.user, meta.item.size)
    ib = bell._twin_buckets(tables.irows, tables.ivals, meta.item, meta.user.size)

    def side(F_own, F_other, buckets):
        a2 = torch.tensor(alpha2, dtype=F_own.dtype, device=F_own.device)
        out = F_own.clone()
        for bucket in buckets:
            fo, terms = bell._bucket_terms(F_own, F_other, bucket, a2)
            delta = torch.zeros_like(fo)
            for s in range(bucket[2]):
                delta = delta + terms[s]
            out[bucket[0]:bucket[1]] = fo + delta
        return out

    for _ in range(iters):
        L, R = side(L, R, ub), side(R, L, ib)
    return L, R


# The bf16 BELL twin against the JAX package's bf16 BELL step on the CPU
# (``tests/test_torch_bell.py``), 3 steps from the glibc init at
# inst400-50000-30-200-500 and inst50000-5000-100-2-5: the share of factor
# values equal in raw bits, and the largest distance in bf16 ulps
# (``bf16_ulps``).  Readings: 1.0 and 0 at both.  The controls read 0.8909
# / 0.9214 and 3 / 3 ulps (the step in f32 inside, rounded once,
# ``bell_bf16_f32_inside_train``) and 0.1053 / 0.4154 and 151 / 24 ulps (a
# bf16 accumulator in the f32/f64 order, ``bell_bf16_row_acc_train``).  The
# share's limit leaves 1 value in 1000 to a reordered XLA sum, 78x fewer
# than the nearest control's unequal values; the ulp limit is a third of
# the nearest control's.
BF16_JAX_SHARE = 0.999
BF16_JAX_ULPS = 1


def bit_share(a, b) -> float:
    """The share of values equal in raw bits across two sequences of
    tensors of one dtype."""
    same = sum(int((x.contiguous().view(_BITS[x.element_size()]) == y.contiguous().view(_BITS[y.element_size()]))
                   .sum()) for x, y in zip(a, b))
    return same / sum(x.numel() for x in a)


def bf16_ulps(a, b) -> int:
    """The largest distance in bf16 ulps between two sequences of bf16
    tensors: the bit patterns mapped to an ordered integer line (-0.0
    and +0.0 one point)."""
    def line(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)

    return max(int((line(x) - line(y)).abs().max()) for x, y in zip(a, b))


def bell_bf16_f32_inside_train(L, R, tables, alpha2: float, meta, iters: int):
    """The first control of the bf16 BELL readings: each step computed in
    f32 from the bf16 factors (``bell.bell_train_plain`` in f32, alpha2
    rounded to bf16) and rounded to bf16 once, at its end."""
    from recsys_tpu_torch.ops import bell

    t32 = tables._replace(uvals=tables.uvals.float(), ivals=tables.ivals.float())
    a2 = bell._alpha(alpha2, torch.bfloat16)
    for _ in range(iters):
        L, R = (x.bfloat16() for x in bell.bell_train_plain(L.float(), R.float(), t32, a2, meta, 1))
    return L, R


def bell_bf16_row_acc_train(L, R, tables, alpha2: float, meta, iters: int):
    """The second control: the bf16 step with the f32/f64 kernel's order
    carried over, the row itself the accumulator, each slot's term
    rounded to bf16 and added into it with a bf16 rounding, slot after
    slot."""
    from recsys_tpu_torch.ops import bell

    ub = bell._twin_buckets(tables.ucols, tables.uvals, meta.user, meta.item.size)
    ib = bell._twin_buckets(tables.irows, tables.ivals, meta.item, meta.user.size)
    a2 = torch.tensor(bell._alpha(alpha2, torch.bfloat16), dtype=torch.float32, device=L.device)

    def side(F_own, F_other, buckets):
        out = F_own.clone()
        for bucket in buckets:
            acc, terms = bell._bucket_terms(F_own, F_other, bucket, a2)
            for s in range(bucket[2]):
                acc = bell._bf(acc + bell._bf(terms[s]))
            out[bucket[0]:bucket[1]] = acc.bfloat16()
        return out

    for _ in range(iters):
        L, R = side(L, R, ub), side(R, L, ib)
    return L, R


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def same_bits(a, b) -> bool:
    """Two float tensors, or two sequences of them, alike bit for bit: the
    raw bits compared, so -0.0 and +0.0 differ (``torch.equal`` takes them
    as equal)."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.contiguous().view(_BITS[x.element_size()]), y.contiguous().view(_BITS[y.element_size()]))
        for x, y in zip(a, b))


def hub_spec(features: int, seed: int = 0, *, users: int = 300, items: int = 2000, hub: int = 1500):
    """A BELL spec whose user 0 rated ``hub`` items and every other user 1
    to 20: one row far wider than the rest, alone in its bucket, and a few
    popular items.  Ratings 1..5, some stored as 0 (real entries)."""
    from recsys_tpu_torch.config import ProblemSpec

    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for u in range(users):
        n = hub if u == 0 else int(rng.integers(1, 21))
        p = None if u == 0 else 1.0 / np.arange(1, items + 1) / np.sum(1.0 / np.arange(1, items + 1))
        rows.append(np.full(n, u, np.int32))
        cols.append(np.sort(rng.choice(items, n, replace=False, p=p)).astype(np.int32))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.integers(0, 6, rows.size).astype(np.float64)
    return ProblemSpec(iters=4, alpha=1e-4, features=features, users=users, items=items,
                       rows=rows, cols=cols, vals=vals)
