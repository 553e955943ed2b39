"""B1's and B2's sparse form on the CPU: the walk's tables (``walk_tables``)
against a numpy reference, and a plain torch step over them
(``walk_train_plain``) against ``resident_train_plain`` and the JAX
``pallas_dense.resident_train`` / ``resident_train_top1`` (interpret mode,
as tests/test_torch_dense_fused.py runs them).

The CUDA kernels that walk these tables (the persistent kernel and the loop
form) are held against the dense form bit for bit in tests/test_torch_cuda.py,
probes/resident_sparse.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.ops import dense_fused

MASK = (1 << 24) - 1
SPECS = {
    "32x40": dict(users=32, items=40, features=10, min_nz_row=2, max_nz_row=8, iters=5, alpha=0.01, seed=11),
    "32x700": dict(users=32, items=700, features=8, min_nz_row=2, max_nz_row=8, iters=4, alpha=0.01, seed=7),
    # 500 users -> 512 and 900 items -> 1024: several column blocks and
    # chunks on both sides.
    "500x900": dict(users=500, items=900, features=12, min_nz_row=2, max_nz_row=90, iters=3, alpha=0.001, seed=3),
}
# (spec, k, split): the default split (H100 SMs), and splits whose chunks
# hold several sub-strips (128 = 2 x 64 rows; 96 = 3 x 32 at G = 2).
WALKS = [("32x40", None, None), ("32x700", None, None), ("500x900", None, None),
         ("500x900", None, (128, 8, 128, 4)), ("500x900", 40, (96, 11, 96, 6))]


def _inputs(name, k=None, a_dtype=torch.int8):
    spec = generate_instance(**{**SPECS[name], **({"features": k} if k else {})})
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, "cpu")
    return spec, torch.from_numpy(Lt), torch.from_numpy(Rt), At


def _reference(At: np.ndarray, split, sub):
    """Each side's cells in numpy, as lists of (own, other, value) in the
    walk's order: by (unit, sub-strip, column, row)."""
    G, chunk_l, s_l, chunk_r, s_r = split
    BC = dense_fused.UNIT_COLS // G
    I, U = At.shape
    r, c = np.nonzero(At)
    v = At[r, c].astype(np.float32) * (0.5 if At.dtype == np.int8 else 1.0)
    out = {}
    for side, own, other, N, chunk in (("l", c, r, U, chunk_l), ("r", r, c, I, chunk_r)):
        unit = (other // chunk) * (N // BC) + own // BC
        order = np.lexsort((other, own, (other % chunk) // sub, unit))
        out[side] = [(own[j], other[j], v[j]) for j in order]
    return out


def _decode(cell, off, N, chunk, sub, BC):
    """(own, other, unit) of each cell from a side's cell words and offsets."""
    nsub = -(-chunk // sub)
    run = np.repeat(np.arange(off.size - 1), np.diff(off))
    unit, col = run // (nsub * BC), run % BC
    assert np.array_equal(cell >> 24, col)  # each run holds its own column's cells
    assert np.array_equal((run // BC) % nsub, (cell & MASK) // sub)  # and its own sub-strip's
    own = (unit % (N // BC)) * BC + (cell >> 24)
    other = (unit // (N // BC)) * chunk + (cell & MASK)
    return own, other, unit


@pytest.mark.parametrize("name,k,split", WALKS)
def test_walk_tables_match_numpy(name, k, split):
    spec, Lt, Rt, At = _inputs(name, k)
    K, U = Lt.shape
    I = Rt.shape[1]
    w = dense_fused.resident_walk(At, K, split)
    G, chunk_l, s_l, chunk_r, s_r = w.split
    assert (chunk_l, s_l, chunk_r, s_r) == (split or dense_fused.resident_split(K, U, I))
    assert G == dense_fused._lanes_per_column(K) and w.sub == dense_fused.sub_strip(G) and w.shape == (I, U)
    BC = dense_fused.UNIT_COLS // G
    want = _reference(At.numpy(), w.split, w.sub)
    n = int((At != 0).sum())
    caps, unit_cells = [], []
    for side, N, M, chunk, S in (("l", U, I, chunk_l, s_l), ("r", I, U, chunk_r, s_r)):
        cell, val, off, order = (getattr(w, f"{side}_{f}").numpy() for f in ("cell", "val", "off", "order"))
        assert cell.size == val.size == n and off[0] == 0 and off[-1] == n and np.all(np.diff(off) >= 0)
        assert off.size == S * (N // BC) * -(-chunk // w.sub) * BC + 1
        own, other, unit = _decode(cell, off, N, chunk, w.sub, BC)
        got = list(zip(own, other, val))
        # Each rated cell once, in each chain's order: a column's cells in a
        # chunk by ascending row.
        assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want[side]]
        assert np.array_equal(val, [x for *_, x in want[side]])
        # Padding columns hold no cell.
        assert np.all(own < (spec.users if side == "l" else spec.items))
        # Each unit's columns by descending degree, ties in ascending order.
        deg = np.bincount(unit * BC + (cell >> 24), minlength=S * (N // BC) * BC).reshape(-1, BC)
        for u, ranks in enumerate(order.reshape(-1, BC)):
            assert list(ranks) == sorted(range(BC), key=lambda c: (-deg[u, c], c))
        caps.append(np.diff(off[::BC]).max())
        unit_cells.append(np.bincount(unit, minlength=S * (N // BC)))
    assert w.cap == max(caps)
    # The units of both sides (the dl side's first), heaviest first.
    cells = np.concatenate(unit_cells)
    assert list(w.units.numpy()) == sorted(range(cells.size), key=lambda u: (-cells[u], u))


@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_walk_tables_take_every_a_storage(a_dtype):
    _, Lt, _, A8 = _inputs("500x900")
    _, _, _, A = _inputs("500x900", a_dtype=a_dtype)
    w8, w = (dense_fused.resident_walk(x, Lt.shape[0]) for x in (A8, A))
    assert all(torch.equal(a, b) for a, b in zip(w8.tables, w.tables))


def test_walk_bytes_count_the_tables():
    spec, Lt, Rt, At = _inputs("500x900")
    K, U = Lt.shape
    w = dense_fused.resident_walk(At, K)
    got = sum(t.numel() * t.element_size() for t in w.tables)
    assert dense_fused.walk_bytes(K, U, Rt.shape[1], spec.nnz) == got


@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_walk_step_matches_resident_twin(precision, a_dtype, k):
    # The small spec the card holds B1 to (200 x 300), k = 40 at G = 2.
    spec = generate_instance(200, 300, k, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    Lt, Rt = torch.from_numpy(Lt), torch.from_numpy(Rt)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, "cpu")
    w = dense_fused.resident_walk(At, K)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    got = dense_fused.walk_train_plain(Lt, Rt, w, **kw)
    want = dense_fused.resident_train_plain(Lt, Rt, At, **kw)
    assert checks.factor_rel(got, want) <= checks.FACTOR_RTOL[precision]
    assert all(bool(torch.isfinite(x).all()) for x in got)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("name", ["32x40", "32x700"])
def test_walk_step_matches_jax(name, precision):
    spec = generate_instance(**SPECS[name])
    Lt, Rt, A, _ = pallas_dense.pad_for_pallas(spec, strip=128)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    Lj, Rj = pallas_dense.resident_train(Lt, Rt, A, strip=128, **kw)
    _, _, tj = pallas_dense.resident_train_top1(Lt, Rt, A, strip=128, items_true=spec.items, **kw)
    At = torch.from_numpy(np.array(A))
    w = dense_fused.resident_walk(At, Lt.shape[0])
    Lp, Rp = dense_fused.walk_train_plain(torch.from_numpy(np.array(Lt)), torch.from_numpy(np.array(Rt)), w, **kw)
    # Same math, f32 sums in another order: a few f32 ulps of the factors.
    np.testing.assert_allclose(Lp.numpy(), np.asarray(Lj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=1e-5, atol=1e-7)
    top = dense_fused.plain_top1(Lp, Rp, At, precision, spec.items)
    np.testing.assert_array_equal(top.numpy(), np.asarray(tj))


def _edge_At():
    """A^T (384 items, 256 users) with user 5, users 156 on, items 64-127
    (one item chunk of 64) and items 284 on unrated: a column with no
    cells, a chunk with none, and empty last segments on both sides."""
    g = torch.Generator().manual_seed(3)
    At = torch.zeros((384, 256), dtype=torch.int8)
    rated = torch.rand((284, 156), generator=g) < 0.08
    At[:284, :156] = torch.randint(1, 11, rated.shape, generator=g, dtype=torch.int8) * rated
    At[:, 5] = 0
    At[64:128] = 0
    return At


EDGE_SPLIT = (64, 6, 64, 4)  # chunk_l, s_l (items), chunk_r, s_r (users) at K = 32


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_walk_with_empty_columns_chunks_and_last_segments(precision):
    At = _edge_At()
    g = torch.Generator().manual_seed(4)
    Lt, Rt = (0.1 * torch.rand((32, n), generator=g) for n in (256, 384))
    w = dense_fused.resident_walk(At, 32, EDGE_SPLIT)
    nnz = int((At != 0).sum())
    # The empty chunk's units, and the last unit of each side, hold nothing.
    BC = dense_fused.UNIT_COLS  # G = 1
    l_off, r_off = w.l_off.long(), w.r_off.long()
    assert int(l_off[-1]) == int(r_off[-1]) == nnz
    unit_cells = torch.diff(l_off[::BC])  # one sub-strip a unit (chunk 64 = SR)
    assert unit_cells.view(6, 256 // BC)[1].sum() == 0 and unit_cells[-1] == 0
    assert torch.diff(r_off[::BC])[-1] == 0
    own, _, _ = _decode(w.l_cell.numpy(), w.l_off.numpy(), 256, 64, w.sub, BC)
    assert 5 not in set(own.tolist())
    kw = dict(iters=3, alpha2=0.002, precision=precision)
    got = dense_fused.walk_train_plain(Lt, Rt, w, **kw)
    want = dense_fused.resident_train_plain(Lt, Rt, At, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    # A column with no cells gains exactly nothing.
    assert torch.equal(got[0][:, 5], Lt[:, 5]) and torch.equal(got[0][:, 156:], Lt[:, 156:])
    assert torch.equal(got[1][:, 64:128], Rt[:, 64:128]) and torch.equal(got[1][:, 284:], Rt[:, 284:])


def test_wrappers_refuse_a_walk_of_another_split_or_shape():
    At = _edge_At()
    Lt, Rt = torch.zeros((32, 256)), torch.zeros((32, 384))
    w = dense_fused.resident_walk(At, 32, EDGE_SPLIT)
    kw = dict(iters=1, alpha2=0.1)
    # The walk's own split is taken, and the twin runs on the CPU.
    L, R = dense_fused.resident_train(Lt, Rt, At, walk=w, split=EDGE_SPLIT, **kw)
    assert torch.equal(L, Lt) and torch.equal(R, Rt)
    other = (128, 3, 64, 4)
    with pytest.raises(ValueError, match="built for split"):
        dense_fused.resident_train(Lt, Rt, At, walk=w, split=other, **kw)
    with pytest.raises(ValueError, match="built for split"):
        dense_fused.resident_train_top1(Lt, Rt, At, walk=w, split=other, items_true=384, **kw)
    with pytest.raises(ValueError, match="built for split"):  # the default split is another
        dense_fused.resident_train(Lt, Rt, At, walk=w, **kw)
    wider = torch.zeros((384, 384), dtype=torch.int8)  # another A^T shape, same chunks
    with pytest.raises(ValueError, match="built for split"):
        dense_fused._walk_for(w, wider, 32, EDGE_SPLIT)
    with pytest.raises(ValueError, match="does not cut"):
        dense_fused.resident_train(Lt, Rt, At, split=(64, 5, 64, 4), **kw)
    with pytest.raises(ValueError, match="unknown form"):
        dense_fused.resident_train(Lt, Rt, At, form="graph", **kw)


def test_resident_split_is_the_dense_forms():
    # The sparse form keeps the dense form's chunks: instML100k's padded shape.
    assert dense_fused.resident_split(32, 1024, 1792) == (64, 28, 64, 16)
    chunk_l, s_l, chunk_r, s_r = dense_fused.resident_split(32, 6144, 3968)
    assert (chunk_l, s_l, chunk_r, s_r) == (672, 6, 704, 9)


def test_clock_probe_marks_every_phase():
    # probes/resident_clocks.py marks the sparse kernel's phases by text
    # substitution: each mark must still find its one place in the source.
    from recsys_tpu_torch.probes import resident_clocks

    src = resident_clocks.instrumented_source()
    assert all(f"g_marks[blockIdx.x * 8 + {j}]" in src for j in range(8))
    assert "g_smem_floor" in src and "rs_set_marks" in src
