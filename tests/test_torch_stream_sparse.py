"""B3's sparse form on the CPU: the walk's tables (``walk_tables``) against
a numpy reference, and a plain torch step over them (``walk_train_plain``)
against ``stream_train_plain`` and the JAX ``pallas_dense.stream_train``
(interpret mode, as tests/test_pallas.py runs it).

The CUDA kernel that walks these tables is held against the dense form bit
for bit in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.ops import dense_fused, dense_stream

SPECS = {
    "32x40": dict(users=32, items=40, features=10, min_nz_row=2, max_nz_row=8, iters=5, alpha=0.01, seed=11),
    "32x700": dict(users=32, items=700, features=8, min_nz_row=2, max_nz_row=8, iters=4, alpha=0.01, seed=7),
    # 500 users -> 512 (4 blocks of 128, clusters of 2 at grid (3, 2)), 900
    # items in many chunks, k = 40 -> G = 2 at the k > 32 case below.
    "500x900": dict(users=500, items=900, features=12, min_nz_row=2, max_nz_row=90, iters=3, alpha=0.001, seed=3),
}
# (spec, k, grid): several chunks and several user groups in each.
WALKS = [("32x40", None, (3, 16)), ("32x700", None, (3, 16)), ("500x900", None, (3, 2)),
         ("500x900", 40, (3, 2)), ("500x900", None, (40, 16))]


def _inputs(name, k=None, a_dtype=torch.int8):
    spec = generate_instance(**{**SPECS[name], **({"features": k} if k else {})})
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, "cpu")
    return spec, torch.from_numpy(Lt), torch.from_numpy(Rt), At


def _reference(At: np.ndarray, split, sub):
    """The walk's two orders in numpy: (user order, item order) as lists
    of (item, user, value)."""
    G, C, chunk, S = split
    BC = 128 // G
    r, c = np.nonzero(At)
    v = At[r, c].astype(np.float32) * (0.5 if At.dtype == np.int8 else 1.0)
    tile = (r // chunk) * (At.shape[1] // BC) + c // BC
    user = np.lexsort((r, c, (r % chunk) // sub, tile))  # by (tile, sub-strip, user, item)
    item = np.lexsort((c, r, tile))  # by (tile, item, user)
    return [(r[j], c[j], v[j]) for j in user], [(r[j], c[j], v[j]) for j in item]


@pytest.mark.parametrize("name,k,grid", WALKS)
def test_walk_tables_match_numpy(name, k, grid):
    _, Lt, Rt, At = _inputs(name, k)
    K, U = Lt.shape
    I = Rt.shape[1]
    split = dense_stream.stream_split(K, U, I, grid=grid)
    G, C, chunk, S = split
    sub = dense_stream.sub_strip(G)
    BC, nb = 128 // G, U // (128 // G)
    nsub = -(-chunk // sub)
    w = dense_stream.walk_tables(At, split, sub)
    want_user, want_item = _reference(At.numpy(), split, sub)
    n = len(want_user)
    assert n == int((At != 0).sum()) and w.u_cell.numel() == w.i_user.numel() == n

    # Decode the user order from the offsets: (tile, sub-strip, user) runs.
    run = np.repeat(np.arange(S * nb * nsub * BC), np.diff(w.u_off.numpy()))
    tile, ul = run // (nsub * BC), run % BC
    item = (tile // nb) * chunk + (w.u_cell.numpy() & ((1 << 24) - 1))
    user = (tile % nb) * BC + (w.u_cell.numpy() >> 24)
    assert np.array_equal(ul, w.u_cell.numpy() >> 24)
    got_user = list(zip(item, user, w.u_val.numpy()))
    assert [(a, b) for a, b, _ in got_user] == [(a, b) for a, b, _ in want_user]
    assert np.array_equal([x for *_, x in got_user], [x for *_, x in want_user])

    # The item order, and its map onto the user order.
    runs = np.repeat(np.arange(S * nb * chunk), np.diff(w.i_off.numpy()))
    item_i = (runs // (chunk * nb)) * chunk + runs % chunk
    user_i = (runs // chunk % nb) * BC + w.i_user.numpy()
    assert list(zip(item_i, user_i)) == [(a, b) for a, b, _ in want_item]
    cell = w.i_cell.numpy()
    assert sorted(cell) == list(range(n))  # each cell once
    assert np.array_equal(item[cell], item_i) and np.array_equal(user[cell], user_i)

    # Degree orders: permutations, descending degree (per tile; per
    # sub-strip for items), ties in ascending order.
    udeg = np.bincount(tile * BC + ul, minlength=S * nb * BC).reshape(-1, BC)
    uo = w.u_order.numpy().reshape(-1, BC)
    for t in range(S * nb):
        assert sorted(uo[t]) == list(range(BC))
        assert list(uo[t]) == sorted(range(BC), key=lambda u: (-udeg[t, u], u))
    ideg = np.diff(w.i_off.numpy()).reshape(-1, chunk)
    io = w.i_order.numpy().reshape(-1, chunk)
    for t in range(S * nb):
        assert list(io[t]) == sorted(range(chunk), key=lambda r: (r // sub, -ideg[t, r], r))
    segments = np.diff(w.u_off.numpy()[::BC])
    assert w.cap == segments.max()


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("name,k,grid", WALKS)
def test_walk_step_matches_stream_twin(name, k, grid, precision):
    spec, Lt, Rt, At = _inputs(name, k)
    K, U = Lt.shape
    split = dense_stream.stream_split(K, U, Rt.shape[1], grid=grid)
    w = dense_stream.walk_tables(At, split, dense_stream.sub_strip(split[0]))
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    got = dense_stream.walk_train_plain(Lt, Rt, w, **kw)
    want = dense_stream.stream_train_plain(Lt, Rt, At, **kw)
    # The same function, f32 sums grouped otherwise: a few f32 ulps.
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("a_dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_walk_tables_take_every_a_storage(a_dtype):
    _, Lt, Rt, A8 = _inputs("32x700")
    _, _, _, A = _inputs("32x700", a_dtype=a_dtype)
    split = dense_stream.stream_split(*Lt.shape, Rt.shape[1])
    w8, w = (dense_stream.walk_tables(x, split, 64) for x in (A8, A))
    assert all(torch.equal(a, b) for a, b in zip(w8.tables, w.tables))


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("name", ["32x40", "32x700"])
def test_walk_step_matches_jax(name, precision):
    spec = generate_instance(**SPECS[name])
    Lt, Rt, A, _ = pallas_dense.pad_for_pallas(spec, strip=128)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision)
    Lj, Rj = pallas_dense.stream_train(Lt, Rt, A, strip=128, **kw)
    At = torch.from_numpy(np.array(A))
    split = dense_stream.stream_split(Lt.shape[0], Lt.shape[1], Rt.shape[1])
    w = dense_stream.walk_tables(At, split, dense_stream.sub_strip(split[0]))
    Lp, Rp = dense_stream.walk_train_plain(torch.from_numpy(np.array(Lt)), torch.from_numpy(np.array(Rt)), w, **kw)
    np.testing.assert_allclose(Lp.numpy(), np.asarray(Lj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), rtol=1e-5, atol=1e-7)


def test_walk_tables_refuse_too_many_items():
    At = torch.zeros((1 << 24, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="fewer than"):
        dense_stream.walk_tables(At, (1, 1, 32, 1), 64)


def _empty_tail_At():
    """A^T (384 items, 256 users) whose last user block (128 users) and last
    100 items hold no rated cell: the walk's last segments are empty."""
    g = torch.Generator().manual_seed(3)
    At = torch.zeros((384, 256), dtype=torch.int8)
    rated = torch.rand((284, 128), generator=g) < 0.05
    At[:284, :128] = torch.randint(1, 11, rated.shape, generator=g, dtype=torch.int8) * rated
    return At


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_walk_with_empty_last_segments(precision):
    At = _empty_tail_At()
    g = torch.Generator().manual_seed(4)
    Lt, Rt = (0.1 * torch.rand((32, n), generator=g) for n in (256, 384))
    split = dense_stream.stream_split(32, 256, 384, grid=(3, 2))
    sub = dense_stream.sub_strip(split[0])
    w = dense_stream.walk_tables(At, split, sub)
    nnz = int((At != 0).sum())
    nsub = -(-split[2] // sub)
    assert int(w.u_off[-1]) == int(w.i_off[-1]) == nnz == w.u_cell.numel()
    # The last tile's segments begin at nnz and hold nothing.
    assert (w.u_off[-nsub * 128 - 1:] == nnz).all() and (w.i_off[-split[2] - 1:] == nnz).all()
    kw = dict(iters=3, alpha2=0.002, precision=precision)
    got = dense_stream.walk_train_plain(Lt, Rt, w, **kw)
    want = dense_stream.stream_train_plain(Lt, Rt, At, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_walk_for_another_split_is_refused():
    At = _empty_tail_At()
    split = dense_stream.stream_split(32, 256, 384, grid=(3, 2))
    w = dense_stream.walk_tables(At, split, dense_stream.sub_strip(split[0]))
    assert dense_stream._walk_for(w, At, 32, split) is w
    other = dense_stream.stream_split(32, 256, 384, grid=(3, 1))
    assert other != split
    with pytest.raises(ValueError, match="built for split"):
        dense_stream._walk_for(w, At, 32, other)
