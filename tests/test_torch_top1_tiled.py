"""B4's tiled form (``top1_tiled`` in recsys_tpu_torch/csrc/dense_fused.cu,
``dense_stream.stream_top1``) on the CPU: a plain torch model of its order
-- item chunks, each chunk's tiles of 16 * TI items split among 16 threads
of TI items, a strictly-greater running max per thread over ascending
items, the threads merged by (higher score, then lower index) and the
chunks by a strictly-greater merge in ascending order -- against
``dense_fused.plain_top1`` and the JAX ``pallas_dense.stream_top1``
(interpret mode, as tests/test_pallas.py runs it); the wrapper's checks.

The CUDA kernel is held against the dense form it replaced in raw bits of
each user's index and best score in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.ops import dense_fused, dense_stream

MODES = ["highest", "bf16x3", "default"]
# Users and the thread columns of a block (csrc/dense_fused.cu, TBU and 16 x 16 threads).
THREADS = 16


def _items_a_thread(precision: str, K: int) -> int:
    """TopTile<P, G>::TI: 2 in bf16x3 or for K > 64 (G >= 4), else 4."""
    return 2 if precision == "bf16x3" or K > 64 else 4


def _tiled_model(b: torch.Tensor, split, ti: int):
    """The tiled form's (top1 (1, U) int32, best (U,)) from masked scores
    b (I, U), in its order of comparisons."""
    chunk, S = split
    I, U = b.shape
    per_tile = THREADS * ti
    best = torch.full((U,), -torch.inf)
    top = torch.zeros(U, dtype=torch.int64)
    for s in range(S):
        lo, hi = s * chunk, min(I, s * chunk + chunk)
        tb = torch.full((THREADS, U), -torch.inf)
        tix = torch.zeros((THREADS, U), dtype=torch.int64)
        for i in range(lo, hi):  # ascending: each thread's items in order
            t = (i - lo) % per_tile // ti
            take = b[i] > tb[t]
            tb[t] = torch.where(take, b[i], tb[t])
            tix[t] = torch.where(take, i, tix[t])
        cb, ci = tb[0], tix[0]
        for t in range(1, THREADS):  # the threads of a user: any order
            take = (tb[t] > cb) | ((tb[t] == cb) & (tix[t] < ci))
            cb, ci = torch.where(take, tb[t], cb), torch.where(take, tix[t], ci)
        take = cb > best  # the chunks: ascending, strictly greater
        best, top = torch.where(take, cb, best), torch.where(take, ci, top)
    return top.to(torch.int32)[None, :], best


def _inputs(k: int, seed: int = 1):
    """(spec, Lt, Rt, A) numpy: 32 users x 700 items padded to 128 x 768, K
    = k rounded up to 8, factors moved far from the initial ones."""
    spec = generate_instance(32, 700, k, 2, 8, iters=4, alpha=0.01, seed=7)
    Lt, Rt, A, _ = pallas_dense.pad_for_pallas(spec, strip=128)
    rng = np.random.default_rng(seed)
    Lt = (Lt + 0.1 * rng.standard_normal(Lt.shape) * (Lt != 0)).astype(np.float32)
    Rt = (Rt + 0.1 * rng.standard_normal(Rt.shape) * (Rt != 0)).astype(np.float32)
    return spec, Lt, Rt, A


def _t(x):
    return torch.from_numpy(np.array(x))


def _model_top1(Lt, Rt, A, precision, items_true, split=None):
    K, U = Lt.shape
    I = Rt.shape[1]
    split = split or dense_fused.top1_split(U, I)
    b = dense_fused.plain_scores(_t(Lt), _t(Rt), _t(A), precision, items_true)
    return _tiled_model(b, split, _items_a_thread(precision, K))


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("k", [10, 40, 256])
def test_tiled_order_matches_plain_and_jax(k, precision):
    spec, Lt, Rt, A = _inputs(k)
    want = pallas_dense.stream_top1(Lt, Rt, A, strip=128, precision=precision, items_true=spec.items)
    plain = dense_fused.plain_top1(_t(Lt), _t(Rt), _t(A), precision, spec.items)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
    # the engine's split (a chunk a tile here) and three chunks of two tiles
    for split in (None, (256, 3)):
        top, best = _model_top1(Lt, Rt, A, precision, spec.items, split)
        assert torch.equal(top, plain), split
    # the wrapper on the CPU: the twin, with each user's best score
    got, got_best = dense_stream.stream_top1_scores(_t(Lt), _t(Rt), _t(A), precision=precision,
                                                    items_true=spec.items)
    assert torch.equal(got, plain) and torch.equal(got_best[0], best)


def test_all_ones_tie_lowest_index_wins():
    K, U = 8, 128
    ones = np.ones((K, U), np.float32)
    zeros = np.zeros((U, U), np.float32)
    want = pallas_dense.stream_top1(ones, ones, zeros, strip=128, items_true=U)
    for split in (None, (64, 2)):
        top, best = _model_top1(ones, ones, zeros, "highest", U, split)
        assert torch.equal(top, torch.zeros((1, U), dtype=torch.int32))
        assert bool((best == K).all())
    np.testing.assert_array_equal(np.asarray(want), np.zeros((1, U), np.int32))


@pytest.mark.parametrize("precision", MODES)
def test_items_past_items_true_never_win(precision):
    spec, Lt, Rt, A = _inputs(10)
    Rt[:, 650:] = 10.0  # the highest scores lie at items 650 and on
    items_true = 650
    want = pallas_dense.stream_top1(Lt, Rt, A, strip=128, precision=precision, items_true=items_true)
    top, _ = _model_top1(Lt, Rt, A, precision, items_true)
    assert int(top.max()) < items_true
    np.testing.assert_array_equal(top.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dense_fused.plain_top1(_t(Lt), _t(Rt), _t(A), precision, items_true).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("precision", MODES)
def test_a_rated_best_cell_never_wins(precision):
    spec, Lt, Rt, A = _inputs(40, seed=3)
    b = dense_fused.plain_scores(_t(Lt), _t(Rt), _t(A), precision, spec.items)
    first = torch.argmax(b, dim=0)
    A = A.copy()
    A[first.numpy(), np.arange(A.shape[1])] = 3.0  # each user's best cell is now rated
    top, _ = _model_top1(Lt, Rt, A, precision, spec.items)
    assert not bool((top[0].long() == first).any())
    assert torch.equal(top, dense_fused.plain_top1(_t(Lt), _t(Rt), _t(A), precision, spec.items))
    if precision != "default":
        # In `default` XLA and torch sum the bf16 products in other orders,
        # and a runner-up near-tie here resolves differently between them.
        want = pallas_dense.stream_top1(Lt, Rt, A, strip=128, precision=precision, items_true=spec.items)
        np.testing.assert_array_equal(top.numpy(), np.asarray(want))


def test_top1_split_cuts_items_into_tiles():
    for U, I in ((1024, 1792), (6144, 3968), (128, 128), (256, 10240)):
        chunk, S = dense_fused.top1_split(U, I)
        assert chunk % dense_fused.TOP1_ITEMS == 0 and S == -(-I // chunk) and (S - 1) * chunk < I
    # gen-instML1M: 96 user blocks, the grid about one wave of 3 x 132 blocks
    assert dense_fused.top1_split(6144, 3968) == (1024, 4)


def test_wrapper_checks_and_no_launch_on_cpu():
    spec, Lt, Rt, A = _inputs(10)
    args = (_t(Lt), _t(Rt), _t(A))
    kw = dict(items_true=spec.items)
    with pytest.raises(ValueError, match="unknown top-1 form"):
        dense_stream.stream_top1_scores(*args, form="warp", **kw)
    with pytest.raises(ValueError, match="unknown precision"):
        dense_stream.stream_top1_dense(*args, precision="tf32", **kw)
    meta = [x.to("meta") for x in args]
    for call in (lambda a: dense_stream.stream_top1(*a, **kw), lambda a: dense_stream.stream_top1_dense(*a, **kw),
                 lambda a: dense_stream.stream_top1_scores(*a, form="dense", **kw)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call(meta)
    before = dense_stream.stream_top1.launches, dense_stream.stream_top1_dense.launches
    want = dense_fused.plain_top1(*args, "highest", spec.items)
    assert torch.equal(dense_stream.stream_top1(*args, **kw), want)
    assert torch.equal(dense_stream.stream_top1_dense(*args, **kw), want)
    for form in ("tiled", "dense"):
        assert torch.equal(dense_stream.stream_top1_scores(*args, form=form, **kw)[0], want)
    assert (dense_stream.stream_top1.launches, dense_stream.stream_top1_dense.launches) == before


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("k", [10, 40, 256])
@pytest.mark.parametrize("kind", ["stream", "resident"])
def test_plan_counts_what_the_route_allocates(kind, k, monkeypatch):
    # dense_plan's bytes hold every buffer of the route's kernels on an
    # H100, the tiled top-1's in each precision among them.
    monkeypatch.setattr(dense_stream, "_sms", lambda dev: dense_fused.H100_SMS)
    spec = generate_instance(200, 300, k, 2, 30, iters=2, alpha=0.001, seed=5)
    plan = trainer.dense_plan(spec, a_max_bytes=0 if kind == "stream" else 1 << 62)
    assert plan.kind == kind
    K, U, I = plan.K, plan.U, plan.I
    At = dense_fused.device_dense_AT(spec, U, I, plan.a_dtype, "cpu")
    factors = (torch.empty((K, U)), torch.empty((K, I)))
    if kind == "stream":
        split, outs, parts = dense_stream._train_buffers(K, U, I, "cpu")
        walk = dense_stream.walk_tables(At, split, dense_fused.sub_strip(split[0]))
        train = _nbytes(*outs, *parts, *walk.tables)
        assert dense_stream.stream_walk_bytes(K, U, I, spec.nnz) == _nbytes(*walk.tables)
    else:
        split = dense_fused.resident_split(K, U, I)
        walk = dense_fused.resident_walk(At, K)
        train = _nbytes(*dense_fused._resident_buffers(K, U, I, "cpu", split), *walk.tables)
    S = dense_fused.top1_split(U, I)[1]
    for precision in MODES:
        top1 = _nbytes(*dense_fused.top1_buffers(K, U, I, S, "cpu", precision))
        assert top1 == dense_fused.top1_bytes(K, U, I, precision)
        assert plan.device_bytes >= _nbytes(At, *factors) + train + top1, precision
    # the operands: none in `highest`, one table in `default`, hi and lo in `bf16x3`
    ops = [dense_fused.top1_buffers(K, U, I, S, "cpu", p)[0].numel() for p in MODES]
    assert ops == [0, 2 * K * (U + I), K * (U + I)]
