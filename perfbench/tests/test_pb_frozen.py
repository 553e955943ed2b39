"""The frozen copies: the roofline arithmetic against hand counts, the
glibc draw against the program's generator, glibc's first draws and the
recurrence word by word (``glibc.random_words_loop``)."""

import numpy as np
import pytest

from perfbench import glibc, roofline


def test_iteration_work_by_hand():
    # 10 ratings, k = 2, 3 rated users and 4 rated items, float32:
    # 6·2·10 = 120 FLOP; 10·(4 + 4) + 2·(3 + 4)·2·4 = 80 + 112 = 192 bytes.
    assert roofline.iteration_work(10, 2, 3, 4, "float32") == (120.0, 192.0)
    # float64: 10·(8 + 4) + 2·7·2·8 = 120 + 224 = 344 bytes.
    assert roofline.iteration_work(10, 2, 3, 4, "float64") == (120.0, 344.0)


def test_floor_names_its_bound():
    assert roofline.floor_seconds(67e12, 0.0, "float32") == (1.0, "operations")
    assert roofline.floor_seconds(0.0, 3.35e12, "float64") == (1.0, "bytes")


def test_job_flops_and_rated_rows():
    assert roofline.job_flops(nnz=10, k=2, iters=3, users=4, items=5) == 6 * 2 * 10 * 3 + 2 * 2 * 4 * 5
    rows, cols = np.array([0, 0, 2]), np.array([1, 4, 1])
    assert roofline.rated_rows(rows, cols, 3, 6) == (2, 2)


def test_ml100k_floor_matches_the_program_copy():
    from recsys_tpu_torch.bench import roofline as program

    class Spec:  # the program's count reads rated rows off these two
        features, nnz, rated_users, rated_items = 30, 100_000, 943, 1682

    for dtype in ("float32", "float64", "bfloat16"):
        assert roofline.iteration_work(100_000, 30, 943, 1682, dtype) == program.iteration_work(Spec, dtype)


def test_glibc_words_are_glibcs():
    # glibc 2.x: srandom(1); random() -> 1804289383, 846930886, 1681692777, ...
    assert glibc.random_words(3).tolist() == [1804289383, 846930886, 1681692777]
    assert glibc.random_words_loop(3).tolist() == [1804289383, 846930886, 1681692777]


# A block of 1500 words: past the table's host rows (1024), so the table
# doubles once; the cases are the window's edges and the blocks' edges.
STREAM_BLOCK = 1500


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 33, 34, 35, STREAM_BLOCK - 1, STREAM_BLOCK, STREAM_BLOCK + 1,
                               3 * STREAM_BLOCK + 7])
def test_the_stream_equals_the_loop(monkeypatch, n, seed):
    monkeypatch.setattr(glibc, "HOST_BLOCK", STREAM_BLOCK)
    got = glibc.random_words(n, seed)
    want = glibc.random_words_loop(n, seed)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("users,items,k", [(3, 4, 2), (943, 1682, 30), (6040, 3952, 30)])
def test_initial_factors_equal_the_programs(users, items, k):
    from recsys_tpu_torch.models.mf import init_factors

    L, R = glibc.initial_factors(users, items, k)
    draws = glibc.random_words_loop((users + items) * k) / glibc.RAND_MAX / k
    assert np.array_equal(L, draws[: users * k].reshape(users, k))
    assert np.array_equal(R, draws[users * k:].reshape(k, items).T)
    want = init_factors(users, items, k)
    assert np.array_equal(L, want.L) and np.array_equal(R, want.R)
    Lt, Rt = glibc.initial_factors(users, items, k, device="cpu")
    assert np.array_equal(Lt.numpy(), L) and np.array_equal(Rt.numpy(), R)
