"""The cells' data: deterministic per seed, at the configurations' counts."""

import numpy as np
import pytest

from perfbench import datagen, registry
from perfbench.tests.pb_helpers import REPO


def _cfg(name):
    return registry.load_json(f"{REPO}/perfbench/configs/{name}.json")


@pytest.fixture(scope="module")
def ml1m():
    return {s: datagen.make(_cfg("ml1m"), s, REPO) for s in (7, 2**31 + 5)}


def test_ml1m_counts_and_degree_floor(ml1m):
    cfg = _cfg("ml1m")
    for inst in ml1m.values():
        assert (inst.users, inst.items, inst.nnz) == (6040, 3952, 1_000_209)
        deg = np.bincount(inst.rows, minlength=inst.users)
        assert deg.min() >= cfg["data"]["min_user_ratings"] == 20
        assert np.unique(inst.cols).size == cfg["data"]["rated_items"] == 3706
        assert inst.cols.max() < 3952
        key = inst.rows * inst.items + inst.cols
        assert np.all(np.diff(key) > 0)  # row-major, no pair twice
        assert set(np.unique(inst.vals)) <= {1.0, 2.0, 3.0, 4.0, 5.0}


def test_ml1m_is_skewed_like_movielens(ml1m):
    inst = ml1m[7]
    pop = np.sort(np.bincount(inst.cols))[::-1]
    assert pop[:37].sum() > 0.04 * inst.nnz  # the top 1% of items hold over 4% of the ratings
    assert np.bincount(inst.rows).max() > 5 * np.median(np.bincount(inst.rows))


def test_ml1m_deterministic_per_seed(ml1m):
    again = datagen.make(_cfg("ml1m"), 7, REPO)
    assert np.array_equal(again.rows, ml1m[7].rows) and np.array_equal(again.cols, ml1m[7].cols)
    assert np.array_equal(again.vals, ml1m[7].vals)
    assert not np.array_equal(ml1m[7].cols, ml1m[2**31 + 5].cols)


def test_ml100k_seed0_is_the_file_and_seeds_relabel():
    cfg = _cfg("ml100k")
    with open(f"{REPO}/{cfg['data']['file']}", "rb") as f:
        src = datagen.parse_in(f.read())
    zero = datagen.make(cfg, 0, REPO)
    assert np.array_equal(zero.rows, src.rows) and np.array_equal(zero.cols, src.cols)
    a, b = datagen.make(cfg, 99, REPO), datagen.make(cfg, 99, REPO)
    assert np.array_equal(a.cols, b.cols) and np.array_equal(a.rows, b.rows)
    assert not np.array_equal(a.cols, src.cols)
    assert sorted(np.bincount(a.rows)) == sorted(np.bincount(src.rows))
    assert sorted(np.bincount(a.cols, minlength=a.items)) == sorted(np.bincount(src.cols, minlength=a.items))
    assert np.array_equal(np.sort(a.vals), np.sort(src.vals))
    assert np.all(np.diff(a.rows * a.items + a.cols) > 0)


def test_sha256_is_checked(tmp_path):
    cfg = _cfg("ml100k")
    cfg["data"]["sha256"] = "0" * 64
    with pytest.raises(ValueError, match="sha256"):
        datagen.make(cfg, 0, REPO)


def test_the_written_file_parses_back_in_the_program():
    from recsys_tpu_torch.io.parser import parse_in_bytes

    inst = datagen.make(_cfg("ml100k"), 5, REPO)
    spec = parse_in_bytes(datagen.format_in(inst).encode())
    assert (spec.users, spec.items, spec.features, spec.iters, spec.alpha) == (943, 1682, 30, 3000, 1e-4)
    assert np.array_equal(spec.rows, inst.rows) and np.array_equal(spec.cols, inst.cols)
    assert np.array_equal(spec.vals, inst.vals)
