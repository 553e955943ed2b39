"""The recipe ``uniform_rows`` (configuration ``inst1e6``): exactly the
configuration's count of ratings for every seed, 1-3 distinct items a user,
sorted row-major, values 1-5, deterministic per seed; at the full size and
at a small copy."""

import numpy as np
import pytest

from perfbench import datagen, registry
from perfbench.tests.pb_helpers import REPO

SEEDS = (1, 2**31 + 12345, 3_000_000_077)


def _cfg(**small):
    cfg = registry.load_json(f"{REPO}/perfbench/configs/inst1e6.json")
    cfg.update(small)
    return cfg


def _small():
    return _cfg(users=2000, items=100, ratings=4000)


@pytest.fixture(scope="module")
def full():
    return {s: datagen.make(_cfg(), s, REPO) for s in SEEDS}


def _holds_the_configuration(inst, cfg):
    datagen.check_header(cfg, inst)  # the count of ratings included
    d = cfg["data"]
    deg = np.bincount(inst.rows, minlength=inst.users)
    assert deg.min() >= d["min_user_ratings"] == 1 and deg.max() <= d["max_user_ratings"] == 3
    assert deg.sum() == cfg["ratings"] and inst.cols.min() >= 0 and inst.cols.max() < inst.items
    assert np.all(np.diff(inst.rows * inst.items + inst.cols) > 0)  # row-major, items distinct within a row
    assert set(np.unique(inst.vals)) == {1.0, 2.0, 3.0, 4.0, 5.0}


@pytest.mark.parametrize("seed", SEEDS)
def test_the_full_instance_holds_the_configuration(full, seed):
    cfg = _cfg()
    assert (cfg["users"], cfg["items"], cfg["ratings"], cfg["features"]) == (1_000_000, 100, 2_000_000, 700)
    _holds_the_configuration(full[seed], cfg)


def test_the_full_instance_draws_items_and_counts_uniformly(full):
    for inst in full.values():
        per_item = np.bincount(inst.cols, minlength=inst.items)
        assert np.abs(per_item - inst.nnz / inst.items).max() < 8 * np.sqrt(inst.nnz / inst.items)
        share = np.bincount(np.bincount(inst.rows, minlength=inst.users), minlength=4)[1:] / inst.users
        assert np.abs(share - 1 / 3).max() < 0.01


@pytest.mark.parametrize("seed", (0, 7, 2**40 + 3, -5))
def test_a_small_copy_holds_it_and_repeats_per_seed(seed):
    cfg = _small()
    a, b = datagen.make(cfg, seed, REPO), datagen.make(cfg, seed, REPO)
    _holds_the_configuration(a, cfg)
    assert np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols) and np.array_equal(a.vals, b.vals)
    other = datagen.make(cfg, seed + 1, REPO)
    assert not np.array_equal(a.cols, other.cols)


@pytest.mark.parametrize("ratings", (2000, 6000, 2001, 5999))
def test_the_count_is_exact_at_its_edges(ratings):
    _holds_the_configuration(datagen.make(_cfg(users=2000, ratings=ratings), 11, REPO),
                             _cfg(users=2000, ratings=ratings))


def test_a_count_the_rows_cannot_hold_is_refused():
    with pytest.raises(ValueError, match="do not fit"):
        datagen.make(_cfg(users=2000, ratings=6001), 1, REPO)
