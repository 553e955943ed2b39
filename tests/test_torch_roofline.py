"""The port's roofline (``recsys_tpu_torch/bench/roofline.py``): one count
of work for every route, priced at the H100 data sheet's peaks, held
against a hand count at instML100k; the committed card rows stay under
the chip."""

import json
import pathlib
import re
from types import SimpleNamespace

import pytest

from helpers import FIXTURES
from recsys_tpu_torch.bench import roofline
from recsys_tpu_torch.bench.sweep import run_config
from recsys_tpu_torch.io.parser import load_problem

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROWS = ROOT / "bench_results_torch.jsonl"
ROUTES = ("pallas", "bell", "dense", "coo")
DTYPES = ("float32", "f32x3", "bfloat16", "float64")


@pytest.fixture(scope="module")
def ml100k():
    return load_problem(str(FIXTURES / "instML100k.in"))


@pytest.mark.parametrize("path", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_cost_model_is_the_hand_count_at_ml100k(ml100k, path, dtype):
    """instML100k: 943 users, 1682 items (every one rated), k=30, 100,000
    ratings.  An iteration is 6·30·100,000 FLOP; it moves each rating's
    value and int32 column once and L and R (943 + 1682 rows of 30) read and
    written once."""
    es = {"float32": 4, "f32x3": 4, "bfloat16": 2, "float64": 8}[dtype]
    peak = {"float32": 67e12, "f32x3": 67e12, "bfloat16": 989e12, "float64": 34e12}[dtype]
    flops = 6 * 30 * 100_000
    nbytes = 100_000 * (es + 4) + 2 * (943 + 1682) * 30 * es
    want = max(flops / peak, nbytes / 3.35e12)
    model, per_iter = roofline.train_cost_model(ml100k, run_config(dtype), path)
    assert per_iter == pytest.approx(want, rel=1e-12)
    assert model == ("operations" if flops / peak >= nbytes / 3.35e12 else "bytes")


def test_one_work_count_for_every_route():
    """The share reads the same work whatever route computes it; the host
    route has no model; f32x3 is float32 work."""
    for dims in [(943, 1682, 30, 100_000), (1_000_000, 100, 700, 1_998_967), (200, 10_000, 50, 39_819),
                 (6040, 3952, 30, 989_175)]:
        spec = SimpleNamespace(users=dims[0], items=dims[1], features=dims[2], nnz=dims[3], iters=3000,
                               rated_users=dims[0], rated_items=dims[1])
        for dtype in DTYPES:
            cfg = run_config(dtype)
            costs = {roofline.train_cost_model(spec, cfg, p) for p in ROUTES}
            assert len(costs) == 1, (dims, dtype, costs)
            assert roofline.train_cost_model(spec, cfg, "host") == (None, None)
        assert roofline.train_cost_model(spec, run_config("f32x3"), "bell") == \
            roofline.train_cost_model(spec, run_config("float32"), "bell")


def test_wide_factors_are_operations_bound_in_f64():
    """k = 700 on gen-inst1e6 in f64: 6·k FLOP a rating against (8 + 4) B a
    rating and the factors' traffic; the count says which binds."""
    spec = SimpleNamespace(users=1_000_000, items=100, features=700, nnz=1_998_967, iters=10,
                           rated_users=1_000_000, rated_items=100)
    flops, nbytes = roofline.iteration_work(spec, "float64")
    assert flops == 6.0 * 700 * 1_998_967
    assert nbytes == 1_998_967 * 12 + 2.0 * 1_000_100 * 700 * 8
    by, _ = roofline.train_cost_model(spec, run_config("float64"), "bell")
    assert by == ("operations" if flops / 34e12 >= nbytes / 3.35e12 else "bytes")


def test_rows_without_a_rating_are_not_priced():
    """inst1000-1e6-1000-1-3: 2,014 ratings over 1,000 x 1,000,000; an
    iteration touches only the rows that hold a rating, never the 1M-row
    R table whole."""
    spec = load_problem(str(FIXTURES / "inst1000-1e6-1000-1-3.in"))
    users, items = roofline.rated_rows(spec)
    assert users <= 1000 and items <= spec.nnz == 2014
    _, nbytes = roofline.iteration_work(spec, "float32")
    assert nbytes == 2014 * 8 + 2.0 * (users + items) * 1000 * 4
    dims = SimpleNamespace(users=spec.users, items=spec.items, features=1000, nnz=2014, iters=10,
                           rated_users=users, rated_items=items)
    assert roofline.iteration_work(dims, "float32") == roofline.iteration_work(spec, "float32")


def test_pct_of_roofline_keeps_the_formula(ml100k):
    _, per_iter = roofline.train_cost_model(ml100k, run_config("float32"), "pallas")
    model, pct = roofline.pct_of_roofline(ml100k, run_config("float32"), "pallas", 0.074)
    assert pct == round(100.0 * ml100k.iters * per_iter / 0.074, 1) and model == "bytes"
    assert roofline.pct_of_roofline(ml100k, run_config("float32"), "host", 0.074) == (None, None)
    assert roofline.pct_of_roofline(ml100k, run_config("float32"), "pallas", 0.0) == (None, None)


def test_the_bound_stays_the_data_sheet():
    """The card's measured copy rate reads below the data sheet's HBM rate,
    which stays the bound: a share can read low, never above the chip."""
    assert roofline.HBM_BYTES_S == 3.35e12
    assert 0 < roofline.MEASURED_HBM_GBPS * 1e9 < roofline.HBM_BYTES_S


def test_calibrate_takes_the_highest_card_share():
    rows = [
        {"backend": "cuda", "path": "bell", "dtype": "float64", "pct_roofline": 3.5},
        {"backend": "cuda", "path": "bell", "dtype": "float64", "pct_roofline": 7.25},
        {"backend": "cuda", "path": "pallas", "dtype": "float32", "pct_roofline": 1.5},
        {"backend": "cuda", "path": "host", "dtype": "float32", "pct_roofline": None},
        {"backend": "cpu", "path": "bell", "dtype": "float64", "pct_roofline": 99.0},
    ]
    assert roofline.calibrate(rows) == {("bell", "float64"): 7.25, ("pallas", "float32"): 1.5}


def test_no_tpu_constant_in_the_bench_modules():
    """The port's bench holds the card's facts, none of the TPU's: no 819
    GB/s HBM, no 197 TFLOP/s MXU, no gather row rates, no 90 GB/s ICI."""
    for name in ("roofline", "sweep", "bf16_policy", "scaling"):
        src = (ROOT / "recsys_tpu_torch" / "bench" / f"{name}.py").read_text()
        for pattern in (r"\b819\b", r"\b197\b", r"GATHER_ROWS", r"ICI_GBPS", r"\b90\.0\b", r"420e6", r"PALLAS_ITER"):
            assert not re.search(pattern, src), (name, pattern)


def test_committed_card_rows_sit_under_the_chip():
    """No committed row reads above 105% of the data sheet's floor, stored
    or recomputed from its dims with the current model."""
    from recsys_tpu_torch.bench.sweep import _recompute_roofline

    rows = [json.loads(line) for line in ROWS.read_text().splitlines() if line.strip()]
    assert rows and all(r["backend"] == "cuda" for r in rows)
    for r in rows:
        assert r["pct_roofline"] is None or 0 < r["pct_roofline"] <= 105, r
    _recompute_roofline(rows)
    for r in rows:
        assert r["pct_roofline"] is None or 0 < r["pct_roofline"] <= 105, r
        assert (r["pct_roofline"] is None) == (r["path"] == "host"), r
