"""The port's golden sweep (``recsys_tpu_torch/bench/sweep.py``) against the
JAX package's (``recsys_tpu/bench/sweep.py``): the same table cells from
the same rows, the same guards, and ``run_instance`` on the CPU giving the
JAX row's keys and its agreement on the same fixtures."""

import contextlib
import io
import json
from types import SimpleNamespace

import pytest

from helpers import FIXTURES
from recsys_tpu.bench import sweep as jax_sweep
from recsys_tpu_torch.bench import roofline, sweep
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import save_problem

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _row(**kw):
    base = dict(instance="instML100k", dtype="float32", path="pallas", wall_s=0.38, updates_per_s=7.9e8,
                iters=3000, nnz=100000, users=943, items=1682, rated_users=943, rated_items=1682, k=30,
                golden_exact=False, agreement=0.9894,
                backend="cuda", device=CARD)
    base.update(kw)
    return base


ROWS = [
    _row(),
    _row(golden_exact=True, agreement=1.0, train_s=0.077, per_iter_ms=0.0257, train_marginal_s=0.0741,
         per_iter_marginal_ms=0.0247, pct_roofline=1.7, roofline_model="bytes", hbm_peak_mb=31.5),
    _row(dtype="bfloat16", agreement=0.9691, bf16_below_floor=True, pct_roofline=0.4, roofline_model="bytes"),
    _row(instance="gen-instML1M", wall_s=12.5201, agreement=None),
    _row(instance="gen-instX", agreement=None),
    _row(instance="inst0", path="host", wall_s=0.0006, golden_exact=True, agreement=1.0, backend="cpu",
         device="cpu"),
    _row(instance="inst200-10000-50-100-300", dtype="float64", path="bell", wall_s=0.11, agreement=0.995,
         train_s=0.03, pct_roofline=130.2, roofline_model="operations"),
    _row(instance="inst1000-1e6-1000-1-3", dtype="f32x3", path="bell", wall_s=2.5, agreement=0.989,
         bf16_below_floor=False, train_s=0.4, train_marginal_s=0.1),
]


def _cells(md: str) -> list[list[str]]:
    """The sweep table's data rows as cells, less the memory column (the
    table ends at the first line that is not a row)."""
    lines = md.splitlines()
    body = lines[lines.index(next(x for x in lines if x.startswith("| instance"))) + 2:]
    out = []
    for line in body:
        if not line.startswith("| "):
            break
        out.append([c.strip() for c in line.strip("|").split("|")][:-1])
    return out


def test_format_markdown_cells_match_jax():
    """The same speedup, golden, share, train and per-iteration cells as
    the JAX table on the same rows, in the same order; only the header and
    the memory column differ (the card's name; a device peak, no VMEM)."""
    port, jax_md = sweep.format_markdown([dict(r) for r in ROWS]), jax_sweep.format_markdown([dict(r) for r in ROWS])
    assert _cells(port) == _cells(jax_md)
    assert len(_cells(port)) == len(ROWS)
    assert port.splitlines()[0] == f"# recsys-tpu-torch benchmark sweep ({CARD})"
    assert "TPU" not in port and "VMEM" not in port
    assert "| 31.5 |" in port and "| exact | 1.7% bytes | 31.5 |" in port
    assert "276.1x" in port and "36.6x" in port and "98.94%" in port and "BELOW-FLOOR" in port


def test_constants_match_jax():
    assert sweep.REFERENCE_S == jax_sweep.REFERENCE_S
    assert sweep.DEFAULT_INSTANCES == jax_sweep.DEFAULT_INSTANCES
    assert sweep.BF16_MIN_AGREEMENT == jax_sweep.BF16_MIN_AGREEMENT
    assert sweep.TRAIN_RESOLUTION_S == jax_sweep.TRAIN_RESOLUTION_S


@pytest.mark.parametrize("row", [
    {"train_s": 0.5, "train_marginal_s": 0.4, "wall_s": 1.0},
    {"train_s": 0.1, "train_marginal_s": 0.09, "wall_s": 1.0},
    {"train_s": 0.5, "train_marginal_s": 0.2, "wall_s": 1.0},
    {"train_s": None, "train_marginal_s": None, "wall_s": 0.7},
    {"train_s": 0.3, "wall_s": 0.9},
])
def test_effective_train_s_matches_jax(row):
    assert sweep.effective_train_s(row) == jax_sweep.effective_train_s(row)


@pytest.mark.parametrize("row", [
    {"train_s": 0.01, "pct_roofline": 140.0, "roofline_model": "bytes"},
    {"train_s": 0.5, "pct_roofline": 140.0, "roofline_model": "bytes"},
    {"train_s": 0.01, "pct_roofline": 80.0, "roofline_model": "operations"},
    {"train_s": 0.01, "pct_roofline": None, "roofline_model": None},
])
def test_clamp_sub_resolution_pct_matches_jax(row):
    port, ref = dict(row), dict(row)
    sweep._clamp_sub_resolution_pct(port)
    jax_sweep._clamp_sub_resolution_pct(ref)
    assert port == ref


def test_latest_rows_keep_the_card():
    """The newest row per (instance, dtype) wins, but a CPU row never
    displaces a card row."""
    a = _row(wall_s=0.5)
    b = _row(wall_s=0.4)
    c = _row(wall_s=9.0, backend="cpu", device="cpu")
    d = _row(instance="inst0", backend="cpu", device="cpu")
    assert sweep.latest_rows([a, b, c, d]) == [b, d]


def _bell_fixture(tmp_path):
    """A small instance whose f64 route is ``bell`` on the CPU (past the
    host engine's top-1 budget: 16 x 12,500 x k=1024), its golden written by
    the native serial engine (the reference's trajectory)."""
    spec = generate_instance(16, 12_500, 1024, 1, 3, iters=10, alpha=1e-3, seed=5)
    assert trainer.choose_path(spec, RunConfig(dtype="float64"), "cpu") == "bell"
    save_problem(spec, str(tmp_path / "bellsmall.in"))
    out, _ = trainer.run(spec, RunConfig(dtype="float64", path="host"), "cpu")
    (tmp_path / "bellsmall.out").write_text(out)
    return spec


@pytest.mark.parametrize("case", ["host", "bell"])
def test_run_instance_matches_the_jax_row(tmp_path, monkeypatch, case):
    """``run_instance(..., device="cpu")`` in f64: the route, the JAX row's
    keys (and the card's name), and the JAX ``run_instance``'s agreement
    and exact match on the same fixture (JAX on the CPU)."""
    if case == "host":
        name, fixture_dir = "inst30-40-10-2-10", str(FIXTURES)
    else:
        name, fixture_dir = "bellsmall", str(tmp_path)
        _bell_fixture(tmp_path)
        monkeypatch.setattr(jax_sweep, "_fixture_dir", lambda: fixture_dir)
    row = sweep.run_instance(name, "float64", 1, device="cpu", fixture_dir=fixture_dir)
    ref = jax_sweep.run_instance(name, "float64", 1)
    assert row["path"] == case and ref["path"] == case
    assert set(ref) <= set(row)
    assert row["backend"] == "cpu" and row["device"] == "cpu" and row["hbm_peak_mb"] is None
    # The peaks are the card's: a CPU row carries no share.
    assert row["resident_vmem_est_mb"] is None and row["pct_roofline"] is None
    assert (row["agreement"], row["golden_exact"]) == (ref["agreement"], ref["golden_exact"])
    assert row["golden_exact"] is True
    for key in ("iters", "nnz", "users", "items", "k", "dtype", "instance"):
        assert row[key] == ref[key]
    assert row["train_s"] is not None and row["sync_floor_s"] == 0.0


def test_main_sweeps_the_cpu_only_on_request(capsys):
    """``--device cpu`` prints one row; the default device is the card, and
    without one the sweep refuses (no fallback to the CPU)."""
    import torch

    assert sweep.main(["--device", "cpu", "--instances", "inst30-40-10-2-10", "--dtype", "float64",
                       "--repeats", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(rows) == 1 and rows[0]["instance"] == "inst30-40-10-2-10" and rows[0]["golden_exact"]
    if not torch.cuda.is_available():
        assert sweep.main(["--instances", "inst0", "--dtype", "float64"]) == 2
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_render_keeps_the_newest_card_row(tmp_path):
    rows = tmp_path / "rows.jsonl"
    rows.write_text("".join(json.dumps(r) + "\n" for r in (
        _row(wall_s=0.5, train_s=0.3), _row(wall_s=0.4, train_s=0.25), _row(wall_s=9.0, backend="cpu", device="cpu"),
        _row(instance="inst0", path="host", backend="cpu", device="cpu", golden_exact=True, agreement=1.0))))
    out = tmp_path / "b.md"
    with contextlib.redirect_stdout(io.StringIO()):
        assert sweep.main(["--render", str(rows), "--out", str(out)]) == 0
    md = out.read_text()
    lines = _cells(md)
    assert [c[0] for c in lines] == ["inst0", "instML100k"]
    ml = next(c for c in lines if c[0] == "instML100k")
    assert ml[3] == "0.4" and ml[2] == "pallas"
    # The share is recomputed from the row's own dims at render time.
    dims = SimpleNamespace(users=943, items=1682, features=30, nnz=100000, iters=3000, rated_users=943,
                           rated_items=1682)
    _, per_iter = roofline.train_cost_model(dims, RunConfig(dtype="float32"), "pallas")
    assert ml[10] == f"{round(100.0 * 3000 * per_iter / 0.25, 1):g}% bytes"
