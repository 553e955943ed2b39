"""The port's bf16 policy (``recsys_tpu_torch/bench/bf16_policy.py``) and
its gate in the CLI: the JAX ``tests/test_cli.py`` cases on the port's
``run`` (a ``--strict`` refusal before training, a warning on a shape never
measured), and every pinned value equal to the committed card row of its
shape."""

import json
import pathlib

import pytest

from helpers import FIXTURES
from recsys_tpu_torch import cli
from recsys_tpu_torch.bench import bf16_policy
from recsys_tpu_torch.bench.sweep import BF16_MIN_AGREEMENT
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance
from recsys_tpu_torch.io.parser import load_problem, save_problem

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _rows():
    return [json.loads(line) for line in (ROOT / "bench_results_torch.jsonl").read_text().splitlines() if line.strip()]


def test_pinned_tables_are_the_card_rows():
    """Every MEASURED agreement is the bfloat16 row of its shape in
    bench_results_torch.jsonl, every FASTEST tier the best wall at the floor
    there, and no bf16 row is left out."""
    measured, fastest = bf16_policy.tables_from_rows(_rows())
    assert bf16_policy.MEASURED == measured
    assert bf16_policy.FASTEST == fastest
    assert bf16_policy.FLOOR == BF16_MIN_AGREEMENT == 0.98


def _below_floor_fixture():
    """A committed fixture whose card bf16 agreement is below the floor."""
    for r in _rows():
        path = FIXTURES / f"{r['instance']}.in"
        if r["dtype"] == "bfloat16" and r["agreement"] is not None and r["agreement"] < 0.98 and path.exists():
            return path, r["agreement"]
    pytest.fail("no committed fixture reads below the bf16 floor on the card")


def test_strict_refuses_below_the_floor_before_training(capsys, monkeypatch):
    """A shape the card's rows put below the floor: ``--strict`` exits 2
    with the measured agreement and the hint, before any training."""
    path, agree = _below_floor_fixture()

    def no_training(*args, **kwargs):
        raise AssertionError("trained a refused bf16 run")

    monkeypatch.setattr(trainer, "run", no_training)
    for cmd in ("run", "bench"):
        rc = cli.main([cmd, str(path), "--device", "cpu", "--dtype", "bfloat16", "--strict", "--no-time"]
                      if cmd == "run" else [cmd, str(path), "--device", "cpu", "--dtype", "bfloat16", "--strict"])
        captured = capsys.readouterr()
        assert rc == 2 and captured.out == ""
        assert f"{agree:.2%} argmax agreement" in captured.err
        assert "use --dtype" in captured.err and "error: refusing bfloat16 under --strict" in captured.err


def test_unknown_shape_warns_and_runs(tmp_path, capsys):
    """A shape no card row measured gets the generic warning, the true-f32
    hint, and still runs without ``--strict``; with it, it is refused."""
    spec = generate_instance(3, 5, 2, 1, 3, iters=40, alpha=0.01, seed=17)
    path = tmp_path / "tiny.in"
    save_problem(spec, str(path))
    assert bf16_policy.lookup(spec) is None
    rc = cli.main(["run", str(path), "--device", "cpu", "--dtype", "bfloat16", "--path", "dense", "--no-time"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "no measured argmax agreement" in captured.err and "use --dtype float32" in captured.err
    assert len(captured.out.splitlines()) == 3
    rc = cli.main(["run", str(path), "--device", "cpu", "--dtype", "bfloat16", "--strict", "--no-time"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_policy_verdicts_follow_the_card():
    """instML100k and gen-instML1M (built in memory) run or are refused
    under ``--strict`` as their measured agreement against the floor says."""
    for spec in (load_problem(str(FIXTURES / "instML100k.in")), generate_instance(**GEN_SPECS["gen-instML1M"])):
        agree = bf16_policy.lookup(spec)
        assert agree is not None
        assert bf16_policy.check(spec, strict=True) == (agree >= bf16_policy.FLOOR)
        assert bf16_policy.check(spec, strict=False)


def test_hints_name_the_fastest_tier_and_never_claim_bf16x3():
    """A hint names the tier the card's rows show fastest at the floor on
    that shape; where none does, true f32.  No message claims bf16x3 is
    the fast tier."""
    for shape, tier in bf16_policy.FASTEST.items():
        spec = type("S", (), dict(zip(("users", "items", "features", "iters"), shape)))
        assert bf16_policy.TIER_FLAGS[tier] in bf16_policy.hint(spec)
    unknown = type("S", (), dict(users=1, items=1, features=1, iters=1))
    assert bf16_policy.hint(unknown).startswith("use --dtype float32 (")
    assert "float32" not in bf16_policy.FASTEST.values()
    assert "bf16x3 is the accurate fast tier" not in (ROOT / "recsys_tpu_torch" / "cli.py").read_text()


def test_tables_from_rows_rank_only_real_tiers():
    """FASTEST keeps a tier other than float32 only where it ran another
    computation and beat float32 at the floor: f32x3 off the dense kernels
    and any dtype on the host route are float32's run; CPU rows, rows below
    the floor and older rows of the same (instance, dtype) do not count."""
    def row(instance, dtype, path, wall, agreement=1.0, backend="cuda", shape=(10, 20, 4, 100)):
        return dict(instance=instance, dtype=dtype, path=path, wall_s=wall, agreement=agreement, backend=backend,
                    users=shape[0], items=shape[1], k=shape[2], iters=shape[3])
    a, b, c, d = (10, 20, 4, 100), (11, 20, 4, 100), (12, 20, 4, 100), (13, 20, 4, 100)
    rows = [
        row("a", "float32", "pallas", 0.5, shape=a), row("a", "float64", "bell", 0.4, shape=a),
        row("a", "bfloat16", "pallas", 0.3, agreement=0.97, shape=a),
        row("b", "float32", "bell", 0.5, shape=b), row("b", "f32x3", "bell", 0.1, shape=b),
        row("b", "float64", "bell", 0.2, agreement=0.5, shape=b), row("b", "float64", "bell", 0.3, shape=b),
        row("c", "float32", "host", 0.5, shape=c), row("c", "float64", "host", 0.1, shape=c),
        row("c", "bfloat16", "host", 0.1, backend="cpu", shape=c),
        row("d", "float32", "pallas", 0.5, shape=d), row("d", "f32x3", "pallas", 0.4, shape=d),
    ]
    measured, fastest = bf16_policy.tables_from_rows(rows)
    assert measured == {a: 0.97}
    assert fastest == {a: "float64", b: "float64", d: "f32x3"}
