"""The span and count readers (``metrics/_spans.py`` and its metrics) on
made-up readings and job records."""

import types

import pytest

from perfbench import registry
from recsys_tpu_torch.utils import timing

SPAN_METRICS = ("parse_s", "plan_s", "format_s", "densify_s", "walk_s")


def _span(name, start, end, parent=None):
    return types.SimpleNamespace(name=name, start=start, end=end, parent=parent, counts=None)


def _readings(records: list, ok=None):
    """Readings of one window job a record, and the program's ``record_of``
    over them (by the phases dict's identity)."""
    jobs = [{"wall": 1.0, "ok": True if ok is None else ok[i], "phases": {"train": 0.5}} for i in range(len(records))]
    by_id = {id(j["phases"]): types.SimpleNamespace(phases=j["phases"], **r) for j, r in zip(jobs, records)}
    return {"jobs": jobs}, lambda out: by_id.get(id(out))


def _read(name, readings):
    return registry.reader(name)(readings)


def test_span_medians_sum_a_jobs_spans(monkeypatch):
    recs = [{"spans": [_span("parse", 0.0, 0.010), _span("upload", 0.02, 0.05), _span("densify", 0.02, 0.03, 1),
                       _span("h2d", 0.03, 0.035, 1), _span("h2d", 0.035, 0.04, 1)], "counts": {"h2d_bytes": 3_000_000}},
            {"spans": [_span("parse", 0.0, 0.030)], "counts": {"h2d_bytes": 1_000_000}},
            {"spans": [_span("parse", 0.0, 0.020)], "counts": {"h2d_bytes": 2_000_000}}]
    readings, record_of = _readings(recs)
    monkeypatch.setattr(timing, "record_of", record_of)
    assert _read("parse_s", readings) == pytest.approx(0.020)
    assert _read("densify_s", readings) == pytest.approx(0.010)  # one job recorded it
    assert _read("h2d_mb", readings) == pytest.approx(2.0)
    assert _read("walk_s", readings) is None and _read("plan_s", readings) is None


def test_failed_jobs_and_jobs_without_a_record_are_left_out(monkeypatch):
    recs = [{"spans": [_span("plan", 0.0, 0.5)], "counts": {}}, {"spans": [_span("plan", 0.0, 0.004)], "counts": {}}]
    readings, record_of = _readings(recs, ok=[False, True])
    readings["jobs"].append({"wall": 1.0, "ok": True, "phases": {}})
    monkeypatch.setattr(timing, "record_of", record_of)
    assert _read("plan_s", readings) == pytest.approx(0.004)
    assert _read("h2d_mb", readings) is None


@pytest.mark.parametrize("name", SPAN_METRICS + ("h2d_mb",))
def test_a_program_without_records_reads_none(monkeypatch, name):
    readings, _ = _readings([{"spans": [_span("parse", 0.0, 1.0)], "counts": {"h2d_bytes": 5}}])
    monkeypatch.delattr(timing, "record_of")
    assert _read(name, readings) is None


def test_real_records_from_the_collector():
    jobs = []
    for n in (1, 3, 2):
        ph: dict = {}
        with timing.collect_phases(ph):
            with timing.phase("upload"), timing.span("walk"):
                timing.count("h2d_bytes", n * 1_000_000)
        jobs.append({"wall": 1.0, "ok": True, "phases": ph})
    readings = {"jobs": jobs}
    assert _read("h2d_mb", readings) == pytest.approx(2.0)
    assert _read("walk_s", readings) > 0 and _read("parse_s", readings) is None
