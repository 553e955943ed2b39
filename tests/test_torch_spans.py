"""The port's spans, counts and job records (``recsys_tpu_torch/utils/timing.py``)
and where the engine and the CLI place them, on the CPU; one ``cuda`` case
checks the sparse walk's span on the card.  The harness's reading of the
profiler's timeline (``perfbench/trace.py``) is held unchanged by the
program's own ``phase:`` ranges."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import FIXTURES, read_golden
from perfbench import trace as pb_trace
from recsys_tpu_torch import cli
from recsys_tpu_torch.config import RunConfig
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.utils import timing

ROOT = pathlib.Path(__file__).resolve().parent.parent
INST = "inst0"
RUN = ["run", str(FIXTURES / f"{INST}.in"), "--device", "cpu", "--dtype", "float32", "--path", "pallas", "--no-time"]
PHASES = {"prep", "upload", "train", "top1"}  # the dense route's phases, as before spans existed


def _run_cli(argv=RUN) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def _spans(rec, name):
    return [s for s in rec.spans if s.name == name]


def _parent(rec, s):
    return None if s.parent is None else rec.spans[s.parent].name


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    reads, clock = [], timing.time.perf_counter

    def counted():
        reads.append(1)
        return clock()

    n = len(timing._LOG)
    monkeypatch.setattr(timing.time, "perf_counter", counted)
    assert timing.span("a") is timing.span("b") and timing.phase("a") is timing.phase("b")
    with timing.span("x") as s, timing.phase("y") as psync:
        timing.count("n", 3)
        assert s is None and psync(5) == 5
    x = np.arange(4, dtype=np.float32)
    assert torch.equal(timing.h2d(x, "cpu"), torch.from_numpy(x))
    monkeypatch.undo()
    assert not reads and len(timing._LOG) == n


def test_spans_nest_and_counts_sit_where_they_were_made():
    out: dict = {}
    with timing.collect_phases(out):
        timing.count("n", 1)
        with timing.span("a"):
            timing.count("n", 2)
            with timing.phase("p"), timing.span("b"):
                timing.count("n", 3)
    rec = timing.record_of(out)
    assert [(s.name, _parent(rec, s)) for s in rec.spans] == [("a", None), ("p", "a"), ("b", "p")]
    assert rec.counts == {"n": 6}
    assert [s.counts for s in rec.spans] == [{"n": 2}, None, {"n": 3}]
    assert set(out) == {"p"} and out["p"] == rec.spans[1].end - rec.spans[1].start
    assert all(s.start <= c.start and c.end <= s.end for s in rec.spans for c in rec.spans[rec.spans.index(s) + 1:])


def test_cli_run_records_its_spans_and_keeps_the_phase_keys():
    out: dict = {}
    with timing.collect_phases(out):
        printed = _run_cli()
    assert printed == read_golden(INST)
    assert set(out) == PHASES
    rec = timing.record_of(out)
    for name, parent in (("parse", None), ("plan", None), ("format", None), ("upload", None),
                         ("densify", "upload"), ("h2d", "upload")):
        got = _spans(rec, name)
        assert got and all(_parent(rec, s) == parent for s in got), name
    for name in PHASES:  # each phase once, its wall the one in ``out``
        (s,) = _spans(rec, name)
        assert out[name] == s.end - s.start
    assert [s.name for s in rec.spans if s.parent is None][:3] == ["args", "parse", "plan"]
    assert rec.spans[-1].name == "format" and not _spans(rec, "walk")  # no walk tables off the card


def test_generate_parses_its_arguments_without_torch(tmp_path):
    code = ("import sys; from recsys_tpu_torch import cli; "
            f"rc = cli.main(['generate', 'inst20-30-4-1-5', {str(tmp_path / 'g.in')!r}, '--iters', '3']); "
            "print(rc, 'torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.stdout.split() == ["0", "False"], r.stderr[-2000:]


def test_h2d_bytes_are_the_plans_a_and_factor_tables():
    spec = load_problem(str(FIXTURES / f"{INST}.in"))
    plan = trainer.dense_plan(spec)
    want = plan.U * plan.I * torch.empty(0, dtype=plan.a_dtype).element_size() + 4 * plan.K * (plan.U + plan.I)
    out: dict = {}
    with timing.collect_phases(out):
        _run_cli()
    rec = timing.record_of(out)
    assert rec.counts["h2d_bytes"] == want
    assert sum(s.counts["h2d_bytes"] for s in _spans(rec, "h2d")) == want
    assert all(s.counts is None for s in rec.spans if s.name not in ("h2d", "format"))
    assert [s.counts for s in _spans(rec, "format")] == [{"format_native": 1}]


def test_record_of_is_by_identity_and_the_log_is_bounded():
    a, b = {}, {}
    with timing.collect_phases(a):
        pass
    with timing.collect_phases(b):
        pass
    assert a == b and timing.record_of(a).phases is a and timing.record_of(b).phases is b
    assert timing.record_of(a).id != timing.record_of(b).id and timing.record_of({}) is None
    assert timing._LOG.maxlen == timing.JOB_LOG_MAX >= 51 * 100  # a 51 s window of 10 ms jobs
    for _ in range(timing.JOB_LOG_MAX):
        with timing.collect_phases({}):
            pass
    assert len(timing._LOG) == timing.JOB_LOG_MAX and timing.record_of(a) is None


def test_profile_writes_the_programs_ranges_and_the_jobs_spans(tmp_path):
    printed = _run_cli([*RUN, "--profile", str(tmp_path)])
    assert printed == read_golden(INST)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"phase:parse", "phase:plan", "phase:format", "phase:upload", "phase:densify", "phase:h2d"} <= names
    rec = json.loads((tmp_path / "spans.json").read_text())
    assert set(rec["phases"]) == PHASES and rec["counts"]["h2d_bytes"] > 0
    spans = rec["spans"]
    assert {s["name"] for s in spans} >= {"parse", "plan", "upload", "densify", "h2d", "format"}
    assert all(0 <= s["start"] <= s["end"] for s in spans)
    assert all(spans[s["parent"]]["name"] == "upload" for s in spans if s["name"] in ("densify", "h2d"))


def test_profiler_alone_gets_the_ranges_and_no_record():
    n = len(timing._LOG)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run_cli()
    names = {e["name"] for e in pb_trace.export_events(prof) if e.get("cat") == "user_annotation"}
    assert {"phase:parse", "phase:plan", "phase:format", "phase:upload", "phase:train"} <= names
    assert len(timing._LOG) == n


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _without_inner_duplicates(events):
    """The events less each ``phase:`` range that a range of the same name
    encloses: the trace the harness's own ranges alone would give."""
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("phase:")]
    inner = {id(e) for e in ranges for o in ranges
             if o is not e and o["name"] == e["name"] and o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
             and (o["ts"], -o["dur"]) < (e["ts"], -e["dur"])}
    return [e for e in events if id(e) not in inner]


def _same_reading(a, b):
    assert a["busy_s"] == b["busy_s"] and a["window_s"] == b["window_s"] and a["ops"] == b["ops"]
    assert set(a["idle_by_span"]) == set(b["idle_by_span"])
    assert a["idle_by_span"] == pytest.approx(b["idle_by_span"], rel=1e-9, abs=1e-12)
    assert sum(a["idle_by_span"].values()) == pytest.approx(sum(b["idle_by_span"].values()), rel=1e-9, abs=1e-12)


def test_duplicated_phase_ranges_leave_the_timeline_reading_unchanged():
    base = [_x("job 0", 0, 1000), _x("phase:upload", 100, 400), _x("phase:densify", 120, 100),
            _x("phase:train", 600, 300), _x("k", 250, 100, "kernel"), _x("copy", 450, 20, "gpu_memcpy"),
            _x("k", 700, 150, "kernel")]
    dup = base + [_x("phase:upload", 101, 398), _x("phase:densify", 121, 98), _x("phase:train", 602, 296)]
    _same_reading(pb_trace.read_timeline(dup), pb_trace.read_timeline(base))
    assert _without_inner_duplicates(dup) == base


def test_harness_ranges_and_the_programs_count_each_phase_once():
    out: dict = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pb_trace.phase_spans(), torch.profiler.record_function("job 0"), timing.collect_phases(out):
            _run_cli()
    assert set(out) == PHASES
    rec = timing.record_of(out)
    for name in PHASES:
        (s,) = _spans(rec, name)
        assert out[name] == s.end - s.start
    events = pb_trace.export_events(prof)
    upload = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "phase:upload"]
    assert len(upload) == 2  # the harness's range and the program's own
    alone = _without_inner_duplicates(events)
    assert len([e for e in alone if e.get("name") == "phase:upload"]) == 1
    _same_reading(pb_trace.read_timeline(events), pb_trace.read_timeline(alone))


@pytest.mark.cuda
@pytest.mark.parametrize("a_max_bytes,kind", [(trainer.RESIDENT_A_MAX_BYTES, "resident"), (0, "stream")])
def test_walk_span_on_the_card(a_max_bytes, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk tables are built only on the card")
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    plan = trainer.dense_plan(spec, a_max_bytes=a_max_bytes)
    assert plan.kind == kind
    out: dict = {}
    with timing.collect_phases(out):
        printed, _ = trainer.run(spec, RunConfig(dtype="float32"), "cuda", a_max_bytes=a_max_bytes)
    assert printed == read_golden("instML100k")
    rec = timing.record_of(out)
    assert set(out) == PHASES
    (walk,) = _spans(rec, "walk")
    assert _parent(rec, walk) == "upload" and walk.end > walk.start
    a_bytes = plan.U * plan.I * torch.empty(0, dtype=plan.a_dtype).element_size()
    assert rec.counts["h2d_bytes"] == a_bytes + 4 * plan.K * (plan.U + plan.I)
