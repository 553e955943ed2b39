"""The reading of the profiler's timeline, on a made-up trace."""

import pytest

from perfbench import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_idle_and_the_names_of_idle_stretches():
    events = [
        _x("job 0", "user_annotation", 0, 100), _x("phase:train", "user_annotation", 20, 60),
        _x("k1", "kernel", 25, 20), _x("k1", "kernel", 40, 10), _x("k2", "kernel", 70, 10),
        _x("copy", "gpu_memcpy", 85, 5), _x("outside", "kernel", 150, 10),
    ]
    t = trace.read_timeline(events)
    assert t["window_s"] == pytest.approx(100e-6) and t["busy_s"] == pytest.approx(40e-6) and t["ops"] == 4
    assert t["device_ops"][0][0] == "k1" and t["device_ops"][0][1] == pytest.approx(30e-6)
    # idle 0-25 is cut where train begins (20): 20 us of cli, 5 of train; 50-70 train;
    # 80-85 cli (train ends at 80); 90-100 cli
    assert t["idle_by_span"] == pytest.approx({"cli": 35e-6, "train": 25e-6})
    assert t["idle_gaps"][0][0] in ("cli (job 0)", "train (job 0)") and t["idle_gaps"][0][1] == pytest.approx(20e-6)


def test_no_job_ranges_no_reading():
    assert trace.read_timeline([_x("k", "kernel", 0, 5)]) is None
