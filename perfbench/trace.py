"""The traced run's spans and its reading of the device timeline.

``phase_spans`` puts each engine phase (``utils.timing.phase``) on the
profiler's timeline as a ``phase:<name>`` range, by wrapping the name in
every loaded module of the program that imported it; the harness puts
``job <n>`` ranges around each job.  ``read_timeline`` reads the profiler's
Chrome trace: the device's busy time inside the profiled jobs' span, the
operations that took most of it, and the longest idle stretches: each
idle gap cut where a host range begins or ends, each piece named by the
innermost range it lies in (``<phase> (job <n>)``, ``cli`` outside the
engine's phases).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def phase_spans():
    import torch

    from recsys_tpu_torch.utils import timing

    orig = timing.phase

    @contextlib.contextmanager
    def spanned(name):
        with torch.profiler.record_function(f"phase:{name}"), orig(name) as psync:
            yield psync

    mods = [m for n, m in list(sys.modules.items())
            if n.split(".")[0] == "recsys_tpu_torch" and getattr(m, "phase", None) is orig]
    for m in mods:
        m.phase = spanned
    try:
        yield
    finally:
        for m in mods:
            m.phase = orig


def export_events(prof) -> list:
    """The profiler's events as Chrome-trace dicts (written to a temporary
    file under ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_timeline(events: list, top: int = 10) -> dict | None:
    """{busy_s, window_s, device_ops, idle_gaps, idle_by_span, ops, op_s}
    over the span of the ``job <n>`` ranges, or None without them."""
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    jobs = [e for e in ranges if e["name"].startswith("job ")]
    if not jobs:
        return None
    t0 = min(e["ts"] for e in jobs)
    t1 = max(e["ts"] + e["dur"] for e in jobs)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0]
    busy = _union([(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)) for e in dev])
    by_op: dict = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e.get("dur", 0) * 1e-6
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    edges = sorted({r["ts"] for r in ranges} | {r["ts"] + r["dur"] for r in ranges})

    def label(ts):
        inside = [r for r in ranges if r["ts"] <= ts < r["ts"] + r["dur"]]
        job = next((r["name"] for r in inside if r["name"].startswith("job ")), "")
        ph = [r for r in inside if r["name"].startswith("phase:")]
        name = min(ph, key=lambda r: r["dur"])["name"][6:] if ph else ("cli" if job else "harness")
        return f"{name} ({job})" if job else name

    named = []  # each gap cut at the host ranges' edges, each piece named by the range it lies in
    for s, e in gaps:
        cuts = [s] + [x for x in edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, e)]] + [e]
        for a, b in zip(cuts, cuts[1:]):
            if b > a:
                named.append((label((a + b) / 2), (b - a) * 1e-6))
    by_span: dict = {}
    for n, s in named:
        key = n.split(" (")[0]
        by_span[key] = by_span.get(key, 0.0) + s
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (t1 - t0) * 1e-6,
        "ops": len(dev),
        "op_s": sum(e.get("dur", 0) for e in dev) * 1e-6,
        "device_ops": sorted(([n, s] for n, s in by_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in named), key=lambda x: -x[1])[:top],
        "idle_by_span": by_span,
    }
