"""Helpers the span readers share (not a metric: no ``read``).  Each
traced window job's record is ``utils.timing.record_of`` of its phases
dict: the spans the program opened in the job, with their parents, and
its counts.  A program without job records gives no record, and every
reading is then None."""

from __future__ import annotations

import statistics


def records(readings: dict) -> list:
    """The records of the traced window's completed jobs."""
    from recsys_tpu_torch.utils import timing

    record_of = getattr(timing, "record_of", None)
    if record_of is None:
        return []
    recs = (record_of(j["phases"]) for j in readings["jobs"] if j["ok"] and j.get("phases") is not None)
    return [r for r in recs if r is not None]


def span_median(readings: dict, name: str):
    """The median over the jobs of the seconds a job spent in its ``name``
    spans, summed, or None where no job recorded one."""
    vals = []
    for r in records(readings):
        secs = [s.end - s.start for s in r.spans if s.name == name and s.end is not None]
        if secs:
            vals.append(sum(secs))
    return statistics.median(vals) if vals else None


def count_median(readings: dict, name: str):
    """The median over the jobs of a job's ``name`` count, or None where
    no job counted it."""
    vals = [r.counts[name] for r in records(readings) if name in r.counts]
    return statistics.median(vals) if vals else None
