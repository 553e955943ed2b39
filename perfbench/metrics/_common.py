"""Helpers the metric readers share (not a metric: no ``read``)."""

from __future__ import annotations

import statistics


def phase_median(readings: dict, name: str):
    """The median over the traced window's jobs of one engine phase's
    seconds (``utils.timing.collect_phases``), or None where no job ran it."""
    vals = [j["phases"][name] for j in readings["jobs"] if j.get("phases") and name in j["phases"]]
    return statistics.median(vals) if vals else None


def solve_seconds(readings: dict):
    """The window over the jobs completed in it."""
    n = sum(1 for j in readings["jobs"] if j["ok"])
    return readings["window_s"] / n if n else None
