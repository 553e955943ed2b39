"""cli_s (program span): the median over the traced window's jobs of the
job's wall less its engine phases: parsing, argument handling and
formatting (``cli.py``, ``io/``)."""

import statistics


def read(readings):
    vals = [j["wall"] - sum(j["phases"].values()) for j in readings["jobs"] if j["ok"] and j.get("phases")]
    return statistics.median(vals) if vals else None
