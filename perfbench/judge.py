"""The comparison that decides ``correct``: the program's output against
the plain reference's, number by number, each against the limit its cell's
file in ``limits/`` sets.

* ``factor_gap``: the trained factors.  Over every captured job and both
  tables, the largest ``max |program - reference|`` over the table, as a
  share of the reference table's largest magnitude.
* ``top1_gap``: the printed list (the top-1 and the writer).  Over every
  distinct stdout of the window's jobs, the widest gap by which the
  reference's score of the item a user was given lies below the
  reference's best, as a share of the largest best score.  A list of the
  wrong length, a line that is no item index or an item the user rated
  reads ``inf``.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from perfbench import reference


def host_factors(capture, inst) -> tuple[np.ndarray, np.ndarray]:
    """A tap's capture as float64 (users, k) and (items, k) host arrays."""
    layout, L, R = capture
    k = inst.features
    if layout == "kmajor":
        L, R = L[:k, : inst.users].T, R[:k, : inst.items].T
    else:
        L, R = L[: inst.users, :k], R[: inst.items, :k]
    return L.double().cpu().numpy(), R.double().cpu().numpy()


def factor_gap(programs: list, ref: tuple[np.ndarray, np.ndarray]) -> float:
    if not programs:
        return math.inf
    worst = 0.0
    for pair in programs:
        for P, Q in zip(pair, ref):
            if P.shape != Q.shape:
                return math.inf
            d = float(np.max(np.abs(P - Q))) / float(np.max(np.abs(Q)))
            worst = max(worst, d if math.isfinite(d) else math.inf)
    return worst


def parse_list(text: str, n_lines: int, items: int) -> np.ndarray | None:
    """The item indices of one stdout, or None when it is malformed."""
    lines = text.split("\n")
    if lines[-1] != "" or len(lines) != n_lines + 1:
        return None
    try:
        got = np.array([int(x) for x in lines[:-1]], dtype=np.int64)
    except ValueError:
        return None
    if got.size and (got.min() < 0 or got.max() >= items):
        return None
    return got


def top1_gap(outputs: list[str], B: np.ndarray, inst) -> float:
    if not outputs:
        return math.inf
    users = reference.listed_users(inst)
    best = B[users].max(axis=1)
    scale = float(np.max(np.abs(best))) if users.size else 1.0
    worst = 0.0
    for text in outputs:
        got = parse_list(text, users.size, inst.items)
        if got is None:
            return math.inf
        chosen = B[users, got]
        if not np.all(np.isfinite(chosen)):
            return math.inf
        worst = max(worst, float(np.max(best - chosen)) / scale if users.size else 0.0)
    return worst


def load_limits(root: str, workload: str) -> dict:
    with open(os.path.join(root, "perfbench", "limits", f"{workload}.json")) as f:
        return json.load(f)


def checks(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every value within its limit, {name: {"value", "limit"}}); a number
    with no limit, or a limit with no number, is not correct."""
    out, ok = {}, set(values) == {k for k in limits if not k.startswith("_")}
    for name, v in values.items():
        lim = limits.get(name, {}).get("limit")
        out[name] = {"value": v, "limit": lim}
        ok = ok and lim is not None and math.isfinite(v) and v <= lim
    return ok, out
