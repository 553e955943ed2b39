"""The comparison that decides ``correct``: the program's output against
the plain reference's, number by number, each against the limit its cell's
file in ``limits/`` sets.

* ``factor_gap``: the trained factors.  Over every captured job and both
  tables, the largest ``max |program - reference|`` over the table, as a
  share of the reference table's largest magnitude, in float64 on the
  device where the taps left the program's tables and the reference made
  its own: no whole table is copied to the host.
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
import torch

from perfbench import reference


# The float64 bytes of one block of rows in the factor check.
BLOCK_BYTES = 1 << 28


def tables(capture, inst) -> tuple:
    """A tap's capture as its (users, k) and (items, k) tables: views of
    the program's tensors, on their device, in their dtype."""
    layout, L, R = capture
    k = inst.features
    if layout == "kmajor":
        return L[:k, : inst.users].T, R[:k, : inst.items].T
    return L[: inst.users, :k], R[: inst.items, :k]


def table_gap(P, Q) -> float:
    """max |P - Q| / max |Q| in float64, a block of rows at a time on
    ``Q``'s device; inf for a table of another shape or a reading that is
    not finite.  Subtraction, ``abs`` and ``max`` in float64 are exact, so
    the value does not depend on the blocks or the device."""
    if tuple(P.shape) != tuple(Q.shape):
        return math.inf
    rows = max(1, BLOCK_BYTES // (8 * max(1, Q.shape[1])))
    diff, mag = [], []
    for r in range(0, Q.shape[0], rows):
        q = Q[r : r + rows].to(torch.float64)
        diff.append(torch.amax(torch.abs(P[r : r + rows].to(device=q.device, dtype=torch.float64) - q)))
        mag.append(torch.amax(torch.abs(q)))
    d = float(torch.stack(diff).amax()) / float(torch.stack(mag).amax())
    return d if math.isfinite(d) else math.inf


def factor_gap(captures: list, ref: tuple, inst) -> float:
    """The largest ``table_gap`` over the captured jobs' two tables against
    the reference's (L, R); inf with no capture."""
    if not captures:
        return math.inf
    worst = 0.0
    for capture in captures:
        for P, Q in zip(tables(capture, inst), ref):
            worst = max(worst, table_gap(P, Q))
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
