"""Ingest of the ``.in`` instance format: a copy of
``recsys_tpu/io/parser.py``, kept in the port so that it imports nothing
of the JAX package.

Format (reference ``matFact.c:79-105``; every ``samples/*.in``)::

    iters                  # line 1: GD iterations (int)
    alpha                  # line 2: learning rate (double)
    features               # line 3: latent dimension k (int)
    users items nnz        # line 4
    row col value          # nnz lines, sorted row-major

Unlike the reference's rank-0 fscanf streaming + MPI_Send distribution
(``matFact-mpi.c:220-457``), ingest here is a single host-side bulk
parse into COO numpy arrays; the engine moves them to the device
later. A C fast path (``recsys_tpu_torch/csrc/recsys_native.c``)
accelerates the entry-body parse for
multi-million-line files; the numpy path below is the fallback and the
test oracle for it.
"""

from __future__ import annotations

import io as _io
import numpy as np

from recsys_tpu_torch.config import ProblemSpec


class ParseError(ValueError):
    """Malformed .in input (the reference's die() analogue, but raisable)."""


def parse_in_bytes(data: bytes) -> ProblemSpec:
    """Parse an in-memory ``.in`` payload into a ProblemSpec."""
    # Header: first four lines.
    off = 0
    fields = []
    for _ in range(4):
        nl = data.find(b"\n", off)
        if nl < 0:
            raise ParseError("truncated header")
        fields.append(data[off:nl])
        off = nl + 1
    try:
        iters = int(fields[0])
        alpha = float(fields[1])
        features = int(fields[2])
        users, items, nnz = (int(t) for t in fields[3].split())
    except Exception as e:  # noqa: BLE001
        raise ParseError(f"malformed header: {e}") from e
    if min(iters, features, users, items) <= 0 or nnz < 0:
        raise ParseError("non-positive dimension in header")

    body = np.frombuffer(data[off:], dtype=np.uint8)
    rows, cols, vals = _parse_entries_numpy(body, nnz)
    if rows.size != nnz:
        raise ParseError(f"expected {nnz} entries, parsed {rows.size}")
    if rows.size and (rows.max() >= users or cols.max() >= items or rows.min() < 0 or cols.min() < 0):
        raise ParseError("entry index out of range")
    return ProblemSpec(
        iters=iters,
        alpha=alpha,
        features=features,
        users=users,
        items=items,
        rows=rows,
        cols=cols,
        vals=vals,
    )


def _parse_entries_numpy(body: np.ndarray, nnz: int):
    """Whitespace-token parse of the nnz 'row col value' lines via numpy."""
    if nnz == 0:
        return (
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.float64),
        )
    text = body.tobytes()
    toks = text.split()
    if len(toks) < 3 * nnz:
        raise ParseError("truncated entry body")
    toks = toks[: 3 * nnz]
    rows = np.array(toks[0::3], dtype=np.int32)
    cols = np.array(toks[1::3], dtype=np.int32)
    vals = np.array(toks[2::3], dtype=np.float64)
    return rows, cols, vals


def load_problem(path: str) -> ProblemSpec:
    """Load a ``.in`` instance file (native C fast path when available)."""
    spec = _native_load(path)
    if spec is not None:
        return spec
    with open(path, "rb") as f:
        return parse_in_bytes(f.read())


def _native_load(path: str):
    try:
        from recsys_tpu_torch.io import _native
    except Exception:
        return None
    return _native.load_problem(path)


def save_problem(spec: ProblemSpec, path: str) -> None:
    """Write a ProblemSpec back out in the ``.in`` format (fixture tooling)."""
    body = None
    try:
        from recsys_tpu_torch.io import _native

        body = _native.format_entries(spec.rows, spec.cols, spec.vals)
    except Exception:
        body = None
    with open(path, "w") as f:
        f.write(f"{spec.iters}\n{spec.alpha}\n{spec.features}\n")
        f.write(f"{spec.users} {spec.items} {spec.nnz}\n")
        if body is not None:
            f.write(body.decode())
            return
        buf = _io.StringIO()
        for r, c, v in zip(spec.rows, spec.cols, spec.vals):
            buf.write(f"{int(r)} {int(c)} {v:.6f}\n")
        f.write(buf.getvalue())
