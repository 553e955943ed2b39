"""The H100 counterpart of the TPU probe P2 (``scripts/probe_mosaic_gather.py``):
row gathers from a resident factor table, with the BELL error and
gradient math fused behind them in ``p4``.

    python -m recsys_tpu_torch.probes.mosaic_gather [variants ...]

Run from the root of a checkout on a machine with a CUDA card.  The
shapes, inputs and loop are the TPU probe's: a (N, K) = (5001, 128) f32
table (the R table at inst50000-5000's shape, k = 100 padded to 128),
S = 176,128 gathered rows (one BELL side), blocks of BLK = 1024 slots, and
INNER = 50 gathers in one loop whose table drifts by 1e-20 of each
gather's column sum, so no step can be skipped or hoisted.  Variants:

* ``xla``: ``index_select`` and the sum, the library call (the TPU probe's
  XLA ``take`` baseline);
* ``p1``, ``p2``, ``p3``: ``ops/gather.py::gather_rows`` (the three TPU
  lowerings compute one function; here one kernel);
* ``p4``: ``ops/gather.py::gather_err_grad``, the fused kernel (two slots
  a warp).

Each kernel is first held against its twin on the probe's inputs, and
``p4`` against itself over two runs in raw bits.  Each variant prints its
milliseconds per gather (the best of three loops of INNER, by CUDA
events, over INNER) and GB/s of gathered rows.  Then ``err_grad_ms``
times ``p4`` alone, a call from CUDA graph replays.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import gather
from recsys_tpu_torch.utils.timing import alternating_ms, graphed

N, K = 5001, 128
S = 176_128
BLK = 1024
INNER = 50
VARIANTS = ("xla", "p1", "p2", "p3", "p4")
# Calls a graph replays in ``err_grad_ms``: a 40-60 us kernel is shorter
# than its wrapper's host work.
GRAPH_CALLS = 20


def inputs(device, n: int = N, k: int = K, s: int = S):
    """(table, idx, vals) of the TPU probe (its numpy draws, seed 0) on ``device``."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((n, k), dtype=np.float32)
    idx = rng.integers(0, n, s).astype(np.int32)
    vals = rng.standard_normal(s).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (table, idx, vals))


def steps(idx, vals, blk: int = BLK) -> dict:
    """Each variant's step: table -> (K,) column sum of what it gathers."""
    idx_long = idx.long()
    return {
        "xla": lambda tab: tab.index_select(0, idx_long).sum(dim=0),
        **{p: (lambda tab: gather.gather_rows(tab, idx).sum(dim=0)) for p in ("p1", "p2", "p3")},
        "p4": lambda tab: gather.gather_err_grad(tab, idx, vals, blk).sum(dim=0),
    }


def loop(step, table, inner: int = INNER):
    """``step`` ``inner`` times with the TPU probe's carried dependency."""
    tab, acc = table, torch.zeros(table.shape[1], dtype=table.dtype, device=table.device)
    for _ in range(inner):
        r = step(tab)
        tab = tab + 1e-20 * r[None, :]
        acc = acc + r
    return acc


def check_kernels(table, idx, vals, blk: int = BLK) -> dict:
    """Each kernel against its twin on the same inputs; returns each one's
    max abs error, and raises if ``gather_rows`` differs in any bit,
    ``gather_err_grad`` by more than ``testing.GATHER_ERR_GRAD_RTOL``, or
    two runs of it in any bit."""
    rows = gather.gather_rows(table, idx)
    rows_twin = gather.gather_rows_plain(table, idx)
    fused = gather.gather_err_grad(table, idx, vals, blk)
    again = gather.gather_err_grad(table, idx, vals, blk)
    fused_twin = gather.gather_err_grad_plain(table, idx, vals, blk)
    errs = {"gather_rows": float((rows - rows_twin).abs().max()),
            "gather_err_grad": float((fused - fused_twin).abs().max())}
    rel = errs["gather_err_grad"] / float(fused_twin.abs().max())
    if not torch.equal(rows, rows_twin) or not torch.equal(rows, table.index_select(0, idx.long())):
        raise AssertionError("gather_rows differs from its twin or from index_select")
    if not rel <= checks.GATHER_ERR_GRAD_RTOL:
        raise AssertionError(f"gather_err_grad vs twin: rel {rel} > {checks.GATHER_ERR_GRAD_RTOL}")
    if not checks.same_bits(fused, again):
        raise AssertionError("two runs of gather_err_grad differ in raw bits")
    print(f"[probe] gather_rows == twin == index_select bit for bit; gather_err_grad max_abs_err "
          f"{errs['gather_err_grad']!r} rel {rel!r} (limit {checks.GATHER_ERR_GRAD_RTOL}), two runs the same raw "
          f"bits (K={table.shape[1]}, S={idx.shape[0]})", flush=True)
    return errs


def timeit(name, step, table, inner: int = INNER) -> float:
    """Milliseconds per gather of one variant (best of three loops)."""
    first = float(loop(step, table, inner).sum())  # warm-up, and the checksum
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loop(step, table, inner)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    per = best / inner
    gb = S * table.shape[1] * table.element_size() / 1e9
    print(f"[probe] {name}: {per!r} ms/gather ({gb / (per / 1e3)!r} GB/s of rows; checksum {first:.5g})",
          flush=True)
    return per


def err_grad_ms(table, idx, vals, blk: int = BLK, rounds: int = 7) -> float:
    """Milliseconds a call of ``gather_err_grad``, the median of ``rounds``
    CUDA graph replays of ``GRAPH_CALLS`` calls.  A replay launches without
    calling the wrapper, so it adds to no launch count."""
    fn = graphed(lambda: gather.gather_err_grad(table, idx, vals, blk), GRAPH_CALLS)
    ms = alternating_ms({"p4": fn}, rounds)["p4"] / GRAPH_CALLS
    print(f"[probe] gather_err_grad: {ms!r} ms a call (graph replays)", flush=True)
    return ms


def run(device, names=VARIANTS, graphs: bool = True) -> tuple[dict, dict]:
    """Check the kernels, then time ``names`` and, with ``graphs``,
    ``gather_err_grad`` alone; returns ({kernel: max abs error against its
    twin}, {variant: ms per gather, and "p4 call": ``err_grad_ms``})."""
    table, idx, vals = inputs(device)
    errs = check_kernels(table, idx, vals)
    fns = steps(idx, vals)
    per = {name: timeit(name, fns[name], table) for name in names}
    if graphs:
        per["p4 call"] = err_grad_ms(table, idx, vals)
    return errs, per


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("mosaic_gather: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi} | N={N} K={K} S={S} BLK={BLK} INNER={INNER}", flush=True)
    run(torch.device("cuda", 0), names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
