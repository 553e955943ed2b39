"""Runtime acceptance policy for the bfloat16 speed mode, built from the
card's rows (port of ``recsys_tpu/bench/bf16_policy.py``).

bfloat16 is a speed tier whose claim is argmax agreement with the exact-f64
golden; the sweep flags rows below ``FLOOR`` when it renders them, and
``run``/``bench`` in the CLI must not silently print sub-floor
recommendations either.  ``MEASURED`` pins the card's per-shape bf16
agreements, keyed by problem shape so a generated and an original fixture
of one shape share a verdict; unknown shapes get the generic warning.  The
JAX package's values are TPU readings and are not used here.

The hint a warning gives is the tier the card's rows show to be fastest
(best end-to-end wall) among those reaching the floor on that shape
(``FASTEST``), or ``--dtype float32`` where no row says otherwise.  On the
card ``bf16x3`` is not the fast tier: it reads slower than true f32 on the
dense kernels (instML100k 38.38 against 24.71 µs an iteration on an NVIDIA
H100 80GB HBM3 at 700 W, PERF.md §5).

``tables_from_rows`` derives both tables from sweep rows; the test suite
holds the pinned tables against ``bench_results_torch.jsonl``.
"""

from __future__ import annotations

import sys

from recsys_tpu_torch.bench.sweep import BF16_MIN_AGREEMENT as FLOOR  # one floor, everywhere
from recsys_tpu_torch.bench.sweep import latest_rows

# (users, items, features, iters) -> measured argmax agreement of bf16 with
# the exact-f64 golden.  Source: the bfloat16 rows of bench_results_torch.jsonl
# (python -m recsys_tpu_torch.bench.sweep --dtype bfloat16, NVIDIA H100 80GB
# HBM3, 700.00 W).
MEASURED: dict[tuple[int, int, int, int], float] = {
    (1000, 80000, 20, 3000): 0.0,  # gen-inst1000-80000-20-10-1000
    (100000, 1000, 20, 200): 0.9955,  # gen-inst100000-1000-20-1-3
    (1000000, 100, 700, 10): 0.4178,  # gen-inst1e6-100-700-1-3
    (20000, 10000, 40, 1000): 0.0001,  # gen-inst20000-10000-40-2-50
    (60000, 2000, 200, 200): 0.0027,  # gen-inst60000-2000-200-10-20
    (6040, 3952, 30, 3000): 0.9699,  # gen-instML1M
    (3, 5, 2, 5000): 1.0,  # inst0
    (4, 5, 2, 100000): 1.0,  # inst1
    (1000, 1000, 100, 1000): 0.992,  # inst1000-1000-100-2-30
    (1000, 1000000, 1000, 10): 0.683,  # inst1000-1e6-1000-1-3
    (5, 7, 4, 50000): 1.0,  # inst2
    (200, 10000, 50, 1000): 0.99,  # inst200-10000-50-100-300
    (30, 40, 10, 20000): 1.0,  # inst30-40-10-2-10
    (400, 50000, 30, 500): 0.455,  # inst400-50000-30-200-500
    (500, 500, 20, 10000): 0.734,  # inst500-500-20-2-100
    (50000, 5000, 20, 3000): 0.1036,  # inst50000-5000-100-2-5
    (600, 10000, 10, 5000): 0.8317,  # inst600-10000-10-40-400
    (943, 1682, 30, 3000): 0.9883,  # instML100k
}

# (users, items, features, iters) -> the sweep dtype with the best wall among
# the float32, f32x3 and float64 rows at or above FLOOR on that shape, where
# it is not float32 (same rows; ``tables_from_rows``).  In these rows float32
# is the fastest such tier on every other shape.
FASTEST: dict[tuple[int, int, int, int], str] = {
    (1000, 1000, 100, 1000): "float64",  # inst1000-1000-100-2-30
}

TIER_FLAGS = {"f32x3": "--dtype float32 --precision bf16x3", "float64": "--dtype float64"}


def _shape(spec) -> tuple[int, int, int, int]:
    return (spec.users, spec.items, spec.features, spec.iters)


def lookup(spec) -> float | None:
    """Measured bf16 agreement for this problem shape, or None if never measured."""
    return MEASURED.get(_shape(spec))


def hint(spec) -> str:
    """What to run instead: the fastest tier at or above the floor on this
    shape in the card's rows, else true f32."""
    tier = FASTEST.get(_shape(spec))
    if tier is None:
        return "use --dtype float32 (no card row shows a faster tier at the floor on this shape)"
    return f"use {TIER_FLAGS[tier]} (the fastest tier at or above the floor on this shape in the card's rows)"


def check(spec, strict: bool = False, file=None) -> bool:
    """Warn (stderr) about bf16 accuracy for ``spec``; False if refused.

    Returns True when the run may proceed.  With ``strict``, refuses any
    shape whose measured agreement is below ``FLOOR`` or that has no
    measured agreement at all.
    """
    file = sys.stderr if file is None else file
    agree = lookup(spec)
    if agree is None:
        print(
            "warning: bfloat16 is a lossy speed mode with no measured argmax "
            f"agreement for this problem shape (floor: {FLOOR:.0%}); "
            "validate against --dtype float64 before trusting the output, or "
            + hint(spec),
            file=file,
        )
        return not strict
    if agree < FLOOR:
        print(
            f"warning: bfloat16 measured only {agree:.2%} argmax agreement with "
            f"the exact-f64 output on this problem shape (acceptance floor: "
            f"{FLOOR:.0%}, see docs/BENCHMARKS_TORCH.md); " + hint(spec),
            file=file,
        )
        return not strict
    print(
        f"note: bfloat16 speed mode — measured {agree:.2%} argmax agreement "
        f"with exact f64 on this problem shape (floor: {FLOOR:.0%})",
        file=file,
    )
    return True


def tables_from_rows(rows: list[dict]) -> tuple[dict, dict]:
    """(MEASURED, FASTEST) as the card's sweep rows give them: the newest
    row per (instance, dtype), card rows only, bf16 rows with a golden.  A
    row that ran float32's computation under another flag (any dtype on the
    host route, f32x3 off the dense kernels, where its precision does not
    apply) is no tier of its own: only its wall's noise could rank it."""
    measured: dict = {}
    best: dict = {}
    for r in latest_rows(rows):
        if r.get("backend") != "cuda" or r["agreement"] is None:
            continue
        key = (r["users"], r["items"], r["k"], r["iters"])
        if r["dtype"] == "bfloat16":
            measured[key] = r["agreement"]
        elif r["agreement"] >= FLOOR and (r["dtype"] == "float32" or (
                r["path"] != "host" and (r["dtype"] == "float64" or r["path"] == "pallas"))):
            if key not in best or r["wall_s"] < best[key][1]:
                best[key] = (r["dtype"], r["wall_s"])
    return measured, {key: tier for key, (tier, _) in best.items() if tier != "float32"}
