"""The card's ceilings and one cost model for every route (port of
``recsys_tpu/bench/roofline.py``).

The JAX module prices TPU formulations (a 128-lane MXU contraction, the
split f64 gather, a calibrated fused-gather row rate); none of that holds on
an H100.  Here one count of work serves every route, so the sweep's
``pct_roofline`` reads the same work whatever route computes it:

* an iteration is 6·k FLOP per rating (the prediction once and both
  gradients) and moves A's ratings once (a value in the run's dtype and an
  int32 column index: CSR, the least a sparse form needs) plus the rows of
  L and R that hold a rating each read and written once (a row with no
  rating never changes: counting it would price work the data does not
  need, as inst1000-1e6's 1M items with 2,014 ratings show);
* the run's top-1 is 2·k FLOP per (user, item).  It runs in the ``top1``
  phase on every route but the ``resident`` plan, whose B1 launch finishes
  it inside ``train``; there its floor is 0.1% of the train phase's
  (instML100k: 95 MFLOP once against 3000 iterations of 1.4 MB), so the
  per-iteration floor leaves it out.

The floor is ``max(FLOP / peak(dtype), bytes / HBM)``.  The peaks are the
data sheet's, so a share can read low, never above the chip.  ``PERF.md``
§6 prices each kernel by its own formulation (a BELL step as 4·k FLOP per
rating and side, the dense kernels' A once a run): those are per-kernel
bounds of one launch, this is the per-iteration floor of the function the
whole run computes, so the two tables differ by design.

``measured_hbm_gbps`` reads the card's copy rate (in the manner of
``scripts/calibrate_gather_ceiling.py``, which serves the JAX ceilings);
``calibrate`` reports the highest share any committed card row reaches.

Usage (the card's HBM rate and sync floor, then the highest shares):
    python -m recsys_tpu_torch.bench.roofline [--device cuda] [bench_results_torch.jsonl]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np

# NVIDIA H100 SXM data sheet (dense, 700 W): f32 on the CUDA cores, bf16 on
# the tensor cores, f64 on the CUDA cores, HBM3 bandwidth.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
F64_FLOPS = 34e12
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS, "float64": F64_FLOPS}
# Measured: ``measured_hbm_gbps`` on an NVIDIA H100 80GB HBM3 at 700.00 W
# (a 4 GiB device-to-device copy_, read + write, median of 5; 2998.0-3038.2
# over four calls).  The bound keeps the data sheet's 3350 GB/s, so a share
# reads low, never above the chip.
MEASURED_HBM_GBPS = 2998.0

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}
# Routes the model prices; ``host`` (the native serial engine) has none.
DEVICE_ROUTES = ("pallas", "bell", "dense", "coo")


def rated_rows(spec) -> tuple[int, int]:
    """(users, items) with at least one rating: the rows of L and R an
    iteration reads and writes.  A ProblemSpec counts them from its
    ratings; a sweep row's dims carry them as ``rated_users`` and
    ``rated_items``."""
    if hasattr(spec, "rated_users"):
        return spec.rated_users, spec.rated_items
    return (int(np.count_nonzero(np.bincount(spec.rows, minlength=spec.users))),
            int(np.count_nonzero(np.bincount(spec.cols, minlength=spec.items))))


def iteration_work(spec, dtype: str) -> tuple[float, float]:
    """(FLOP, bytes) of one iteration: 6·k FLOP a rating; A's ratings read
    once (value + int32 column), the rated rows of L and R each read and
    written once."""
    es = ITEMSIZE[dtype]
    k = spec.features
    flops = 6.0 * k * spec.nnz
    nbytes = spec.nnz * (es + 4) + 2.0 * sum(rated_rows(spec)) * k * es
    return flops, nbytes


def floor_seconds(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """(seconds, bound_by): the larger of operations over the dtype's peak
    and bytes over HBM."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def train_cost_model(spec, cfg, path: str):
    """(bound_by, seconds per iteration) of the floor of one iteration on a
    device route (``pallas`` on any plan, ``bell``, ``dense``, ``coo``), in
    f32, bf16 or f64: the same count for every route; (None, None) for
    ``host``.  ``f32x3`` (``precision="bf16x3"``) is float32 work: the same
    function, computed in three bf16 products.  ``spec`` is a ProblemSpec or
    a row's dims (``rated_rows``)."""
    if path not in DEVICE_ROUTES:
        return None, None
    seconds, by = floor_seconds(*iteration_work(spec, cfg.dtype), cfg.dtype)
    return by, seconds


def pct_of_roofline(spec, cfg, path: str, wall_s: float):
    """(model, percent) where percent = modelled-minimum wall over the
    measured wall (pass the steady-state train wall when available, the
    end-to-end wall otherwise); None when no model applies."""
    model, per_iter = train_cost_model(spec, cfg, path)
    if model is None or not wall_s:
        return None, None
    return model, round(100.0 * spec.iters * per_iter / wall_s, 1)


def measured_hbm_gbps(device, nbytes: int = 4 << 30, samples: int = 5) -> float:
    """GB/s of a device-to-device ``copy_`` of ``nbytes`` (read + write
    counted), by CUDA events, median of ``samples`` after one warm copy."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"measured_hbm_gbps reads a CUDA card, not {device}")
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=device).fill_(1.0)
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize(device)
    ms = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    del src, dst
    torch.cuda.empty_cache()
    return 2.0 * nbytes / (statistics.median(ms) * 1e-3) / 1e9


def calibrate(rows: list[dict]) -> dict:
    """{(path, dtype): the highest ``pct_roofline`` any card row reaches}
    (``scripts/calibrate_gather_ceiling.py``'s question, as a function):
    CPU rows and rows with no share are skipped."""
    best: dict = {}
    for r in rows:
        pct = r.get("pct_roofline")
        if r.get("backend") != "cuda" or pct is None:
            continue
        key = (r["path"], r["dtype"])
        best[key] = max(best.get(key, 0.0), pct)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="recsys-tpu-torch-roofline")
    ap.add_argument("jsonl", nargs="?", default=None, help="sweep rows whose highest shares to print")
    ap.add_argument("--device", default=None, help="read this card's HBM rate and sync floor (cuda)")
    args = ap.parse_args(argv)
    if args.device:
        import subprocess

        import torch

        from recsys_tpu_torch.utils.timing import sync_floor_seconds

        if torch.device(args.device).type != "cuda" or not torch.cuda.is_available():
            print(f"error: {args.device!r} is not an available CUDA card", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"measured_hbm_gbps {measured_hbm_gbps(args.device)!r} (data sheet {HBM_BYTES_S / 1e9:g}) | "
              f"sync_floor_seconds {sync_floor_seconds(args.device)!r} | {smi}")
    if args.jsonl:
        with open(args.jsonl) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        for (path, dtype), pct in sorted(calibrate(rows).items()):
            print(f"{path:8s} {dtype:9s} highest share {pct:g}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
