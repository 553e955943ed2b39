"""Readings that set a cell's limits: the program's sound jobs and the
cell's controls, on many seeds, at the cell's own size.

    python3 -m perfbench.control --workload ml100k.f32 --seeds 1-12 --controls 3 --faults 3 [--device cuda]

For every seed it makes the cell's data, runs one job of the cell's timed
path (after one warm job) and judges it against the float64 reference, as
a run of ``perfbench.run`` does.  On the first ``--controls`` seeds it also
judges each control that the traffic mix names under ``controls``:

* ``{"argv": {...}}``: the program with a lower-precision path of its own
  switched on (the job's flags replaced by these);
* ``{"reference_dtype": ..., "tf32": ...}``: the reference itself, put in
  the program's place and computed in a lower precision.

On the first ``--faults`` seeds it judges one job with each fault of
``perfbench.faults`` planted under the timed path (``fault_<name>``).

One JSON line a reading: seed, variant, and each compared number.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def parse_seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def readings(cell, seeds: list[int], controls: int, device: str = "cuda", root: str | None = None,
             n_faults: int = 0):
    """Yields one dict a (seed, variant): ``factor_gap``, ``top1_gap``."""
    import torch

    from perfbench import datagen, faults, judge, reference, registry, run
    from perfbench.taps import Sink, install_all
    from recsys_tpu_torch import cli

    root = root or registry.ROOT
    sink = Sink()
    undo = install_all(sink)
    warmed = set()
    try:
        for n, seed in enumerate(seeds):
            inst = datagen.make(cell.config, seed, root, device)
            fd, path = tempfile.mkstemp(suffix=".in", prefix="perfbench_control_")
            with os.fdopen(fd, "w") as f:
                f.write(datagen.format_in(inst))
            try:
                variants = {"sound": {}}
                if n < controls:
                    variants.update(cell.traffic.get("controls", {}))
                if n < n_faults:
                    variants.update({f"fault_{f}": {"fault": f} for f in faults.FAULTS})
                t = time.perf_counter()
                ref_L, ref_R = reference.solve(inst, device=device, dtype=torch.float64)
                B = reference.scores(ref_L, ref_R, inst)
                ref_s = time.perf_counter() - t
                for name, v in variants.items():
                    if "reference_dtype" in v:
                        L, R = reference.solve(inst, device=device, dtype=getattr(torch, v["reference_dtype"]),
                                               tf32=v.get("tf32", False))
                        out = reference.format_top1(reference.top1(reference.scores(L, R, inst)), inst)
                        caps, ok, wall = [("rows", L, R)], True, None
                    else:
                        argv = run.job_argv(path, {**cell.traffic, **v.get("argv", {})}, device)
                        if tuple(argv) not in warmed:
                            run.run_job(cli, argv, sink, None, False, None)
                            warmed.add(tuple(argv))
                        sink.kept.clear()
                        unplant = faults.plant(v["fault"]) if "fault" in v else (lambda: None)
                        try:
                            job = run.run_job(cli, argv, sink, 0, False, None)
                        finally:
                            unplant()
                        caps, ok, out, wall = list(sink.kept.values()), job["ok"], job["out"], job["wall"]
                    yield {"workload": cell.name, "seed": seed, "variant": name, "ok": ok, "wall_s": wall,
                           "reference_s": ref_s,
                           "factor_gap": judge.factor_gap(caps, (ref_L, ref_R), inst),
                           "top1_gap": judge.top1_gap([out] if ok else [], B, inst)}
            finally:
                os.remove(path)
    finally:
        for u in undo:
            u()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0, help="seeds on which each planted fault is read")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    from perfbench import registry, run

    run.cache_env(registry.ROOT)
    cell = registry.cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    for r in readings(cell, parse_seeds(args.seeds), args.controls, args.device, n_faults=args.faults):
        line = json.dumps(r)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
