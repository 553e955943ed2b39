"""Probe of the stream kernel's grid on the card: per-step time of B3
(``dense_stream.stream_train``) at several grid sizes and cluster sizes,
against B2 (``dense_fused.resident_train``), and whole runs of B1 against
B3 + B4, at gen-instML1M's and instML100k's shapes in every precision;
then whole runs of both kinds at generated shapes between the two, at
about gen-instML1M's density, to place ``RESIDENT_A_MAX_BYTES``.

    python -m recsys_tpu_torch.probes.stream_grid

Run from the root of a checkout on a machine with a CUDA card.  Times
are CUDA-event times over 300 steps (per step) and over one whole run of
the instance's iterations.
"""

from __future__ import annotations

import os
import subprocess

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.ops import dense_fused, dense_stream
from recsys_tpu_torch.utils.timing import cuda_event_ms as event_ms

MODES = ("highest", "bf16x3", "default")
GRIDS = ((2, 8), (3, 8), (3, 16), (4, 8), (4, 16))  # (blocks per SM, largest cluster)
# (users, items) between instML100k (1.8 MB of int8 A^T) and gen-instML1M (24.4 MB).
CROSSOVER_SHAPES = ((1536, 1152), (2048, 1536), (2816, 2048), (3584, 2688), (4608, 3328), (5120, 3584), (5632, 3840))
CROSSOVER_ITERS = 1000
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def inputs(spec, dev):
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, torch.int8, dev)
    return torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev), A


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stream_grid: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi}", flush=True)
    specs = {"gen-instML1M": generate_instance(**GEN_SPECS["gen-instML1M"]),
             "instML100k": load_problem(os.path.join(ROOT, "tests", "fixtures", "instML100k.in"))}
    for name, spec in specs.items():
        Lt, Rt, A = inputs(spec, dev)
        K, U, I = Lt.shape[0], Lt.shape[1], Rt.shape[1]
        for precision in MODES:
            kw = dict(alpha2=2 * spec.alpha, precision=precision, iters=300)
            res, ref = [], None
            for grid in GRIDS:
                got = dense_stream.stream_train(Lt, Rt, A, grid=grid, **kw)
                ref = ref or got
                part = dense_stream.stream_partial_bytes(K, U, I, grid=grid)
                res.append((f"B3 grid {grid[0]}/{grid[1]} partials {part} B rel_to_first {checks.factor_rel(got, ref):.2e}",
                            event_ms(lambda: dense_stream.stream_train(Lt, Rt, A, grid=grid, **kw))))
            res.append(("B2", event_ms(lambda: dense_fused.resident_train(Lt, Rt, A, **kw))))
            print(f"[step] {name} {precision}: " + " | ".join(f"{k} {v / 300 * 1e3!r} us" for k, v in res),
                  flush=True)
        for precision in MODES:
            kw = dict(alpha2=2 * spec.alpha, precision=precision, iters=spec.iters)
            b1 = event_ms(lambda: dense_fused.resident_train_top1(Lt, Rt, A, items_true=spec.items, **kw))
            b34 = event_ms(lambda: dense_stream.stream_top1(*dense_stream.stream_train(Lt, Rt, A, **kw), A,
                                                            precision=precision, items_true=spec.items))
            print(f"[run] {name} {precision} {spec.iters} iters, grid {dense_stream._GRID}: "
                  f"B1 {b1!r} ms, B3+B4 {b34!r} ms", flush=True)
    for users, items in CROSSOVER_SHAPES:
        spec = generate_instance(users, items, 30, max(2, items // 100), items // 12,
                                 iters=CROSSOVER_ITERS, alpha=1e-4, seed=users)
        Lt, Rt, A = inputs(spec, dev)
        density = spec.nnz / (users * items)
        for precision in MODES:
            kw = dict(alpha2=2 * spec.alpha, precision=precision, iters=spec.iters)
            b1 = event_ms(lambda: dense_fused.resident_train_top1(Lt, Rt, A, items_true=spec.items, **kw))
            b34 = event_ms(lambda: dense_stream.stream_top1(*dense_stream.stream_train(Lt, Rt, A, **kw), A,
                                                            precision=precision, items_true=spec.items))
            print(f"[cross] {users}x{items} A^T {A.numel()} B density {density:.4f} {precision} "
                  f"{spec.iters} iters: B1 {b1!r} ms, B3+B4 {b34!r} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
