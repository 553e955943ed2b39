#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases,
each printed as it runs:

1. device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions.  No CUDA device -> exit 1 at once.
2. build: the CUDA kernels from ``recsys_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source).
3. B1 vs its plain twin on the card, every precision x A storage, on a
   small generated instance and on the instML100k shape: the factors
   after 20 iterations and the update of one step from near-fit factors,
   each within its limit (``recsys_tpu_torch/testing.py``); then the
   controls each limit must reject, and the all-ones tie case.
4. B2, B3, B4 and B6 vs their twins, every precision x A storage, on the
   small instance and at the instML100k and gen-instML1M shapes (the
   main paths' shapes of B2 and of B3, B4): the same readings, the
   controls at gen-instML1M's shape, and the identities B2 = B1's factors,
   B4 = B1's top-1 and B6 = B3 then B4, bit for bit; B3 against itself
   (two runs) in raw bits and within the factor limit of B2; the tie case
   for B4 and B6.
5. B5 (its fused step, as ``tiled_train`` runs it) vs its twin, every
   precision x A storage, on the small instance and at the gen-instML1M
   and gen-inst1e6-100-700-1-3 shapes (20 steps): the same readings, two
   runs bit for bit, the controls at both large shapes, and B5's training
   within the factor limit of B3's at gen-instML1M's.  Then (``[redesign]``)
   the fused step against the composition it replaced, B5's raw deltas
   and the torch update (``probes/tiled_fused.py``): equal in raw bits in
   each form of its L pass, every precision x A storage, at the small
   spec (k = 10, 700, 1000) and both large shapes, the raw deltas against
   the twin's, and both timed in turns at gen-inst1e6 (ms a step) and
   gen-instML1M (us a step); the fused step must be no slower at
   gen-inst1e6.
5b. ``bell_side_update`` (P2's engine form) vs its twin, bit for bit, in
   f64, f32 and bf16, on small specs (stored 0 ratings, k = 700 and hub
   rows of 1500 slots at k = 30, 100 and 700 among them) and at
   instML100k (20 steps), in both forms, two runs bit for bit; in f64
   against ``_native.serial_gd`` bit for bit, and the sum-then-add
   control, which must differ there; in bf16 the two controls of
   ``testing.py`` (the step in f32 rounded once, a bf16 row accumulator),
   which must differ from the twin; then at gen-inst1e6-100-700-1-3's
   shape (2 steps, hub rows of ~20,000 slots, 1M-row buckets) against the
   twin, bit for bit in f64, f32 and bf16, two runs bit for bit, and one
   step of the block form against the warp form alone, bit for bit and
   timed in turns.
5c. the resident/stream line (``probes/plan_line.py``): B2's steps and
   B3's at instML100k and gen-instML1M in `highest`, slopes in turns; then
   ``bell_side_update``'s block form against its warp form bit for bit
   (``probes/bell_wide.py``: instML100k and a hub-row spec in f64 and f32)
   and one step at several thresholds in turns, and ``bell_train``'s fused
   step against two launches a step; the engine's forms must be no slower
   at instML100k.
6. main path, instML100k: ``trainer.run`` in highest, bf16x3 and default on
   the auto plan (resident) and with the stream kind forced, held against
   the golden ``.out`` with launch counts, phase times, the slope and the
   plain twin's train time.
7. main path, gen-instML1M (built in memory from ``GEN_SPECS``): the same on
   the auto plan (stream: B3 then B4) and with the resident and tiled
   kinds forced.
8. main path, ``--checkpoint``: the CLI on instML100k in chunks of 1000
   iterations (B2) against an unchunked ``factorize`` + ``recommend``.
9. main path, gen-inst1e6-100-700-1-3 (k = 700, built in memory): ``run``
   with ``path="pallas"`` in every mode on the auto plan (tiled: B5's fused
   step once per step, then ``recommend`` on the factors left on the card)
   against the golden ``.out``, with launch counts and phase times; then
   one tiled step's device time by kernel (``torch.profiler``), fused and
   as the old composition, at its shape and at gen-instML1M's.
10. main path, exact f64: instML100k through ``run()`` on the auto route
   (``bell``, one launch a step) byte for byte against its golden, with
   phases, the slope and one twin step's time; ``--path dense`` f64 once;
   inst200-10000-50-100-300 f64 through ``run()``.
10b. the device init's kernel (``glibc_init``): its words equal to the host
    generator's either side of a segment and a block's span, then
    ``device_init_factors`` at gen-inst1e6's shape bit for bit against the
    host draws on a sample of rows and against the torch twin on the card
    over every draw, and both timed beside the floor; phase 11's f32 run
    then draws its factors on the card, in one launch.
11. main path, gen-inst1e6-100-700-1-3 on the auto route (``bell``) in
   f64 (byte for byte against its golden) and in f32.
11b. main path, bf16 on the auto route (``bell``, one launch a step) at
   gen-inst100000-1000-20-1-3, inst400-50000-30-200-500,
   inst50000-5000-100-2-5 (host init) and gen-inst1e6-100-700-1-3 (device
   init), each agreement beside the JAX package's own bf16 reading and
   the port twin's on the CPU; gated at 0.98 on gen-inst100000-1000 and at
   ``INST1E6_BF16_FLOOR`` on gen-inst1e6, where the JAX package's bf16
   agreement holds.  At inst400-50000 and gen-inst1e6 the card's trained
   factors must equal the twin's in raw bits over the whole run (the twin
   on the host CPU, and on the card for gen-inst1e6), and the top-1 of
   those factors is read on the card and on the CPU.
12. the P2 probe (``probes/mosaic_gather.py``) at the TPU script's shapes:
   ``gather_rows`` and ``gather_err_grad`` against their twins and
   ``gather_err_grad`` against itself (two runs) in raw bits, then the
   five variants, and ``gather_err_grad`` alone from graph replays.
13. the P1 probe (``probes/gather.py``): ``lane_gather_loop`` (the
   bank-conflict-free schedule) equal to its twin bit for bit at every
   probe shape, with full-width and broadcast indices;
   ``lane_cumsum_loop`` (a row over a thread-block cluster) equal to the
   kernel's order (``lane_cumsum_loop_order_plain``) in raw bits at every
   probe shape and t = 2, 5, 512, and within ``testing.LANE_CUMSUM_RTOL``
   of the twin with its control rejected; then the probe's timings, each
   kernel's step counts in turns in one profile a shape, the cluster size
   chosen with ``cudaOccupancyMaxActiveClusters``, and the gate: every
   kernel's T-scaling in 3.5-4.5x (T = 512 against T = 128 net of the
   T = 0 launch at every shape; raw T = 2048 against T = 512 at the widest
   shape).
14. the P3 probe (``probes/stream_v2.py``): ``stream_v2_train`` (B3's walk
   on the packed layout) against its twin (control rejected), and in raw
   bits against itself (two runs) and B3, at the small spec (every A
   storage, k = 40) and at gen-instML1M's and inst200-10000's shapes, then
   both slopes in turns: B3 ("v1") and P3 ("v2").
15. main path, ``--path coo``: instML100k through ``run()`` in f32 (prefix
   sums) and f64 (segment sums) against the golden, two ``factorize`` runs
   bit for bit in each, phases and slope, one step's device time by kernel.

16. the sharded engine (``recsys_tpu_torch/parallel``), every shard on the
   card: ``bell_side_delta`` (the delta form of ``bell_side_update``, the
   sharded BELL's per-shard kernel) against its twin in raw bits in f64,
   f32 and bf16, both forms, every shard of a 2x4 mesh at the dryrun's
   shapes and a hub spec and shard (0, 0) of gen-inst1e6 on its (4, 1)
   mesh, 2 steps; B5's raw ``tiled_deltas`` against its twin at
   instML100k's 2x2 shard shapes within ``testing.TILED_UPDATE_RTOL``;
   ``parallel.engine.dryrun(8)``; instML100k through ``run()`` on a 2x2
   mesh in f32 `highest` (``tiled_deltas`` a shard and step, floor 0.99)
   and f64 (the checkerboard BELL, byte for byte), each with one step split
   by CUDA events into the shards' kernels and the reductions, copies and
   updates; gen-inst1e6 f32 through ``run()`` on the (4, 1) mesh (the
   checkerboard BELL with the device init, floor 0.99).  Each run prints a
   ``[mesh]`` line: phases, wall, agreement, launches.
17. the multi-process layer (``recsys_tpu_torch/parallel/multihost.py``,
   ranks started by ``parallel/launch.py``): one rank over NCCL in this
   process, then 2 and 4 ranks sharing the card over gloo (NCCL refuses two
   ranks on one GPU), each rank a process, on instML100k 2x2 (f64
   ``bell`` on 2 and 4 ranks, byte for byte; f32 ``tiled`` on 1 and 2),
   and 3 ranks on a 2x3 mesh at a small generated instance (f64 ``bell``,
   f32 ``tiled``; one mesh row sums 3 partials).  Every rank's whole
   factors equal the one-process engine's in raw bits, its text the one
   process's; the kernels' launches, summed over the ranks, go into the
   kernels line; each rank's step is split by CUDA events into its shards'
   kernels, the exchange of partials and the rest (``[multihost]`` lines,
   with the card's name and power limit).  Then the CLI: ``bench``
   instML100k (its JSON line, ``path`` the auto route), and ``generate``
   a small instance into build/, ``run`` it in f64 and ``oracle`` it, the
   outputs byte equal less the time line.  A rank's failure, timeout or
   missing line fails the phase.
18. the bench harness (``recsys_tpu_torch/bench``): the card's HBM copy rate
   (``roofline.measured_hbm_gbps``) and the cost of a synchronise
   (``timing.sync_floor_seconds``); ``sweep.run_instance`` with one repeat
   on instML100k f32 (``pallas``: a byte match and a slope) and
   inst200-10000-50-100-300 f64 (``bell``: all 200 lines, 200/201 of the
   golden's), each a ``[bench]`` row from the card with its device memory
   peak and a share of the roofline in (0, 105]; ``scaling.measure_mesh``
   on instML100k at 50 iterations on 1x1, 2x1 and 2x2, every shard on the
   card; and the CLI's ``run --dtype bfloat16 --strict`` on instML100k and
   on gen-instML1M (written to a temporary directory), each running or
   refused before training as ``bench/bf16_policy.MEASURED`` says.

Every main path runs with the launch counts set to 0 just before it and
read just after.  The last two lines are a JSON object of the kernels'
numbers and ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before them.  It imports nothing of JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ML100K = os.path.join(FIXTURES, "instML100k")
ML1M_OUT = os.path.join(ROOT, "tests", "fixtures", "gen-instML1M.out")
INST1E6 = "gen-inst1e6-100-700-1-3"
INST1E6_OUT = os.path.join(ROOT, "tests", "fixtures", INST1E6 + ".out")
MODES = ("highest", "bf16x3", "default")
STORAGES = ("int8", "bfloat16", "float32")
# Argmax agreement floors against the f64 golden: the f32 tiers match it
# fully on the reference chip; single-pass bf16 is held to the bench's
# 98% floor (recsys_tpu/bench/sweep.py:93) on instML100k.  gen-instML1M's
# bf16 floor is 0.95: the JAX package itself reads 0.9669 there
# (bench_results.jsonl).
AGREEMENT_FLOOR = {"highest": 0.99, "bf16x3": 0.99, "default": 0.98}
ML1M_FLOOR = {"highest": 0.99, "bf16x3": 0.99, "default": 0.95}
# gen-inst1e6's f32 run reads 0.9938 in the JAX package's tiled route
# (bench_results.jsonl); `default` runs as `highest` on the tiled route.
INST1E6_FLOOR = {"highest": 0.99, "bf16x3": 0.98, "default": 0.99}
# The card's peaks (f32 and f64 on the CUDA cores, bf16 on the tensor
# cores) and HBM rate are the H100 SXM data sheet's, held in
# recsys_tpu_torch/bench/roofline.py and read by ``_bound``.
# Shared memory of an H100 SXM: 128 B a clock per SM (32 banks of 4 B) at
# the 1,980 MHz boost clock on 132 SMs.
SMEM_BYTES_S = 128 * 1.98e9 * 132
# Steps of the P3 probe (the TPU script's default).
P3_ITERS = 300
INST200 = os.path.join(ROOT, "tests", "fixtures", "inst200-10000-50-100-300")
# Argmax agreement floors of the f64 runs that are not byte-exact by
# contract: the dense route's DGEMMs sum in another order than the
# reference (0.99), inst200-10000 sits at 99.5% in every JAX engine.
# gen-inst1e6 on `bell` is byte-exact in f64 (1.0 demands the byte match)
# and held to its f32 floor in f32.
DENSE_F64_FLOOR, INST200_FLOOR = 0.99, 0.995
INST1E6_BELL_FLOOR = {"float64": 1.0, "float32": 0.99}
# bf16 on `bell` through `run()`: the argmax agreement with the golden in
# bf16 on the BELL route of the JAX package (JAX_BF16_BELL) and of the
# port's twin (PORT_CPU_BF16_BELL), both on the CPU at each instance's full
# iteration count (tests/bf16_bell_readings.py).  The two part after a few
# steps: one f32 sum of a row's terms that lands on a bf16 tie in slot
# order and off it in XLA's order (PERF.md).  bf16 there is a speed mode
# whose agreement depends on the instance, so the gate stands only where
# the reference holds: the bench's 0.98 on gen-inst100000-1000, and on
# gen-inst1e6 (no JAX bf16 reading) INST1E6_BF16_FLOOR: the first H100
# reading, 0.417817 (PERF.md), less INST1E6_FLOOR's margin of 0.01, rounded
# down, with the twin's factors on the card as its witness (_bf16_witness).
# bf16's 8-bit mantissa there loses most of k = 700's small updates.
JAX_BF16_BELL = {"gen-inst100000-1000-20-1-3": 0.99553, "inst400-50000-30-200-500": 0.4475,
                 "inst50000-5000-100-2-5": 0.1038}
PORT_CPU_BF16_BELL = {"gen-inst100000-1000-20-1-3": 0.99553, "inst400-50000-30-200-500": 0.455,
                      "inst50000-5000-100-2-5": 0.1036}
BF16_BELL_FLOOR = {"gen-inst100000-1000-20-1-3": 0.98}
INST1E6_BF16_FLOOR = 0.40
# Where the bf16 factors and top-1 are held against the twin and the CPU
# (``_bf16_witness``), besides gen-inst1e6.
BF16_WITNESS = "inst400-50000-30-200-500"
# Steps of the BELL kernel-vs-twin reading at gen-inst1e6's shape.
INST1E6_BELL_STEPS = 2
FORCE_RESIDENT = 1 << 62
# The sharded engine's phase: instML100k on a 2x2 mesh, gen-inst1e6 on the
# (4, 1) mesh ``balanced_grid`` picks for 4 shards of 1M x 100, every shard
# on the one card; the dryrun's shard count; floors against the golden (f64
# demands the byte match).
MESH, INST1E6_MESH, DRYRUN_SHARDS = (2, 2), (4, 1), 8
MESH_FLOOR = {"float32": 0.99, "float64": 1.0}
# The multi-process phase: ranks sharing the card over gloo (NCCL refuses
# two ranks on one GPU), as (ranks, mesh, cases); the 2x3 mesh on 3 ranks
# runs a small generated instance (generate_instance's five dims, iters,
# alpha, seed), where one mesh row sums 3 partials, 2 of one rank and 1 of
# another; steps of each rank's step split; the ranks' time limit.
MULTIHOST_GEN = [600, 900, 16, 2, 20, 200, 0.001, 7]
# key: (mesh, dtype, path, the sharded route it takes); "ml" is instML100k.
MULTIHOST_CASES = {"ml f64": (MESH, "float64", "auto", "bell"), "ml f32": (MESH, "float32", "auto", "tiled"),
                   "gen f64": ((2, 3), "float64", "bell", "bell"), "gen f32": ((2, 3), "float32", "pallas", "tiled")}
MULTIHOST_RUNS = ((2, MESH, ("ml f64", "ml f32")), (4, MESH, ("ml f64",)), (3, (2, 3), ("gen f64", "gen f32")))
MULTIHOST_REPS, MULTIHOST_TIMEOUT = 20, 240
# The CLI's check: ``generate`` this instance into build/, ``run`` it in f64
# on the card (``bell``) and hold it against ``oracle``.
CLI_GEN = ("inst300-500-20-2-30", ["--iters", "500", "--alpha", "0.001", "--seed", "3"])

# The bench phase: (instance, sweep dtype, the route it must take) of each
# ``sweep.run_instance`` row; the mesh shapes and iterations of
# ``scaling.measure_mesh``; the instances of the CLI's bf16 ``--strict`` check.
BENCH_ROWS = (("instML100k", "float32", "pallas"), ("inst200-10000-50-100-300", "float64", "bell"))
BENCH_MESH_SHAPES, BENCH_MESH_ITERS = ((1, 1), (2, 1), (2, 2)), 50
BENCH_CLI = ("instML100k", "gen-instML1M")

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "resident_train_top1": ("recsys_tpu_torch/csrc/dense_fused.cu", "recsys_tpu/ops/pallas_dense.py:663"),
    "resident_train": ("recsys_tpu_torch/csrc/dense_fused.cu", "recsys_tpu/ops/pallas_dense.py:238"),
    "stream_train": ("recsys_tpu_torch/csrc/dense_stream.cu", "recsys_tpu/ops/pallas_dense.py:420"),
    "stream_top1": ("recsys_tpu_torch/csrc/dense_fused.cu", "recsys_tpu/ops/pallas_dense.py:473"),
    "stream_train_top1": ("recsys_tpu_torch/csrc/dense_stream.cu", "recsys_tpu/ops/pallas_dense.py:433"),
    "tiled_deltas": ("recsys_tpu_torch/csrc/dense_tiled.cu", "recsys_tpu/ops/pallas_dense.py:566"),
    "tiled_step": ("recsys_tpu_torch/csrc/dense_tiled.cu", "recsys_tpu/ops/pallas_dense.py:566"),
    "bell_side_update": ("recsys_tpu_torch/csrc/bell.cu", "scripts/probe_mosaic_gather.py:139"),
    "gather_rows": ("recsys_tpu_torch/csrc/bell.cu", "scripts/probe_mosaic_gather.py:118"),
    "gather_err_grad": ("recsys_tpu_torch/csrc/bell.cu", "scripts/probe_mosaic_gather.py:139"),
    "bell_side_update_bf16": ("recsys_tpu_torch/csrc/bell.cu", "scripts/probe_mosaic_gather.py:139"),
    "bell_side_delta": ("recsys_tpu_torch/csrc/bell.cu", "scripts/probe_mosaic_gather.py:139"),
    "lane_gather": ("recsys_tpu_torch/csrc/lane.cu", "scripts/probe_gather.py:40"),
    "lane_cumsum": ("recsys_tpu_torch/csrc/lane.cu", "scripts/probe_gather.py:57"),
    "stream_v2_train": ("recsys_tpu_torch/csrc/dense_stream.cu", "scripts/probe_stream_v2.py:89"),
    "glibc_init": ("recsys_tpu_torch/csrc/glibc_init.cu", "none (the JAX package draws with XLA ops)"),
}
# The T-scaling of the P1 kernels: 4x the steps must take 4x the time,
# within this range, or the loop-invariant body was hoisted: T = 512 against
# T = 128 net of the T = 0 launch at every shape, and raw T = 2048 against
# T = 512 at the widest shape (a fixed cost f and a step s read 3.5 there
# while f <= 102.4 s; at 512 / 128 while f <= 25.6 s).
T_SCALING = (3.5, 4.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def _wrappers():
    from recsys_tpu_torch.ops import bell, dense_fused, dense_stream, dense_tiled, device_rng, gather, lane, stream_v2

    return {
        "glibc_init": device_rng.glibc_stream,
        "resident_train_top1": dense_fused.resident_train_top1,
        "resident_train": dense_fused.resident_train,
        "stream_train": dense_stream.stream_train,
        "stream_top1": dense_stream.stream_top1,
        "stream_train_top1": dense_stream.stream_train_top1,
        "tiled_deltas": dense_tiled.tiled_deltas,
        "tiled_step": dense_tiled.tiled_step,
        "bell_side_update": bell.bell_side_update,
        "bell_side_delta": bell.bell_side_delta,
        "gather_rows": gather.gather_rows,
        "gather_err_grad": gather.gather_err_grad,
        "lane_gather": lane.lane_gather_loop,
        "lane_cumsum": lane.lane_cumsum_loop,
        "stream_v2_train": stream_v2.stream_v2_train,
    }


@contextlib.contextmanager
def counted(into: dict):
    """Every kernel's launch count set to 0 on entry; the counts on exit
    go into ``into``."""
    fns = _wrappers()
    for fn in fns.values():
        fn.launches = 0
    yield
    into.update({name: fn.launches for name, fn in fns.items()})


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from recsys_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc} | "
        f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def build_phase():
    from recsys_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {time.perf_counter() - t0:.3f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _inputs(spec, a_dtype, dev, torch):
    from recsys_tpu_torch.ops import dense_fused

    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, a_dtype, dev)
    return torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev), A


def _small_spec(iters):
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(200, 300, 10, 2, 30, iters=iters, alpha=0.001, seed=5)


def _ml1m_spec():
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    return generate_instance(**GEN_SPECS["gen-instML1M"])


def _inst1e6_spec():
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    t0 = time.perf_counter()
    spec = generate_instance(**GEN_SPECS[INST1E6])
    log(f"[main] {INST1E6} generated in memory in {time.perf_counter() - t0!r} s: {spec.users}x{spec.items} "
        f"k={spec.features} nnz={spec.nnz} iters={spec.iters}")
    return spec


def _tiled_inputs(spec, a_dtype, dev, torch, factors):
    """(L, R, A) on ``dev`` in the tiled layout, from the host tables
    ``factors`` of ``dense_tiled.pad_factors_lane_major``."""
    from recsys_tpu_torch.ops import dense_tiled

    L, R, (U, I, _) = factors
    A = dense_tiled.device_dense_A(spec, U, I, a_dtype, dev)
    return torch.from_numpy(L).to(dev), torch.from_numpy(R).to(dev), A


def kernel_vs_plain_phase(torch, dev):
    """The kernel-vs-twin readings of ``recsys_tpu_torch/testing.py`` for
    B1, every precision x A storage, then the controls each limit must
    reject.  Returns the highest-precision max abs error at the instML100k
    shape."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.ops import dense_fused

    kernel, plain = dense_fused.resident_train_top1, dense_fused.resident_train_top1_plain

    def factor_run(spec, a_dtype, precision, twin_precision):
        Lt, Rt, A = _inputs(spec, a_dtype, dev, torch)
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, items_true=spec.items)
        got = kernel(Lt, Rt, A, precision=precision, **kw)
        want = plain(Lt, Rt, A, precision=twin_precision, **kw)
        torch.cuda.synchronize()
        return A, kw, got, want

    def probe_rel(spec, a_dtype, precision, twin_precision):
        Lt, Rt, A = checks.precision_probe(spec, a_dtype, dev)
        kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2, items_true=spec.items)
        got = kernel(Lt, Rt, A, precision=precision, **kw)
        return checks.update_rel(got, plain(Lt, Rt, A, precision=twin_precision, **kw), Lt, Rt)

    small = _small_spec(checks.FACTOR_ITERS)
    ml = dataclasses.replace(load_problem(ML100K + ".in"), iters=checks.FACTOR_ITERS)
    worst, failed = {}, []
    for name, spec in (("small 200x300 k10", small), ("instML100k shape", ml)):
        for precision in MODES:
            for a_dtype in (torch.int8, torch.bfloat16, torch.float32):
                A, kw, (Lk, Rk, tk), (Lp, Rp, tp) = factor_run(spec, a_dtype, precision, precision)
                err = max(float((Lk - Lp).abs().max()), float((Rk - Rp).abs().max()))
                rel = checks.factor_rel((Lk, Rk), (Lp, Rp))
                upd = probe_rel(spec, a_dtype, precision, precision)
                finite = bool(torch.isfinite(Lk).all() and torch.isfinite(Rk).all())
                # The top-1 pass alone, from identical final factors.
                _, _, t0k = kernel(Lk, Rk, A, precision=precision, **{**kw, "iters": 0})
                _, _, t0p = plain(Lk, Rk, A, precision=precision, **{**kw, "iters": 0})
                top_same = float((tk == tp).float().mean())
                top0_same = float((t0k == t0p).float().mean())
                ok = (finite and rel <= checks.FACTOR_RTOL[precision] and upd <= checks.UPDATE_RTOL[precision]
                      and top0_same == 1.0 and (spec is not small or top_same == 1.0))
                log(f"[kernel] B1 {name} {precision:7s} A={str(a_dtype).split('.')[-1]:8s} "
                    f"max_abs_err={err!r} factor_rel={rel!r} (limit {checks.FACTOR_RTOL[precision]}) "
                    f"probe update_rel={upd!r} (limit {checks.UPDATE_RTOL[precision]}) "
                    f"top1_same={top_same!r} top1_pass_same={top0_same!r} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{name} {precision} {a_dtype}")
                if spec is ml:
                    worst[precision] = max(worst.get(precision, 0.0), err)
    # Controls: the kernel in another mode than the twin stands for a kernel
    # that skips the bf16 rounding of `default` or the split of `bf16x3`, or
    # that drops `highest` to split products.  Each limit must reject it.
    controls = [("factor", kp, tp, checks.factor_rel(*factor_run(ml, torch.int8, kp, tp)[2:]),
                 checks.FACTOR_RTOL[tp]) for kp, tp in checks.FACTOR_CONTROLS]
    controls += [("probe update", kp, tp, probe_rel(ml, torch.int8, kp, tp), checks.UPDATE_RTOL[tp])
                 for kp, tp in checks.UPDATE_CONTROLS]
    failed += _report_controls("B1 instML100k shape", controls)
    K, U = 8, 128
    ones = torch.ones((K, U), device=dev)
    _, _, tie = kernel(ones, torch.ones((K, U), device=dev), torch.zeros((U, U), device=dev),
                       iters=0, alpha2=0.0, items_true=U)
    if not bool((tie == 0).all()):
        failed.append("tie case: lowest index must win")
    log(f"[kernel] B1 all-ones tie case -> all zeros {'ok' if bool((tie == 0).all()) else 'FAIL'}")
    if failed:
        raise AssertionError(f"kernel vs plain twin failed: {failed}")
    return worst


def _report_controls(where, controls):
    failed = []
    for kind, kp, tp, rel, limit in controls:
        ok = rel > limit
        log(f"[control] {where} {kind}: kernel {kp} vs twin {tp} rel={rel!r} (limit {limit}) "
            f"{'rejected ok' if ok else 'FAIL: the limit does not reject it'}")
        if not ok:
            failed.append(f"control {where} {kind} {kp} vs {tp}")
    return failed


def stream_kernels_phase(torch, dev):
    """B2, B3, B4 and B6 against their twins and against each other.
    Returns {kernel: max abs error in highest at the shape its main path
    gives it}: instML100k's for B2 (``--checkpoint``), gen-instML1M's for
    B3, B4 and B6."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.ops import dense_fused as df
    from recsys_tpu_torch.ops import dense_stream as ds

    same = checks.same_bits

    def probe_rel(train, twin, spec, a_dtype, precision, twin_precision):
        Lt, Rt, A = checks.precision_probe(spec, a_dtype, dev)
        kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2)
        got = train(Lt, Rt, A, precision=precision, **kw)
        return checks.update_rel(got, twin(Lt, Rt, A, precision=twin_precision, **kw), Lt, Rt)

    small = _small_spec(checks.FACTOR_ITERS)
    ml = dataclasses.replace(load_problem(ML100K + ".in"), iters=checks.FACTOR_ITERS)
    ml1m = dataclasses.replace(_ml1m_spec(), iters=checks.FACTOR_ITERS)
    worst, failed = {}, []
    for name, spec in (("small 200x300 k10", small), ("instML100k shape", ml), ("gen-instML1M shape", ml1m)):
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha)
        for precision in MODES:
            for storage in STORAGES:
                Lt, Rt, A = _inputs(spec, getattr(torch, storage), dev, torch)
                L1, R1, t1 = df.resident_train_top1(Lt, Rt, A, precision=precision, items_true=spec.items, **kw)
                b2 = df.resident_train(Lt, Rt, A, precision=precision, **kw)
                b3 = ds.stream_train(Lt, Rt, A, precision=precision, **kw)
                b3_again = ds.stream_train(Lt, Rt, A, precision=precision, **kw)
                b4 = ds.stream_top1(*b3, A, precision=precision, items_true=spec.items)
                b6 = ds.stream_train_top1(Lt, Rt, A, precision=precision, items_true=spec.items, **kw)
                twin2 = df.resident_train_plain(Lt, Rt, A, precision=precision, **kw)
                twin = ds.stream_train_plain(Lt, Rt, A, precision=precision, **kw)
                twin_top = ds.stream_top1_plain(*b3, A, precision=precision, items_true=spec.items)
                b1_top = df.resident_train_top1(*b3, A, precision=precision, items_true=spec.items,
                                                iters=0, alpha2=0.0)[2]
                torch.cuda.synchronize()
                r2 = checks.factor_rel(b2, twin2)
                r3 = checks.factor_rel(b3, twin)
                r32 = checks.factor_rel(b3, b2)
                u2 = probe_rel(df.resident_train, df.resident_train_plain, spec, getattr(torch, storage),
                               precision, precision)
                u3 = probe_rel(ds.stream_train, ds.stream_train_plain, spec, getattr(torch, storage),
                               precision, precision)
                err2 = max(float((k - p).abs().max()) for k, p in zip(b2, twin2))
                err3 = max(float((k - p).abs().max()) for k, p in zip(b3, twin))
                finite = all(bool(torch.isfinite(x).all()) for x in (*b2, *b3))
                checks_ok = {
                    "B2=B1 factors": same(b2, (L1, R1)),
                    "B2 vs twin": r2 <= checks.FACTOR_RTOL[precision] and u2 <= checks.UPDATE_RTOL[precision],
                    "B3 vs twin": r3 <= checks.FACTOR_RTOL[precision] and u3 <= checks.UPDATE_RTOL[precision],
                    "B3 vs B2": r32 <= checks.FACTOR_RTOL[precision],
                    "B3 two runs": same(b3, b3_again),
                    "B4=twin": torch.equal(b4, twin_top),
                    "B4=B1 top-1": torch.equal(b4, b1_top),
                    "B6=B3+B4": same(b6, (*b3, b4)),
                    "finite": finite,
                }
                bad = [k for k, v in checks_ok.items() if not v]
                log(f"[kernel] B2-B6 {name} {precision:7s} A={storage:8s} "
                    f"B2 max_abs_err={err2!r} factor_rel={r2!r} update_rel={u2!r} | "
                    f"B3 max_abs_err={err3!r} factor_rel={r3!r} update_rel={u3!r} vs_B2={r32!r} "
                    f"(limits {checks.FACTOR_RTOL[precision]} / {checks.UPDATE_RTOL[precision]}) "
                    f"two runs bit for bit {checks_ok['B3 two runs']} | "
                    f"B2=B1 {checks_ok['B2=B1 factors']} B4=twin {checks_ok['B4=twin']} "
                    f"B4=B1 {checks_ok['B4=B1 top-1']} B6=B3+B4 {checks_ok['B6=B3+B4']} "
                    f"{'ok' if not bad else 'FAIL ' + ','.join(bad)}")
                if bad:
                    failed.append(f"{name} {precision} {storage}: {bad}")
                if spec is ml and precision == "highest":
                    worst["resident_train"] = max(worst.get("resident_train", 0.0), err2)
                if spec is ml1m and precision == "highest":
                    worst["stream_train"] = max(worst.get("stream_train", 0.0), err3)
                    worst["stream_top1"] = max(worst.get("stream_top1", 0.0),
                                               float((b4 - twin_top).abs().max()))
                    worst["stream_train_top1"] = max(worst.get("stream_train_top1", 0.0), err3)

    def factor_control(kp, tp):
        Lt, Rt, A = _inputs(ml1m, torch.int8, dev, torch)
        kw = dict(iters=ml1m.iters, alpha2=2.0 * ml1m.alpha)
        return checks.factor_rel(ds.stream_train(Lt, Rt, A, precision=kp, **kw),
                                 ds.stream_train_plain(Lt, Rt, A, precision=tp, **kw))

    controls = [("factor", kp, tp, factor_control(kp, tp), checks.FACTOR_RTOL[tp])
                for kp, tp in checks.FACTOR_CONTROLS]
    controls += [("probe update", kp, tp,
                  probe_rel(ds.stream_train, ds.stream_train_plain, ml1m, torch.int8, kp, tp),
                  checks.UPDATE_RTOL[tp]) for kp, tp in checks.UPDATE_CONTROLS]
    failed += _report_controls("B3 gen-instML1M shape", controls)
    K, U = 8, 128
    ones, zeros = torch.ones((K, U), device=dev), torch.zeros((U, U), device=dev)
    tie4 = ds.stream_top1(ones, ones, zeros, items_true=U)
    tie6 = ds.stream_train_top1(ones, ones, zeros, iters=0, alpha2=0.0, items_true=U)[2]
    tie_ok = bool((tie4 == 0).all()) and bool((tie6 == 0).all())
    log(f"[kernel] B4/B6 all-ones tie case -> all zeros {'ok' if tie_ok else 'FAIL'}")
    if not tie_ok:
        failed.append("B4/B6 tie case: lowest index must win")
    if failed:
        raise AssertionError(f"B2-B6 vs twins failed: {failed}")
    return worst


def tiled_kernel_phase(torch, dev, big):
    """B5's fused step (``tiled_train``, ``tiled_gd_step``) against its twin, every precision x A storage, on the small
    instance and at the gen-instML1M and gen-inst1e6 (``big``) shapes, 20
    steps: the factor and probe-update readings, two runs bit for bit, the
    controls at both large shapes, and B5's training against B3's at
    gen-instML1M's shape.  Returns the fused step's max abs error in
    highest at gen-inst1e6's shape."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.ops import dense_fused as df
    from recsys_tpu_torch.ops import dense_stream as ds
    from recsys_tpu_torch.ops import dense_tiled as dt

    def readings(spec, L, R, A, probe, precision, twin_precision):
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha)
        got = dt.tiled_train(L, R, A, precision=precision, **kw)
        twin = dt.tiled_train_plain(L, R, A, precision=twin_precision, **kw)
        pL, pR, pA = probe
        upd = checks.update_rel(dt.tiled_gd_step(pL, pR, pA, alpha2=checks.PROBE_ALPHA2, precision=precision),
                                dt.tiled_train_plain(pL, pR, pA, iters=1, alpha2=checks.PROBE_ALPHA2,
                                                     precision=twin_precision), pL, pR)
        return got, twin, checks.factor_rel(got, twin), upd

    small = _small_spec(checks.FACTOR_ITERS)
    ml1m = dataclasses.replace(_ml1m_spec(), iters=checks.FACTOR_ITERS)
    big = dataclasses.replace(big, iters=checks.FACTOR_ITERS)
    worst, failed = 0.0, []
    for name, spec in (("small 200x300 k10", small), ("gen-instML1M shape", ml1m), ("gen-inst1e6 shape", big)):
        t0 = time.perf_counter()
        factors = dt.pad_factors_lane_major(spec)
        probe8 = checks.tiled_probe(spec, torch.int8, dev)
        for storage in STORAGES:
            a_dtype = getattr(torch, storage)
            L, R, A = _tiled_inputs(spec, a_dtype, dev, torch, factors)
            probe = (*probe8[:2], df.load_at(probe8[2]).to(a_dtype) if storage != "int8" else probe8[2])
            for precision in MODES:
                got, twin, rel, upd = readings(spec, L, R, A, probe, precision, precision)
                again = dt.tiled_train(L, R, A, iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision)
                torch.cuda.synchronize()
                err = max(float((k - p).abs().max()) for k, p in zip(got, twin))
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                finite = all(bool(torch.isfinite(x).all()) for x in got)
                ok = (finite and same and rel <= checks.TILED_FACTOR_RTOL[precision]
                      and upd <= checks.TILED_UPDATE_RTOL[precision])
                log(f"[kernel] B5 {name} {precision:7s} A={storage:8s} max_abs_err={err!r} factor_rel={rel!r} "
                    f"(limit {checks.TILED_FACTOR_RTOL[precision]}) probe update_rel={upd!r} "
                    f"(limit {checks.TILED_UPDATE_RTOL[precision]}) two runs same bits {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"B5 {name} {precision} {storage}")
                if spec is big and precision == "highest":
                    worst = max(worst, err)
                del got, twin, again
        if spec is ml1m:  # B5's training against B3's, same inputs
            L, R, A = _tiled_inputs(spec, torch.int8, dev, torch, factors)
            Lt, Rt, At = _inputs(spec, torch.int8, dev, torch)
            k, u, i = spec.features, spec.users, spec.items
            for precision in MODES:
                kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision)
                L5, R5 = dt.tiled_train(L, R, A, **kw)
                L3, R3 = ds.stream_train(Lt, Rt, At, **kw)
                rel = checks.factor_rel((L5[:u, :k], R5[:i, :k]), (L3[:k, :u].T, R3[:k, :i].T))
                ok = rel <= checks.TILED_FACTOR_RTOL[precision]
                log(f"[kernel] B5 vs B3 {name} {precision:7s} factor_rel={rel!r} "
                    f"(limit {checks.TILED_FACTOR_RTOL[precision]}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"B5 vs B3 {name} {precision}")
        if spec is not small:
            L, R, A = _tiled_inputs(spec, torch.int8, dev, torch, factors)
            controls = [("factor", kp, tp, readings(spec, L, R, A, probe8, kp, tp)[2],
                         checks.TILED_FACTOR_RTOL[tp]) for kp, tp in checks.FACTOR_CONTROLS]
            controls += [("probe update", kp, tp, readings(spec, L, R, A, probe8, kp, tp)[3],
                          checks.TILED_UPDATE_RTOL[tp]) for kp, tp in checks.UPDATE_CONTROLS]
            failed += _report_controls(f"B5 {name}", controls)
        del factors, probe8, L, R, A
        torch.cuda.empty_cache()
        log(f"[kernel] B5 {name}: {time.perf_counter() - t0!r} s")
    if failed:
        raise AssertionError(f"B5 vs its twin failed: {failed}")
    return worst


def _run(spec, precision, dev, torch, path="auto", dtype="float32", mesh_shape=None, **plan):
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.utils.timing import collect_phases

    cfg = RunConfig(dtype=dtype, path=path, precision=precision, mesh_shape=mesh_shape)
    phases = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with collect_phases(phases):
        out, _ = trainer.run(spec, cfg, dev, **plan)
    wall = time.perf_counter() - t0
    return out, wall, phases


def _agreement(out, golden_lines):
    got = out.splitlines()
    return sum(a == b for a, b in zip(got, golden_lines)) / len(golden_lines), len(got)


def _plain_seconds(fn, torch, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path_runs(name, spec, golden, floors, dev, torch, launches, kinds):
    """``trainer.run`` on ``spec`` in every mode for each plan kind in
    ``kinds`` ({label: plan kwargs}), each kind's runs in one launch-count
    window.  Returns {(label, mode): train seconds}."""
    from recsys_tpu_torch.engine import trainer

    want = golden.splitlines()
    train = {}
    for label, plan in kinds.items():
        for precision in MODES:  # warm-up
            _run(dataclasses.replace(spec, iters=10), precision, dev, torch, **plan)
        counts = {}
        with counted(counts):
            for precision in MODES:
                out, wall, ph = _run(spec, precision, dev, torch, **plan)
                agree, lines = _agreement(out, want)
                _, _, ph1k = _run(dataclasses.replace(spec, iters=1000), precision, dev, torch, **plan)
                slope = (ph["train"] - ph1k["train"]) / (spec.iters - 1000)
                train[label, precision] = ph["train"]
                log(f"[main] {name} {label} plan={trainer.dense_plan(spec, **plan).kind} {precision}: "
                    f"agreement {agree!r} byte_match {out == golden} lines {lines} | wall {wall!r} s "
                    f"prep {ph['prep']!r} upload {ph['upload']!r} train {ph['train']!r} top1 {ph['top1']!r} "
                    f"| slope {slope * 1e6!r} us/iter (1000 vs {spec.iters} iters)")
                if lines != len(want) or agree < floors[precision]:
                    raise AssertionError(f"{name} {label} {precision}: agreement {agree} below {floors[precision]}")
        log(f"[main] {name} {label} launches in the main-path runs: {counts}")
        launches[name, label] = counts
    return train


def ml100k_phase(torch, dev, launches):
    """instML100k through ``run()``: the auto plan (resident, B1) and the
    stream kind forced; the plain twin's train time."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.engine.oracle import run_oracle
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.ops import dense_fused

    spec = load_problem(ML100K + ".in")
    with open(ML100K + ".out") as f:
        golden = f.read()
    path = trainer.choose_path(spec, RunConfig(dtype="float32"), dev)
    log(f"[main] instML100k {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} "
        f"iters={spec.iters}: path={path} plan={trainer.dense_plan(spec)}")
    if path != "pallas" or trainer.dense_plan(spec).kind != "resident":
        raise AssertionError(f"instML100k must take the resident dense route, got {path!r}")
    small = _small_spec(50)
    for precision in MODES:  # a small run held against the f64 oracle, both kinds
        for plan in ({}, {"a_max_bytes": 0}):
            out, _, _ = _run(small, precision, dev, torch, path="pallas", **plan)
            agree, _ = _agreement(out, run_oracle(small).splitlines())
            log(f"[main] small 200x300 {precision} {plan or 'auto'}: agreement with f64 oracle {agree!r}")
            if precision != "default" and agree < 1.0:
                raise AssertionError("small instance disagrees with the f64 oracle")
    train = main_path_runs("instML100k", spec, golden, AGREEMENT_FLOOR, dev, torch, launches,
                           {"auto": {}, "stream forced": {"a_max_bytes": 0}})
    if launches["instML100k", "auto"]["resident_train_top1"] <= 0:
        raise AssertionError("the instML100k main path did not launch B1")

    plan = trainer.dense_plan(spec)
    Lt, Rt, A = _inputs(spec, plan.a_dtype, dev, torch)
    want = golden.splitlines()
    plain = {}
    for precision in MODES:
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision, items_true=spec.items)
        dense_fused.resident_train_top1_plain(Lt, Rt, A, **{**kw, "iters": 10})  # warm-up
        (_, _, top), plain_s = _plain_seconds(dense_fused.resident_train_top1_plain, torch, Lt, Rt, A, **kw)
        idx = top.cpu().numpy()[0, : spec.users]
        keep = spec.rated_counts() < spec.items
        agree = sum(str(int(i)) == w for i, w in zip(idx[keep], want)) / len(want)
        plain[precision] = plain_s
        log(f"[main] instML100k plain twin {precision}: train {plain_s!r} s vs kernel "
            f"{train['auto', precision]!r} s (stream forced {train['stream forced', precision]!r} s)"
            f" | plain agreement {agree!r}")
    return spec, train, plain


def ml1m_phase(torch, dev, launches):
    """gen-instML1M through ``run()``: the auto plan (stream: B3 then B4)
    and the resident and tiled kinds forced; the plain twin's train time."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.ops import dense_stream

    spec = _ml1m_spec()
    with open(ML1M_OUT) as f:
        golden = f.read()
    path = trainer.choose_path(spec, RunConfig(dtype="float32"), dev)
    plan = trainer.dense_plan(spec)
    log(f"[main] gen-instML1M {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} "
        f"iters={spec.iters}: path={path} plan={plan}")
    if path != "pallas" or plan.kind != "stream":
        raise AssertionError(f"gen-instML1M must take the stream dense route, got {path!r} {plan.kind!r}")
    train = main_path_runs("gen-instML1M", spec, golden, ML1M_FLOOR, dev, torch, launches,
                           {"auto": {}, "resident forced": {"a_max_bytes": FORCE_RESIDENT},
                            "tiled forced": {"tiled": True}})
    counts = launches["gen-instML1M", "auto"]
    if counts["stream_train"] <= 0 or counts["stream_top1"] <= 0:
        raise AssertionError(f"the gen-instML1M main path did not launch B3 and B4: {counts}")
    tiled = launches["gen-instML1M", "tiled forced"]
    if tiled["tiled_step"] != len(MODES) * (spec.iters + 1000) or tiled["tiled_deltas"]:
        raise AssertionError(f"gen-instML1M with the tiled kind forced must launch B5's fused step once a step "
                             f"and the raw deltas never: {tiled}")

    Lt, Rt, A = _inputs(spec, plan.a_dtype, dev, torch)
    want = golden.splitlines()
    keep = spec.rated_counts() < spec.items
    plain = {}
    for precision in MODES:
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision)
        dense_stream.stream_train_plain(Lt, Rt, A, **{**kw, "iters": 10})  # warm-up
        (Lp, Rp), plain_s = _plain_seconds(dense_stream.stream_train_plain, torch, Lt, Rt, A, **kw)
        top = dense_stream.stream_top1_plain(Lp, Rp, A, precision=precision, items_true=spec.items)
        idx = top.cpu().numpy()[0, : spec.users]
        agree = sum(str(int(i)) == w for i, w in zip(idx[keep], want)) / len(want)
        plain[precision] = plain_s
        log(f"[main] gen-instML1M plain twin {precision}: train {plain_s!r} s vs kernel "
            f"{train['auto', precision]!r} s (resident forced {train['resident forced', precision]!r} s, "
            f"tiled forced {train['tiled forced', precision]!r} s)"
            f" | plain agreement {agree!r}")
    return spec, train, plain


def checkpoint_phase(torch, dev, launches):
    """The CLI's ``--checkpoint`` route on instML100k in chunks of 1000
    iterations (B2) against one unchunked ``factorize`` + ``recommend``."""
    from recsys_tpu_torch import cli
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.io.writers import format_recommendations

    spec = load_problem(ML100K + ".in")
    cfg = RunConfig(dtype="float32")
    state = trainer.factorize(spec, cfg, dev)
    want = format_recommendations(trainer.recommend(state, spec, cfg, dev), spec.rated_counts(), spec.items)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with counted(counts), contextlib.redirect_stdout(buf):
            rc = cli.main(["run", ML100K + ".in", "--device", str(dev), "--dtype", "float32", "--no-time",
                           "--checkpoint", os.path.join(tmp, "ck.npz"), "--checkpoint-every", "1000"])
    launches["instML100k checkpoint", "auto"] = counts
    same = rc == 0 and buf.getvalue() == want
    log(f"[main] instML100k --checkpoint --checkpoint-every 1000: stdout equal to unchunked "
        f"factorize + recommend {same} | launches {counts}")
    if not same or counts["resident_train"] <= 0:
        raise AssertionError("the checkpoint route differs from the unchunked run or did not launch B2")


def inst1e6_phase(torch, dev, launches, spec):
    """gen-inst1e6-100-700-1-3 through ``run()`` with ``path="pallas"`` in
    every mode: the auto plan is tiled (B5 once per step, then
    ``recommend`` on the factors left on the card)."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer

    with open(INST1E6_OUT) as f:
        want = f.read().splitlines()
    plan = trainer.dense_plan(spec)
    log(f"[main] {INST1E6}: path={trainer.choose_path(spec, RunConfig(dtype='float32', path='pallas'), dev)} "
        f"plan={plan}")
    if plan.kind != "tiled":
        raise AssertionError(f"{INST1E6} must take the tiled plan, got {plan.kind!r}")
    def one(precision, label=""):
        torch.cuda.reset_peak_memory_stats(dev)
        reserved, retries = torch.cuda.memory_reserved(dev), torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
        out, wall, ph = _run(spec, precision, dev, torch, path="pallas")
        agree, lines = _agreement(out, want)
        retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) - retries
        log(f"[main] {INST1E6} auto plan=tiled {precision}{label}: agreement {agree!r} lines {lines} | wall {wall!r} s "
            f"prep {ph['prep']!r} upload {ph['upload']!r} train {ph['train']!r} top1 {ph['top1']!r} "
            f"| peak device memory {torch.cuda.max_memory_allocated(dev)!r} B, reserved before {reserved!r} B, "
            f"allocator retries {retries}")
        if lines != len(want) or agree < INST1E6_FLOOR[precision]:
            raise AssertionError(f"{INST1E6} {precision}: agreement {agree} below {INST1E6_FLOOR[precision]}")

    counts = {}
    with counted(counts):
        for precision in MODES:
            one(precision)
    log(f"[main] {INST1E6} auto launches in the main-path runs: {counts}")
    one("highest", " (again, after the three)")  # is the first run's train phase longer for its place?
    launches[INST1E6, "auto"] = counts
    if counts["tiled_step"] != len(MODES) * spec.iters or counts["tiled_deltas"]:
        raise AssertionError(f"{INST1E6} must launch B5's fused step {spec.iters} times per run and the raw "
                             f"deltas never: {counts}")


def _bell_small_specs():
    """The small specs of the BELL kernel readings: sparse rows, a
    hyper-sparse item side, stored 0 ratings, gen-inst1e6's k = 700, and a
    hub row of 1500 slots (a block-form bucket) at k = 3, 7, 8, 30, 100
    and 700 (every width of the block form's bf16 row copy: 2, 2, 16, 4,
    8 and 8 bytes)."""
    from recsys_tpu_torch.io.generator import generate_instance
    from recsys_tpu_torch.testing import FACTOR_ITERS as n
    from recsys_tpu_torch.testing import hub_spec

    zero = generate_instance(120, 90, 30, 1, 45, iters=n, alpha=1e-4, seed=30)
    vals = zero.vals.copy()
    vals[::7] = 0.0
    return {
        "sparse 60x200 k8": generate_instance(60, 200, 8, 2, 5, iters=n, alpha=0.01, seed=9),
        "hyper-sparse 50x5000 k3": generate_instance(50, 5000, 3, 1, 2, iters=n, alpha=0.001, seed=4),
        "stored zeros 120x90 k30": dataclasses.replace(zero, vals=vals),
        "wide 120x90 k700": generate_instance(120, 90, 700, 1, 45, iters=4, alpha=1e-5, seed=7),
        **{f"hub 300x2000 k{k}": hub_spec(k) for k in (3, 7, 8, 30, 100, 700)},
    }


def _bell_big_readings(torch, dev, spec):
    """``bell_train`` against ``bell_train_plain`` at ``spec``'s shape
    (gen-inst1e6: 100 item rows of ~20,000 slots, one warp each, and
    1M-row user buckets), ``INST1E6_BELL_STEPS`` steps, bit for bit in f64,
    f32 and bf16, and two runs bit for bit, and one twin step's time.  The
    factors are drawn on the card from a seed, at the glibc init's scale
    (the route's own init is read in ``inst1e6_bell_phase``).  Returns the
    failed readings and bf16's numbers for the kernels line: max abs error
    against the twin, one step's ms (the slope of 3 against 1 steps in
    turns), the twin's, bytes and FLOP."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.ops import bell
    from recsys_tpu_torch.probes import bell_wide
    from recsys_tpu_torch.utils.timing import alternating_ms, cuda_event_ms

    g = torch.Generator(device=dev).manual_seed(0)
    L64, R64 = (torch.rand((n + 1, spec.features), generator=g, dtype=torch.float64, device=dev)
                .div_(spec.features) for n in (spec.users, spec.items))
    L64[-1], R64[-1] = 0.0, 0.0
    failed, steps, a2, bf16 = [], INST1E6_BELL_STEPS, 2.0 * spec.alpha, {}
    for tdtype in (torch.float64, torch.float32, torch.bfloat16):
        name = str(tdtype).split(".")[1]
        data = bell.make_bell_inputs(spec, bell.HOST_DTYPE[tdtype])
        t = bell.device_tables(data.tables, dev, tdtype)
        L, R = L64.to(tdtype), R64.to(tdtype)
        torch.cuda.reset_peak_memory_stats(dev)
        got = bell.bell_train(L, R, t, a2, data.meta, steps)
        twin = bell.bell_train_plain(L, R, t, a2, data.meta, steps)
        torch.cuda.synchronize()
        err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, twin))
        readings = {"= twin": checks.same_bits(got, twin)}
        del twin
        again = bell.bell_train(L, R, t, a2, data.meta, steps)
        readings["two runs same"] = checks.same_bits(got, again)
        readings["finite"] = all(bool(torch.isfinite(a).all()) for a in got)
        bad = [k for k, v in readings.items() if not v]
        del again
        log(f"[kernel] bell_side_update {INST1E6} {name} {steps} steps "
            f"({len(data.meta.user.bounds)}+{len(data.meta.item.bounds)} buckets, widest "
            f"{max(w for _, _, w in data.meta.user.bounds)}/{max(w for _, _, w in data.meta.item.bounds)} slots): "
            f"max_abs_err={err!r} {' '.join(f'{k}={v}' for k, v in readings.items())} | peak device memory "
            f"{torch.cuda.max_memory_allocated(dev)!r} B {'ok' if not bad else 'FAIL'}")
        if bad:
            failed.append(f"{INST1E6} {name}: {bad}")
        del got
        twin_ms = cuda_event_ms(lambda: bell.bell_train_plain(L, R, t, a2, data.meta, 1), 1)
        log(f"[kernels] bell_side_update's plain twin at {INST1E6} {name}, one step: {twin_ms!r} ms "
            f"(CUDA events, after one unmeasured step)")
        # The block form (the engine's) against the warp form alone, one
        # step, bit for bit (raises otherwise) and in turns.
        bell_wide.compare(INST1E6, L, R, t, data.meta, a2, 1, twin=False)
        bell_wide.step_ms(INST1E6, L, R, t, data.meta, a2, (bell.WIDE_MIN, bell.WARP_FORM), steps=1, rounds=3)
        bell_wide.side_ms(INST1E6, L, R, t, data.meta, a2, rounds=3)
        if tdtype != torch.bfloat16:  # the fused step against the two launches it replaced, in turns (logged)
            bell_wide.fused_ms(INST1E6, L, R, t, data.meta, a2, steps=(1, 3), rounds=3)
        nbytes, flops = _bell_work(L, R, t, data.meta, spec.nnz)
        peak = "float64" if tdtype == torch.float64 else "float32"
        log(f"[kernels] bell_side_update at {INST1E6} {name}, one step: {nbytes} B, {flops!r} FLOP, "
            f"bound {_bound(flops, nbytes, peak)!r} ms")
        if tdtype == torch.bfloat16:
            ms = alternating_ms({n: (lambda n=n: bell.bell_train(L, R, t, a2, data.meta, n)) for n in (1, 3)}, 3)
            bf16 = {"err": err, "ms": (ms[3] - ms[1]) / 2, "plain_ms": twin_ms, "nbytes": nbytes, "flops": flops}
            log(f"[kernels] bell_side_update at {INST1E6} bfloat16, one step as the slope of 3 against 1 steps in "
                f"turns: {bf16['ms']!r} ms ({ms})")
        del L, R, t, data
        torch.cuda.empty_cache()
    return failed, bf16


def bell_kernel_phase(torch, dev, big):
    """``bell_side_update`` against its twin and its warp form alone, bit for
    bit, in f64, f32 and bf16, on the small specs and on instML100k (20
    steps), two runs bit for bit; in f64 against ``_native.serial_gd``; the
    sum-then-add control, which must differ from it at instML100k; the two
    bf16 controls, which must differ from the twin at instML100k; then the
    same twin and rerun readings at ``big``'s shape
    (``_bell_big_readings``).  Returns the max abs error against the twin at
    instML100k in f64, and ``_bell_big_readings``' bf16 numbers."""
    import numpy as np

    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.io import _native
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell

    ml = dataclasses.replace(load_problem(ML100K + ".in"), iters=checks.FACTOR_ITERS)
    specs = {**_bell_small_specs(), "instML100k": ml}
    failed, worst = [], 0.0
    for name, spec in specs.items():
        init = init_factors(spec.users, spec.items, spec.features)
        serial = _native.serial_gd(spec, init.L.copy(), init.R.copy())
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            data, L, R, t = bell.bell_tensors(spec, init, dtype, dev)
            a2 = 2.0 * spec.alpha
            got = bell.bell_train(L, R, t, a2, data.meta, spec.iters)
            again = bell.bell_train(L, R, t, a2, data.meta, spec.iters)
            warp = bell.bell_train(L, R, t, a2, data.meta, spec.iters, wide=bell.WARP_FORM)
            twin = bell.bell_train_plain(L, R, t, a2, data.meta, spec.iters)
            torch.cuda.synchronize()
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, twin))
            err_warp = max(float((g.double() - w.double()).abs().max()) for g, w in zip(warp, twin))
            readings = {
                "= twin": checks.same_bits(got, twin),
                "= warp form": checks.same_bits(got, warp),
                "two runs same": checks.same_bits(got, again),
                "finite": all(bool(torch.isfinite(g).all()) for g in got),
            }
            if dtype == torch.float64:
                Lo, Ro = bell.unpermute_factors(got[0].cpu().numpy(), got[1].cpu().numpy(), data)
                readings["= serial_gd"] = np.array_equal(Lo, serial[0]) and np.array_equal(Ro, serial[1])
                if spec is ml:
                    worst = err
                    Lc, Rc = checks.bell_sum_then_add_train(L, R, t, a2, data.meta, spec.iters)
                    Lco, Rco = bell.unpermute_factors(Lc.cpu().numpy(), Rc.cpu().numpy(), data)
                    cells = int((Lco != serial[0]).sum() + (Rco != serial[1]).sum())
                    diff = max(float(np.abs(Lco - serial[0]).max()), float(np.abs(Rco - serial[1]).max()))
                    log(f"[control] BELL {name} f64: sum-then-add (the JAX order) against serial_gd: "
                        f"{cells} of {Lco.size + Rco.size} factors differ, max abs {diff!r} "
                        f"{'rejected ok' if cells else 'FAIL: the bitwise reading does not reject it'}")
                    if not cells:
                        failed.append("sum-then-add control equals serial_gd")
            if dtype == torch.bfloat16 and spec is ml:
                for control in (checks.bell_bf16_f32_inside_train, checks.bell_bf16_row_acc_train):
                    c = control(L, R, t, a2, data.meta, spec.iters)
                    share, ulps = checks.bit_share(c, twin), checks.bf16_ulps(c, twin)
                    log(f"[control] BELL {name} bf16: {control.__name__} against the twin: {share!r} of the factors "
                        f"equal in raw bits, {ulps} ulps at most "
                        f"{'rejected ok' if share < 1.0 else 'FAIL: the bitwise reading does not reject it'}")
                    if share == 1.0:
                        failed.append(f"{control.__name__} equals the bf16 twin")
            bad = [k for k, v in readings.items() if not v]
            log(f"[kernel] bell_side_update {name} {str(dtype).split('.')[1]} {spec.iters} steps "
                f"({len(data.meta.user.bounds)}+{len(data.meta.item.bounds)} buckets, widest "
                f"{max(w for _, _, w in data.meta.user.bounds + data.meta.item.bounds)}): max_abs_err={err!r} "
                f"(warp form alone {err_warp!r}) "
                f"{' '.join(f'{k}={v}' for k, v in readings.items())} {'ok' if not bad else 'FAIL'}")
            if bad:
                failed.append(f"{name} {dtype}: {bad}")
    big_failed, bf16 = _bell_big_readings(torch, dev, big)
    failed += big_failed
    if failed:
        raise AssertionError(f"bell_side_update readings failed: {failed}")
    return worst, bf16


def redesign_phase(torch, dev, launches):
    """The resident/stream line (``probes/plan_line.py``): B2's and B3's
    slopes at instML100k and gen-instML1M in turns, in one launch-count
    window.  Then ``bell_side_update``'s block form against its warp form
    and ``bell_train``'s fused step against two launches a step
    (``probes/bell_wide.py``), bit for bit, then timed in turns; the
    engine's forms must be no slower at instML100k."""
    from recsys_tpu_torch.ops import bell
    from recsys_tpu_torch.probes import bell_wide, plan_line

    counts = {}
    with counted(counts):
        slopes = plan_line.run(dev)
    launches["plan line probe", "both shapes"] = counts
    log(f"[probe] plan line probe launches: {_nonzero(counts)}")
    for name, plans in slopes.items():
        log(f"[redesign] {name} resident/stream line (highest): resident "
            f"{plans['resident']['us_per_step']!r} us/iter, stream {plans['stream']['us_per_step']!r}")
    sweep = bell_wide.run(dev)
    bell_ok = sweep[bell.WIDE_MIN] <= sweep[bell.WARP_FORM] and sweep["fused"] <= sweep["two launches"]
    log(f"[redesign] instML100k f64 bell step: block form from {bell.WIDE_MIN} slots {sweep[bell.WIDE_MIN]!r} ms "
        f"against the warp form alone {sweep[bell.WARP_FORM]!r} ms; the fused step {sweep['fused']!r} ms a step "
        f"against two launches {sweep['two launches']!r} -> the engine's forms no slower {bell_ok}")
    if not bell_ok:
        raise AssertionError("a BELL engine form is slower than the form it replaced")


def tiled_redesign_phase(torch, dev, launches, big):
    """B5's fused step against the composition it replaced
    (``probes/tiled_fused.py``, one launch-count window): raw bits in every
    form, precision and A storage at the small spec and the gen-instML1M and
    gen-inst1e6 (``big``) shapes, then the steps in turns.  The engine's
    form must be no slower than the composition at gen-inst1e6.  Returns
    (the probe's readings, its timings)."""
    from recsys_tpu_torch.probes import tiled_fused

    counts = {}
    with counted(counts):
        readings, times = tiled_fused.run(dev, big=big)
    launches["B5 fused probe", "all shapes"] = counts
    log(f"[probe] B5 fused probe launches: {_nonzero(counts)}")
    base = tiled_fused.BASELINE
    for name, unit in ((INST1E6, "ms"), ("gen-instML1M", "us")):
        t = times[name]
        forms = ", ".join(f"{f} {t[f]['per_step']!r}" for f in t if f not in ("auto", base))
        log(f"[redesign] {name} tiled step in turns: {base} {t[base]['per_step']!r} {unit}/step against fused "
            f"{forms} (engine: {t['auto']['per_step']!r})")
    ok = times[INST1E6]["auto"]["per_step"] <= times[INST1E6][base]["per_step"]
    log(f"[redesign] {INST1E6} B5 fused step no slower than {base}: {ok}")
    if not ok:
        raise AssertionError("B5's fused step is slower than the composition it replaced")
    return readings, times


def _golden_run(name, spec, golden, floor, dev, torch, launches, label, dtype, path="auto"):
    """One ``trainer.run`` in its own launch-count window, held against
    ``golden``: the byte match, and the argmax agreement against ``floor``
    (1.0 demands the byte match).  Logs the first differing lines; returns
    (phases, launch counts, agreement)."""
    counts = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with counted(counts):
        out, wall, ph = _run(spec, "auto", dev, torch, path=path, dtype=dtype)
    want = golden.splitlines()
    agree, lines = _agreement(out, want)
    byte = out == golden
    # inst200-10000's golden ends in an empty line after its 200 users.
    blank = len(want) - len(golden.rstrip("\n").splitlines())
    launches[name, label] = counts
    log(f"[main] {name} {label}: agreement {agree!r} byte_match {byte} lines {lines} | wall {wall!r} s "
        f"prep {ph['prep']!r} upload {ph['upload']!r} train {ph['train']!r} top1 {ph['top1']!r} | peak device "
        f"memory {torch.cuda.max_memory_allocated(dev)!r} B | launches {_nonzero(counts)}")
    if not byte:
        diffs = [(i, a, b) for i, (a, b) in enumerate(zip(out.splitlines(), want)) if a != b]
        log(f"[main] {name} {label}: {len(diffs)} differing lines, first {diffs[:8]}; the golden ends in "
            f"{blank} empty line(s), and the output equals it but for them: {out == golden.rstrip(chr(10)) + chr(10)}")
    if lines != len(want) - blank or agree < floor or (floor >= 1.0 and not byte):
        raise AssertionError(f"{name} {label}: agreement {agree} below {floor}")
    return ph, counts, agree


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def bell_main_phase(torch, dev, launches):
    """instML100k f64 through ``run()`` on the auto route, which must be
    ``bell`` (one launch a step), byte for byte against its golden, with
    phases and the slope; one twin step's time; the ``dense`` route in f64
    once; inst200-10000-50-100-300 f64 through ``run()``."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell

    spec = load_problem(ML100K + ".in")
    with open(ML100K + ".out") as f:
        golden = f.read()
    path = trainer.choose_path(spec, RunConfig(dtype="float64"), dev)
    log(f"[main] instML100k f64: path={path}")
    if path != "bell":
        raise AssertionError(f"instML100k f64 must take the bell route, got {path!r}")
    _run(dataclasses.replace(spec, iters=10), "auto", dev, torch, dtype="float64")  # warm-up
    ph, counts, _ = _golden_run("instML100k f64", spec, golden, 1.0, dev, torch, launches, "auto", "float64")
    if counts["bell_side_update"] != spec.iters:
        raise AssertionError(f"instML100k f64 must launch bell_side_update {spec.iters} times: {counts}")
    _, _, ph1k = _run(dataclasses.replace(spec, iters=1000), "auto", dev, torch, dtype="float64")
    slope = (ph["train"] - ph1k["train"]) / (spec.iters - 1000)
    log(f"[main] instML100k f64 bell: slope {slope * 1e6!r} us/iter (1000 vs {spec.iters} iters)")

    data, L, R, t = bell.bell_tensors(spec, init_factors(spec.users, spec.items, spec.features), torch.float64, dev)
    bell.bell_gd_step_plain(L, R, t, 2.0 * spec.alpha, data.meta)  # warm-up
    _, twin_s = _plain_seconds(bell.bell_gd_step_plain, torch, L, R, t, 2.0 * spec.alpha, data.meta)
    log(f"[main] instML100k f64 plain twin: one step {twin_s!r} s (kernel route: train {ph['train']!r} s "
        f"for {spec.iters} steps)")

    _golden_run("instML100k f64", spec, golden, DENSE_F64_FLOOR, dev, torch, launches, "dense forced",
                "float64", path="dense")
    inst200 = load_problem(INST200 + ".in")
    with open(INST200 + ".out") as f:
        golden200 = f.read()
    log(f"[main] inst200-10000-50-100-300 f64: {inst200.users}x{inst200.items} k={inst200.features} "
        f"nnz={inst200.nnz} iters={inst200.iters} path={trainer.choose_path(inst200, RunConfig(dtype='float64'), dev)}")
    _golden_run("inst200-10000-50-100-300 f64", inst200, golden200, INST200_FLOOR, dev, torch, launches, "auto",
                "float64")


def inst1e6_bell_phase(torch, dev, launches, spec):
    """gen-inst1e6-100-700-1-3 through ``run()`` on the auto route, which
    must be ``bell``, once in f64 and once in f32 (one launch a step)."""
    import gc

    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer

    with open(INST1E6_OUT) as f:
        golden = f.read()
    for dtype in ("float64", "float32"):
        path = trainer.choose_path(spec, RunConfig(dtype=dtype), dev)
        init = "device" if trainer._device_init(spec, RunConfig(dtype=dtype), None) else "host"
        log(f"[main] {INST1E6} {dtype}: path={path}, initial factors drawn on the {init} "
            f"({(spec.users + spec.items) * spec.features} draws)")
        if init != ("host" if dtype == "float64" else "device"):
            raise AssertionError(f"{INST1E6} {dtype}: the {init} init ran")
        if path != "bell":
            raise AssertionError(f"{INST1E6} {dtype} must take the bell route on the card, got {path!r}")
        _, counts, _ = _golden_run(f"{INST1E6} {dtype}", spec, golden, INST1E6_BELL_FLOOR[dtype], dev, torch,
                                launches, "auto", dtype)
        if counts["bell_side_update"] != spec.iters:
            raise AssertionError(f"{INST1E6} {dtype} must launch bell_side_update {spec.iters} times")
        if counts["glibc_init"] != int(dtype == "float32"):
            raise AssertionError(f"{INST1E6} {dtype} launched glibc_init {counts['glibc_init']} times")
        gc.collect()
        torch.cuda.empty_cache()


def bf16_bell_phase(torch, dev, launches, big):
    """bf16 through ``run()`` on the auto route, which must be ``bell`` (2
    launches a step), at the instances of ``JAX_BF16_BELL`` (host init) and
    at gen-inst1e6 (``big``, device init), each in its own launch-count
    window, its agreement with the golden beside the JAX package's bf16
    reading; gated by ``BF16_BELL_FLOOR`` and ``INST1E6_BF16_FLOOR``.
    Returns {instance: agreement}."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem

    cfg, out = RunConfig(dtype="bfloat16"), {}
    runs = [(name, lambda name=name: load_problem(os.path.join(ROOT, "tests", "fixtures", name + ".in")))
            for name in JAX_BF16_BELL] + [(INST1E6, lambda: big)]
    for name, spec_of in runs:
        spec = spec_of()
        with open(os.path.join(ROOT, "tests", "fixtures", name + ".out")) as f:
            golden = f.read()
        path, init = trainer.choose_path(spec, cfg, dev), trainer._device_init(spec, cfg, None)
        log(f"[main] {name} bfloat16: {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} iters={spec.iters} "
            f"path={path}, initial factors drawn on the {'device' if init else 'host'}")
        if path != "bell" or init != (spec is big):
            raise AssertionError(f"{name} bfloat16 must take the bell route with the "
                                 f"{'device' if spec is big else 'host'} init, got {path!r}, device init {init}")
        floor = INST1E6_BF16_FLOOR if spec is big else BF16_BELL_FLOOR.get(name, 0.0)
        _, counts, agree = _golden_run(f"{name} bfloat16", spec, golden, floor, dev, torch, launches, "auto",
                                       "bfloat16")
        if counts["bell_side_update"] != spec.iters:
            raise AssertionError(f"{name} bfloat16 must launch bell_side_update {spec.iters} times: {counts}")
        jax = JAX_BF16_BELL.get(name)
        log(f"[main] {name} bfloat16 on bell: agreement {agree!r} against the JAX package's "
            f"{'not read' if jax is None else repr(jax)} and the port's twin's "
            f"{PORT_CPU_BF16_BELL.get(name, 'not read')} (CPU, bf16 BELL), floor {floor}")
        out[name] = agree
        if name == BF16_WITNESS or spec is big:
            _bf16_witness(torch, dev, name, spec, golden, agree, on_card=spec is big)
    return out


def _bf16_witness(torch, dev, name, spec, golden, agree, on_card):
    """Where the card's bf16 answer comes from, outside any launch-count
    window: the route's trained factors against the twin's over the whole
    run in raw bits, which must be equal (the twin on the host CPU, or with
    ``on_card`` on the card through the same route, its device init
    included); then the top-1 of the card's factors on the card, which
    must give the run's agreement, and, without ``on_card``, on the CPU."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.writers import format_recommendations
    from recsys_tpu_torch.models.mf import MFState
    from recsys_tpu_torch.ops import bell

    cfg, want = RunConfig(dtype="bfloat16", path="bell"), golden.splitlines()
    card = trainer._factorize_bell_device(spec, cfg, dev)
    t0 = time.perf_counter()
    if on_card:
        kernel_train = bell.bell_train
        bell.bell_train = lambda L, R, t, a2, meta, iters, donate=False: bell.bell_train_plain(L, R, t, a2, meta, iters)
        try:
            twin = trainer._factorize_bell_device(spec, cfg, dev)
        finally:
            bell.bell_train = kernel_train
    else:
        twin = trainer._factorize_bell_device(spec, cfg, torch.device("cpu"))
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    same = checks.same_bits((card.L.cpu(), card.R.cpu()), (twin.L.cpu(), twin.R.cpu()))
    del twin
    tops = {"card": trainer.recommend(card, spec, cfg, dev)}
    if not on_card:
        tops["CPU"] = trainer.recommend(MFState(L=card.L.cpu(), R=card.R.cpu()), spec, cfg, torch.device("cpu"))
    agrees = {k: _agreement(format_recommendations(v, spec.rated_counts(), spec.items), want)[0]
              for k, v in tops.items()}
    top1 = "" if on_card else (f"; the top-1 of those factors on the card and on the CPU differ on "
                               f"{int((tops['card'] != tops['CPU']).sum())} of {spec.users} users, agreement "
                               f"{agrees['card']!r} on the card, {agrees['CPU']!r} on the CPU")
    log(f"[witness] {name} bfloat16: the card's trained factors equal the twin's over all {spec.iters} steps "
        f"({'on the card' if on_card else 'on the host CPU'}, {twin_s:.1f} s) in raw bits: {same}; the run's "
        f"agreement {agree!r}, its top-1 again {agrees['card']!r}{top1}")
    if not same or agrees["card"] != agree:
        raise AssertionError(f"{name} bfloat16: the card's factors differ from the twin's ({same}) or its top-1 "
                             f"from the run's ({agrees['card']} against {agree})")


def p2_probe_phase(torch, dev, launches):
    """P2's probe (``probes/mosaic_gather.py``) at the TPU script's shapes:
    the kernels against their twins and ``gather_err_grad`` against itself
    (two runs) in raw bits, then all five variants, in one launch-count
    window; then ``gather_err_grad`` alone from CUDA graph replays (outside
    the window: a replay calls no wrapper).  Returns ({kernel: max abs
    error against its twin}, {variant: ms per gather, "p4 call": ms a
    call})."""
    from recsys_tpu_torch.probes import mosaic_gather

    counts = {}
    with counted(counts):
        errs, per = mosaic_gather.run(dev, graphs=False)
    launches["P2 probe", "all variants"] = counts
    log(f"[probe] P2 launches: {_nonzero(counts)}")
    if min(counts[k] for k in ("gather_rows", "gather_err_grad")) <= 0:
        raise AssertionError(f"the P2 probe did not launch every kernel: {counts}")
    per["p4 call"] = mosaic_gather.err_grad_ms(*mosaic_gather.inputs(dev))
    return errs, per


def p1_probe_phase(torch, dev, launches):
    """P1's probe (``probes/gather.py``) in one launch-count window: both
    kernels at the check shape, then at every probe shape the gather equal
    to its twin bit for bit (full-width and broadcast indices, T = 512) and
    the scan equal to the kernel's order in raw bits (t = 2, 5, 512) and
    within its limit of the twin with the control rejected (a failure
    raises there); then the timings, a kernel's step counts in turns in one
    profile a shape.  Gate: every kernel's T-scaling.  Returns ({kernel:
    max abs error}, the probe's timing rows)."""
    from recsys_tpu_torch.probes import gather as probe

    counts = {}
    with counted(counts):
        errs, rows = probe.run(dev)
    launches["P1 probe", "all shapes"] = counts
    log(f"[probe] P1 launches: {_nonzero(counts)}")
    if any(counts[name] <= 0 for name, _, _ in probe.KERNELS.values()):
        raise AssertionError(f"the P1 probe did not launch every kernel: {counts}")
    lo, hi = T_SCALING
    failed = []
    for row in rows:
        ok = lo <= row["scaling_net"] <= hi and (not row["widest"] or lo <= row["scaling_long"] <= hi)
        long = (f", T={probe.T_LONG} / T={probe.T} x{row['scaling_long']!r} (widest shape)" if row["widest"]
                else "")
        log(f"[probe] P1 {row['name']} ({row['S']}, {row['W']}) T-scaling: net of T=0 T={probe.T} / "
            f"T={probe.T_SHORT} x{row['scaling_net']!r}{long}; raw T={probe.T} / T={probe.T_SHORT} "
            f"x{row['scaling']!r} (range {lo}-{hi}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{row['name']} ({row['S']}, {row['W']}) T-scaling")
    if failed:
        raise AssertionError(f"P1 phase failed: {failed}")
    return errs, rows


def p3_probe_phase(torch, dev, launches):
    """P3's probe (``probes/stream_v2.py``, 300 steps) in one launch-count
    window: P3 against its twin, itself and B3 at the small spec and both
    probe shapes, then both slopes in turns.  Returns (readings,
    timings)."""
    from recsys_tpu_torch.probes import stream_v2 as probe

    counts = {}
    with counted(counts):
        readings, timings = probe.run(dev, P3_ITERS)
    launches["P3 probe", "all shapes"] = counts
    log(f"[probe] P3 launches: {_nonzero(counts)}")
    if counts["stream_v2_train"] <= 0:
        raise AssertionError(f"the P3 probe did not launch stream_v2_train: {counts}")
    t = timings["gen-instML1M"]
    log(f"[probe] gen-instML1M P3 slope: {t['v2']['per_step_ms']!r} ms/step (B3 {t['v1']['per_step_ms']!r})")
    return readings, timings


def coo_phase(torch, dev, launches):
    """instML100k through ``run(path="coo")`` in f32 (the prefix-sum form on
    the card) and f64 (segment sums) against its golden at
    ``DENSE_F64_FLOOR`` with the byte match reported; two ``factorize``
    runs bit for bit in each; phases and the slope (1000 vs 3000 steps);
    one step's device time by kernel."""
    import numpy as np

    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.ops import coo

    spec = load_problem(ML100K + ".in")
    with open(ML100K + ".out") as f:
        golden = f.read()
    for dtype in ("float32", "float64"):
        cfg = RunConfig(dtype=dtype, path="coo")
        form = "prefix sums" if trainer._coo_use_cumsum(spec, cfg, dev) else "segment sums"
        if form != ("prefix sums" if dtype == "float32" else "segment sums"):
            raise AssertionError(f"instML100k coo {dtype} took the {form} form")
        _run(dataclasses.replace(spec, iters=10), "auto", dev, torch, path="coo", dtype=dtype)  # warm-up
        ph, _, _ = _golden_run(f"instML100k coo {dtype} ({form})", spec, golden, DENSE_F64_FLOOR, dev, torch,
                            launches, "coo", dtype, path="coo")
        _, _, ph1k = _run(dataclasses.replace(spec, iters=1000), "auto", dev, torch, path="coo", dtype=dtype)
        a, b = (trainer.factorize(spec, cfg, dev) for _ in range(2))
        same = np.array_equal(a.L, b.L) and np.array_equal(a.R, b.R)
        log(f"[main] instML100k coo {dtype}: slope {(ph['train'] - ph1k['train']) / (spec.iters - 1000) * 1e6!r} "
            f"us/iter (1000 vs {spec.iters} iters) | two factorize runs same bits {same}")
        if not same:
            raise AssertionError(f"instML100k coo {dtype}: two runs differ")
        cumsum = form == "prefix sums"
        tdt = getattr(torch, dtype)
        data = coo.to_device((coo.make_coo_seg_inputs if cumsum else coo.make_coo_inputs)(spec, dtype=np.float64),
                             dev, tdt)
        L, R = (torch.from_numpy(x).to(dev, tdt) for x in (a.L, a.R))
        step = coo.coo_gd_step_cumsum if cumsum else coo.coo_gd_step
        _step_profile(torch, f"COO step at instML100k {dtype} ({form})", lambda: step(L, R, data, 2.0 * spec.alpha), 20)


def _mesh_run(name, spec, golden, floor, dev, torch, launches, shape, dtype, route):
    """One ``trainer.run`` with ``mesh_shape=shape`` (every shard on the
    card) in its own launch-count window, on the sharded ``route``, held
    against ``golden`` at ``floor`` (1.0 demands the byte match).  Returns
    (phases, launch counts)."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.parallel import engine as par
    from recsys_tpu_torch.parallel.mesh import make_mesh

    precision = "highest" if dtype == "float32" else "auto"
    cfg = RunConfig(dtype=dtype, precision=precision, mesh_shape=shape)
    got = par.sharded_route(spec, cfg, make_mesh(spec.users, spec.items, shape, device=dev))
    if got != route:
        raise AssertionError(f"{name} {dtype} on {shape} took the sharded {got!r} route, not {route!r}")
    counts = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with counted(counts):
        out, wall, ph = _run(spec, precision, dev, torch, dtype=dtype, mesh_shape=shape)
    want = golden.splitlines()
    agree, lines = _agreement(out, want)
    launches[f"{name} mesh", dtype] = counts
    log(f"[mesh] {name} {dtype} mesh {shape[0]}x{shape[1]} ({route}): agreement {agree!r} byte_match "
        f"{out == golden} lines {lines} | wall {wall!r} s prep {ph['prep']!r} upload {ph['upload']!r} "
        f"train {ph['train']!r} top1 {ph['top1']!r} | peak device memory {torch.cuda.max_memory_allocated(dev)!r} B "
        f"| launches {_nonzero(counts)}")
    if lines != len(want) or agree < floor or (floor >= 1.0 and out != golden):
        raise AssertionError(f"{name} {dtype} mesh {shape}: agreement {agree} below {floor}")
    return ph, counts


def _delta_readings(torch, dev, label, data, blocks, shards, a2, steps):
    """``bell_side_delta`` in both forms against ``bell_side_delta_plain``
    in raw bits, in f64, f32 and bf16, on both sides of each shard in
    ``shards``, ``steps`` steps of the shard alone (its twin deltas added to
    its rows), and two kernel calls the same.  ``blocks(ub, ib)`` gives the
    shard's f64 factor blocks (zero row last).  Returns (failed, max abs
    error)."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.ops import bell

    m, failed, worst = data.meta, [], 0.0
    for tdt in (torch.float64, torch.float32, torch.bfloat16):
        for ub, ib in shards:
            t = bell.shard_tables(data.tables, ub, ib, dev, tdt)
            l, r = (x.to(tdt) for x in blocks(ub, ib))
            ok = {"= twin": True, "= warp form": True, "two runs same": True}
            for _ in range(steps):
                twins = []
                for own, other, cols, vals, side in ((l, r, t.ucols, t.uvals, m.user), (r, l, t.irows, t.ivals, m.item)):
                    twin = bell.bell_side_delta_plain(own, other, cols, vals, side, a2)
                    got = bell.bell_side_delta(own, other, cols, vals, side, a2)
                    warp = bell.bell_side_delta(own, other, cols, vals, side, a2, wide=bell.WARP_FORM)
                    again = bell.bell_side_delta(own, other, cols, vals, side, a2)
                    ok["= twin"] &= checks.same_bits(got, twin)
                    ok["= warp form"] &= checks.same_bits(warp, twin)
                    ok["two runs same"] &= checks.same_bits(again, got)
                    if twin.numel():
                        worst = max(worst, float((got.double() - twin.double()).abs().max()))
                    twins.append(twin)
                l[: m.user.n_nz] += twins[0]
                r[: m.item.n_nz] += twins[1]
            bad = [k for k, v in ok.items() if not v]
            if bad:
                failed.append(f"{label} shard {(ub, ib)} {tdt}: {bad}")
        log(f"[mesh] bell_side_delta {label} {str(tdt).split('.')[1]}, shards {shards}, {steps} steps "
            f"({len(m.user.bounds)}+{len(m.item.bounds)} buckets, widest "
            f"{max((w for _, _, w in m.user.bounds + m.item.bounds), default=0)} slots): kernel = twin and warp "
            f"form = twin in raw bits, two runs same: {'ok' if not failed else failed}")
    return failed, worst


def _step_split(torch, label, step_fn, kernels_fn, reps=20):
    """One sharded step's device time by CUDA events (``step_fn(n)`` runs n
    steps) against that of the shards' kernels alone (``kernels_fn()``, one
    step's partials): the rest is the reductions, the copies and the
    updates.  Logged; returns (step ms, kernels ms)."""
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    step_ms = cuda_event_ms(lambda: step_fn(reps)) / reps
    kern_ms = cuda_event_ms(kernels_fn, reps)
    log(f"[mesh] {label}: one step {step_ms!r} ms by CUDA events, the shards' kernels {kern_ms!r} ms, the "
        f"reductions, copies and updates {step_ms - kern_ms!r} ms ({(step_ms - kern_ms) / step_ms:.1%})")
    return step_ms, kern_ms


def mesh_phase(torch, dev, launches, big):
    """The sharded engine (``recsys_tpu_torch/parallel``), every shard on
    the card: (a) ``bell_side_delta`` against its twin in raw bits (f64,
    f32, bf16, both forms) at the dryrun's shapes and a hub spec on a 2x4
    mesh (2 steps) and at shard (0, 0) of gen-inst1e6 on its (4, 1) mesh
    (2 steps), and B5's raw ``tiled_deltas`` against its twin at
    instML100k's 2x2 shard shapes within ``testing.TILED_UPDATE_RTOL``;
    (b) ``parallel.engine.dryrun(8)``; (c) instML100k through ``run()`` on
    a 2x2 mesh in f32 `highest` (the sharded ``tiled`` route) and f64 (the
    checkerboard ``bell``, byte for byte), with each step's split into the
    shards' kernels and the rest; (d) gen-inst1e6 f32 through ``run()`` on
    the (4, 1) mesh (``bell``, the device init).  Returns the numbers of the
    kernels line's ``tiled_deltas`` and ``bell_side_delta`` entries."""
    import gc

    import numpy as np

    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.generator import generate_instance
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell, dense_tiled
    from recsys_tpu_torch.parallel import engine as par
    from recsys_tpu_torch.parallel import step
    from recsys_tpu_torch.parallel.mesh import make_mesh
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    failed, worst = [], 0.0
    # (a) the delta form at the dryrun's shapes and a hub spec (rows of 375
    # slots a shard: the block form), every shard of a 2x4 mesh.
    small = {"dryrun 200x300 k8": generate_instance(200, 300, 8, 1, 6, iters=5, alpha=0.02, seed=11),
             "dryrun 12x20 k4": generate_instance(12, 20, 4, 1, 5, iters=1, alpha=0.01, seed=7),
             "hub 300x2000 k30": checks.hub_spec(30)}
    for label, spec in small.items():
        data = bell.make_sharded_bell(spec, 2, 4, np.float64)
        Lp, Rp = (torch.from_numpy(x).to(dev) for x in
                  bell.pad_factors_sharded_bell(init_factors(spec.users, spec.items, spec.features), data, np.float64))
        m = data.meta

        def blocks(ub, ib, Lp=Lp, Rp=Rp, m=m):
            return (Lp[ub * (m.u_blk + 1):(ub + 1) * (m.u_blk + 1)].clone(),
                    Rp[ib * (m.i_blk + 1):(ib + 1) * (m.i_blk + 1)].clone())

        f, e = _delta_readings(torch, dev, label, data, blocks, [(ub, ib) for ub in range(2) for ib in range(4)],
                               2.0 * spec.alpha, 2)
        failed, worst = failed + f, max(worst, e)
    t0 = time.perf_counter()
    data = bell.make_sharded_bell(big, *INST1E6_MESH, np.float64)
    m = data.meta
    log(f"[mesh] {INST1E6} on {INST1E6_MESH}: sharded BELL tables built in {time.perf_counter() - t0!r} s; a shard "
        f"holds {m.u_blk} users, {m.i_blk} items")
    g = torch.Generator(device=dev).manual_seed(0)

    def big_blocks(ub, ib):
        l, r = (torch.rand((n + 1, big.features), generator=g, dtype=torch.float64, device=dev).div_(big.features)
                for n in (m.u_blk, m.i_blk))
        l[-1], r[-1] = 0.0, 0.0
        return l, r

    f, e = _delta_readings(torch, dev, INST1E6, data, big_blocks, [(0, 0)], 2.0 * big.alpha, 2)
    failed, worst = failed + f, max(worst, e)
    del data
    gc.collect()
    torch.cuda.empty_cache()

    ml = load_problem(ML100K + ".in")
    with open(ML100K + ".out") as fh:
        golden = fh.read()
    mesh = make_mesh(ml.users, ml.items, MESH, device=dev)
    L, R, Ab, At = par.tiled_inputs(ml, mesh)
    got, twin = [], []
    for ub, ib, _ in mesh.shards():
        got += dense_tiled.tiled_deltas(L[ub][ib], R[ib][ub], Ab[ub][ib], At=At[ub][ib])
        twin += dense_tiled.tiled_deltas_plain(L[ub][ib], R[ib][ub], Ab[ub][ib])
    rel = (max(float((a - b).abs().max()) for a, b in zip(got, twin))
           / max(float(b.abs().max()) for b in twin))  # max |kernel - twin| / max |twin|, all shards
    del got, twin
    limit = checks.TILED_UPDATE_RTOL["highest"]
    log(f"[mesh] tiled_deltas at instML100k's {MESH} shards (L {tuple(L[0][0].shape)}, R {tuple(R[0][0].shape)}, A "
        f"{tuple(Ab[0][0].shape)} {Ab[0][0].dtype}), highest: max |kernel - twin| / max |twin| {rel!r} (limit "
        f"{limit}) {'ok' if rel <= limit else 'FAIL'}")
    if rel > limit:
        failed.append(f"tiled_deltas at instML100k's shards: {rel} > {limit}")
    if failed:
        raise AssertionError(f"the sharded kernels' readings failed: {failed}")
    l0, r0, a0, at0 = L[0][0], R[0][0], Ab[0][0], At[0][0]
    tiled = {"err": float(max((x - y).abs().max() for x, y in zip(dense_tiled.tiled_deltas(l0, r0, a0, At=at0),
                                                                     dense_tiled.tiled_deltas_plain(l0, r0, a0)))),
             "ms": cuda_event_ms(lambda: dense_tiled.tiled_deltas(l0, r0, a0, At=at0), 50),
             "plain_ms": cuda_event_ms(lambda: dense_tiled.tiled_deltas_plain(l0, r0, a0), 20),
             "nnz": int((a0 != 0).sum()), "nbytes": a0.numel() * a0.element_size() + 2 * 4 * (l0.numel() + r0.numel())}

    # (b) the dryrun, every shard on the card.
    t0 = time.perf_counter()
    par.dryrun(DRYRUN_SHARDS, device=dev)
    log(f"[mesh] dryrun({DRYRUN_SHARDS}) on {dev}: ok in {time.perf_counter() - t0!r} s")

    # (c) instML100k on the 2x2 mesh, then one step split by CUDA events.
    for dtype, route in (("float32", "tiled"), ("float64", "bell")):
        _mesh_run("instML100k", dataclasses.replace(ml, iters=10), golden, 0.0, dev, torch, {}, MESH, dtype,
                  route)  # warm-up
        ph, counts = _mesh_run("instML100k", ml, golden, MESH_FLOOR[dtype], dev, torch, launches, MESH, dtype, route)
        kernel = "tiled_deltas" if route == "tiled" else "bell_side_delta"
        want = ml.iters * 4 * (1 if route == "tiled" else 2)
        if counts[kernel] != want:
            raise AssertionError(f"instML100k {dtype} mesh: {kernel} launched {counts[kernel]} times, not {want}")
    a2 = 2.0 * ml.alpha
    t_split = _step_split(torch, f"instML100k f32 mesh {MESH} (tiled)",
                          lambda n: step.tiled_train(mesh, L, R, Ab, At, a2, n),
                          lambda: [dense_tiled.tiled_deltas(L[ub][ib], R[ib][ub], Ab[ub][ib], At=At[ub][ib])
                                   for ub, ib, _ in mesh.shards()])
    del L, R, Ab, At
    data, L, R, tables = par.bell_inputs(ml, RunConfig(dtype="float64"), mesh)
    m, preps = data.meta, step.bell_preps(mesh, tables, data.meta)
    b_split = _step_split(torch, f"instML100k f64 mesh {MESH} (bell)",
                          lambda n: step.bell_train(mesh, L, R, tables, a2, n, m),
                          lambda: step.bell_partials(mesh, L, R, tables, a2, m, preps))

    def twin_partials():
        for ub, ib, _ in mesh.shards():
            t = tables[ub][ib]
            bell.bell_side_delta_plain(L[ub][ib], R[ib][ub], t.ucols, t.uvals, m.user, a2)
            bell.bell_side_delta_plain(R[ib][ub], L[ub][ib], t.irows, t.ivals, m.item, a2)

    k = ml.features
    slots = sum(t.ucols.numel() + t.irows.numel() for row in tables for t in row)
    delta = {"err": worst, "ms": b_split[1], "plain_ms": cuda_event_ms(twin_partials, 3), "flops": 2 * 4.0 * k * ml.nnz,
             "nbytes": 8 * k * (m.pu * (m.u_blk + 1) + m.pi * (m.i_blk + 1)) + (4 + 8) * slots
             + m.pu * m.pi * 8 * k * (m.user.n_nz + m.item.n_nz)}
    log(f"[kernels] bell_side_delta at instML100k f64 on {MESH}, one step's partials (8 launches): {delta['nbytes']} B "
        f"(L, R and every shard's tables read once, every shard's partials written), {delta['flops']!r} FLOP; the whole "
        f"step {b_split[0]!r} ms, the tiled route's {t_split[0]!r} ms")
    del L, R, tables, preps
    gc.collect()
    torch.cuda.empty_cache()

    # (d) gen-inst1e6 f32 on the (4, 1) mesh: the checkerboard BELL with the device init.
    with open(INST1E6_OUT) as fh:
        golden = fh.read()
    if not trainer._device_init(big, RunConfig(dtype="float32"), None):
        raise AssertionError(f"{INST1E6} f32 must draw its factors on the card")
    _, counts = _mesh_run(INST1E6, big, golden, INST1E6_BELL_FLOOR["float32"], dev, torch, launches, INST1E6_MESH,
                          "float32", "bell")
    if counts["bell_side_delta"] != 2 * 4 * big.iters:
        raise AssertionError(f"{INST1E6} mesh: bell_side_delta launched {counts['bell_side_delta']} times")
    gc.collect()
    torch.cuda.empty_cache()
    return {"tiled_deltas": tiled, "bell_side_delta": delta}


def _multihost_cases(dev, torch):
    """The multi-process phase's cases (``parallel/launch.py``), each with
    its sharded route, mesh and the one-process engine's factor digest,
    text digest and wall on the card (``factorize_sharded`` +
    ``recommend_sharded``, the reference the ranks must equal in raw bits)."""
    import hashlib

    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.io.writers import format_recommendations
    from recsys_tpu_torch.parallel import engine as par
    from recsys_tpu_torch.parallel import launch
    from recsys_tpu_torch.parallel.mesh import make_mesh

    cases = {}
    for key, (shape, dtype, path, route) in MULTIHOST_CASES.items():
        if key.startswith("ml"):
            case = {"name": f"instML100k {dtype}", "input": ML100K + ".in",
                    "golden": ML100K + ".out" if dtype == "float64" else None}
        else:
            case = {"name": f"gen 2x3 {dtype}", "gen": MULTIHOST_GEN}
        case.update(dtype=dtype, path=path, mesh=list(shape))
        spec, cfg = launch.case_spec(case), launch.case_config(case)
        mesh = make_mesh(spec.users, spec.items, shape, device=dev)
        if par.sharded_route(spec, cfg, mesh) != route:
            raise AssertionError(f"{case['name']} on {shape} does not take the sharded {route!r} route")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = par.factorize_sharded(spec, cfg, mesh=mesh)
        text = format_recommendations(par.recommend_sharded(state, spec, mesh), spec.rated_counts(), spec.items)
        wall = time.perf_counter() - t0
        kernel = "tiled_deltas" if route == "tiled" else "bell_side_delta"
        cases[key] = {"case": case, "route": route, "shape": shape, "digest": checks.factor_digest(state),
                      "text": hashlib.sha256(text.encode()).hexdigest(), "wall": wall, "kernel": kernel,
                      "launches": spec.iters * shape[0] * shape[1] * (1 if route == "tiled" else 2)}
        log(f"[multihost] one process, {case['name']} on {shape[0]}x{shape[1]} ({route}): wall {wall!r} s (the "
            "reference the ranks must equal in raw bits)")
    return cases


def _check_ranks(label, ranks, lines, cases, keys, smi, counts):
    """Hold each rank's line of each case against the one-process engine
    (factor and text digests), the golden, its route and the kernel's
    launches summed over the ranks (added into ``counts``); log the ranks'
    walls and step splits."""
    for key in keys:
        c = cases[key]
        got = [next((x for x in rank if x["case"] == c["case"]["name"]), None) for rank in lines]
        if len(got) != ranks or any(x is None for x in got):
            raise AssertionError(f"{label} {c['case']['name']}: a rank printed no line")
        bad = [x["rank"] for x in got if x["factors_sha256"] != c["digest"] or x["text_sha256"] != c["text"]
               or x["route"] != c["route"] or (c["case"].get("golden") and x["golden"] is not True)]
        total = sum(x["launches"][c["kernel"]] for x in got)
        for k in counts:
            counts[k] += sum(x["launches"][k] for x in got)
        for x in got:
            split = (f"step {x['step_ms']!r} ms: kernels {x['kernels_ms']!r}, exchange {x['exchange_ms']!r}, rest "
                     f"{x['rest_ms']!r}" if "step_ms" in x else "no step split")
            log(f"[multihost] {label} {c['case']['name']} on {c['shape'][0]}x{c['shape'][1]} ({c['route']}) rank "
                f"{x['rank']}: wall {x['wall_s']!r} s (one process {c['wall']!r} s) train {x['train_s']!r} s | "
                f"{split} | {c['kernel']} launches {x['launches'][c['kernel']]} | golden {x['golden']} | "
                f"factors = one process {x['factors_sha256'] == c['digest']} | {smi}")
        if bad or total != c["launches"]:
            raise AssertionError(f"{label} {c['case']['name']}: ranks {bad} differ from the one-process engine or "
                                 f"its golden, or {c['kernel']} launched {total} times, not {c['launches']}")


def multihost_phase(torch, dev, launches, smi):
    """The multi-process layer (``parallel/multihost.py``) through its
    launcher (``parallel/launch.py``): (a) one rank over NCCL in this
    process on the card, instML100k 2x2 in f64 (checkerboard ``bell``,
    byte for byte) and f32 `highest` (sharded ``tiled``); (b) 2 and 4 ranks
    sharing the card over gloo, each a process, on instML100k 2x2 (f64 on 2
    and 4 ranks, f32 on 2), and 3 ranks on a 2x3 mesh at ``MULTIHOST_GEN``
    (f64 ``bell``, f32 ``tiled``).  Every rank's whole factors must equal
    the one-process engine's in raw bits, its text the one process's (and
    the golden), every rank print its line, and the sharded kernel's
    launches, summed over the ranks, be a shard's and step's each; any
    rank's failure or timeout fails the phase.  Then ``_cli_checks``.  Each rank's step is split
    by CUDA events into its shards' kernels, the exchange of partials and
    the rest.  The ranks' launches go into ``launches["multihost", "all
    ranks"]``."""
    import json

    from recsys_tpu_torch.parallel import launch, multihost

    cases = _multihost_cases(dev, torch)
    counts = dict.fromkeys(launch.KERNELS, 0)
    multihost.initialize(f"127.0.0.1:{launch.free_port()}", 1, 0, device=dev)
    try:
        lines = [[launch.run_case(cases[key]["case"], dev, MULTIHOST_REPS) for key in ("ml f64", "ml f32")]]
    finally:
        multihost.shutdown()
    _check_ranks("nccl 1 rank", 1, lines, cases, ("ml f64", "ml f32"), smi, counts)
    for ranks, _, keys in MULTIHOST_RUNS:
        t0 = time.perf_counter()
        results = launch.spawn(ranks, ["--device", str(dev), "--backend", "gloo", "--reps", str(MULTIHOST_REPS),
                                       "--cases", json.dumps([cases[k]["case"] for k in keys])], MULTIHOST_TIMEOUT)
        lines = launch.rank_lines(results)
        log(f"[multihost] gloo {ranks} ranks on one card: {time.perf_counter() - t0!r} s with the ranks' start")
        _check_ranks(f"gloo {ranks} ranks", ranks, lines, cases, keys, smi, counts)
    launches["multihost", "all ranks"] = counts
    log(f"[multihost] launches over every rank of the phase: {counts}")
    _cli_checks(torch, dev, smi)


def _cli_checks(torch, dev, smi):
    """The CLI's subcommands: ``python -m recsys_tpu_torch.cli bench``
    instML100k (its JSON line parses, ``path`` the auto route), then
    ``generate`` ``CLI_GEN`` into build/, ``run`` it in f64 on the card and
    ``oracle`` it: the two outputs byte equal, less the time line."""
    import contextlib
    import io

    from recsys_tpu_torch import cli
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem

    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-P", "-m", "recsys_tpu_torch.cli", "bench", ML100K + ".in", "--device",
                        str(dev), "--repeats", "3"], capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"cli bench exited with {r.returncode}: {r.stderr[-2000:]}")
    row = json.loads(r.stdout.splitlines()[-1])
    want = trainer.choose_path(load_problem(ML100K + ".in"), RunConfig(dtype="float32"), dev)
    log(f"[multihost] cli bench instML100k --repeats 3: {json.dumps(row)} | {smi}")
    if row["path"] != want or row["repeats"] != 3 or not row["wall_s"] > 0:
        raise AssertionError(f"cli bench: path {row['path']!r}, not the auto route {want!r}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    gen = os.path.join(ROOT, "build", f"{CLI_GEN[0]}.in")
    outs = []
    for argv in (["generate", CLI_GEN[0], gen, *CLI_GEN[1]], ["run", gen, "--device", str(dev), "--dtype", "float64"],
                 ["oracle", gen]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(argv)
        lines = buf.getvalue().splitlines(keepends=True)
        if rc != 0 or (argv[0] != "generate" and not lines[-1].startswith("time : ")):
            raise AssertionError(f"cli {argv[0]}: exit {rc}, last line {lines[-1:]}")
        outs.append("".join(lines[:-1]))
    log(f"[multihost] cli generate {CLI_GEN[0]}, run --dtype float64 on {dev} and oracle: byte equal less the time "
        f"line {outs[1] == outs[2]} ({outs[1].count(chr(10))} lines)")
    if outs[1] != outs[2] or not outs[1]:
        raise AssertionError("cli run --dtype float64 differs from oracle")


def bench_phase(torch, dev, launches, smi):
    """The bench harness on the card: ``BENCH_ROWS`` through
    ``sweep.run_instance`` (one repeat), each row from ``cuda`` with a device
    memory peak above 0 and a share of the roofline in (0, 105], on its
    route, instML100k f32 a byte match with a slope and inst200-10000 f64
    200/201 = 0.99502 of its golden (all 200 users' lines); the sharded
    engine through ``scaling.measure_mesh``; then ``_bf16_cli_checks``.
    Every run has its own launch-count window."""
    from recsys_tpu_torch.bench import roofline, scaling, sweep
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.utils.timing import sync_floor_seconds

    log(f"[bench] measured_hbm_gbps {roofline.measured_hbm_gbps(dev)!r} GB/s (data sheet "
        f"{roofline.HBM_BYTES_S / 1e9:g}) | sync_floor_seconds {sync_floor_seconds(dev)!r} s | {smi}")
    kernel = {"pallas": "resident_train_top1", "bell": "bell_side_update"}
    for name, dtype, route in BENCH_ROWS:
        counts = {}
        with counted(counts):
            row = sweep.run_instance(name, dtype, 1, dev)
        launches[f"bench {name}", dtype] = counts
        log(f"[bench] {json.dumps(row)} | launches {_nonzero(counts)}")
        pct = row["pct_roofline"]
        bad = [what for what, ok in (
            ("backend", row["backend"] == "cuda"), ("route", row["path"] == route),
            ("memory peak", (row["hbm_peak_mb"] or 0) > 0), ("share", pct is not None and 0 < pct <= 105),
            ("launches", counts[kernel[route]] > 0),
            ("golden", row["golden_exact"] is True and row["per_iter_marginal_ms"] is not None if dtype == "float32"
             else row["agreement"] == round(200 / 201, 4) and row["golden_exact"] is False))
            if not ok]
        if bad:
            raise AssertionError(f"bench {name} {dtype}: {bad} wrong in {row}")
    spec = sweep.load_instance("instML100k", FIXTURES)
    counts = {}
    with counted(counts):
        rows = scaling.measure_mesh(dataclasses.replace(spec, iters=BENCH_MESH_ITERS), RunConfig(dtype="float32"),
                                    BENCH_MESH_SHAPES, dev)
    launches["bench mesh", "float32"] = counts
    for pu, pi, wall, spread, route in rows:
        log(f"[bench] measure_mesh instML100k {BENCH_MESH_ITERS} iterations {pu}x{pi} ({route}, every shard on "
            f"the card): wall {wall!r} s, spread {spread!r} | {smi}")
    if [(pu, pi) for pu, pi, *_ in rows] != list(BENCH_MESH_SHAPES) or counts["tiled_deltas"] == 0:
        raise AssertionError(f"measure_mesh: rows {rows}, launches {_nonzero(counts)}")
    _bf16_cli_checks(torch, dev, launches)


def _bf16_cli_checks(torch, dev, launches):
    """``cli run --dtype bfloat16 --strict`` on each of ``BENCH_CLI``
    (gen-instML1M written from ``GEN_SPECS`` into a temporary directory): a
    shape at or above the floor in ``bf16_policy.MEASURED`` runs (exit 0,
    one line a user, kernels launched), one below it is refused (exit 2,
    nothing printed, no kernel launched)."""
    from recsys_tpu_torch import cli
    from recsys_tpu_torch.bench import bf16_policy, sweep
    from recsys_tpu_torch.io.parser import save_problem

    with tempfile.TemporaryDirectory() as tmp:
        for name in BENCH_CLI:
            spec = sweep.load_instance(name, FIXTURES)
            path = os.path.join(tmp, f"{name}.in")
            save_problem(spec, path)
            agree = bf16_policy.lookup(spec)
            if agree is None:
                raise AssertionError(f"bf16_policy.MEASURED has no row of {name}'s shape")
            runs = agree >= bf16_policy.FLOOR
            counts = {}
            out, err = io.StringIO(), io.StringIO()
            with counted(counts), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(["run", path, "--device", str(dev), "--dtype", "bfloat16", "--strict", "--no-time"])
            launches[f"bench cli bf16 {name}", "strict"] = counts
            log(f"[bench] cli run {name} --dtype bfloat16 --strict: exit {rc}, {out.getvalue().count(chr(10))} "
                f"lines, measured {agree!r} (floor {bf16_policy.FLOOR}) | launches {_nonzero(counts)} | "
                f"{err.getvalue().strip()[:300]}")
            ok = (rc == 0 and out.getvalue().count("\n") == spec.users and any(counts.values())) if runs else \
                (rc == 2 and out.getvalue() == "" and not any(counts.values()))
            if not ok:
                raise AssertionError(f"cli bf16 --strict on {name}: exit {rc}, expected it to "
                                     f"{'run' if runs else 'be refused before training'}")
            del spec


def device_rng_phase(torch, dev, spec):
    """The device init's kernel (``device_rng.glibc_stream``,
    ``csrc/glibc_init.cu``): its words against the host generator's for
    counts either side of a segment and of a block's span; then
    ``device_init_factors`` at ``spec``'s shape (gen-inst1e6: L 1M x 700,
    then R 100 x 700) bit for bit against ``f32(host random()) *
    f32(scale)`` on a sample of L's rows (the first, the last, and every row
    that holds a block span's first or last draw) and on all of R, and
    against the torch twin (``DeviceGlibcStream``) on the card over every
    draw; then the kernel's time by CUDA events beside its floor (4 B a draw
    written once at the HBM rate) and the twin's.  Returns the kernels
    line's readings."""
    import numpy as np

    from recsys_tpu_torch.bench import roofline
    from recsys_tpu_torch.io.glibc_random import RAND_MAX, GlibcRandom, rand01_sequence
    from recsys_tpu_torch.ops import device_rng
    from recsys_tpu_torch.testing import same_bits
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    failed = []
    span = device_rng.SEGMENT << device_rng.LOG_THREADS
    for n in (5, device_rng.SEGMENT + 1, 3 * span + 12345):
        words = device_rng.glibc_stream(n, device=dev).cpu().numpy() >> 1
        host = GlibcRandom(0).raw(n) if n < 10_000 else np.rint(rand01_sequence(n) * RAND_MAX).astype(np.int64)
        same = np.array_equal(words, host)
        log(f"[kernel] glibc_init words, {n} draws ({n // span} block spans of {span} and {n % span}): "
            f"= host bit for bit {same}")
        if not same:
            failed.append(f"words {n}")
    k, users, items = spec.features, spec.users, spec.items
    draws = (users + items) * k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L, R = device_rng.device_init_factors(users, items, k, device=dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    r01 = rand01_sequence(draws)  # the host init's draws, random() / RAND_MAX in f64
    t_host = time.perf_counter() - t0
    scale = np.float32(1.0 / (float(RAND_MAX) * k))
    edges = np.arange(span, users * k, span)
    rows = np.unique(np.concatenate([[0, users - 1], edges // k, (edges - 1) // k]))

    def expect(x):  # random() recovered exactly (below 2^31), then the card's float step
        return np.rint(x * RAND_MAX).astype(np.float32) * scale

    want_L = expect(r01[: users * k].reshape(users, k)[rows])
    want_R = expect(r01[users * k :].reshape(k, items).T)
    same = (np.array_equal(L[torch.from_numpy(rows).to(dev)].cpu().numpy(), want_L)
            and np.array_equal(R.cpu().numpy(), want_R))
    del r01
    twin = device_rng.DeviceGlibcStream(0, device_rng.DEFAULT_BLOCK, dev)
    plain = twin.rand01_over(draws, float(k))
    same_twin = same_bits(plain, torch.cat([L.reshape(-1), R.T.reshape(-1)]))
    log(f"[kernel] device_init_factors {users}x{items} k={k}: {draws} draws on the card in {t_dev!r} s (first "
        f"call), host draws {t_host!r} s; {len(rows)} rows of L (first, last, span edges) and all of R = "
        f"f32(host)*scale bit for bit {same}; every draw = the twin's on the card bit for bit {same_twin}")
    if not (same and same_twin):
        failed.append("device_init_factors")
    del L, R, plain
    if failed:
        raise AssertionError(f"device RNG phase failed: {failed}")
    ms = cuda_event_ms(lambda: device_rng.device_init_factors(users, items, k, device=dev), 20)
    plain_ms = cuda_event_ms(lambda: twin.rand01_over(draws, float(k)), 2)
    bound_ms = 4.0 * draws / roofline.HBM_BYTES_S * 1e3
    log(f"[kernel] glibc_init at {users}x{items} k={k}: {ms!r} ms a call (CUDA events, 20 calls), bound "
        f"{bound_ms!r} ms (4 B a draw at the HBM rate), {100 * bound_ms / ms!r}% of it; the twin on the card "
        f"{plain_ms!r} ms")
    del twin
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "nbytes": 4.0 * draws, "err": 0.0}


def _timing_inputs(spec, dev, torch):
    """(L, R, A, At) of the tiled plan at ``spec``'s shape, for timing:
    ``spec``'s ratings and random factors (the time does not depend on
    their values)."""
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.ops import dense_tiled

    plan = trainer.dense_plan(spec, tiled=True)
    g = torch.Generator(device=dev).manual_seed(0)
    L = torch.rand((plan.U, plan.K), generator=g, device=dev) / spec.features
    R = torch.rand((plan.I, plan.K), generator=g, device=dev) / spec.features
    A = dense_tiled.device_dense_A(spec, plan.U, plan.I, plan.a_dtype, dev)
    return L, R, A, A.t().contiguous()


def _step_profile(torch, label, step, reps=5):
    """Device time by kernel of one ``step()`` from ``torch.profiler`` over
    ``reps`` calls, and their sum.  Logged only."""
    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = [(getattr(e, "device_time_total", 0.0) / reps, e.key) for e in prof.key_averages()]
    rows = sorted((t, k) for t, k in rows if t > 0)[::-1]
    if not rows:
        log(f"[profile] {label}: the profiler saw no device time")
    for t, key in rows:
        log(f"[profile] {label}: {t!r} us per step {key[:90]}")
    log(f"[profile] {label}: {sum(t for t, _ in rows)!r} us of device time per step in all")


def tiled_step_profile(torch, dev, spec, name):
    """One step at ``spec``'s shape (tiled plan, `highest`) by kernel: B5's
    fused step (``tiled_gd_step``, the engine's form of its L pass), then
    the composition it replaced, B5's raw deltas beside the torch update."""
    from recsys_tpu_torch.ops import dense_tiled as dt

    L, R, A, At = _timing_inputs(spec, dev, torch)
    a2 = 2.0 * spec.alpha
    form = dt.step_form(L.shape[1], R.shape[0], A.dtype)
    _step_profile(torch, f"B5 fused step ({form}) at {name}", lambda: dt.tiled_gd_step(L, R, A, alpha2=a2, At=At))
    _step_profile(torch, f"B5 deltas+apply at {name}",
                  lambda: dt._apply(L, R, *dt.tiled_deltas(L, R, A, At=At), a2))
    del L, R, A, At


def _bound(flops, nbytes, peak="float32"):
    """(bound_ms, bound_by): operations at the data sheet's peak of the
    dtype ``peak`` (by default f32 on the CUDA cores, `highest`;
    ``bench/roofline.py``) against bytes over HBM, whichever takes longer."""
    from recsys_tpu_torch.bench import roofline

    t_ops, t_bytes = flops / roofline.PEAK_FLOPS[peak], nbytes / roofline.HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _record(name, launches, err, ms, plain_ms, flops, nbytes, peak="float32", library_ms=None):
    """One kernel's entry of the kernels line."""
    bound_ms, bound_by = _bound(flops, nbytes, peak)
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def kernel_records(torch, dev, ml100k, ml1m, big, launches, errs, times, p1_rows, p3):
    """The kernels line: every number measured in this run, in `highest`.
    The train kernels' bound counts 6*k FLOP per rated cell and step, the
    top-1's 2*k per (user, item); bytes count each input tensor read once
    and each output written once.  B5's raw deltas are one launch at
    instML100k's 2x2 shard shape (the sharded route's; gen-inst1e6's
    logged beside), its fused step one step at gen-inst1e6's shape
    (``big``, the B5 probe's slope in turns); then ``bell_records`` and
    ``bell_side_delta``, one step's partials of the 2x2 mesh at instML100k
    in f64 (``mesh_phase``).  The launches of the two sharded kernels add
    the multi-process phase's, every rank's (``multihost_phase``)."""
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.ops import dense_fused as df
    from recsys_tpu_torch.ops import dense_stream as ds
    from recsys_tpu_torch.ops import dense_tiled as dt
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    def shapes(spec):
        plan = trainer.dense_plan(spec)
        a_bytes = torch.empty((), dtype=plan.a_dtype).element_size() * plan.U * plan.I
        factors = 4 * plan.K * (plan.U + plan.I)
        train_flops = 6.0 * spec.nnz * spec.features * spec.iters
        top_flops = 2.0 * spec.users * spec.items * spec.features
        return plan, a_bytes, factors, train_flops, top_flops

    out = []

    def add(*args):
        out.append(_record(*args))

    plan, a_b, f_b, tr, tp = shapes(ml100k)
    add("resident_train_top1", launches["instML100k", "auto"]["resident_train_top1"], errs["B1"],
        times["B1"][0] * 1e3, times["B1"][1] * 1e3, tr + tp, a_b + 2 * f_b + 4 * plan.U)
    Lt, Rt, A = _inputs(ml100k, plan.a_dtype, dev, torch)
    kw = dict(iters=ml100k.iters, alpha2=2.0 * ml100k.alpha, precision="highest")
    b2_ms = cuda_event_ms(lambda: df.resident_train(Lt, Rt, A, **kw))
    b2_plain = cuda_event_ms(lambda: df.resident_train_plain(Lt, Rt, A, **kw))
    add("resident_train", launches["instML100k checkpoint", "auto"]["resident_train"], errs["resident_train"],
        b2_ms, b2_plain, tr, a_b + 2 * f_b)

    plan, a_b, f_b, tr, tp = shapes(ml1m)
    Lt, Rt, A = _inputs(ml1m, plan.a_dtype, dev, torch)
    kw = dict(iters=ml1m.iters, alpha2=2.0 * ml1m.alpha, precision="highest")
    Lf, Rf = ds.stream_train(Lt, Rt, A, **kw)
    counts = launches["gen-instML1M", "auto"]
    add("stream_train", counts["stream_train"], errs["stream_train"],
        times["B3"][0] * 1e3, times["B3"][1] * 1e3, tr, a_b + 2 * f_b)
    b4 = _top1_ms(torch, dev, Lf, Rf, A, ml1m.items)
    b4_plain = cuda_event_ms(lambda: ds.stream_top1_plain(Lf, Rf, A, precision="highest", items_true=ml1m.items), 5)
    add("stream_top1", counts["stream_top1"], errs["stream_top1"], b4["B4"], b4_plain, tp, a_b + f_b + 4 * plan.U)
    log(f"[kernels] stream_top1 reference composition torch.mm (true f32) + where + argmax: "
        f"{b4['torch.mm + where + argmax']!r} ms (no single call computes the function: library none)")
    b6_ms = cuda_event_ms(lambda: ds.stream_train_top1(Lt, Rt, A, items_true=ml1m.items, **kw))
    b6_plain = cuda_event_ms(lambda: ds.stream_train_top1_plain(Lt, Rt, A, items_true=ml1m.items, **kw))
    add("stream_train_top1", counts["stream_train_top1"], errs["stream_train_top1"], b6_ms, b6_plain,
        tr + tp, a_b + 2 * f_b + 4 * plan.U)

    plan, a_b, f_b, _, _ = shapes(big)
    L, R, A, At = _timing_inputs(big, dev, torch)
    b5_ms = cuda_event_ms(lambda: dt.tiled_deltas(L, R, A, At=At), 10)
    b5_plain = cuda_event_ms(lambda: dt.tiled_deltas_plain(L, R, A), 5)
    # The raw deltas' main path is the sharded tiled route: one launch a
    # shard and step at instML100k's 2x2 shard shape (``mesh_phase``).
    tl = times["mesh"]["tiled_deltas"]
    ranks = launches["multihost", "all ranks"]
    add("tiled_deltas", launches["instML100k mesh", "float32"]["tiled_deltas"] + ranks["tiled_deltas"], tl["err"],
        tl["ms"], tl["plain_ms"],
        6.0 * tl["nnz"] * ml100k.features, tl["nbytes"])
    log(f"[kernels] tiled_deltas at {INST1E6}, one launch: {b5_ms!r} ms, twin {b5_plain!r} ms, bound "
        f"{_bound(6.0 * big.nnz * big.features, a_b + 2 * f_b)!r} ms, max_abs_err against the twin "
        f"{errs['tiled_deltas']!r}; the B5 probe's launches {launches['B5 fused probe', 'all shapes']['tiled_deltas']}")
    # The fused step: ms a step from the probe's slope in turns.
    step_plain = cuda_event_ms(lambda: dt.tiled_train_plain(L, R, A, iters=1, alpha2=2.0 * big.alpha), 5)
    add("tiled_step", launches[INST1E6, "auto"]["tiled_step"], errs["tiled_step"], times["B5 step"], step_plain,
        6.0 * big.nnz * big.features, a_b + 2 * f_b)
    log(f"[kernels] tiled_deltas dense count at {INST1E6}: 8*U*I*K = {8.0 * plan.U * plan.I * plan.K!r} FLOP, "
        f"{_bound(8.0 * plan.U * plan.I * plan.K, a_b + 2 * f_b)[0]!r} ms at the f32 peak")
    del L, R, A, At
    out += bell_records(torch, dev, ml100k, launches, errs, times)
    bd = times["mesh"]["bell_side_delta"]
    out.append(_record("bell_side_delta", launches["instML100k mesh", "float64"]["bell_side_delta"]
                       + ranks["bell_side_delta"], bd["err"],
                       bd["ms"], bd["plain_ms"], bd["flops"], bd["nbytes"], "float64"))
    gi = times["glibc_init"]
    out.append(_record("glibc_init", launches[f"{INST1E6} float32", "auto"]["glibc_init"], gi["err"], gi["ms"],
                       gi["plain_ms"], 0.0, gi["nbytes"]))
    out += probe_records(torch, dev, launches, errs, p1_rows, p3)
    for rec in out:
        log(f"[kernels] {rec['name']}: {rec['ms']!r} ms vs bound {rec['bound_ms']!r} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']!r} ms, library {rec['library_ms']!r} ms, "
            f"launches {rec['launches']}")
    return out


def _top1_ms(torch, dev, Lt, Rt, At, items_true, calls=20, rounds=5):
    """{"B4": ms a call of ``stream_top1`` in `highest`, "torch.mm + where +
    argmax": the reference composition's}, each replayed ``calls`` times
    from a CUDA graph (``timing.graphed``: a 40-80 us kernel is shorter than
    its wrapper's host work), the two in turns.  A replay calls no wrapper,
    so it adds to no launch count."""
    from recsys_tpu_torch.ops import dense_fused as df
    from recsys_tpu_torch.ops import dense_stream as ds
    from recsys_tpu_torch.utils.timing import alternating_ms, graphed

    a = df.load_at(At)
    item = torch.arange(Rt.shape[1], device=dev)[:, None]

    def composition():
        with df.exact_f32(dev):
            b = torch.mm(Rt.T, Lt)
        return torch.argmax(torch.where((a != 0) | (item >= items_true), -torch.inf, b), dim=0)

    fns = {"B4": lambda: ds.stream_top1(Lt, Rt, At, precision="highest", items_true=items_true),
           "torch.mm + where + argmax": composition}
    ms = alternating_ms({name: graphed(fn, calls) for name, fn in fns.items()}, rounds)
    return {name: t / calls for name, t in ms.items()}


def _bell_work(L, R, t, meta, nnz):
    """(bytes, FLOP) of one BELL step: each factor table read once (as own
    and as other side), the slot tables (int32 index and a value), the
    updated rows written; 4*k FLOP per rating and side."""
    k, size = L.shape[1], L.element_size()
    nbytes = (2 * size * k * (L.shape[0] + R.shape[0]) + (4 + size) * (t.ucols.numel() + t.irows.numel())
              + size * k * (meta.user.n_nz + meta.item.n_nz))
    return nbytes, 2 * 4.0 * k * nnz


def bell_records(torch, dev, ml100k, launches, errs, times, steps=100):
    """The kernels line's entries of ``bell_side_update`` (one step, its
    its one launch, at instML100k in f64; 4*k f64 FLOP per rating and side),
    of its bf16 instance (one step at gen-inst1e6, ``times["bf16 bell"]``
    from ``_bell_big_readings``, 2 B a value, its f32 arithmetic at the
    f32 peak), ``gather_rows`` and ``gather_err_grad`` (one launch at P2's
    shapes).  Times are by CUDA events: a BELL step as the
    slope of ``bell_train`` between 3 * ``steps`` and ``steps`` steps in
    turns (the descriptors and copies of a call cancel), ``gather_rows``
    and the twins and library call as the mean of back-to-back calls,
    ``gather_err_grad`` from CUDA graph replays (``times["P2 call"]``, the
    P2 probe's)."""
    from recsys_tpu_torch.models.mf import init_factors
    from recsys_tpu_torch.ops import bell, gather
    from recsys_tpu_torch.probes import mosaic_gather as mg
    from recsys_tpu_torch.utils.timing import alternating_ms, cuda_event_ms

    data, L, R, t = bell.bell_tensors(ml100k, init_factors(ml100k.users, ml100k.items, ml100k.features),
                                      torch.float64, dev)
    a2, k, m = 2.0 * ml100k.alpha, ml100k.features, data.meta
    forms = (bell.WIDE_MIN, bell.WARP_FORM)
    ms = alternating_ms({(w, n): (lambda w=w, n=n: bell.bell_train(L, R, t, a2, m, n, wide=w))
                         for w in forms for n in (3 * steps, steps)})
    step_ms = {w: (ms[w, 3 * steps] - ms[w, steps]) / (2 * steps) for w in forms}

    nbytes, flops = _bell_work(L, R, t, m, ml100k.nnz)
    out = [_record("bell_side_update", launches["instML100k f64", "auto"]["bell_side_update"],
                   errs["bell_side_update"], step_ms[bell.WIDE_MIN],
                   cuda_event_ms(lambda: bell.bell_gd_step_plain(L, R, t, a2, m), 3),
                   flops, nbytes, "float64")]
    # The warp form alone, the form the block form replaced: the same entry
    # point with no row in a block (``bell.WARP_FORM``), timed alike.
    log(f"[redesign] bell_side_update at instML100k f64, one step: warp form alone "
        f"{step_ms[bell.WARP_FORM]!r} ms against the block form {out[0]['ms']!r} ms (in turns)")
    gathered = 8 * k * (t.ucols.numel() + t.irows.numel()) + 2 * 8 * k * (m.user.n_nz + m.item.n_nz)
    log(f"[kernels] bell_side_update at instML100k f64, counting every gathered row (the slots, "
        f"{t.ucols.numel()} + {t.irows.numel()}) and the own rows read and written: {gathered} B, "
        f"{_bound(flops, gathered, 'float64')[0]!r} ms")
    del L, R, t
    bf = times["bf16 bell"]
    out.append(_record("bell_side_update_bf16", launches[f"{INST1E6} bfloat16", "auto"]["bell_side_update"],
                       bf["err"], bf["ms"], bf["plain_ms"], bf["flops"], bf["nbytes"]))

    table, idx, vals = mg.inputs(dev)
    (S,), (N, K) = idx.shape, table.shape
    idx_long = idx.long()
    p2 = launches["P2 probe", "all variants"]
    out.append(_record("gather_rows", p2["gather_rows"], errs["gather_rows"],
                       cuda_event_ms(lambda: gather.gather_rows(table, idx), 50),
                       cuda_event_ms(lambda: gather.gather_rows_plain(table, idx), 50), 0.0,
                       4 * (N * K + S + S * K),
                       library_ms=cuda_event_ms(lambda: table.index_select(0, idx_long), 50)))
    err_grad_plain = cuda_event_ms(lambda: gather.gather_err_grad_plain(table, idx, vals, mg.BLK), 20)
    out.append(_record("gather_err_grad", p2["gather_err_grad"], errs["gather_err_grad"], times["P2 call"],
                       err_grad_plain, 4.0 * S * K + 2.0 * S, 4 * (N * K + 2 * S + S * K)))
    return out


def probe_records(torch, dev, launches, errs, p1_rows, p3):
    """The kernels line's entries of P1's kernels (one launch of T = 512
    steps at (8, 32768), from the probe's own timings: the kernel by the
    profiler, twin and library loop by CUDA events) and P3's (300 steps at gen-instML1M's
    probe shape, the probe's time by CUDA events; its twin timed here
    alike).  P1 counts 2 FLOP per gathered element and step, 3 per scanned
    one (the scan's add, 0 * out and its add); bytes are the inputs read
    and the output written once.  Their shared-memory reads are logged
    beside, at 128 B a clock per SM."""
    from recsys_tpu_torch.ops import stream_v2
    from recsys_tpu_torch.probes import gather as pg
    from recsys_tpu_torch.probes import stream_v2 as ps
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    p1 = launches["P1 probe", "all shapes"]
    out = []
    for name, flop, nbytes, smem in (("lane_gather", 2, 12, 4), ("lane_cumsum", 3, 8, 4)):
        row = next(r for r in p1_rows if r["name"] == name and (r["S"], r["W"]) == (8, 32768))
        n = row["S"] * row["W"]
        out.append(_record(name, p1[name], errs[name], row["ms"], row["plain_ms"], flop * n * pg.T, nbytes * n,
                           library_ms=row["library_ms"]))
        log(f"[kernels] {name} at (8, 32768), T={pg.T}: shared-memory reads {smem * n * pg.T} B "
            f"({smem // 4} a step and element), {smem * n * pg.T / SMEM_BYTES_S * 1e3!r} ms at {SMEM_BYTES_S:.4g} B/s")
    readings, timings = p3
    spec = dataclasses.replace(ps.shapes()["gen-instML1M"], iters=P3_ITERS)
    Lt, _, Rp, A, _ = ps.inputs(spec, ps.STRIP, dev)
    kw = dict(iters=P3_ITERS, alpha2=2.0 * spec.alpha, strip=ps.STRIP)
    plain_ms = cuda_event_ms(lambda: stream_v2.stream_v2_train_plain(Lt, Rp, A, **kw))
    out.append(_record("stream_v2_train", launches["P3 probe", "all shapes"]["stream_v2_train"],
                       readings["gen-instML1M"]["max_abs_err"], timings["gen-instML1M"]["v2"]["ms"], plain_ms,
                       6.0 * spec.nnz * spec.features * P3_ITERS, A.numel() + 2 * 4 * (Lt.numel() + Rp.numel())))
    del Lt, Rp, A
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "recsys_tpu_torch")):
        print("chip_smoke: run from the root of a recsys-tpu checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = t_lap = time.perf_counter()

    def lap(name):  # each phase's wall time, from the end of the one before
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[time] {name} {now - t_lap:.1f} s")
        t_lap = now

    try:
        smi = device_phase(torch)
        lap("device")
        build_phase()
        lap("build")
        dev = torch.device("cuda", 0)
        errs = {"B1": kernel_vs_plain_phase(torch, dev)["highest"]}
        lap("B1 kernel")
        errs.update(stream_kernels_phase(torch, dev))
        lap("stream kernels")
        big = _inst1e6_spec()
        lap("gen-inst1e6 generation")
        errs["tiled_step"] = tiled_kernel_phase(torch, dev, big)
        lap("tiled kernel")
        launches = {}
        b5_readings, b5_times = tiled_redesign_phase(torch, dev, launches, big)
        lap("B5 redesign")
        errs["tiled_deltas"] = b5_readings["deltas"]
        errs["bell_side_update"], bf16_big = bell_kernel_phase(torch, dev, big)
        errs["bell_side_update_bf16"] = bf16_big["err"]
        lap("BELL kernel")
        redesign_phase(torch, dev, launches)
        lap("plan line, BELL forms")
        ml100k, train1, plain1 = ml100k_phase(torch, dev, launches)
        lap("instML100k")
        ml1m, train2, plain2 = ml1m_phase(torch, dev, launches)
        lap("gen-instML1M")
        checkpoint_phase(torch, dev, launches)
        lap("checkpoint")
        inst1e6_phase(torch, dev, launches, big)
        lap("gen-inst1e6")
        tiled_step_profile(torch, dev, big, INST1E6)
        tiled_step_profile(torch, dev, ml1m, "gen-instML1M")
        lap("tiled profiles")
        bell_main_phase(torch, dev, launches)
        lap("bell main")
        glibc = device_rng_phase(torch, dev, big)
        lap("device init")
        inst1e6_bell_phase(torch, dev, launches, big)
        lap("gen-inst1e6 bell")
        bf16_bell_phase(torch, dev, launches, big)
        lap("bf16 bell")
        p2_errs, p2_per = p2_probe_phase(torch, dev, launches)
        errs.update(p2_errs)
        lap("P2 probe")
        p1_errs, p1_rows = p1_probe_phase(torch, dev, launches)
        errs.update(p1_errs)
        lap("P1 probe")
        p3 = p3_probe_phase(torch, dev, launches)
        lap("P3 probe")
        coo_phase(torch, dev, launches)
        lap("COO")
        mesh_times = mesh_phase(torch, dev, launches, big)
        lap("mesh")
        multihost_phase(torch, dev, launches, smi)
        lap("multihost")
        bench_phase(torch, dev, launches, smi)
        lap("bench")
        times = {"B1": (train1["auto", "highest"], plain1["highest"]),
                 "B3": (train2["auto", "highest"], plain2["highest"])}
        times["B5 step"] = b5_times[INST1E6]["auto"]["per_step"]
        times["bf16 bell"], times["P2 call"] = bf16_big, p2_per["p4 call"]
        times["mesh"], times["glibc_init"] = mesh_times, glibc
        kernels = kernel_records(torch, dev, ml100k, ml1m, big, launches, errs, times, p1_rows, p3)
        lap("kernels line")
    except Exception as e:  # noqa: BLE001 - report any failed phase, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "recsys_tpu.")) or m == "recsys_tpu")
    if leaked:
        print(f"chip_smoke: the JAX package or jax was imported: {leaked}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
