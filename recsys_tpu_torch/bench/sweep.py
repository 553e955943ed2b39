"""Benchmark sweep over the golden instances on one card (port of
``recsys_tpu/bench/sweep.py``).

Successor of the reference's ``run-samples.sh``: each instance runs through
``trainer.run`` on the auto route in one dtype a process, its best wall is
held against the reference's published numbers (report-omp.pdf Table 2 /
report-mpi.pdf Tables 1-3, transcribed in SURVEY.md §6) and its output
against the golden ``.out``.  Rows accumulate in a JSONL file, each with the
card's name and power limit; ``--render`` merges them into the markdown
table.  A missing card is an error: nothing falls back to the CPU unless
``--device cpu`` asks for it.  ``gen-*`` instances are built in memory from
``GEN_SPECS``; nothing is written into ``tests/fixtures/``.

Usage:
    python -m recsys_tpu_torch.bench.sweep --dtype float32 --jsonl bench_results_torch.jsonl
        [--device cuda] [--instances inst0,instML100k,...] [--repeats N]
    python -m recsys_tpu_torch.bench.sweep --render bench_results_torch.jsonl --out docs/BENCHMARKS_TORCH.md
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

# Published reference timings, seconds (SURVEY.md §6; report-omp.pdf
# Table 2 serial / best over all published parallel configs incl. MPI
# and hybrid). None = not published.
REFERENCE_S = {
    "inst0": (0.001, 0.001),
    "inst1": (0.063, 0.063),
    "inst2": (0.060, 0.060),
    "inst30-40-10-2-10": (0.421, 0.224),
    "inst1000-1000-100-2-30": (18.123, 2.922),
    "inst200-10000-50-100-300": (24.711, 3.043),
    "inst400-50000-30-200-500": (35.813, 3.38),
    "inst50000-5000-100-2-5": (156.984, 25.208),
    "inst500-500-20-2-100": (57.798, 6.46),
    "inst600-10000-10-40-400": (83.490, 11.717),
    "instML100k": (104.930, 13.922),
    "instML1M": (125.201, 8.60),
    # Cluster-only instances: the reference never published serial
    # numbers for these (they only ran at MPI 16-64 ranks,
    # report-mpi.pdf Table 1); best-published is the best across
    # Tables 1-3 (cluster MPI, local MPI, hybrid).
    "inst1000-1e6-1000-1-3": (None, 143.60),  # MPI-64 (211.80@16, 174.89@32)
    "inst1e6-100-700-1-3": (None, 70.34),  # MPI-64 (87.42@16, 86.32@32)
    "inst1000-80000-20-10-1000": (None, 19.04),
    "inst20000-10000-40-2-50": (None, 56.07),
    "inst60000-2000-200-10-20": (None, 11.05),
}

DEFAULT_INSTANCES = [
    "inst0",
    "inst1",
    "inst2",
    "inst30-40-10-2-10",
    "inst500-500-20-2-100",
    "inst1000-1000-100-2-30",
    "inst200-10000-50-100-300",
    "inst600-10000-10-40-400",
    "inst400-50000-30-200-500",
    "instML100k",
    "gen-instML1M",
    "inst50000-5000-100-2-5",
    # The reference's cluster-only extreme shapes (report-mpi.pdf
    # Table 1, MPI-16): the real 1000x1M k=1000 fixture and the 1M-user
    # gen-* analogue of the missing inst1e6-100-700-1-3 blob.
    "inst1000-1e6-1000-1-3",
    "gen-inst1e6-100-700-1-3",
    # The three orphan-golden shapes (outputs survive upstream, inputs
    # missing): gen-* analogues with iteration counts derived from the
    # published MPI-1 walls (GEN_SPECS, io/generator.py).
    "gen-inst1000-80000-20-10-1000",
    "gen-inst20000-10000-40-2-50",
    "gen-inst60000-2000-200-10-20",
]

# bfloat16 acceptance floor: bf16 is a speed mode whose correctness
# claim is argmax agreement with the exact-f64 golden.  Rows measuring
# below this agreement are flagged in the table and must not be quoted
# as wins; rows with no golden cannot be validated and bf16 should not be
# used for them.
BF16_MIN_AGREEMENT = 0.98

# Train phases below this are at the timing's own resolution; a >100%
# share computed from one is a measurement artifact, not a ceiling breach,
# and is clamped to 100 with a '~' marker.  A >100% row above it stays
# visible raw: a breach of the data sheet's peaks is a fault of the model.
TRAIN_RESOLUTION_S = 0.05


def _repo_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fixture_dir() -> str:
    return os.path.join(_repo_dir(), "tests", "fixtures")


def load_instance(name: str, fixture_dir: str):
    """``<fixture_dir>/<name>.in`` if it exists, else a ``GEN_SPECS``
    instance built in memory; FileNotFoundError for neither."""
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance
    from recsys_tpu_torch.io.parser import load_problem

    path = os.path.join(fixture_dir, f"{name}.in")
    if os.path.exists(path):
        return load_problem(path)
    if name in GEN_SPECS:
        return generate_instance(**GEN_SPECS[name])
    raise FileNotFoundError(path)


def run_config(dtype: str):
    """The RunConfig of a sweep dtype: "f32x3" is the f32 mode with the
    3-pass split product (``precision="bf16x3"``), as in JAX."""
    from recsys_tpu_torch.config import RunConfig

    if dtype == "f32x3":
        return RunConfig(dtype="float32", precision="bf16x3")
    return RunConfig(dtype=dtype)


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def effective_train_s(r: dict):
    """The wall %roofline should divide by: the marginal (slope) train
    when the row has a TRUSTWORTHY one, else the single-call train
    phase, else the end-to-end wall.  The marginal is trusted only when
    the train phase is >= 0.2 s and the slope explains at least half of
    it (a 'fixed cost' above 50% of a full train is noise)."""
    t = r.get("train_s")
    m = r.get("train_marginal_s")
    if m and t and t >= 0.2 and m >= 0.5 * t:
        return m
    return t or r.get("wall_s")


def _instrumented(spec, cfg, device, floor: float | None = None, peak: bool = False):
    """Per-phase walls of two instrumented ``run`` passes, the per-phase
    minimum, less ``floor`` seconds for each synchronise a phase made (the
    measured floor when None); with ``peak``, the first pass's device
    memory peak in bytes (None on the CPU): the allocator's peak counter
    reset before the pass, less what was allocated then, so memory an
    earlier instance left held (cuBLAS's workspace, once a matmul ran) is
    not charged to this row.  Returns (phases, floor, peak bytes)."""
    import torch

    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.utils.timing import collect_phases

    on_card = device.type == "cuda"
    ph: dict = {}
    syncs: dict = {}
    peak_bytes = None
    for i in range(2):
        p: dict = {}
        s: dict = {}
        if peak and i == 0 and on_card:
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
        with collect_phases(p, s):
            trainer.run(spec, cfg, device)
        if peak and i == 0 and on_card:
            peak_bytes = torch.cuda.max_memory_allocated(device) - held
        for k, v in s.items():
            syncs[k] = max(v, syncs.get(k, 0))
        ph = {k: min(v, ph.get(k, v)) for k, v in p.items()}
    if floor is None:
        from recsys_tpu_torch.utils.timing import sync_floor_seconds

        floor = sync_floor_seconds(device) if syncs else 0.0
    ph = {k: max(v - floor * syncs.get(k, 0), 0.0) for k, v in ph.items()}
    return ph, floor, peak_bytes


def run_instance(name: str, dtype: str, repeats: int, device="cuda", fixture_dir: str | None = None, spec=None):
    """One row: a warm-up run, the best of ``repeats`` walls, the argmax
    agreement and exact match against ``<fixture_dir>/<name>.out``, two
    instrumented passes (per-phase minimum, the sync floor subtracted), the
    slope from a rerun at ``iters // 3``, the device memory peak of one
    instrumented pass and the share of the roofline.  ``spec`` skips the
    load when the caller has it."""
    import torch

    from recsys_tpu_torch.bench.roofline import pct_of_roofline, rated_rows
    from recsys_tpu_torch.engine import trainer

    device = torch.device(device)
    fixture_dir = fixture_dir or _fixture_dir()
    if spec is None:
        spec = load_instance(name, fixture_dir)
    cfg = run_config(dtype)
    out, _ = trainer.run(spec, cfg, device)  # warm-up: builds and loads the kernels
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out, _ = trainer.run(spec, cfg, device)  # host text: the card has finished
        walls.append(time.perf_counter() - t0)
    golden_path = os.path.join(fixture_dir, f"{name}.out")
    agree = None
    exact = None
    if os.path.exists(golden_path) and os.path.getsize(golden_path):
        with open(golden_path) as f:
            golden = f.read()
        glines = golden.splitlines()
        olines = out.splitlines()
        agree = sum(x == y for x, y in zip(olines, glines)) / max(len(glines), 1)
        exact = out == golden
    wall = min(walls)
    chosen = trainer.choose_path(spec, cfg, device)
    # The host route synchronises no card: nothing to subtract there.
    host_routed = chosen == "host"
    ph, floor, peak_bytes = _instrumented(spec, cfg, device, 0.0 if host_routed else None, peak=True)
    train_s = ph.get("train")
    # Marginal (slope) per-iteration time: the train phase of one call
    # still carries per-call fixed costs (launch setup, the first
    # synchronise); re-running at a reduced iteration count and
    # differencing cancels them.
    train_marginal_s = None
    if train_s is not None and spec.iters >= 100 and not host_routed:
        n1 = max(spec.iters // 3, 10)
        q, _, _ = _instrumented(dataclasses.replace(spec, iters=n1), cfg, device, floor)
        best1 = q.get("train")
        if best1 is not None and 0 < best1 < train_s:
            train_marginal_s = (train_s - best1) / (spec.iters - n1) * spec.iters
    # The peaks are the card's: a CPU row carries no share.
    rl_model, rl_pct = None, None
    if device.type == "cuda":
        rl_model, rl_pct = pct_of_roofline(
            spec, cfg, chosen,
            effective_train_s({"train_s": train_s, "train_marginal_s": train_marginal_s, "wall_s": wall}),
        )
    rated = rated_rows(spec)
    row = {
        "backend": device.type,
        "device": device_label(device),
        "hbm_peak_mb": None if peak_bytes is None else round(peak_bytes / 1e6, 1),
        # VMEM is a TPU fact: the card's rows have no resident on-chip estimate.
        "resident_vmem_est_mb": None,
        "instance": name,
        "dtype": dtype,
        "path": chosen,
        "wall_s": round(wall, 4),
        "train_s": None if train_s is None else round(train_s, 4),
        "per_iter_ms": None if train_s is None else round(1e3 * train_s / max(spec.iters, 1), 4),
        "train_marginal_s": None if train_marginal_s is None else round(train_marginal_s, 4),
        "per_iter_marginal_ms": (
            None if train_marginal_s is None else round(1e3 * train_marginal_s / max(spec.iters, 1), 4)
        ),
        "prep_s": None if "prep" not in ph else round(ph["prep"], 4),
        "upload_s": None if "upload" not in ph else round(ph["upload"], 4),
        "top1_s": None if "top1" not in ph else round(ph["top1"], 4),
        "sync_floor_s": floor,
        "updates_per_s": round(spec.iters * spec.nnz / wall),
        "iters": spec.iters,
        "nnz": spec.nnz,
        "users": spec.users,
        "items": spec.items,
        "rated_users": rated[0],
        "rated_items": rated[1],
        "k": spec.features,
        "golden_exact": exact,
        "agreement": None if agree is None else round(agree, 4),
        "roofline_model": rl_model,
        "pct_roofline": rl_pct,
    }
    _clamp_sub_resolution_pct(row)
    if dtype in ("bfloat16", "f32x3"):
        # Reduced-pass speed tiers share the acceptance floor: quote a
        # row only if it reaches the agreement floor against the golden.
        row["bf16_below_floor"] = agree is None or agree < BF16_MIN_AGREEMENT
    return row


_DTYPE_ORDER = {"float32": 0, "f32x3": 1, "bfloat16": 2, "float64": 3}


def _row_order(r: dict):
    inst = r["instance"]
    try:
        i = DEFAULT_INSTANCES.index(inst)
    except ValueError:
        i = len(DEFAULT_INSTANCES)
    return (_DTYPE_ORDER.get(r["dtype"], 9), i, inst)


def format_markdown(rows: list[dict]) -> str:
    from recsys_tpu_torch.bench.roofline import MEASURED_HBM_GBPS

    rows = sorted(rows, key=_row_order)
    cards = sorted({r["device"] for r in rows if r.get("backend") == "cuda" and r.get("device")})
    lines = [
        f"# recsys-tpu-torch benchmark sweep ({'; '.join(cards) if cards else 'no card rows'})",
        "",
        "Reference numbers: report-omp.pdf Table 2 (serial, 1 Ryzen 1700X core) and the",
        "best published parallel config across all reference tables (SURVEY.md §6) —",
        "including 16-64-rank cluster MPI runs, so 'vs best published' compares one card",
        "against the reference's best at ANY scale.",
        "",
        "float64 rows are the exact-conformance mode (byte-identical output; the card",
        "runs f64 natively). float32 (f32x3: its 3-pass split product) and bfloat16 rows",
        "are the speed modes (argmax agreement reported). Problems below the device's",
        "reach (path 'host') run the native sequential engine on the host CPU",
        "(recsys_tpu_torch/csrc/recsys_native.c, the reference binary's trajectory bit",
        "for bit) regardless of dtype.",
        "",
        "| instance | dtype | path | wall (s) | train (s) | per-iter (ms) | updates/s | vs serial | vs best published | golden | %roofline | device peak (MB) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        # gen-* instances are scale-equivalent regenerations of blobs
        # missing upstream; compare against the original's numbers.
        ref = REFERENCE_S.get(r["instance"]) or REFERENCE_S.get(r["instance"].removeprefix("gen-"))
        vs_serial = f"{ref[0] / r['wall_s']:.1f}x" if ref and ref[0] else "-"
        vs_best = f"{ref[1] / r['wall_s']:.1f}x" if ref and ref[1] else "-"
        if r["golden_exact"]:
            gold = "exact"
        elif r["agreement"] is not None:
            gold = f"{100 * r['agreement']:.2f}%"
        else:
            gold = "-"
        if r.get("bf16_below_floor"):
            gold += " BELOW-FLOOR"
        mem = r.get("hbm_peak_mb")
        memcol = "-" if mem is None else f"{mem:g}"
        pct = r.get("pct_roofline")
        rlcol = "-" if pct is None else f"{pct:g}% {r.get('roofline_model', '')}"
        train = r.get("train_s")
        traincol = "-" if train is None else f"{train:g}"
        pit = r.get("per_iter_ms")
        if r.get("train_marginal_s") and effective_train_s(r) == r["train_marginal_s"]:
            pit = r.get("per_iter_marginal_ms")
        pitcol = "-" if pit is None else f"{pit:g}"
        pathcol = r["path"] + (" (cpu)" if r.get("backend") == "cpu" else "")
        lines.append(
            f"| {r['instance']} | {r['dtype']} | {pathcol} | {r['wall_s']} | "
            f"{traincol} | {pitcol} | "
            f"{r['updates_per_s']:.3g} | {vs_serial} | {vs_best} | {gold} | {rlcol} | {memcol} |"
        )
    lines += [
        "",
        "Notes:",
        "- Rows are written by `python -m recsys_tpu_torch.bench.sweep` (one process a",
        "  dtype, `--repeats 2`): the wall is the best of the repeats after a warm-up",
        "  run that builds the kernels; 'train (s)' / 'per-iter (ms)' come from two",
        "  instrumented passes (utils/timing.py collect_phases, per-phase minimum, the",
        "  measured cost of a synchronise subtracted once a synchronise). Rows with",
        "  >= 100 iterations also measure the MARGINAL per-iteration time (a rerun at",
        "  iters // 3, differenced); per-iter and %roofline use it when the train phase",
        "  is >= 0.2 s and the slope explains at least half of it.",
        "- '%roofline' is the floor of the same work on every route over the measured",
        "  train wall (recsys_tpu_torch/bench/roofline.py): an iteration is 6·k FLOP a",
        "  rating and moves A's ratings once (value + int32 column) and L and R each",
        "  read and written once; the floor is max(FLOP over the dtype's peak, bytes",
        "  over HBM) at the H100 SXM data sheet's peaks (67 TFLOP/s f32, 989 bf16, 34",
        "  f64; 3.35 TB/s; a 4 GiB copy_ measured "
        f"{MEASURED_HBM_GBPS:g} GB/s on the card), named 'operations' or",
        "  'bytes' by whichever binds. f32x3 is priced as float32 work. Host-routed",
        "  rows have no model. A '~' marks a share",
        f"  clamped to 100 because its train phase sat below {TRAIN_RESOLUTION_S:g} s.",
        f"- bfloat16 policy: rows must reach {100 * BF16_MIN_AGREEMENT:.0f}% argmax agreement with the",
        "  exact-f64 golden; rows marked BELOW-FLOOR (or without a golden) fail",
        "  the floor and are excluded from headline claims. The port's `--strict`",
        "  follows these rows (recsys_tpu_torch/bench/bf16_policy.py).",
        "- 'device peak' is torch.cuda.max_memory_allocated over one instrumented pass,",
        "  its counter reset just before and what was allocated then subtracted: each",
        "  row's own peak, not the process's (cuBLAS's 32 MiB workspace counts in the",
        "  first row of a process that calls a matmul, and in no later one).",
        "- `gen-*` rows are scale-equivalent regenerations of instances whose `.in`",
        "  blobs are missing upstream (tests/fixtures/README.md), built in memory from",
        "  GEN_SPECS; gen-instML1M is compared against instML1M's published numbers.",
        "- inst200-10000's golden ends in an empty line after its 200 users: a correct",
        "  output reads 200/201 = 99.50% there, never 'exact'.",
        "- Scaling (the port's exchange volume, projected NVLink efficiency, shards",
        "  sharing one card): spliced in below from docs/SCALING_TORCH.md (regenerate",
        "  with `python -m recsys_tpu_torch.bench.scaling --all`).",
        "",
    ]
    return "\n".join(lines)


def latest_rows(rows: list[dict]) -> list[dict]:
    """The newest row per (instance, dtype): refreshed runs append.  A CPU
    row never displaces a card row; it renders only as the sole
    measurement, labeled via the path column."""
    latest: dict = {}
    for r in rows:
        key = (r["instance"], r["dtype"])
        cur = latest.get(key)
        if cur is not None and r.get("backend") == "cpu" and cur.get("backend") != "cpu":
            continue
        latest[key] = r
    return list(latest.values())


def _recompute_roofline(rows: list[dict]) -> None:
    """Refresh each row's %roofline with the CURRENT cost model at render
    time, from the row's own dims (the model needs its users, items, k,
    nnz and rated rows alone).  CPU rows get no share: the peaks are the
    card's."""
    from types import SimpleNamespace

    from recsys_tpu_torch.bench.roofline import pct_of_roofline

    for r in rows:
        if r.get("backend") == "cpu":
            r["roofline_model"], r["pct_roofline"] = None, None
            continue
        dims = SimpleNamespace(iters=r["iters"], features=r["k"], users=r["users"], items=r["items"], nnz=r["nnz"],
                               rated_users=r["rated_users"], rated_items=r["rated_items"])
        r["roofline_model"], r["pct_roofline"] = pct_of_roofline(dims, run_config(r["dtype"]), r["path"],
                                                                 effective_train_s(r))
        _clamp_sub_resolution_pct(r)


def _clamp_sub_resolution_pct(r: dict) -> None:
    pct = r.get("pct_roofline")
    if pct is not None and pct > 100 and (effective_train_s(r) or 1.0) < TRAIN_RESOLUTION_S:
        r["pct_roofline"] = 100.0
        r["roofline_model"] = "~" + (r.get("roofline_model") or "")


def _f64_feasible(name: str, spec, device) -> bool:
    """f64 rows run wherever both factor tables (and the un-permute's
    copy) fit half of the device's memory (the host's RAM on the CPU), and
    a dense-route f64 instance within the dense route's budget of A and M
    (``trainer.DENSE_BUDGET_BYTES``)."""
    import torch

    from recsys_tpu_torch.engine import trainer

    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[1] // 2
    else:
        budget = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    factor_bytes = 2 * 2 * (spec.users + spec.items) * spec.features * 8
    if factor_bytes > budget:
        print(f"skip {name}: f64 factor tables exceed the device's budget", file=sys.stderr)
        return False
    if trainer.choose_path(spec, run_config("float64"), device) != "dense":
        return True
    ok = 2 * spec.users * spec.items * 8 <= trainer.DENSE_BUDGET_BYTES
    if not ok:
        print(f"skip {name}: dense-route f64 above {trainer.DENSE_BUDGET_BYTES:,} bytes of A and M", file=sys.stderr)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(prog="recsys-tpu-torch-sweep")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16", "f32x3"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu only on request)")
    ap.add_argument("--out", default=None, help="write a markdown table here")
    ap.add_argument("--jsonl", default=None, help="append JSONL rows here")
    ap.add_argument("--instances", default=None, help="comma-separated subset")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--render", default=None, help="render this JSONL to --out and exit")
    args = ap.parse_args(argv)

    if args.render:
        with open(args.render) as f:
            rows = latest_rows([json.loads(line) for line in f if line.strip()])
        _recompute_roofline(rows)
        md = format_markdown(rows)
        # The port's scaling section, regenerated by bench.scaling.
        scaling_md = os.path.join(_repo_dir(), "docs", "SCALING_TORCH.md")
        if os.path.exists(scaling_md):
            with open(scaling_md) as f:
                md += "\n" + f.read()
        if args.out:
            with open(args.out, "w") as f:
                f.write(md)
        else:
            print(md)
        return 0

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but torch.cuda.is_available() is False (pass --device cpu to sweep the CPU)",
              file=sys.stderr)
        return 2
    fixture_dir = _fixture_dir()
    names = args.instances.split(",") if args.instances else DEFAULT_INSTANCES
    rows = []
    for name in names:
        try:
            spec = load_instance(name, fixture_dir)
        except FileNotFoundError:
            print(f"skip {name}: no .in fixture", file=sys.stderr)
            continue
        if args.dtype == "float64" and not _f64_feasible(name, spec, device):
            continue
        try:
            r = run_instance(name, args.dtype, args.repeats, device, fixture_dir, spec=spec)
        except Exception as e:  # noqa: BLE001 - the sweep reports a failed instance and goes on
            print(f"FAIL {name} {args.dtype}: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            continue
        finally:
            # Collect dead device buffers between instances: a whole sweep
            # in one process must not carry an earlier instance's tables.
            del spec
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        rows.append(r)
        print(json.dumps(r), flush=True)
        if args.jsonl:
            with open(args.jsonl, "a") as f:
                f.write(json.dumps(r) + "\n")
    if args.out:
        with open(args.out, "w") as f:
            f.write(format_markdown(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
