"""Command-line interface of the port (``recsys_tpu/cli.py``):

    python -m recsys_tpu_torch.cli run <file.in> [--device cuda] [--dtype ...] [--precision ...]
    python -m recsys_tpu_torch.cli run <file.in> --checkpoint ck.npz [--checkpoint-every 500]
    python -m recsys_tpu_torch.cli oracle <file.in> [--no-time] [--dump-mats PATH --record N]
    python -m recsys_tpu_torch.cli bench <file.in> [--repeats N] [the run flags]
    python -m recsys_tpu_torch.cli generate inst<u>-<i>-<k>-<min>-<max> <out.in> [--iters --alpha --seed]

``run`` prints the reference binaries' stdout contract: one top-1 item
index per user, then ``time : <seconds>`` (``matFact.c:127,134``).  Flags
keep the JAX CLI's names.  ``--checkpoint`` trains in chunks of
``--checkpoint-every`` iterations through ``trainer.factorize``, resuming
from the file if it exists, and then runs ``trainer.recommend`` with
``--block-items`` (``recsys_tpu/cli.py:155-163``).  ``--dtype float64``
is the exact mode: on the card it takes the BELL route, whose factors are
the reference binary's bit for bit.  ``--path`` forces a route: ``bell``,
``dense``, ``pallas`` or ``coo`` (the COO step: prefix sums for f32 on the
card, sorted segment sums otherwise).  ``--mesh RxC`` runs the sharded
engine (``parallel/engine.py``) on an R x C mesh whose shards all sit on
``--device``; with ``--checkpoint`` it is refused (the checkpointed route
trains on one device).

``oracle`` runs the numpy f64 engine (``engine/oracle.py``) and prints
the same contract, or with ``--dump-mats`` writes the reference's ``.mats``
dump of the first ``--record`` iterations.  ``bench`` runs once to warm
up, then ``--repeats`` timed runs, and prints one JSON line with the JAX
CLI's keys: ``wall_s`` is the best run, ``path`` the route
(``trainer.choose_path``, or the sharded route under ``--mesh``).
``generate`` writes a seeded instance (``io/generator.py``).
``run --profile DIR`` runs under ``torch.profiler`` and a phase collector
(``utils/timing.py``) and writes two files to DIR: ``trace.json``, the
Chrome trace, whose timeline carries the program's ``phase:<name>``
ranges (the engine's phases and the spans inside them: ``parse``,
``plan``, ``upload``'s ``densify``, ``h2d`` and ``walk``, ``format``, ...),
and ``spans.json``, the job's record: its phases, its spans with their
parents and their times since the job began, and its counts
(``h2d_bytes``).  bfloat16
goes through one gate in ``run`` and ``bench``, after the instance is
loaded and before training (``bench/bf16_policy.py``, built from the card's
sweep rows): a shape at or above the agreement floor runs with a note; a
shape below it, or with no measured agreement, warns, and under ``--strict``
is refused (exit 2).
The multi-process layer is the library entry ``parallel.multihost.run``,
as in the JAX package: no subcommand reaches it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def _add_common(p) -> None:
    """The flags ``run`` and ``bench`` share."""
    p.add_argument("input", help="path to .in instance file")
    p.add_argument("-v", "--verbose", action="store_true", help="print dataset/config info to stderr")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--dtype", default=None, help="float32|float64|bfloat16 (default: f32 on cuda, f64 on cpu)")
    p.add_argument("--path", default="auto", choices=["auto", "dense", "bell", "coo", "pallas"])
    p.add_argument("--precision", default="auto", choices=["auto", "highest", "bf16x3", "default"])
    p.add_argument("--mesh", default=None, help="RxC mesh of shards, all on --device")
    p.add_argument("--block-items", type=int, default=4096, help="item-block size of recommend()'s top-1 (--checkpoint)")
    p.add_argument("--no-time", action="store_true", help="suppress the trailing time line")
    p.add_argument("--strict", action="store_true",
                   help="refuse bfloat16 on shapes below the measured agreement floor or never measured")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="recsys-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="factorize + print top-1 recommendations")
    _add_common(p)
    p.add_argument("--checkpoint", metavar="PATH", default=None, help="snapshot/resume file")
    p.add_argument("--checkpoint-every", type=int, default=500, metavar="N", help="iterations between snapshots")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler chrome trace (trace.json, with the program's phase: ranges) "
                        "and the job's spans and counts (spans.json) here")

    orc = sub.add_parser("oracle", help="numpy float64 reference engine")
    orc.add_argument("input")
    orc.add_argument("--no-time", action="store_true")
    orc.add_argument("--dump-mats", metavar="PATH", default=None,
                     help="write the .mats debug dump (initial/per-iter/final L,R,B) and exit")
    orc.add_argument("--record", type=int, default=5, help="iterations to record in the dump")

    bench = sub.add_parser("bench", help="timed run, JSON metrics line")
    _add_common(bench)
    bench.add_argument("--repeats", type=int, default=3)

    gen = sub.add_parser("generate", help="generate an instance file")
    gen.add_argument("name", help="inst<users>-<items>-<k>-<minnz>-<maxnz>")
    gen.add_argument("out", help="output .in path")
    gen.add_argument("--iters", type=int, default=100)
    gen.add_argument("--alpha", type=float, default=0.0001)
    gen.add_argument("--seed", type=int, default=42)
    return ap


def _loaded_span(name: str):
    """``utils.timing.span(name)`` once the port's timing module is loaded.
    Until it is, no collector is open and nothing could record, and the
    argument parsing of ``oracle`` and ``generate`` imports no torch."""
    timing = sys.modules.get("recsys_tpu_torch.utils.timing")
    return contextlib.nullcontext() if timing is None else timing.span(name)


def main(argv=None) -> int:
    with _loaded_span("args"):
        args = _parser().parse_args(argv)

    if args.cmd == "generate":
        return _cmd_generate(args)
    if args.cmd == "oracle":
        return _cmd_oracle(args)

    import torch

    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.utils import timing

    device = torch.device(args.device)
    if args.dtype is None:
        args.dtype = "float64" if device.type == "cpu" else "float32"
    mesh_shape = None
    if args.mesh:
        if getattr(args, "checkpoint", None):
            print("error: --mesh with --checkpoint is refused: the checkpointed route trains on one device",
                  file=sys.stderr)
            return 2
        r, c = args.mesh.lower().split("x")
        mesh_shape = (int(r), int(c))
    cfg = RunConfig(dtype=args.dtype, path=args.path, mesh_shape=mesh_shape, precision=args.precision,
                    block_items=args.block_items)

    def banner(spec):
        if args.verbose:
            print(
                f"dataset: {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} "
                f"iters={spec.iters} alpha={spec.alpha} | dtype={cfg.dtype} "
                f"path={_route(spec, cfg, device)} device={device}",
                file=sys.stderr,
            )

    if args.cmd == "bench":
        with timing.span("parse"):
            spec = load_problem(args.input)
        banner(spec)
        if not _bf16_gate(spec, cfg, args):
            return 2
        trainer.run(spec, cfg, device)  # warm-up: builds and loads the kernels
        times = []
        for _ in range(args.repeats):
            with timing.Timer() as t:
                trainer.run(spec, cfg, device)
            times.append(t.seconds)
        best = min(times)
        print(json.dumps({"instance": os.path.basename(args.input), "wall_s": best,
                          "updates_per_s": spec.iters * spec.nnz / best, "dtype": cfg.dtype,
                          "path": _route(spec, cfg, device), "repeats": args.repeats}))
        return 0

    prof = collect = contextlib.nullcontext()
    phases: dict = {}
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        collect = timing.collect_phases(phases)
    with prof, collect, timing.Timer() as t:
        with timing.span("parse"):
            spec = load_problem(args.input)
        banner(spec)
        if not _bf16_gate(spec, cfg, args):
            return 2
        if args.checkpoint:
            from recsys_tpu_torch.utils.checkpoint import run_with_checkpoints

            state = run_with_checkpoints(spec, cfg, args.checkpoint, args.checkpoint_every, device)
            top1 = trainer.recommend(state, spec, cfg, device)
            out = trainer.format_top1(top1, spec)
        else:
            out, _ = trainer.run(spec, cfg, device)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        with open(os.path.join(args.profile, "spans.json"), "w") as f:
            json.dump(timing.record_of(phases).as_dict(), f, indent=1)
    sys.stdout.write(out)
    if not args.no_time:
        print(t.line())
    return 0


def _route(spec, cfg, device) -> str:
    """The route ``run`` takes: ``choose_path``'s, or on a mesh the sharded
    engine's (``tiled``, ``bell``, ``dense``, ``coo_seg``, ``coo``)."""
    from recsys_tpu_torch.engine import trainer

    if cfg.mesh_shape is None:
        return trainer.choose_path(spec, cfg, device)
    from recsys_tpu_torch.parallel import engine as parallel_engine
    from recsys_tpu_torch.parallel.mesh import make_mesh

    return parallel_engine.sharded_route(spec, cfg, make_mesh(spec.users, spec.items, cfg.mesh_shape, device=device))


def _bf16_gate(spec, cfg, args) -> bool:
    """bfloat16 in ``run`` and ``bench`` (JAX ``_bf16_gate``): the card's
    measured agreement for this shape (``bench.bf16_policy.check``); False
    (refused) under ``--strict`` below the floor or on a shape never
    measured."""
    if cfg.dtype != "bfloat16":
        return True
    from recsys_tpu_torch.bench.bf16_policy import check

    if check(spec, strict=args.strict):
        return True
    print("error: refusing bfloat16 under --strict", file=sys.stderr)
    return False


def _cmd_oracle(args) -> int:
    from recsys_tpu_torch.engine.oracle import dump_mats, run_oracle
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.utils.timing import Timer

    if args.dump_mats:
        spec = load_problem(args.input)
        with open(args.dump_mats, "w") as f:
            f.write(dump_mats(spec, record=args.record))
        return 0
    with Timer() as t:
        spec = load_problem(args.input)
        out = run_oracle(spec)
    sys.stdout.write(out)
    if not args.no_time:
        print(t.line())
    return 0


def _cmd_generate(args) -> int:
    from recsys_tpu_torch.io.generator import generate_instance, parse_instance_name
    from recsys_tpu_torch.io.parser import save_problem

    u, i, k, lo, hi = parse_instance_name(args.name)
    spec = generate_instance(u, i, k, lo, hi, iters=args.iters, alpha=args.alpha, seed=args.seed)
    save_problem(spec, args.out)
    print(f"wrote {args.out}: {u}x{i} k={k} nnz={spec.nnz}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
