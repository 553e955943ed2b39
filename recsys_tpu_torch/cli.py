"""Command-line interface of the port (the ``run`` subcommand of
``recsys_tpu/cli.py``, :47-236):

    python -m recsys_tpu_torch.cli run <file.in> [--device cuda] [--dtype ...] [--precision ...]
    python -m recsys_tpu_torch.cli run <file.in> --checkpoint ck.npz [--checkpoint-every 500]

It prints the reference binaries' stdout contract: one top-1 item index
per user, then ``time : <seconds>`` (``matFact.c:127,134``).  Flags keep
the JAX CLI's names.  ``--checkpoint`` trains in chunks of
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
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="recsys-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="factorize + print top-1 recommendations")
    p.add_argument("input", help="path to .in instance file")
    p.add_argument("-v", "--verbose", action="store_true", help="print dataset/config info to stderr")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--dtype", default=None, help="float32|float64|bfloat16 (default: f32 on cuda, f64 on cpu)")
    p.add_argument("--path", default="auto", choices=["auto", "dense", "bell", "coo", "pallas"])
    p.add_argument("--precision", default="auto", choices=["auto", "highest", "bf16x3", "default"])
    p.add_argument("--mesh", default=None, help="RxC mesh of shards, all on --device")
    p.add_argument("--block-items", type=int, default=4096, help="item-block size of recommend()'s top-1 (--checkpoint)")
    p.add_argument("--no-time", action="store_true", help="suppress the trailing time line")
    p.add_argument("--strict", action="store_true", help="refuse bfloat16 (the port has no measured bf16 policy)")
    p.add_argument("--checkpoint", metavar="PATH", default=None, help="snapshot/resume file")
    p.add_argument("--checkpoint-every", type=int, default=500, metavar="N", help="iterations between snapshots")
    p.add_argument("--profile", metavar="DIR", default=None, help="write a torch.profiler chrome trace here")
    args = ap.parse_args(argv)

    import torch

    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.utils.timing import Timer

    device = torch.device(args.device)
    if args.dtype is None:
        args.dtype = "float64" if device.type == "cpu" else "float32"
    mesh_shape = None
    if args.mesh:
        if args.checkpoint:
            print("error: --mesh with --checkpoint is refused: the checkpointed route trains on one device",
                  file=sys.stderr)
            return 2
        r, c = args.mesh.lower().split("x")
        mesh_shape = (int(r), int(c))
    cfg = RunConfig(dtype=args.dtype, path=args.path, mesh_shape=mesh_shape, precision=args.precision,
                    block_items=args.block_items)
    if cfg.dtype == "bfloat16":
        print("warning: bfloat16 is a lossy speed mode judged by argmax agreement "
              "(floor 98%); --dtype float32 --precision bf16x3 is the accurate fast tier",
              file=sys.stderr)
        if args.strict:
            print("error: refusing bfloat16 under --strict", file=sys.stderr)
            return 2

    prof = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    with prof, Timer() as t:
        spec = load_problem(args.input)
        if args.verbose:
            print(
                f"dataset: {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} "
                f"iters={spec.iters} alpha={spec.alpha} | dtype={cfg.dtype} "
                f"path={trainer.choose_path(spec, cfg, device)} device={device}",
                file=sys.stderr,
            )
        if args.checkpoint:
            from recsys_tpu_torch.io.writers import format_recommendations
            from recsys_tpu_torch.utils.checkpoint import run_with_checkpoints

            state = run_with_checkpoints(spec, cfg, args.checkpoint, args.checkpoint_every, device)
            top1 = trainer.recommend(state, spec, cfg, device)
            out = format_recommendations(top1, spec.rated_counts(), spec.items)
        else:
            out, _ = trainer.run(spec, cfg, device)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    sys.stdout.write(out)
    if not args.no_time:
        print(t.line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
