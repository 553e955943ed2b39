"""Start and run the ranks of a multi-process run (``parallel/multihost.py``)
on one machine: the launcher the tests and ``chip_smoke.py`` use.

    python -P -m recsys_tpu_torch.parallel.launch --coordinator HOST:PORT --ranks N --rank R \\
        [--device cuda:{rank}] [--backend gloo] [--reps 20] --cases JSON

runs one rank: ``multihost.initialize``, then for each case (``{"name",
"input": a .in path, or "gen": generate_instance's arguments, "dtype",
"path", "mesh": [R, C], "golden": a .out path or null}``) ``multihost``'s
factorize and recommend, and prints one ``RANK <json>`` line: the output's
match with the golden, sha256 of the whole factors' raw bytes
(``testing.factor_digest``) and of the output text, the launches of the
sharded kernels in that run, its wall and ``train`` seconds and, on a
card, one step split by CUDA events into the shards' kernels, the
exchange of partials and the rest (adds, updates, host work).  A rank
that imported jax or the JAX package fails.  ``spawn`` starts N such
ranks on a free port of 127.0.0.1 and returns their outputs; a rank that
fails ends the others.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Launch counters of the kernels on the multi-process path.
KERNELS = ("tiled_deltas", "bell_side_delta")


def free_port() -> int:
    """A TCP port of 127.0.0.1 free a moment ago (bound to port 0 and closed)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(ranks: int, args: list[str], timeout: float) -> list[tuple[int, str, str]]:
    """Run ``ranks`` processes of this module (``--rank`` 0..ranks-1, the
    rest of the command line ``args``) with the repository on their path;
    returns each rank's (exit code, stdout, stderr).  The first rank to
    fail ends the others; past ``timeout`` seconds all are ended and
    TimeoutError raised.  ``OMP_NUM_THREADS`` defaults to 1 a rank."""
    cmd = [sys.executable, "-P", "-m", "recsys_tpu_torch.parallel.launch",
           "--coordinator", f"127.0.0.1:{free_port()}", "--ranks", str(ranks), *args]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    # One host thread a rank unless the caller says otherwise (as torchrun
    # does): ranks spinning on every core each starve the others.
    env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(os.path.join(tmp, f"{r}.out"), "w+"), open(os.path.join(tmp, f"{r}.err"), "w+"))
                for r in range(ranks)]
        procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=out, stderr=err, env=env, cwd=ROOT)
                 for r, (out, err) in enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{ranks} ranks still running after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            results = []
            for p, (out, err) in zip(procs, logs):
                out.seek(0)
                err.seek(0)
                results.append((p.returncode, out.read(), err.read()))
                out.close()
                err.close()
    return results


def rank_lines(results: list[tuple[int, str, str]]) -> list[list[dict]]:
    """Each rank's ``RANK`` lines, parsed; raises if a rank failed."""
    out = []
    for r, (rc, stdout, stderr) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"rank {r} exited with {rc}:\n{stderr[-4000:]}")
        out.append([json.loads(line[5:]) for line in stdout.splitlines() if line.startswith("RANK ")])
    return out


def case_spec(case: dict):
    """The case's ProblemSpec: its ``input`` file or ``gen``'s instance."""
    if case.get("input"):
        from recsys_tpu_torch.io.parser import load_problem

        return load_problem(case["input"])
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(*case["gen"][:5], iters=case["gen"][5], alpha=case["gen"][6], seed=case["gen"][7])


def case_config(case: dict):
    from recsys_tpu_torch.config import RunConfig

    precision = "highest" if case["dtype"] == "float32" else "auto"
    return RunConfig(dtype=case["dtype"], path=case.get("path", "auto"), precision=precision,
                     mesh_shape=tuple(case["mesh"]))


def run_case(case: dict, device, reps: int = 0) -> dict:
    """One case through ``multihost``'s factorize and recommend on this
    rank, with the launch counts set to 0 just before and read just after;
    then, on a card with ``reps`` > 0, ``step_split``.  Returns the case's
    line."""
    import hashlib

    import torch

    from recsys_tpu_torch.io.writers import format_recommendations
    from recsys_tpu_torch.ops import bell, dense_tiled
    from recsys_tpu_torch.parallel import engine as par
    from recsys_tpu_torch.parallel import multihost
    from recsys_tpu_torch.testing import factor_digest
    from recsys_tpu_torch.utils.timing import collect_phases, phase

    counters = {"tiled_deltas": dense_tiled.tiled_deltas, "bell_side_delta": bell.bell_side_delta}
    spec, cfg = case_spec(case), case_config(case)
    mesh = multihost.world_mesh(spec, cfg, device)
    for fn in counters.values():
        fn.launches = 0
    ph = {}
    t0 = time.perf_counter()
    with collect_phases(ph):
        state, mesh = multihost.factorize_multihost(spec, cfg, mesh=mesh)
        with phase("top1"):
            top1 = multihost.recommend_multihost(state, spec, mesh)
    text = format_recommendations(top1, spec.rated_counts(), spec.items)
    wall = time.perf_counter() - t0
    line = {"case": case["name"], "rank": mesh.rank, "owners": mesh.owners,
            "route": par.sharded_route(spec, cfg, mesh), "launches": {k: fn.launches for k, fn in counters.items()},
            "golden": None, "factors_sha256": factor_digest(state),
            "text_sha256": hashlib.sha256(text.encode()).hexdigest(), "wall_s": wall, "train_s": ph["train"]}
    if case.get("golden"):
        with open(case["golden"]) as fh:
            line["golden"] = text == fh.read()
    del state
    if reps and torch.device(device).type == "cuda":
        line.update(step_split(spec, cfg, mesh, reps))
    return line


def step_split(spec, cfg, mesh, reps: int) -> dict:
    """One step of the case's route on this rank, by CUDA events: the whole
    step (mean of ``reps``), this rank's shards' kernels alone (one step's
    partials) and the exchange alone (the gathers of one step's partials
    over the row and column groups); the rest is the adds, the updates and
    the host's work between.  Every rank runs it together (the step and
    the exchange are collective)."""
    from recsys_tpu_torch.ops import dense_tiled
    from recsys_tpu_torch.parallel import engine as par
    from recsys_tpu_torch.parallel import step
    from recsys_tpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    route, a2 = par.sharded_route(spec, cfg, mesh), 2.0 * spec.alpha
    if route == "tiled":
        L, R, A, At = par.tiled_inputs(spec, mesh)

        def train(n):
            step.tiled_train(mesh, L, R, A, At, a2, n)

        def partials():
            dL, dR = step._grid(mesh)
            for ub, ib, _ in mesh.shards():
                dL[ub][ib], dR[ib][ub] = dense_tiled.tiled_deltas(L[ub][ib], R[ib][ub], A[ub][ib], At=At[ub][ib])
            return dL, dR
    elif route == "bell":
        data, L, R, tables = par.bell_inputs(spec, cfg, mesh)
        m = data.meta
        preps = step.bell_preps(mesh, tables, m)

        def train(n):
            step.bell_train(mesh, L, R, tables, a2, n, m)

        def partials():
            return step.bell_partials(mesh, L, R, tables, a2, m, preps)
    else:
        return {}
    dL, dR = partials()

    def exchange():
        for axis, parts in ((AXIS_USERS, dL), (AXIS_ITEMS, dR)):
            for b, block in enumerate(parts):
                if any(p is not None for p in block):
                    step._gathered(block, mesh, axis, b)

    step_ms = cuda_event_ms(lambda: train(reps)) / reps
    kernels_ms = cuda_event_ms(partials, reps)
    exchange_ms = cuda_event_ms(exchange, reps)
    return {"step_ms": step_ms, "kernels_ms": kernels_ms, "exchange_ms": exchange_ms,
            "rest_ms": step_ms - kernels_ms - exchange_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="recsys_tpu_torch.parallel.launch")
    ap.add_argument("--coordinator", required=True, help="host:port of rank 0")
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", default="cuda:{rank}", help="this rank's device ({rank} is replaced)")
    ap.add_argument("--backend", default=None, help="nccl (default on CUDA) or gloo")
    ap.add_argument("--reps", type=int, default=0, help="steps of the step split on a card (0: none)")
    ap.add_argument("--cases", required=True, help="JSON list of cases")
    args = ap.parse_args(argv)

    import torch

    from recsys_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device.format(rank=args.rank))
    multihost.initialize(args.coordinator, args.ranks, args.rank, args.backend, device=device)
    try:
        for case in json.loads(args.cases):
            print("RANK " + json.dumps(run_case(case, device, args.reps)), flush=True)
    finally:
        multihost.shutdown()
    check_no_jax()
    return 0


def check_no_jax() -> None:
    """Raise if this process imported jax or the JAX package."""
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "recsys_tpu"))
    if leaked:
        raise RuntimeError(f"jax or the JAX package was imported: {leaked[:5]}")


if __name__ == "__main__":
    sys.exit(main())
