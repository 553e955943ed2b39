"""Runs one cell of the benchmark of ``recsys_tpu_torch``.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.  A
job is the port's CLI ``run`` path in process (``cli.main(["run", <file>,
"--device", "cuda", ...])``, stdout captured), so each job parses the file
again and carries no state over.  One client submits jobs back to back.

* Set-up: the kernels built or loaded (``build/recsys_tpu_torch/``), the
  cell's data made from ``--seed``, its ``.in`` file written once under
  ``TMPDIR``, one warm job.  The card's memory peak is reset after it.
* Window: jobs until ``--seconds`` have passed; the last one to start
  finishes.  With ``--trace 1`` each job also collects the engine's phases,
  and after the window a few more jobs run under ``torch.profiler``.
* Check: once the window has closed and the device memory peak is read,
  the trained factors of a seeded reservoir sample of the window's jobs
  and of its last job (``taps/``) and every
  distinct printed list are judged against the plain reference
  (``reference.py``, ``judge.py``) and the cell's limits.  The factors
  stay on the card where the taps left them and are judged there, a
  block of rows at a time, against the reference's, made on the card.

The last stdout line is the result's JSON object; the last stderr lines
are the numbers compared, each with its limit.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "recsys_tpu")
SAMPLED_JOBS = 4  # jobs of the window whose trained factors are judged, besides the last
PROFILED_JOBS = 3  # jobs run under torch.profiler after a traced window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def cache_env(root: str) -> None:
    """Every kernel cache the program or torch might write, at fixed paths
    inside the checkout (the port's own kernels build into
    ``build/recsys_tpu_torch/`` by themselves)."""
    base = os.path.join(root, "build", "perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = os.path.join(base, sub)


def job_argv(path: str, traffic: dict, device: str) -> list[str]:
    return ["run", path, "--device", device, "--dtype", traffic["dtype"], "--precision", traffic["precision"],
            "--path", traffic["path"], "--no-time"]


def run_job(cli, argv, sink, slot: int | None, phases: bool, label: str | None) -> dict:
    """One job: its wall, whether it succeeded, its stdout, and with
    ``phases`` the engine's phase seconds; its factors go to the sink's
    ``slot`` (None: not kept)."""
    import torch

    from recsys_tpu_torch.utils.timing import collect_phases

    sink.begin(slot)
    buf, ph, err, rc = io.StringIO(), ({} if phases else None), None, None
    span = torch.profiler.record_function(label) if label else contextlib.nullcontext()
    collect = collect_phases(ph) if phases else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with span, collect, contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    except Exception as e:  # noqa: BLE001 -- a job that raises is a failed job
        err = f"{type(e).__name__}: {e}"
    wall = time.perf_counter() - t0
    sink.end()
    return {"wall": wall, "ok": rc == 0 and err is None, "phases": ph, "out": buf.getvalue(),
            "err": err if err else (None if rc == 0 else f"exit {rc}")}


def reservoir_slot(i: int, size: int, rng) -> int | None:
    """Reservoir sampling: the slot job ``i`` takes (None: not kept), so
    that ``size`` jobs drawn evenly from the whole window, however many it
    holds, are kept when it closes."""
    if i < size:
        return i
    j = int(rng.integers(0, i + 1))
    return j if j < size else None


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def instance_facts(inst) -> dict:
    from perfbench import roofline

    ru, ri = roofline.rated_rows(inst.rows, inst.cols, inst.users, inst.items)
    return {"users": inst.users, "items": inst.items, "features": inst.features, "iters": inst.iters,
            "nnz": inst.nnz, "rated_users": ru, "rated_items": ri}


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", root: str | None = None,
             t0: float = _T0) -> dict:
    """Set-up, window and check of one cell; returns the result object."""
    import torch

    from perfbench import datagen, judge, reference, registry
    from perfbench import trace as tracing
    from perfbench.taps import Sink, install_all
    from recsys_tpu_torch import cli

    root = root or registry.ROOT
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    limits = judge.load_limits(root, cell.name)
    marks = {"imports": time.perf_counter()}
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    marks["context"] = time.perf_counter()
    inst = datagen.make(cell.config, seed, root, device)
    marks["data"] = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".in", prefix=f"perfbench_{cell.name}_")
    undo = []
    try:
        with os.fdopen(fd, "w") as f:
            f.write(datagen.format_in(inst))
        marks["file"] = time.perf_counter()
        argv = job_argv(path, cell.traffic, device)
        sink = Sink()
        undo = install_all(sink)
        warm = run_job(cli, argv, sink, None, False, None)
        if not warm["ok"]:
            raise RuntimeError(f"the warm job failed: {warm['err']}")
        setup_s = time.perf_counter() - t0
        marks["warm job"] = t0 + setup_s
        prev, parts = t0, []
        for name, t in marks.items():
            parts.append(f"{name} {t - prev:.3f}")
            prev = t
        log(f"setup_s {setup_s!r}: " + ", ".join(parts))

        if on_card:
            torch.cuda.reset_peak_memory_stats()  # the peak of the window's jobs, not of the set-up's data
        rng = datagen.rng_for(seed, 1)
        jobs, start = [], time.perf_counter()
        while time.perf_counter() - start < seconds:
            i = len(jobs)
            slot = reservoir_slot(i, SAMPLED_JOBS, rng)
            jobs.append(run_job(cli, argv, sink, slot, trace, f"job {i}" if trace else None))
        window_s = time.perf_counter() - start
        walls = sorted(j["wall"] for j in jobs)
        log(f"jobs: {len(walls)}, wall min {walls[0]!r} median {walls[len(walls) // 2]!r} max {walls[-1]!r} s")

        timeline, n_window = None, len(jobs)
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            events = []
            with torch.profiler.profile(activities=acts) as prof, tracing.phase_spans():
                for _ in range(PROFILED_JOBS):
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
                    if ev:
                        ev[0].record()
                    jobs.append(run_job(cli, argv, sink, None, False, f"job {len(jobs)}"))
                    if ev:
                        ev[1].record()
                        events.append(ev)
                sync()
            event_s = sum(a.elapsed_time(b) for a, b in events) * 1e-3 if events else None
            timeline = tracing.read_timeline(tracing.export_events(prof))
            del prof
            if timeline:
                log(f"profile: {timeline['ops']} device ops summing {timeline['op_s']!r} s, busy {timeline['busy_s']!r} s "
                    f"of {timeline['window_s']!r} s over {PROFILED_JOBS} jobs; CUDA events over the same jobs {event_s!r} s")
                log("profile: idle seconds by host span " + json.dumps(timeline["idle_by_span"]))

        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        outputs = sorted({j["out"] for j in jobs if j["ok"]})
        failed = [j for j in jobs if not j["ok"]]
        for j in failed[:3]:
            log(f"failed job: {j['err']}")
        if sink.misses:
            log(f"taps: {sink.misses} job(s) handed no factors to the harness")
        captures = sink.captures()
        log(f"check: factors of {len(captures)} job(s), {len(outputs)} distinct list(s) of {len(jobs)} job(s)")
        for u in undo:
            u()
        undo = []
        del sink
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        t_ref = time.perf_counter()
        L, R = reference.solve(inst, device=device, dtype=torch.float64)
        B = reference.scores(L, R, inst)
        sync()
        t_judge = time.perf_counter()
        values = {"factor_gap": judge.factor_gap(captures, (L, R), inst), "top1_gap": judge.top1_gap(outputs, B, inst),
                  "failed_jobs": float(len(failed))}
        del L, R, B, captures
        log(f"reference_s {t_judge - t_ref!r}, judge_s {time.perf_counter() - t_judge!r} (not in setup_s); "
            f"host RSS peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B")
        ok, checked = judge.checks(values, limits)
    finally:
        for u in undo:
            u()
        os.remove(path)

    window_jobs = jobs[:n_window]
    readings = {"setup_s": setup_s, "window_s": window_s, "jobs": window_jobs, "dtype": cell.traffic["dtype"],
                "instance": instance_facts(inst), "trace": timeline}
    metrics = registry.read_metrics(cell.per_layer if trace else cell.end_to_end, readings, root)
    if trace:
        from perfbench import roofline

        i = readings["instance"]
        _, by = roofline.floor_seconds(*roofline.iteration_work(i["nnz"], i["features"], i["rated_users"],
                                                                i["rated_items"], cell.traffic["dtype"]),
                                       cell.traffic["dtype"])
        log(f"train_roofline: the floor is bound by {by}")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(ok and window_jobs), "attempted": len(window_jobs),
              "failed": sum(1 for j in window_jobs if not j["ok"]), "metrics": metrics, "device": dev}
    if trace and timeline:
        dev["busy_s"], dev["window_s"] = timeline["busy_s"], timeline["window_s"]
        result["breakdown"] = {"device_ops": timeline["device_ops"], "idle_gaps": timeline["idle_gaps"]}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]} for k, v in checked.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import registry

    cache_env(registry.ROOT)
    try:
        cell = registry.cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"error: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"error: the cell needs {cell.chips} CUDA card(s); this machine has {n}")
        return 3
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except Exception:  # noqa: BLE001 -- no result line for a run that could not finish
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        log(f"error: the process loaded {', '.join(found)}")
        return 5
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
