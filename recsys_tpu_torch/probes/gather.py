"""The H100 counterpart of the TPU probe P1 (``scripts/probe_gather.py``):
the throughput of an in-kernel gather along a row and of a scan along a
row, the substrate a resident sparse kernel would be built on.

    python -m recsys_tpu_torch.probes.gather

Run from the root of a checkout on a machine with a CUDA card.  The
kernels (``KERNELS``) are the ones ``lane_gather_loop`` and
``lane_cumsum_loop`` launch.  First the script's correctness checks: T = 2
steps of the gather at (8, 512) with full-width indices, then with one
index row broadcast over the rows, each expecting 1.5 * g and equal to the
twin bit for bit; and the scan against its twin within
``testing.LANE_CUMSUM_RTOL``, with its control rejected.  Then the bits at
every probe shape (``bits``).  Then each kernel at the script's shapes
with T = 512 steps, at its step counts in turns in one profile
(``interleaved_ms``), each read as a median: its device time by
``torch.profiler`` beside the time of its twin and of the library loop (the
same T steps around ``torch.gather(tab, 1, idx)`` or ``torch.cumsum(x, 1)``)
by CUDA events, in G elem/s of S * W * T, and its time at T = 128 and at
T = 0 for the T-scaling (4x the steps must take about 4x the time, or the
compiler hoisted the loop-invariant body; T = 0 is the launch and the
row's load alone), and at T_LONG = 2048 at the widest shape, where a fast
step would put T = 512 / T = 128 under 4x for its fixed cost alone.  Each
scan shape's line first names the cluster size the plan chose and
``cudaOccupancyMaxActiveClusters`` for it.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import lane
from recsys_tpu_torch.utils.timing import cuda_event_ms

T = 512
T_SHORT = 128
T_LONG = 4 * T
GATHER_SHAPES = ((8, 2048), (8, 8192), (24, 8192), (8, 32768))
CUMSUM_SHAPES = ((8, 8192), (24, 8192), (8, 32768))
CHECK_SHAPE = (8, 512)

# Each kernel: the wrapper's name (the kernels line's), the wrapper and the
# name of its CUDA kernel.
KERNELS = {
    "gather": ("lane_gather", lane.lane_gather_loop, "gather_banked"),
    "cumsum": ("lane_cumsum", lane.lane_cumsum_loop, "cumsum_cluster"),
}


def gather_inputs(S: int, W: int, device, rng):
    """(tab, idx) of the script's draws: N(0, 1) f32 and indices in [0, W)."""
    tab = torch.from_numpy(rng.standard_normal((S, W)).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, W, (S, W)).astype(np.int32)).to(device)
    return tab, idx


def check(device, rng=None) -> dict:
    """The script's correctness checks, the gather against its twin bit for
    bit, and the scan within its limit with the control rejected; returns
    each kernel's max abs error against its twin.  Raises on a failure."""
    rng = rng or np.random.default_rng(0)
    tab, idx = gather_inputs(*CHECK_SHAPE, device, rng)
    name, fn, _ = KERNELS["gather"]
    errs = {name: 0.0}
    for kind, ix in (("full-width idx", idx), ("broadcast idx", idx[:1].expand_as(idx).contiguous())):
        out = fn(tab, ix, 2)
        twin = lane.lane_gather_loop_plain(tab, ix, 2)
        expect = 1.5 * torch.take_along_dim(tab, ix.long(), dim=1)
        ok = bool(torch.allclose(out, expect, rtol=1e-6)) and torch.equal(out, twin)
        errs[name] = max(errs[name], float((out - twin).abs().max()))
        print(f"[probe] P1 {name} correctness ({kind}, W={CHECK_SHAPE[1]}): 1.5*g {ok}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {kind}: not 1.5*g or not its twin bit for bit")
    x = torch.from_numpy(rng.standard_normal(CHECK_SHAPE).astype(np.float32)).to(device)
    errs[KERNELS["cumsum"][0]] = scan_reading(x, 2)[0]
    return errs


def scan_reading(x, t: int) -> tuple[float, float, float]:
    """(max abs error, rel, control rel) of the scan against its twin after
    ``t`` steps; raises if rel exceeds ``LANE_CUMSUM_RTOL`` or the control
    does not."""
    out = lane.lane_cumsum_loop(x, t)
    twin = lane.lane_cumsum_loop_plain(x, t)
    scale = float(twin.abs().max())
    err = float((out - twin).abs().max())
    rel = err / scale
    ctrl = float((checks.lane_cumsum_dropped(x) - twin).abs().max()) / scale
    print(f"[probe] P1 lane_cumsum_loop {tuple(x.shape)} t={t}: max_abs_err={err!r} rel={rel!r} "
          f"(limit {checks.LANE_CUMSUM_RTOL}); control (one element left out) rel={ctrl!r}", flush=True)
    if not rel <= checks.LANE_CUMSUM_RTOL or not ctrl > checks.LANE_CUMSUM_RTOL:
        raise AssertionError(f"lane_cumsum_loop {tuple(x.shape)}: rel {rel}, control {ctrl}")
    return err, rel, ctrl


def bits(device, rng=None) -> dict:
    """Each kernel at every probe shape: the gather equal to its twin bit for
    bit with full-width and broadcast indices at T steps; the scan equal to
    ``lane_cumsum_loop_order_plain`` in raw bits at 2, 5 and T steps, and
    within its limit of the twin at T.  Returns each kernel's max abs error
    against its twin; raises after every check if one failed."""
    rng = rng or np.random.default_rng(1)
    gname, cname = KERNELS["gather"][0], KERNELS["cumsum"][0]
    errs, failed = {gname: 0.0, cname: 0.0}, []
    for S, W in GATHER_SHAPES:
        tab, idx = gather_inputs(S, W, device, rng)
        for name, ix in (("full-width", idx), ("broadcast", idx[:1].expand_as(idx).contiguous())):
            twin = lane.lane_gather_loop_plain(tab, ix, T)
            out = lane.lane_gather_loop(tab, ix, T)
            same = checks.same_bits(out, twin)
            errs[gname] = max(errs[gname], float((out - twin).abs().max()))
            print(f"[kernel] {gname} ({S}, {W}) {name} idx T={T}: = twin bit for bit {same}", flush=True)
            if not same:
                failed.append(f"{gname} ({S}, {W}) {name}")
    for S, W in CUMSUM_SHAPES:
        x = torch.from_numpy(rng.standard_normal((S, W)).astype(np.float32)).to(device)
        for t in (2, 5, T):
            same = checks.same_bits(lane.lane_cumsum_loop(x, t), lane.lane_cumsum_loop_order_plain(x, t))
            print(f"[kernel] {cname} ({S}, {W}) t={t}: = the kernel's order (lane_cumsum_loop_order_plain) in "
                  f"raw bits {same}", flush=True)
            if not same:
                failed.append(f"{cname} ({S}, {W}) t={t}")
        try:
            errs[cname] = max(errs[cname], scan_reading(x, T)[0])
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError(f"P1 bits: {failed}")
    return errs


def _library_gather(tab, idx, t):
    ix = idx.long()
    out = torch.zeros_like(tab)
    for _ in range(t):
        out = out * 0.5 + torch.gather(tab, 1, ix)
    return out


def _library_cumsum(x, t):
    out = torch.zeros_like(x)
    for _ in range(t):
        out = out * 0.0 + torch.cumsum(x, 1)
    return out


def interleaved_ms(calls: dict, rounds: int = 30, warm_ms: float = 20.0, attempts: int = 3) -> dict:
    """The median device ms of one launch of each ``calls[key] = (launch,
    name)``, from ``torch.profiler``'s events of the kernels whose name
    holds ``name``.  The calls take turns, ``rounds`` times, behind about
    ``warm_ms`` of the first call in the same profile: the card's clock
    changes between idle and busy, and this way every call meets it in the
    same state.  Calls of one kernel (say at several step counts) are told
    apart by their order.  Each launch is read as the kernel's own time,
    which CUDA events around a launch of a few µs cannot give.  A profile
    can miss launches (see ``timing.cuda_event_ms``): one that holds each
    kernel's measured launches, and for the first call's kernel more than
    those and no more than the window's, counts; another is made in its
    place, and this raises after ``attempts`` that do not."""
    cuda = torch.autograd.DeviceType.CUDA
    keys = list(calls)
    first_launch, first_name = calls[keys[0]]
    t0 = time.perf_counter()
    first_launch()
    torch.cuda.synchronize()
    warm = max(3, int(warm_ms / ((time.perf_counter() - t0) * 1e3)))
    names = {name for _, name in calls.values()}
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                first_launch()
            for _ in range(rounds):
                for key in keys:
                    calls[key][0]()
            torch.cuda.synchronize()
        got, bad = {}, []
        for name in names:
            mine = [key for key in keys if calls[key][1] == name]
            n = rounds * len(mine)
            events = sorted((e for e in prof.events() if e.device_type == cuda and name in e.name),
                            key=lambda e: e.time_range.start)
            # The profiler may miss the first launch or two of a window: they
            # are warm-up ones, and the measured launches are the last.
            if not (n < len(events) <= warm + n if name == first_name else len(events) == n):
                bad.append(f"{len(events)} launches of {name}, not {n + (warm if name == first_name else 0)}")
                continue
            us = [e.time_range.elapsed_us() for e in events[-n:]]
            got.update({key: statistics.median(us[j :: len(mine)]) / 1e3 for j, key in enumerate(mine)})
        if not bad:
            return got
        print(f"[probe] the profiler saw {'; '.join(bad)}: profiling again", flush=True)
    raise RuntimeError(f"the profiler saw {'; '.join(bad)}, {attempts} times")


def time_kernels(device) -> list[dict]:
    """Each kernel at the script's shapes, its step counts in turns in one
    profile a shape (``interleaved_ms``): device ms at T, T_SHORT and 0
    steps, and at T_LONG at the widest shape; then the twin and the library
    loop at T (CUDA events, one call), and G elem/s.  One row a kernel and
    shape."""
    rng = np.random.default_rng(0)
    rows = []
    for kind, shapes in (("gather", GATHER_SHAPES), ("cumsum", CUMSUM_SHAPES)):
        widest = max(w for _, w in shapes)
        for S, W in shapes:
            if kind == "gather":
                args = gather_inputs(S, W, device, rng)
                twin, lib = lane.lane_gather_loop_plain, _library_gather
            else:
                args = (torch.from_numpy(rng.standard_normal((S, W)).astype(np.float32)).to(device),)
                twin, lib = lane.lane_cumsum_loop_plain, _library_cumsum
                NT, EPT, C = lane.cumsum_cluster_plan(S, W, torch.cuda.get_device_properties(device).multi_processor_count)
                print(f"[probe] P1 cumsum (S={S}, W={W}): clusters of C={C} blocks of {NT // C} threads, "
                      f"{EPT} elements a thread; cudaOccupancyMaxActiveClusters {lane.cumsum_clusters(*args)} "
                      f"(the launch takes {S})", flush=True)
            steps = (T, T_SHORT, 0) + ((T_LONG,) if W == widest else ())
            name, fn, kname = KERNELS[kind]
            got = interleaved_ms({t: ((lambda t=t: fn(*args, t)), kname) for t in steps})
            plain_ms = cuda_event_ms(lambda: twin(*args, T))
            library_ms = cuda_event_ms(lambda: lib(*args, T))
            ms, ms_short, ms_zero, ms_long = got[T], got[T_SHORT], got[0], got.get(T_LONG)
            row = {"kind": kind, "name": name, "S": S, "W": W, "widest": W == widest, "ms": ms,
                   "ms_short": ms_short, "ms_zero": ms_zero, "ms_long": ms_long, "scaling": ms / ms_short,
                   "scaling_net": (ms - ms_zero) / (ms_short - ms_zero),
                   "scaling_long": ms_long / ms if ms_long is not None else None,
                   "plain_ms": plain_ms, "library_ms": library_ms, "gelem_s": S * W * T / (ms * 1e-3) / 1e9}
            long = f"; T={T_LONG}: {ms_long!r} ms (x{row['scaling_long']!r} of T={T})" if ms_long else ""
            print(f"[probe] P1 {name} (S={S}, W={W}): {ms!r} ms for {T} steps -> {row['gelem_s']!r} G elem/s; "
                  f"T={T_SHORT}: {ms_short!r} ms (x{row['scaling']!r}); T=0: {ms_zero!r} ms (net of it "
                  f"x{row['scaling_net']!r}){long}; twin {plain_ms!r} ms, library loop {library_ms!r} ms",
                  flush=True)
            rows.append(row)
    return rows


def run(device) -> tuple[dict, list[dict]]:
    """The checks, the bits at every shape, then the timings; returns
    ({kernel: max abs error against its twin}, the timing rows)."""
    errs = check(device)
    for name, err in bits(device).items():
        errs[name] = max(errs[name], err)
    return errs, time_kernels(device)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gather: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi} | T={T}", flush=True)
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
