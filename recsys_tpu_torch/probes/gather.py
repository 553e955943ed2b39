"""The H100 counterpart of the TPU probe P1 (``scripts/probe_gather.py``):
the throughput of an in-kernel gather along a row and of a scan along a
row, the substrate a resident sparse kernel would be built on.

    python -m recsys_tpu_torch.probes.gather

Run from the root of a checkout on a machine with a CUDA card.  First the
script's correctness checks: T = 2 steps of the gather at (8, 512) with
full-width indices, then with one index row broadcast over the rows, each
expecting 1.5 * g and equal to the twin bit for bit; and the scan against
its twin within ``testing.LANE_CUMSUM_RTOL``, with its control rejected.
Then each kernel at the script's shapes with T = 512 steps, its device
time by ``torch.profiler`` beside its twin's and the library loop's (the
same T steps around ``torch.gather(tab, 1, idx)`` or
``torch.cumsum(x, 1)``), in G elem/s of S * W * T, and its time at T = 128
and at T = 0 for the T-scaling (4x the steps must take about 4x the time,
or the compiler hoisted the loop-invariant body; T = 0 is the launch and
the row's load alone).  The three step counts are launched in turn in one
profile and each read as a median (``interleaved_ms``).
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
from recsys_tpu_torch.utils.timing import device_ms

T = 512
T_SHORT = 128
GATHER_SHAPES = ((8, 2048), (8, 8192), (24, 8192), (8, 32768))
CUMSUM_SHAPES = ((8, 8192), (24, 8192), (8, 32768))
CHECK_SHAPE = (8, 512)


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
    errs = {"lane_gather": 0.0}
    for name, ix in (("full-width idx", idx), ("broadcast idx", idx[:1].expand_as(idx).contiguous())):
        out = lane.lane_gather_loop(tab, ix, 2)
        twin = lane.lane_gather_loop_plain(tab, ix, 2)
        expect = 1.5 * torch.take_along_dim(tab, ix.long(), dim=1)
        ok = bool(torch.allclose(out, expect, rtol=1e-6)) and torch.equal(out, twin)
        errs["lane_gather"] = max(errs["lane_gather"], float((out - twin).abs().max()))
        print(f"[probe] P1 gather correctness ({name}, W={CHECK_SHAPE[1]}): 1.5*g {ok}", flush=True)
        if not ok:
            raise AssertionError(f"lane_gather_loop {name}: not 1.5*g or not its twin bit for bit")
    x = torch.from_numpy(rng.standard_normal(CHECK_SHAPE).astype(np.float32)).to(device)
    errs["lane_cumsum"] = scan_reading(x, 2)[0]
    return errs


def scan_reading(x, t: int) -> tuple[float, float, float]:
    """(max abs error, rel, control rel) of ``lane_cumsum_loop`` against its
    twin after ``t`` steps; raises if rel exceeds ``LANE_CUMSUM_RTOL`` or the
    control does not."""
    out = lane.lane_cumsum_loop(x, t)
    twin = lane.lane_cumsum_loop_plain(x, t)
    scale = float(twin.abs().max())
    err = float((out - twin).abs().max())
    rel = err / scale
    ctrl = float((checks.lane_cumsum_dropped(x) - twin).abs().max()) / scale
    print(f"[probe] P1 cumsum {tuple(x.shape)} t={t}: max_abs_err={err!r} rel={rel!r} "
          f"(limit {checks.LANE_CUMSUM_RTOL}); control (one element left out) rel={ctrl!r}", flush=True)
    if not rel <= checks.LANE_CUMSUM_RTOL or not ctrl > checks.LANE_CUMSUM_RTOL:
        raise AssertionError(f"lane_cumsum_loop {tuple(x.shape)}: rel {rel}, control {ctrl}")
    return err, rel, ctrl


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


def interleaved_ms(launch, steps, name: str, rounds: int = 30, warm_ms: float = 20.0) -> dict:
    """The median device ms of one ``launch(t)`` for each t in ``steps``,
    from ``torch.profiler``'s events of the kernels whose name holds
    ``name``.  The step counts take turns, ``rounds`` times, behind about
    ``warm_ms`` of ``launch(steps[0])`` in the same profile: the card's
    clock changes between idle and busy, and this way every step count
    meets it in the same state."""
    cuda = torch.autograd.DeviceType.CUDA
    t0 = time.perf_counter()
    launch(steps[0])
    torch.cuda.synchronize()
    warm = max(3, int(warm_ms / ((time.perf_counter() - t0) * 1e3)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(warm):
            launch(steps[0])
        for _ in range(rounds):
            for t in steps:
                launch(t)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == cuda and name in e.name),
                    key=lambda e: e.time_range.start)
    # The profiler may miss the first launch or two of a window: they are
    # warm-up ones, and the measured launches are the last of the list.
    n = rounds * len(steps)
    if not n < len(events) <= warm + n:
        raise RuntimeError(f"the profiler saw {len(events)} launches of {name}, not {warm + n}")
    us = [e.time_range.elapsed_us() for e in events[-n:]]
    return {t: statistics.median(us[j :: len(steps)]) / 1e3 for j, t in enumerate(steps)}


def time_kernels(device) -> list[dict]:
    """Each kernel at the script's shapes: device ms of the kernel at T,
    T_SHORT and 0 (``interleaved_ms``), the twin and the library loop at
    T, and G elem/s."""
    rng = np.random.default_rng(0)
    rows = []
    for kind, shapes in (("gather", GATHER_SHAPES), ("cumsum", CUMSUM_SHAPES)):
        for S, W in shapes:
            if kind == "gather":
                args = gather_inputs(S, W, device, rng)
                kern, twin, lib, name = lane.lane_gather_loop, lane.lane_gather_loop_plain, _library_gather, "gather_loop"
            else:
                args = (torch.from_numpy(rng.standard_normal((S, W)).astype(np.float32)).to(device),)
                kern, twin, lib, name = lane.lane_cumsum_loop, lane.lane_cumsum_loop_plain, _library_cumsum, "cumsum_loop"
            got = interleaved_ms(lambda t: kern(*args, t), (T, T_SHORT, 0), name)
            ms, ms_short, ms_zero = got[T], got[T_SHORT], got[0]
            row = {"kind": kind, "S": S, "W": W, "ms": ms, "ms_short": ms_short, "ms_zero": ms_zero,
                   "scaling": ms / ms_short, "scaling_net": (ms - ms_zero) / (ms_short - ms_zero),
                   "plain_ms": device_ms(lambda: twin(*args, T), 1),
                   "library_ms": device_ms(lambda: lib(*args, T), 1),
                   "gelem_s": S * W * T / (ms * 1e-3) / 1e9}
            print(f"[probe] P1 {kind} (S={S}, W={W}): {ms!r} ms for {T} steps -> {row['gelem_s']!r} G elem/s; "
                  f"T={T_SHORT}: {ms_short!r} ms (x{row['scaling']!r}); T=0: {ms_zero!r} ms (net of it "
                  f"x{row['scaling_net']!r}); twin {row['plain_ms']!r} ms, "
                  f"library loop {row['library_ms']!r} ms", flush=True)
            rows.append(row)
    return rows


def run(device) -> tuple[dict, list[dict]]:
    """The checks, then the timings; returns ({kernel: max abs error
    against its twin}, the timing rows)."""
    return check(device), time_kernels(device)


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
