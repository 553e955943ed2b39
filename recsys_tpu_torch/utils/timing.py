"""Wall-clock and per-phase timing (port of ``recsys_tpu/utils/timing.py``).

``Timer`` is the reference's ``time : <s>`` line (``benchmark.h:14-23``).
``phase`` times one named stage into an active ``collect_phases`` dict;
the callable it yields synchronises the CUDA device that holds its
argument (a no-op for CPU tensors), because kernel launches return
before the device finishes.  With no collector active, ``phase`` yields
a no-op and adds nothing to the hot path.  ``sync_floor_seconds`` is the
cost of one such synchronise on finished work, which the sweep subtracts
from each phase once a synchronise (JAX ``utils/timing.py:90``).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch


class Timer:
    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False

    def line(self, msg: str = "time") -> str:
        """Reference-style 'time : <seconds>' line (benchmark.h:14-23)."""
        return f"{msg} : {self.seconds:.6f}"


_COLLECTOR: tuple[dict, dict | None] | None = None


def _noop_sync(x=None):
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def device_sync(x=None):
    """Block until the CUDA work producing ``x`` (a tensor or a nested
    tuple/list of them) is done; CPU tensors need no wait."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


def sync_floor_seconds(device="cuda", samples: int = 5) -> float:
    """The least seconds of one ``device_sync`` on work already finished on
    ``device``: the fixed cost each phase's closing synchronise adds to its
    wall (JAX ``utils/timing.py:90`` read a relay round trip; on a card it is
    ``torch.cuda.synchronize``).  0.0 on the CPU, where nothing waits."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    x = torch.ones(8, device=device)
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        device_sync(x)
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def collect_phases(out: dict, syncs: dict | None = None):
    """Collect named phase walls (seconds) into ``out`` for the duration;
    with ``syncs``, also how many times each phase synchronised a card."""
    global _COLLECTOR
    prev = _COLLECTOR
    _COLLECTOR = (out, syncs)
    try:
        yield out
    finally:
        _COLLECTOR = prev


@contextlib.contextmanager
def phase(name: str):
    """Time one named stage.  Yields a sync callable the caller applies
    to the stage's result (a no-op when collection is off)."""
    if _COLLECTOR is None:
        yield _noop_sync
        return
    collector, syncs = _COLLECTOR

    def psync(x=None):
        if syncs is not None and any(t.device.type == "cuda" for t in _tensors(x)):
            syncs[name] = syncs.get(name, 0) + 1
        return device_sync(x)

    t0 = time.perf_counter()
    try:
        yield psync
    finally:
        collector[name] = collector.get(name, 0.0) + time.perf_counter() - t0


def cuda_event_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the current CUDA stream over
    ``reps`` calls after one warm-up call, by CUDA events.  Kernel times
    are read so, and not from ``torch.profiler``'s device events: on an
    H100 (torch 2.11, CUDA 12.8) a profile can miss some or all of the
    launches in its window, with nothing to tell it did."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternating_ms(fns: dict, rounds: int = 5, warm: int = 2) -> dict:
    """The median milliseconds of each ``fns[name]()`` by CUDA events, the
    calls taking turns in one window: ``warm`` rounds unmeasured, then
    ``rounds`` rounds whose order reverses each time (a, b, b, a, ...), so
    every callable meets the card's clock in the same states."""
    names = list(fns)
    times = {name: [] for name in names}
    for i in range(warm + rounds):
        for name in names if i % 2 == 0 else names[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            if i >= warm:
                times[name].append(start.elapsed_time(end))
    return {name: statistics.median(ts) for name, ts in times.items()}


def graphed(fn, calls: int):
    """A callable that replays ``calls`` calls of ``fn`` captured into one
    CUDA graph (after one call outside it, which builds and warms).  Timing
    the replay reads the device's time alone: a wrapper's host work between
    launches, which can exceed a kernel of tens of µs, is not replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    return graph.replay
