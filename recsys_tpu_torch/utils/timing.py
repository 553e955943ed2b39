"""Wall-clock and per-phase timing (port of ``recsys_tpu/utils/timing.py``).

``Timer`` is the reference's ``time : <s>`` line (``benchmark.h:14-23``).
``phase`` times one named stage into an active ``collect_phases`` dict;
the callable it yields synchronises the CUDA device that holds its
argument (a no-op for CPU tensors), because kernel launches return
before the device finishes.  With no collector active, ``phase`` yields
a no-op and adds nothing to the hot path.
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


_COLLECTOR: dict | None = None


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


@contextlib.contextmanager
def collect_phases(out: dict):
    """Collect named phase walls (seconds) into ``out`` for the duration."""
    global _COLLECTOR
    prev = _COLLECTOR
    _COLLECTOR = out
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
    collector = _COLLECTOR
    t0 = time.perf_counter()
    try:
        yield device_sync
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
