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
    ``reps`` calls after one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, names=None) -> float:
    """Mean device milliseconds per call of ``fn()`` from ``torch.profiler``,
    after one warm-up call: the time of the device events (kernels,
    copies) whose name holds one of ``names``, or of all of them when
    ``names`` is None.  Raises where the profiler sees none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == cuda and (names is None or any(n in e.key for n in names)))
    if total <= 0:
        raise RuntimeError(f"the profiler saw no device time of {names or 'any kernel'}")
    return total / reps / 1e3
