"""Wall-clock and per-phase timing, spans and counts of a job (port of
``recsys_tpu/utils/timing.py``).

``Timer`` is the reference's ``time : <s>`` line (``benchmark.h:14-23``).
``phase`` times one named stage into an active ``collect_phases`` dict;
the callable it yields synchronises the CUDA device that holds its
argument (a no-op for CPU tensors), because kernel launches return
before the device finishes.  ``sync_floor_seconds`` is the cost of one
such synchronise on finished work, which the sweep subtracts from each
phase once a synchronise (JAX ``utils/timing.py:90``).

Each ``collect_phases`` block is also one job's record (``JobRecord``):
every ``phase`` and every ``span`` (which nests anywhere and never writes
the phases dict) as a ``Span`` with its parent, and the counts ``count``
adds, at the innermost open span and in the job's totals.  A closed
record is filed in a bounded log and found by its phases dict
(``record_of``).  ``h2d`` is the counted host-to-device copy.  While
``torch.profiler`` records, ``phase`` and ``span`` also open a
``phase:<name>`` range on its timeline.  With no collector active and no
profiler recording, ``phase``, ``span`` and ``count`` read no clock and
allocate nothing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
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


# Job records kept in the log: a 51 s window of 10 ms jobs files 5,100.
JOB_LOG_MAX = 8192


class Span:
    """One timed stretch of a job: ``start`` and ``end`` in
    ``time.perf_counter`` seconds, ``parent`` the index of the enclosing
    span in the job's ``spans`` (None at the top), ``counts`` what ``count``
    added while it was the innermost open span (None: nothing)."""

    __slots__ = ("name", "start", "end", "parent", "counts")

    def __init__(self, name: str, parent: int | None):
        self.name, self.parent = name, parent
        self.start = self.end = None
        self.counts = None


class JobRecord:
    """One ``collect_phases`` block: ``id``, ``phases`` (the caller's dict),
    ``spans`` in the order they opened, ``counts`` (the job's totals)."""

    __slots__ = ("id", "phases", "syncs", "spans", "counts", "t0", "open")

    def __init__(self, job_id: int, phases: dict, syncs: dict | None):
        self.id, self.phases, self.syncs = job_id, phases, syncs
        self.spans: list[Span] = []
        self.counts: dict = {}
        self.open: list[int] = []  # indices of the spans still open, innermost last
        self.t0 = time.perf_counter()

    def as_dict(self) -> dict:
        """The record as JSON-ready data, times in seconds since it opened."""
        def rel(t):
            return None if t is None else t - self.t0

        return {"id": self.id, "phases": dict(self.phases), "counts": dict(self.counts),
                "spans": [{"name": s.name, "start": rel(s.start), "end": rel(s.end), "parent": s.parent,
                           "counts": s.counts or {}} for s in self.spans]}


_COLLECTOR: JobRecord | None = None
_LOG: collections.deque = collections.deque(maxlen=JOB_LOG_MAX)
_JOB_IDS = itertools.count()


@contextlib.contextmanager
def collect_phases(out: dict, syncs: dict | None = None):
    """Collect named phase walls (seconds) into ``out`` for the duration;
    with ``syncs``, also how many times each phase synchronised a card.
    The block is one job's record, filed on exit (``record_of(out)``)."""
    global _COLLECTOR
    prev = _COLLECTOR
    job = JobRecord(next(_JOB_IDS), out, syncs)
    _COLLECTOR = job
    try:
        yield out
    finally:
        _COLLECTOR = prev
        _LOG.append(job)


def record_of(out: dict) -> JobRecord | None:
    """The filed record whose phases dict is ``out`` (by identity), or None."""
    for job in reversed(_LOG):
        if job.phases is out:
            return job
    return None


class _Off:
    """The context of a ``phase`` or ``span`` with nothing recording."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        return self.value

    def __exit__(self, *exc):
        return False


_OFF_PHASE, _OFF_SPAN = _Off(_noop_sync), _Off(None)


class _Range:
    """The context of a ``phase`` or ``span`` while something records."""

    __slots__ = ("name", "job", "is_phase", "rf", "index")

    def __init__(self, name: str, job: JobRecord | None, is_phase: bool):
        self.name, self.job, self.is_phase, self.rf = name, job, is_phase, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(f"phase:{self.name}")
            self.rf.__enter__()
        job = self.job
        if job is None:
            return _noop_sync if self.is_phase else None
        self.index = len(job.spans)
        s = Span(self.name, job.open[-1] if job.open else None)
        job.spans.append(s)
        job.open.append(self.index)
        s.start = time.perf_counter()
        return _phase_sync(self.name, job.syncs) if self.is_phase else None

    def __exit__(self, *exc):
        job = self.job
        if job is not None:
            s = job.spans[self.index]
            s.end = time.perf_counter()
            job.open.remove(self.index)
            if self.is_phase:
                job.phases[self.name] = job.phases.get(self.name, 0.0) + s.end - s.start
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _phase_sync(name: str, syncs: dict | None):
    def psync(x=None):
        if syncs is not None and any(t.device.type == "cuda" for t in _tensors(x)):
            syncs[name] = syncs.get(name, 0) + 1
        return device_sync(x)

    return psync


def phase(name: str):
    """Time one named stage into the collector's dict, as a span of its
    job.  Yields a sync callable the caller applies to the stage's result
    (a no-op when collection is off)."""
    if _COLLECTOR is None and not torch.autograd._profiler_enabled():
        return _OFF_PHASE
    return _Range(name, _COLLECTOR, True)


def span(name: str):
    """Time a named stretch of a job, nested in whatever is open; it is
    recorded in the job's record only, never in the phases dict."""
    if _COLLECTOR is None and not torch.autograd._profiler_enabled():
        return _OFF_SPAN
    return _Range(name, _COLLECTOR, False)


def count(name: str, n) -> None:
    """Add ``n`` to the job's ``name`` count and to the innermost open span's."""
    job = _COLLECTOR
    if job is None:
        return
    job.counts[name] = job.counts.get(name, 0) + n
    if job.open:
        s = job.spans[job.open[-1]]
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n


def h2d(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (a numpy array or a host tensor) on ``device``, cast to
    ``dtype`` when given, by one ``Tensor.to``: the ``h2d`` span, with the
    bytes handed over counted as ``h2d_bytes`` whatever the device."""
    t = torch.as_tensor(x)
    with span("h2d"):
        count("h2d_bytes", t.nbytes)
        return t.to(device=device, dtype=dtype)


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
