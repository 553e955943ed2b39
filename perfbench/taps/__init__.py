"""Taps: pass-through wrappers that hand the harness the trained factors
of the job that is running, as the program produced them.

``run()`` returns only the formatted list and the top-1, so the harness
wraps the program's functions that return the trained factors, one module
of this folder each.  A tap module defines ``install(sink)``, which wraps
its target when the program has it and returns the callable that undoes
it, or returns None when the target is absent.  A wrapper calls its target
unchanged and keeps references to the tensors it returns: it launches
nothing and copies nothing.  A later change of the program that moves the
factors elsewhere adds a tap module here; every module found is installed.
"""

from __future__ import annotations

import importlib
import os


class Sink:
    """The factors each job produced: the last capture of the running job,
    kept in the slot the harness gives a sampled job, and the last job's."""

    def __init__(self):
        self.kept: dict = {}
        self.last = None
        self.misses = 0
        self._cur = None
        self._slot = None

    def begin(self, slot: int | None) -> None:
        """A job starts; its capture goes to ``slot`` (None: not kept)."""
        self._cur, self._slot = None, slot

    def put(self, layout: str, L, R) -> None:
        """``layout``: ``kmajor`` for padded (K, rows) tables, ``rows`` for
        (rows, k) tables."""
        self._cur = (layout, L, R)

    def end(self) -> None:
        if self._cur is None:
            self.misses += 1
            return
        self.last = self._cur
        if self._slot is not None:
            self.kept[self._slot] = self._cur
        self._cur = None

    def captures(self) -> list:
        """The sampled jobs' captures and the last job's."""
        out = list(self.kept.values())
        if self.last is not None and all(self.last is not c for c in out):
            out.append(self.last)
        return out


def wrap(module, name: str, sink: Sink, layout: str, pick):
    """Wrap ``module.name`` so that ``pick(result)`` -> (L, R) reaches the
    sink; returns the undo callable, or None when the target is absent."""
    fn = getattr(module, name, None)
    if fn is None:
        return None

    def tapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.put(layout, *pick(out))
        return out

    return replace(module, name, fn, tapped)


def replace(module, name: str, fn, tapped):
    """Bind ``tapped`` as ``module.name`` with ``fn``'s attributes shared,
    so that counters the program keeps on its function (``.launches``, which
    it bumps through the module's name) still count; returns the undo."""
    tapped.__dict__ = fn.__dict__
    tapped.__name__, tapped.__doc__ = fn.__name__, fn.__doc__
    setattr(module, name, tapped)
    return lambda: setattr(module, name, fn)


def install_all(sink: Sink) -> list:
    """Install every tap module of this folder; returns the undo callables."""
    here = os.path.dirname(os.path.abspath(__file__))
    undo = []
    for f in sorted(os.listdir(here)):
        if f.endswith(".py") and not f.startswith("_"):
            u = importlib.import_module(f"perfbench.taps.{f[:-3]}").install(sink)
            if u is not None:
                undo.append(u)
    return undo
