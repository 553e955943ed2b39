"""Faults planted under the timed path, for the checks that a broken
program comes out not correct (``tests/test_pb_faults.py`` on the CPU,
``control.py --faults`` at a cell's own size on the card):

* ``unchanged``: training returns the initial state (0 steps);
* ``half``: half of the ratings left out of training;
* ``answer``: one user's item altered where the list is produced.

(The cells run on one card, so there is no exchange to leave out.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

FAULTS = ("unchanged", "half", "answer")


def plant(fault: str):
    """Plant ``fault`` in the program; returns the callable that removes it."""
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io import writers

    if fault == "answer":
        module, name = writers, "format_recommendations"
        orig = writers.format_recommendations

        def broken(top1, rated_counts, items):
            top1 = np.array(top1, copy=True)
            top1[0] = (top1[0] + 1) % items
            return orig(top1, rated_counts, items)
    elif fault in ("unchanged", "half"):
        module, name = trainer, "run"
        orig = trainer.run

        def broken(spec, cfg, device, **kw):
            if fault == "unchanged":
                spec = dataclasses.replace(spec, iters=0)
            else:
                keep = np.arange(spec.nnz) % 2 == 0
                spec = dataclasses.replace(spec, rows=spec.rows[keep], cols=spec.cols[keep], vals=spec.vals[keep])
            return orig(spec, cfg, device, **kw)
    else:
        raise ValueError(f"no fault {fault!r}")
    setattr(module, name, broken)
    return lambda: setattr(module, name, orig)
