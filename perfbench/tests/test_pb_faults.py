"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, and the program runs on the CPU
(its plain twins) with one fault of ``perfbench.faults`` planted at a
time.  The same faults are read at the cells' own sizes on the card by
``control.py --faults`` (``test_pb_control.py``)."""

import time

import pytest

from perfbench import faults, registry, run
from perfbench.tests.pb_helpers import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("pb")))


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", ["tiny.cpu32", "tiny.cpu64"])
def test_a_planted_fault_is_not_correct(root, workload, fault):
    undo = faults.plant(fault)
    try:
        r = run.run_cell(registry.cell(workload, root), 4_000_000_007, 0.2, False, device="cpu", root=root,
                         t0=time.perf_counter())
    finally:
        undo()
    assert r["correct"] is False
    over = [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]
    assert over, r["checks"]
