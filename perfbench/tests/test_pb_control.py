"""Each cell's control comes out not correct, and its sound runs correct.

The control of a float32 cell is the reference put in the program's place
in TF32 (``reference_tf32``); of the float64 cell, the program's own
float32 path on the same route (``program_f32_bell``).  On the card the
test reads them at the cells' own sizes on three seeds, together with each
planted fault of ``perfbench.faults``; on the CPU, at a size a test run
holds (the ``tiny`` cells at the cells' k and iterations, TF32 emulated;
the faults there are ``test_pb_faults.py``'s)."""

import pytest

from perfbench import control, faults, judge, registry
from perfbench.tests.pb_helpers import tiny_root

CONTROL = {"float32": "reference_tf32", "float64": "program_f32_bell"}


def _judged(cell, root, seeds, device, n_faults):
    limits = judge.load_limits(root, cell.name)
    for r in control.readings(cell, seeds, len(seeds), device=device, root=root, n_faults=n_faults):
        ok, _ = judge.checks({"factor_gap": r["factor_gap"], "top1_gap": r["top1_gap"], "failed_jobs": 0.0}, limits)
        yield r, ok and r["ok"]


def _assert_control_fails(cell, root, seeds, device, n_faults=0):
    seen = set()
    for r, ok in _judged(cell, root, seeds, device, n_faults):
        if r["variant"] == "sound":
            assert ok, r
        elif r["variant"] == CONTROL[cell.traffic["dtype"]] or r["variant"].startswith("fault_"):
            assert not ok, r
            seen.add((r["seed"], r["variant"]))
    want = {CONTROL[cell.traffic["dtype"]]} | ({f"fault_{f}" for f in faults.FAULTS} if n_faults else set())
    assert seen == {(s, v) for s in seeds for v in want}


@pytest.mark.parametrize("workload", ["tiny.cpu32", "tiny.cpu64"])
def test_control_fails_on_the_cpu(tmp_path, workload):
    root = tiny_root(str(tmp_path), iters=3000, features=30)  # the cells' k and iterations
    _assert_control_fails(registry.cell(workload, root), root, [11, 12, 13], "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ml100k.f32", "ml1m.f32", "ml100k.f64"])
def test_control_fails_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _assert_control_fails(registry.cell(workload), registry.ROOT, [301, 302, 303], "cuda", n_faults=3)
