"""The plain reference against the reference binary's golden output, and
its independence from the program."""

import ast
import os

import numpy as np

from perfbench import datagen, reference, registry
from perfbench.tests.pb_helpers import REPO


def test_seed0_reproduces_instML100k_out():
    cfg = registry.load_json(f"{REPO}/perfbench/configs/ml100k.json")
    inst = datagen.make(cfg, 0, REPO)
    L, R = reference.solve(inst)
    out = reference.format_top1(reference.top1(reference.scores(L, R, inst)), inst)
    with open(f"{REPO}/tests/fixtures/instML100k.out") as f:
        assert out == f.read()


def test_one_step_is_the_dense_gradient_step():
    inst = datagen.Instance(1, 0.01, 2, 3, 4, np.array([0, 1, 2]), np.array([1, 3, 0]), np.array([5.0, 3.0, 1.0]))
    L0, R0 = reference.glibc.initial_factors(3, 4, 2)
    A = np.zeros((3, 4))
    A[inst.rows, inst.cols] = inst.vals
    E = np.where(A != 0, A - L0 @ R0.T, 0.0)
    L, R = reference.solve(inst)
    assert np.allclose(L.numpy(), L0 + 0.02 * E @ R0, rtol=0, atol=1e-15)
    assert np.allclose(R.numpy(), R0 + 0.02 * E.T @ L0, rtol=0, atol=1e-15)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "glibc.py", "judge.py"):
        tops = {m.split(".")[0] for m in _imports(os.path.join(REPO, "perfbench", name))}
        assert not tops & {"recsys_tpu_torch", "recsys_tpu", "jax", "jaxlib", "flax"}, name
