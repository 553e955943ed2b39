"""The port's CUDA kernel on the card: held against its plain torch twin,
and the main path through it against the golden output.

These tests need an NVIDIA card and skip without one.  The machine with
the card has no jax, and tests/conftest.py imports it, so run them there
without the conftest::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import pathlib

import pytest
import torch

from recsys_tpu.config import RunConfig
from recsys_tpu.io.generator import generate_instance
from recsys_tpu.io.parser import load_problem
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.ops import dense_fused

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
# The readings and their limits are in recsys_tpu_torch/testing.py.


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_kernel_matches_plain_twin(precision):
    dev = _cuda()
    spec = generate_instance(200, 300, 10, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)
    Lt, Rt, (U, I, K) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, torch.int8, dev)
    Lt, Rt = torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev)
    kw = dict(iters=spec.iters, alpha2=2 * spec.alpha, precision=precision, items_true=spec.items)
    before = dense_fused.resident_train_top1.launches
    Lk, Rk, tk = dense_fused.resident_train_top1(Lt, Rt, A, **kw)
    Lp, Rp, tp = dense_fused.resident_train_top1_plain(Lt, Rt, A, **kw)
    torch.cuda.synchronize()
    assert dense_fused.resident_train_top1.launches == before + 1
    assert checks.factor_rel((Lk, Rk), (Lp, Rp)) <= checks.FACTOR_RTOL[precision]
    assert torch.equal(tk, tp)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,twin_precision",
                         [(p, p) for p in ("highest", "bf16x3", "default")] + list(checks.UPDATE_CONTROLS))
def test_kernel_update_on_precision_probe(precision, twin_precision):
    # Same mode: within the limit.  A control (kernel in a finer mode than
    # the twin): beyond it, so the limit would catch a kernel that skipped
    # the mode's rounding.
    dev = _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    Lt, Rt, A = checks.precision_probe(spec, torch.int8, dev)
    kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2, items_true=spec.items)
    got = dense_fused.resident_train_top1(Lt, Rt, A, precision=precision, **kw)
    want = dense_fused.resident_train_top1_plain(Lt, Rt, A, precision=twin_precision, **kw)
    rel = checks.update_rel(got, want, Lt, Rt)
    limit = checks.UPDATE_RTOL[twin_precision]
    assert rel <= limit if precision == twin_precision else rel > limit


@pytest.mark.cuda
def test_run_instml100k_matches_golden():
    _cuda()
    spec = load_problem(str(FIXTURES / "instML100k.in"))
    assert trainer.choose_path(spec, RunConfig(dtype="float32"), "cuda") == "pallas"
    before = dense_fused.resident_train_top1.launches
    out, _ = trainer.run(spec, RunConfig(dtype="float32"), "cuda")
    assert dense_fused.resident_train_top1.launches == before + 1
    assert out == (FIXTURES / "instML100k.out").read_text()
