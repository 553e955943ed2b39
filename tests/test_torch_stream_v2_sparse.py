"""P3's sparse form (``ops/stream_v2.py::stream_v2_train``: B3's sparse walk,
``sparse_pass`` of recsys_tpu_torch/csrc/dense_stream.cu, with R in the
strip-packed layout) on the CPU: its tables are B3's ``walk_tables`` of
A^T, and the plain walk over them (``dense_stream.walk_train_plain`` on the
unpacked R) agrees with P3's twin and with the TPU probe's own Pallas kernel
(interpret mode, loaded as tests/test_torch_stream_v2.py loads it); a walk
of another split is refused, and the CPU never launches.

The CUDA kernel is held against P3's dense form and B3 in raw bits in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_fused, dense_stream, stream_v2
from test_torch_stream_v2 import ALPHA2, ITERS, N_STRIPS, STRIP, U, _script

STORAGES = ["int8", "bfloat16", "float32"]


def _inputs(a_dtype: str, k: int):
    """Seeded (Lt, Rp, A) numpy, as tests/test_torch_stream_v2.py makes them,
    at K = k: ratings in 0.5 steps on ~30% of the cells."""
    rng = np.random.default_rng(0)
    Lt = (rng.random((k, U)) / k).astype(np.float32)
    Rt = (rng.random((k, N_STRIPS * STRIP)) / k).astype(np.float32)
    a = np.where(rng.random((U, N_STRIPS * STRIP)) < 0.3, rng.integers(2, 11, (U, N_STRIPS * STRIP)) * 0.5, 0.0)
    A = {"int8": (2 * a).astype(np.int8), "bfloat16": a.astype(np.float32), "float32": a.astype(np.float32)}[a_dtype]
    return Lt, np.asarray(_script()["pack_R"](Rt, STRIP)), A


def _torch(A: np.ndarray, a_dtype: str):
    return torch.from_numpy(A).to(torch.bfloat16) if a_dtype == "bfloat16" else torch.from_numpy(A)


@pytest.mark.parametrize("k", [8, 40])
@pytest.mark.parametrize("a_dtype", STORAGES)
def test_tables_are_b3s_of_a_transposed(a_dtype, k):
    _, _, A = _inputs(a_dtype, k)
    tA = _torch(A, a_dtype)
    walk = stream_v2.v2_walk(tA, k)
    split = dense_stream.stream_split(k, *tA.shape)
    want = dense_stream.walk_tables(tA.T.contiguous(), split, dense_fused.sub_strip(split[0]))
    assert walk.split == want.split and walk.sub == want.sub and walk.cap == want.cap
    assert all(torch.equal(a, b) for a, b in zip(walk.tables, want.tables))


@pytest.mark.parametrize("k", [8, 40])
@pytest.mark.parametrize("a_dtype", STORAGES)
def test_walk_on_packed_r_matches_twin_and_jax(a_dtype, k):
    Lt, Rp, A = _inputs(a_dtype, k)
    tA = _torch(A, a_dtype)
    Lt_t, Rp_t = torch.from_numpy(Lt), torch.from_numpy(Rp)
    walk = stream_v2.v2_walk(tA, k)
    L2, R2 = dense_stream.walk_train_plain(Lt_t, stream_v2.unpack_R(Rp_t, k), walk, iters=ITERS, alpha2=ALPHA2)
    got = (L2, stream_v2.pack_R(R2, STRIP))
    twin = stream_v2.stream_v2_train_plain(Lt_t, Rp_t, tA, iters=ITERS, alpha2=ALPHA2, strip=STRIP)
    assert checks.factor_rel(got, twin) <= checks.STREAM_V2_RTOL
    jA = jnp.asarray(A, jnp.bfloat16) if a_dtype == "bfloat16" else jnp.asarray(A)
    want = _script()["stream_v2_train"](jnp.asarray(Lt), jnp.asarray(Rp), jA, iters=ITERS, alpha2=ALPHA2, strip=STRIP)
    assert checks.factor_rel(got, tuple(torch.from_numpy(np.array(w)) for w in want)) <= checks.STREAM_V2_RTOL


def test_a_walk_of_another_split_is_refused_and_cpu_never_launches():
    Lt, Rp, A = (torch.from_numpy(x) for x in _inputs("int8", 8))
    kw = dict(iters=1, alpha2=ALPHA2, strip=STRIP)
    other = stream_v2.v2_walk(A, 8, sms=1)  # the split of a one-SM card
    assert other.split != dense_stream.stream_split(8, *A.shape)
    with pytest.raises(ValueError, match="split"):
        stream_v2.stream_v2_train(Lt, Rp, A, walk=other, **kw)
    before = stream_v2.stream_v2_train.launches, stream_v2.stream_v2_train_dense.launches
    twin = stream_v2.stream_v2_train_plain(Lt, Rp, A, **kw)
    for fn in (stream_v2.stream_v2_train, stream_v2.stream_v2_train_dense):
        assert checks.same_bits(fn(Lt, Rp, A, **kw), twin)
    assert checks.same_bits(stream_v2.stream_v2_train(Lt, Rp, A, walk=stream_v2.v2_walk(A, 8), **kw), twin)
    assert (stream_v2.stream_v2_train.launches, stream_v2.stream_v2_train_dense.launches) == before
    with pytest.raises(ValueError, match="highest"):
        stream_v2.stream_v2_train_dense(Lt, Rp, A, precision="bf16x3", **kw)
    with pytest.raises(ValueError, match="no kernel"):
        stream_v2.stream_v2_train_dense(Lt.to("meta"), Rp.to("meta"), A.to("meta"), **kw)
