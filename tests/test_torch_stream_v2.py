"""P3's function (recsys_tpu_torch/ops/stream_v2.py) against the TPU probe's
own Pallas kernel, on the CPU.

``_v2_kernel`` and ``stream_v2_train`` are taken from
scripts/probe_stream_v2.py's source (importing it would switch on the JAX
package's persistent cache) and run in interpret mode with A (U, n * strip),
the layout its BlockSpec reads.  The port's twin is held to
``testing.STREAM_V2_RTOL`` against it for int8, bf16 and f32 A; the
control, the same steps with `default`'s bf16 rounding, must exceed it.
"""

import ast
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from helpers import FIXTURES
from recsys_tpu.ops import pallas_dense
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import stream_v2

K, U, STRIP, N_STRIPS, ITERS, ALPHA2 = 8, 128, 128, 3, 2, 0.02


@functools.lru_cache(maxsize=1)
def _script():
    path = FIXTURES.parent.parent / "scripts" / "probe_stream_v2.py"
    tree = ast.parse(path.read_text())
    names = ("_interpret", "_v2_kernel", "stream_v2_train", "pack_R", "unpack_R")
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert len(fns) == len(names)
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": pl, "pltpu": pltpu, "functools": functools, "pd": pallas_dense}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _inputs(a_dtype):
    """Seeded (Lt, Rp, A) numpy arrays: factors near the glibc init's scale,
    ratings in 0.5 steps on ~30% of the cells, A in its storage dtype."""
    rng = np.random.default_rng(0)
    Lt = (rng.random((K, U)) / K).astype(np.float32)
    Rt = (rng.random((K, N_STRIPS * STRIP)) / K).astype(np.float32)
    a = np.where(rng.random((U, N_STRIPS * STRIP)) < 0.3, rng.integers(2, 11, (U, N_STRIPS * STRIP)) * 0.5, 0.0)
    A = {"int8": (2 * a).astype(np.int8), "bfloat16": a.astype(np.float32), "float32": a.astype(np.float32)}[a_dtype]
    return Lt, np.asarray(_script()["pack_R"](Rt, STRIP)), A


@pytest.mark.parametrize("a_dtype", ["int8", "bfloat16", "float32"])
def test_twin_matches_jax_kernel(a_dtype):
    Lt, Rp, A = _inputs(a_dtype)
    jA = jnp.asarray(A, jnp.bfloat16) if a_dtype == "bfloat16" else jnp.asarray(A)
    want = _script()["stream_v2_train"](jnp.asarray(Lt), jnp.asarray(Rp), jA, iters=ITERS, alpha2=ALPHA2,
                                        strip=STRIP)
    tA = torch.from_numpy(A).to(torch.bfloat16) if a_dtype == "bfloat16" else torch.from_numpy(A)
    Lt_t, Rp_t = torch.from_numpy(Lt), torch.from_numpy(Rp)
    kw = dict(iters=ITERS, alpha2=ALPHA2, strip=STRIP)
    got = stream_v2.stream_v2_train(Lt_t, Rp_t, tA, **kw)  # the twin, on the CPU
    want = tuple(torch.from_numpy(np.array(w)) for w in want)
    assert checks.factor_rel(got, want) <= checks.STREAM_V2_RTOL
    assert checks.factor_rel(checks.stream_v2_default(Lt_t, Rp_t, tA, **kw), want) > checks.STREAM_V2_RTOL


def test_pack_unpack_equal_the_script():
    Rt = np.random.default_rng(2).standard_normal((K, N_STRIPS * STRIP)).astype(np.float32)
    Rp = stream_v2.pack_R(torch.from_numpy(Rt), STRIP)
    np.testing.assert_array_equal(Rp.numpy(), _script()["pack_R"](Rt, STRIP))
    np.testing.assert_array_equal(stream_v2.unpack_R(Rp, K).numpy(), Rt)
    np.testing.assert_array_equal(_script()["unpack_R"](Rp.numpy(), K), Rt)


def test_twin_is_the_stream_step_packed():
    # The same GD steps as B3's twin on the unpacked layout, to f32 noise.
    from recsys_tpu_torch.ops import dense_stream

    Lt, Rp, A = (torch.from_numpy(x) for x in _inputs("int8"))
    L2, R2 = dense_stream.stream_train_plain(Lt, stream_v2.unpack_R(Rp, K), A.T.contiguous(), iters=ITERS,
                                             alpha2=ALPHA2)
    got = stream_v2.stream_v2_train(Lt, Rp, A, iters=ITERS, alpha2=ALPHA2, strip=STRIP)
    assert checks.factor_rel(got, (L2, stream_v2.pack_R(R2, STRIP))) <= checks.STREAM_V2_RTOL


def test_wrapper_refuses_what_no_kernel_takes():
    Lt, Rp, A = (torch.from_numpy(x) for x in _inputs("int8"))
    with pytest.raises(ValueError, match="highest"):
        stream_v2.stream_v2_train(Lt, Rp, A, iters=1, alpha2=ALPHA2, strip=STRIP, precision="default")
    with pytest.raises(ValueError, match="n\\*strip"):
        stream_v2.stream_v2_train(Lt, Rp, A.T.contiguous(), iters=1, alpha2=ALPHA2, strip=STRIP)
    with pytest.raises(ValueError, match="no kernel"):
        stream_v2.stream_v2_train(Lt.to("meta"), Rp.to("meta"), A.to("meta"), iters=1, alpha2=ALPHA2, strip=STRIP)
    before = stream_v2.stream_v2_train.launches
    stream_v2.stream_v2_train(Lt, Rp, A, iters=1, alpha2=ALPHA2, strip=STRIP)
    assert stream_v2.stream_v2_train.launches == before  # the twin: no launch
