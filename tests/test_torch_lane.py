"""P1's functions (recsys_tpu_torch/ops/lane.py, probes/gather.py) against
the TPU probe's own Pallas bodies, on the CPU.

``gather_kernel`` and ``cumsum_kernel`` are taken from
scripts/probe_gather.py's source (importing it would switch on the JAX
package's persistent cache) and run in interpret mode.  ``cumsum_kernel``
reads ``out`` before writing it, so it runs with uninitialized memory set
to zero: its defined result is ``cumsum(x)``, which the port's twin starts
from.  The gather's twin equals the JAX body bit for bit (0.5 * out + g
rounds the same way in both); the scan's is held to
``testing.LANE_CUMSUM_RTOL``, which its control must exceed.
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
from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import lane
from recsys_tpu_torch.probes import gather as probe


def _p1_kernels():
    path = FIXTURES.parent.parent / "scripts" / "probe_gather.py"
    tree = ast.parse(path.read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in ("gather_kernel", "cumsum_kernel")]
    assert len(fns) == 2
    ns = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _jax_gather(tab, idx, t):
    # run_gather (probe_gather.py:40) in interpret mode.
    return np.array(pl.pallas_call(
        functools.partial(_p1_kernels()["gather_kernel"], t=t),
        out_shape=jax.ShapeDtypeStruct(tab.shape, jnp.float32), interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx)))


def _jax_cumsum(x, t):
    # run_cumsum (probe_gather.py:57), out's first read as zeros.
    return np.array(pl.pallas_call(
        functools.partial(_p1_kernels()["cumsum_kernel"], t=t),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=pltpu.InterpretParams(uninitialized_memory="zero"),
    )(jnp.asarray(x)))


@pytest.mark.parametrize("broadcast", [False, True])
def test_gather_twin_equals_jax_body(broadcast):
    rng = np.random.default_rng(0)
    tab, idx = probe.gather_inputs(8, 256, "cpu", rng)
    if broadcast:
        idx = idx[:1].expand_as(idx).contiguous()
    got = lane.lane_gather_loop(tab, idx, 3)
    np.testing.assert_array_equal(got.numpy(), _jax_gather(tab.numpy(), idx.numpy(), 3))


@pytest.mark.parametrize("shape", [(8, 256), (3, 96)])
def test_cumsum_twin_matches_jax_body(shape):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    got = lane.lane_cumsum_loop(x, 3)
    want = torch.from_numpy(_jax_cumsum(x.numpy(), 3))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= checks.LANE_CUMSUM_RTOL * scale
    assert float((checks.lane_cumsum_dropped(x) - want).abs().max()) > checks.LANE_CUMSUM_RTOL * scale


def test_probe_checks_on_the_cpu():
    errs = probe.check("cpu")
    assert errs == {"lane_gather": 0.0, "lane_cumsum": 0.0}  # both twins on the CPU


def test_wrappers_refuse_what_no_kernel_takes():
    tab, idx = probe.gather_inputs(2, 64, "cpu", np.random.default_rng(0))
    with pytest.raises(ValueError, match="int32"):
        lane.lane_gather_loop(tab, idx.long(), 1)
    with pytest.raises(ValueError, match="float32"):
        lane.lane_cumsum_loop(tab.double(), 1)
    meta = [x.to("meta") for x in (tab, idx)]
    with pytest.raises(ValueError, match="no kernel"):
        lane.lane_gather_loop(*meta, 1)
    before = lane.lane_gather_loop.launches, lane.lane_cumsum_loop.launches
    lane.lane_gather_loop(tab, idx, 2)
    lane.lane_cumsum_loop(tab, 2)
    assert (lane.lane_gather_loop.launches, lane.lane_cumsum_loop.launches) == before  # twins: no launch
