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
    # Every kernel's wrapper takes its twin on the CPU.
    assert errs == {"lane_gather": 0.0, "lane_cumsum": 0.0}


def test_wrappers_refuse_what_no_kernel_takes():
    tab, idx = probe.gather_inputs(2, 64, "cpu", np.random.default_rng(0))
    with pytest.raises(ValueError, match="int32"):
        lane.lane_gather_loop(tab, idx.long(), 1)
    with pytest.raises(ValueError, match="float32"):
        lane.lane_cumsum_loop(tab.double(), 1)
    meta = [x.to("meta") for x in (tab, idx)]
    with pytest.raises(ValueError, match="no kernel"):
        lane.lane_gather_loop(*meta, 1)
    with pytest.raises(ValueError, match="no kernel"):
        lane.lane_cumsum_loop(meta[0], 1)
    wrappers = (lane.lane_gather_loop, lane.lane_cumsum_loop)
    before = [fn.launches for fn in wrappers]
    assert torch.equal(lane.lane_gather_loop(tab, idx, 2), lane.lane_gather_loop_plain(tab, idx, 2))
    assert torch.equal(lane.lane_cumsum_loop(tab, 2), lane.lane_cumsum_loop_plain(tab, 2))
    assert [fn.launches for fn in wrappers] == before  # twins: no launch


# The probe's scan shapes and the card tests' (tests/test_torch_cuda.py).
PLAN_SHAPES = [(8, 8192), (24, 8192), (8, 32768), (8, 512), (4, 96), (3, 1056), (2, 3040), (3, 8192), (2, 32768),
               (1, 32), (200, 32768), (3, 544)]


@pytest.mark.parametrize("S,W", PLAN_SHAPES)
def test_cumsum_cluster_plan(S, W):
    NT, EPT, C = lane.cumsum_cluster_plan(S, W, 132)
    assert NT == min(W, 1024) and EPT & (EPT - 1) == 0 and NT * EPT >= W > NT * EPT // 2  # the block form's
    assert C in (1, 2, 4, 8) and (NT // 32) % C == 0  # up to the portable cluster size
    assert EPT == 1 or NT // C <= 256  # registers: a thread keeps its elements, the next step's and its results
    assert S * C <= 132 or C == 1 or (EPT > 1 and NT // C == 256)
    if W in (32, 96):
        assert C == 1


def test_cumsum_cluster_plan_fills_the_card():
    assert lane.cumsum_cluster_plan(8, 32768, 132)[2] == 8
    assert lane.cumsum_cluster_plan(24, 8192, 132)[2] == 4
    assert lane.cumsum_cluster_plan(8, 8192, 132)[2] == 8
    assert lane.cumsum_cluster_plan(200, 32768, 132)[2] == 4  # 256 threads a block at most


@pytest.mark.parametrize("shape,t", [((8, 256), 3), ((3, 96), 2), ((2, 3040), 1), ((3, 8192), 2)])
def test_cumsum_kernel_order_matches_jax_body(shape, t):
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    got = lane.lane_cumsum_loop_order_plain(x, t)
    want = torch.from_numpy(_jax_cumsum(x.numpy(), t))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= checks.LANE_CUMSUM_RTOL * scale
    assert float((checks.lane_cumsum_dropped(x) - want).abs().max()) > checks.LANE_CUMSUM_RTOL * scale
    assert checks.same_bits(lane.lane_cumsum_loop_order_plain(x, 0), torch.zeros_like(x))


def test_cumsum_kernel_order_differs_from_torch_in_bits():
    # The order test has teeth: the kernels' sums are not torch.cumsum's.
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 8192)).astype(np.float32))
    got = lane.lane_cumsum_loop_order_plain(x, 1)
    assert not checks.same_bits(got, torch.cumsum(x, 1))
    # ... and each thread's elements are summed in order from 0: one thread
    # alone (W = 32 of ones at its start) gives the counts exactly.
    ones = torch.ones(1, 64)
    np.testing.assert_array_equal(lane.lane_cumsum_loop_order_plain(ones, 1).numpy()[0], np.arange(1, 65))


def _check_schedule(idx, threads, slots):
    cells, rounds = lane.gather_schedule_plain(idx, threads, slots)
    n, cap = idx.numel(), threads // 32 * slots
    assert cells.shape == (cap, 32)
    live = cells[cells >= 0]
    assert sorted(live.tolist()) == list(range(n))  # a permutation of the span
    counts = torch.bincount(idx.long() & 31, minlength=32)
    assert rounds == (int(counts.max()) if counts.max() <= cap else cap)
    assert bool((cells[rounds:] < 0).all()) and bool((cells[:rounds] >= 0).any(dim=1).all())
    addr = torch.where(cells >= 0, idx.long()[cells.clamp(min=0)], -1)
    for r in range(rounds):  # no two lanes of a round share a bank unless they share an address
        a = addr[r][addr[r] >= 0]
        for b in range(32):
            assert len(set(a[(a & 31) == b].tolist())) <= 1 or counts.max() > cap
    return cells, rounds, addr


@pytest.mark.parametrize("S,W", [(8, 2048), (8, 8192), (24, 8192), (8, 32768), (5, 1000), (1, 58112)])
def test_gather_schedule_on_random_spans(S, W):
    grid, span, threads, slots = lane.gather_plan(S, W, 132)
    assert (grid - 1) * span < W <= grid * span and threads * (slots // 2) >= span
    per = 1  # the direct form's outputs a thread, as its launcher finds them from the same plan
    while per * threads < span:
        per *= 2
    assert slots == max(2 * per, 4) and threads <= 512
    idx = torch.from_numpy(np.random.default_rng(W).integers(0, W, span).astype(np.int32))
    cells, rounds, addr = _check_schedule(idx, threads, slots)
    lanes = torch.arange(32).expand_as(addr)
    assert bool(((addr < 0) | ((addr & 31) == lanes)).all())  # lane b reads bank b: no overflow here
    if span >= 512:
        assert rounds < 2 * span // 32  # fewer rounds than the direct form's ~3.5 wavefronts a load


@pytest.mark.parametrize("fill", ["one address", "one bank", "one hot bank"])
def test_gather_schedule_overflow(fill):
    threads, slots, n = 512, 8, 2048
    rng = np.random.default_rng(6)
    idx = {"one address": np.full(n, 77), "one bank": rng.integers(0, 1024, n) * 32,
           "one hot bank": np.where(rng.random(n) < 0.5, rng.integers(0, 64, n) * 32 + 5, rng.integers(0, 8192, n))}[fill]
    cells, rounds, addr = _check_schedule(torch.from_numpy(idx.astype(np.int32)), threads, slots)
    assert rounds == threads // 32 * slots  # a bucket past its rounds: the other lanes take the rest
    if fill == "one address":  # every load of a round reads one address: a broadcast
        assert all(len(set(a[a >= 0].tolist())) == 1 for a in addr)
