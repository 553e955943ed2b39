"""The port's glibc stream (recsys_tpu_torch/ops/device_rng.py) on the CPU:
its torch twin against the JAX package's ``recsys_tpu.ops.device_rng`` and
the host generator, and the host half of the kernel's plan.

The integer words must equal the host generator's bit for bit, for any
count and across calls; the f32 draws equal JAX's bit for bit (the same
``f32(x >> 1) * f32(scale)``) and lie within rtol 3e-7 (~2 f32 ulp) of the
host's f64 divide-then-cast.  The windows the kernel jumps to must equal
the host generator's words at every segment's start.
"""

import numpy as np
import pytest
import torch

from recsys_tpu.ops import device_rng as jax_rng
from recsys_tpu_torch.engine import trainer
from recsys_tpu_torch.io.glibc_random import GlibcRandom
from recsys_tpu_torch.models.mf import init_factors
from recsys_tpu_torch.ops import device_rng


def test_block_coeffs_equal_jax():
    # The same table, stored as one contiguous row per state word.
    np.testing.assert_array_equal(device_rng._block_coeffs(1000).T, jax_rng._block_coeffs(1000).astype(np.int64))


def test_stream_equals_jax_and_host_across_blocks_and_calls():
    # tests/test_device_rng.py:25-38's case: block 1000, 2517 (2 blocks +
    # 517) then 1311 draws from one stream.
    ours, theirs = device_rng.DeviceGlibcStream(0, block=1000), jax_rng.DeviceGlibcStream(0, block=1000)
    got = np.concatenate([ours.rand01_over(2517, 5.0).numpy(), ours.rand01_over(1311, 5.0).numpy()])
    want = np.concatenate([np.asarray(theirs.rand01_over(2517, 5.0)), np.asarray(theirs.rand01_over(1311, 5.0))])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    host = GlibcRandom(0).raw(2517 + 1311).astype(np.float64)
    np.testing.assert_allclose(got, (host / 2147483647.0 / 5.0).astype(np.float32), rtol=3e-7)


@pytest.mark.parametrize("sizes", [(2517, 1311), (999, 1, 1000, 34, 33)])
def test_integer_words_equal_host_raw(sizes):
    st = device_rng.DeviceGlibcStream(0, block=1000)
    words = torch.cat([st.raw32(n) for n in sizes])
    assert int(words.min()) >= 0 and int(words.max()) < 2 ** 32
    np.testing.assert_array_equal((words >> 1).numpy(), GlibcRandom(0).raw(sum(sizes)))


def test_device_init_factors_equal_jax_and_host():
    L, R = device_rng.device_init_factors(37, 23, 6, block=100)
    Lj, Rj = jax_rng.device_init_factors(37, 23, 6)
    assert tuple(L.shape) == (37, 6) and tuple(R.shape) == (23, 6)
    np.testing.assert_array_equal(L.numpy(), np.asarray(Lj))
    np.testing.assert_array_equal(R.numpy(), np.asarray(Rj))
    host = init_factors(37, 23, 6)
    np.testing.assert_allclose(L.numpy(), host.L.astype(np.float32), rtol=3e-7)
    np.testing.assert_allclose(R.numpy(), host.R.astype(np.float32), rtol=3e-7)


def test_bell_route_gate():
    # The JAX gate (trainer.py:378-382): f32, no state given, at least
    # DEVICE_INIT_MIN_DRAWS draws; f64 keeps the exact host init.
    from recsys_tpu.engine.trainer import DEVICE_INIT_MIN_DRAWS
    from recsys_tpu_torch.config import ProblemSpec, RunConfig

    assert trainer.DEVICE_INIT_MIN_DRAWS == DEVICE_INIT_MIN_DRAWS
    empty = np.zeros(0, np.int32)
    big = ProblemSpec(iters=1, alpha=1e-4, features=700, users=1_000_000, items=100, rows=empty, cols=empty,
                      vals=np.zeros(0))
    state = init_factors(3, 2, 2)
    assert trainer._device_init(big, RunConfig(dtype="float32"), None)
    assert not trainer._device_init(big, RunConfig(dtype="float64"), None)
    assert not trainer._device_init(big, RunConfig(dtype="float32"), state)
    small = ProblemSpec(iters=1, alpha=1e-4, features=30, users=943, items=1682, rows=empty, cols=empty,
                        vals=np.zeros(0))
    assert not trainer._device_init(small, RunConfig(dtype="float32"), None)


def test_permute_pad_is_take_with_fill():
    F = torch.arange(12.0).reshape(4, 3)
    perm = np.array([2, 0, 3, 1])
    want = torch.cat([F[torch.from_numpy(perm)], torch.zeros(1, 3)])
    assert torch.equal(trainer._permute_pad(F, perm), want)
    assert torch.equal(trainer._permute_pad(F.T.contiguous().T, perm), want)  # a transposed view, as R is


def _host_window(position: int) -> np.ndarray:
    """The host generator's words x[position - 34 .. position - 1]."""
    g = GlibcRandom(0)
    g.raw(position)
    return g._window.astype(np.uint64)


@pytest.mark.parametrize("segment,log_threads,n", [
    (1, 2, 100),      # segments of one draw: every window of the first 100 positions
    (3, 1, 200),      # the shortest lag
    (33, 2, 1500),    # segment starts either side of 34, blocks of 4 segments
    (34, 3, 2000),
    (35, 0, 800),     # a block a segment: every window by block jumps alone
    (64, 3, 9000),    # starts on 2^k, 17 blocks
    (1000, 2, 30000),
    (device_rng.SEGMENT, 2, 20 * device_rng.SEGMENT + 5),  # the kernel's segment, a ragged last one
])
def test_plan_windows_equal_the_host_words_at_segment_starts(segment, log_threads, n):
    got = device_rng.plan_windows(0, n, segment, log_threads)
    assert got.shape == (-(-n // segment), 34)
    host = GlibcRandom(0)
    for g in range(got.shape[0]):
        np.testing.assert_array_equal(got[g], host._window, err_msg=f"segment {g}")
        host.raw(segment)


@pytest.mark.parametrize("e", [0, 1, 5, 9])
def test_the_kernels_jump_matrices_move_the_window_by_their_draws(e):
    # Entry e of the kernel's table moves a window SEGMENT * 2^e draws on,
    # from the seed's window and from one past a 2^k + 34 boundary.
    J = device_rng.jump_matrices(device_rng.SEGMENT, device_rng.JUMPS)[e]
    assert J.max() < 2 ** 32
    steps = device_rng.SEGMENT << e
    for start in (0, 64 + 34 + 1):
        got = (J @ _host_window(start)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(got, _host_window(start + steps))


def test_a_cpu_stream_takes_the_twin_and_launches_nothing():
    launches = device_rng.glibc_stream.launches
    words = device_rng.glibc_stream(2517)
    floats = device_rng.glibc_stream(2517, divisor=5.0, block=1000)
    assert words.dtype == torch.int64 and floats.dtype == torch.float32
    np.testing.assert_array_equal((words >> 1).numpy(), GlibcRandom(0).raw(2517))
    assert torch.equal(floats, device_rng.DeviceGlibcStream(0, block=1000).rand01_over(2517, 5.0))
    assert device_rng.glibc_stream.launches == launches


def test_the_stream_refuses_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        device_rng.glibc_stream(10, device="meta")
