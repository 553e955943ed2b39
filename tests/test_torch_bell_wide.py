"""The BELL kernel's forms.  On the CPU: ``bell.side_warps`` gives every
row of every bucket to exactly one warp or one block, at thresholds below,
at and above each bucket's width; ``bell_train`` takes the threshold
without changing the twin's result; the step's launch plan
(``step_order``, ``step_plan``, ``waves``) puts both sides' block-form rows
first, widest first, then the warp form, at a given residency.  On the
card (the ``cuda`` tests, which skip without one): the fused step, one launch a step for both sides, holds
the bits of two ``rs_bell_side_update`` launches a step and of the plain
twin, and counts its waves.

The block and warp forms are also held equal bit for bit on the card in
tests/test_torch_cuda.py and chip_smoke.py.  Run the card's tests there
without the conftest (it imports jax)::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_bell_wide.py
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.io import _native
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.models.mf import init_factors
from recsys_tpu_torch.ops import bell

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

SPECS = {
    "instML100k": lambda: load_problem(str(FIXTURES / "instML100k.in")),
    "hub k30": lambda: checks.hub_spec(30),
    "narrow rows": lambda: generate_instance(120, 90, 8, 1, 45, iters=4, alpha=1e-4, seed=8),
}


def _rows_of(desc, side):
    """{row: (form, unit)} from one side's descriptors, asserting that no
    row is taken twice."""
    taken = {}
    for form, rows in (("warp", desc.narrow), ("block", desc.wide)):
        for base, unit0, b0, n, w, rpw in rows.tolist():
            assert (b0, b0 + n, w) in side.bounds
            for r in range(n):
                assert b0 + r not in taken
                taken[b0 + r] = (form, unit0 + r // rpw)
    return taken


@pytest.mark.parametrize("name", list(SPECS))
def test_side_descriptors_cover_every_row_once(name):
    data = bell.make_bell_inputs(SPECS[name](), np.float64)
    for side in (data.meta.user, data.meta.item):
        widths = sorted({w for *_, w in side.bounds})
        for wide in sorted({1, *widths, *(w + 1 for w in widths), bell.WIDE_MIN, bell.WARP_FORM}):
            desc = bell.side_warps(side, wide)
            taken = _rows_of(desc, side)
            assert sorted(taken) == list(range(side.n_nz))
            for b0, b1, w in side.bounds:
                assert {taken[r][0] for r in range(b0, b1)} == {"block" if w >= wide else "warp"}
            # Units are numbered densely: warps 0..warps-1, blocks 0..blocks-1.
            for form, count in (("warp", desc.warps), ("block", desc.blocks)):
                units = {u for f, u in taken.values() if f == form}
                assert units == set(range(count))
            # Flat bases: each bucket's table follows the one before it.
            bases = sorted(desc.narrow[:, 0].tolist() + desc.wide[:, 0].tolist())
            sizes = [w * (b1 - b0) for b0, b1, w in side.bounds]
            assert bases == list(np.cumsum([0] + sizes[:-1]))


def test_warp_form_alone_is_the_old_descriptors():
    side = bell.make_bell_inputs(SPECS["instML100k"](), np.float64).meta.user
    desc = bell.side_warps(side, bell.WARP_FORM)
    assert desc.blocks == 0 and desc.wide.shape == (0, 6)
    want, warp0, base = [], 0, 0
    for b0, b1, w in side.bounds:
        rpw = max(1, 32 // w)
        want.append((base, warp0, b0, b1 - b0, w, rpw))
        warp0 += -(-(b1 - b0) // rpw)
        base += w * (b1 - b0)
    assert desc.narrow.tolist() == [list(r) for r in want] and desc.warps == warp0


@pytest.mark.parametrize("wide", [1, 64, bell.WARP_FORM])
def test_bell_train_on_cpu_takes_the_threshold(wide):
    spec = checks.hub_spec(30)
    data = bell.make_bell_inputs(spec, np.float64)
    L, R = (torch.from_numpy(x) for x in bell.pad_factors_for_bell(init_factors(spec.users, spec.items, 30),
                                                                      data, np.float64))
    t = bell.device_tables(data.tables, "cpu")
    got = bell.bell_train(L, R, t, 2 * spec.alpha, data.meta, spec.iters, wide=wide)
    st = init_factors(spec.users, spec.items, spec.features)
    want = _native.serial_gd(spec, st.L.copy(), st.R.copy())
    Lo, Ro = bell.unpermute_factors(got[0].numpy(), got[1].numpy(), data)
    assert np.array_equal(Lo, want[0]) and np.array_equal(Ro, want[1])


def test_hub_spec_has_one_row_far_wider_than_the_rest():
    spec = checks.hub_spec(30)
    counts = np.bincount(spec.rows, minlength=spec.users)
    assert counts[0] == 1500 and counts[1:].max() <= 20
    assert np.all(np.diff(spec.rows.astype(np.int64) * spec.items + spec.cols) > 0)
    side = bell.make_bell_inputs(spec, np.float32).meta.user
    assert side.bounds[0] == (0, 1, 1500)


PLAN_SPECS = {
    "instML100k": SPECS["instML100k"],
    "hub k30": SPECS["hub k30"],
    "hub users alone": lambda: checks.hub_spec(30, users=40, items=4000),
}


def _plan_descs(name):
    """Both sides' host descriptors (``side_warps``), the user side first."""
    data = bell.make_bell_inputs(PLAN_SPECS[name](), np.float64)
    return [bell.side_warps(s) for s in (data.meta.user, data.meta.item)]


def _smem(k, size, ch):
    """The block form's shared memory at chunks of ch slots (csrc/bell.cu, wide_smem)."""
    a16 = lambda x: (x + 15) & ~15  # noqa: E731
    kp = (k + 1) & ~1
    return 0 if ch == 0 else a16(k * size) + a16(2 * ch * kp * size) + a16(3 * ch * size) + 4 * 3 * ch


def _residency(k, size, regs_blocks=None):
    """A card's blocks an SM: 228 KB of shared memory (1 KB more a block),
    2048 threads, and the registers' limit a block size (H100-like)."""
    regs_blocks = regs_blocks or {128: 8, 512: 1}

    def resident(threads, ch):
        return min(regs_blocks[threads], 2048 // threads, (228 << 10) // (_smem(k, size, ch) + 1024))
    return resident


def _widths(descs):
    """{(side, block): width} of every block-form row."""
    return {(s, b0 + r): w for s, d in enumerate(descs) for _, b0, _, n, w, _ in d.wide.tolist() for r in range(n)}


@pytest.mark.parametrize("name", list(PLAN_SPECS))
def test_step_order_is_both_sides_block_rows_widest_first(name):
    descs = _plan_descs(name)
    order = bell.step_order(descs)
    widths = _widths(descs)
    got = [(int(o) & 1, int(o) >> 1) for o in order]
    assert order.dtype == np.int32 and sorted(got) == sorted(widths)  # every row once
    w = [widths[g] for g in got]
    assert w == sorted(w, reverse=True)  # widest first
    for s in (0, 1):  # each side's rows keep their own order
        mine = [b for side, b in got if side == s]
        assert mine == sorted(mine)
    if name == "instML100k":
        # The two hub chains start together: the user side's 737 slots, then
        # the item side's widest row before any narrower one.
        assert (max(widths.values()), got[0]) == (737, (0, 0))
        first_item = next(i for i, (s, _) in enumerate(got) if s == 1)
        assert widths[got[first_item]] == 583 and all(x >= 583 for x in w[:first_item])
        assert (descs[0].blocks, descs[1].blocks) == (283, 301)


@pytest.mark.parametrize("name", list(PLAN_SPECS))
def test_step_plan_puts_the_warp_rows_after_the_blocks(name):
    descs = _plan_descs(name)
    plan = bell.step_plan(descs, 30, 8, 132, _residency(30, 8))
    blocks = descs[0].blocks + descs[1].blocks
    assert len(plan.order) == blocks
    assert plan.grid == blocks + -(-(descs[0].warps + descs[1].warps) // (plan.threads // 32))
    assert plan.threads in bell.STEP_THREADS and 1 <= plan.chunk <= plan.threads
    assert plan.resident == _residency(30, 8)(plan.threads, plan.chunk)
    assert plan.waves == bell.waves(plan.grid, 132, plan.resident)


def test_step_plan_fits_instml100k_in_one_wave():
    # 584 rows in blocks and 1,527 warps: 512 threads at one block an SM
    # take 6 waves; 128 threads at eight an SM hold all 966 blocks at once,
    # with the largest chunk that keeps eight an SM.
    descs = _plan_descs("instML100k")
    res = _residency(30, 8)
    plan = bell.step_plan(descs, 30, 8, 132, res)
    assert (plan.threads, plan.grid, plan.resident, plan.waves) == (128, 966, 8, 1)
    assert res(128, plan.chunk) == 8 and res(128, plan.chunk + 1) < 8
    assert bell.waves(584 + -(-1527 // 16), 132, res(512, 136)) == 6


@pytest.mark.parametrize("sms,resident,want", [(132, 8, 1), (132, 7, 2), (132, 1, 8), (66, 8, 2), (1, 1, 966)])
def test_waves_from_a_given_residency(sms, resident, want):
    assert bell.waves(966, sms, resident) == want


def test_step_plan_of_one_side():
    # One side alone (rs_bell_side_update, the sharded engine's delta form):
    # its rows, side 0, in its own order; the same rule of sizes.
    user, _ = _plan_descs("instML100k")
    plan = bell.step_plan([user], 30, 8, 132, _residency(30, 8))
    assert plan.order.tolist() == [b << 1 for b in range(user.blocks)]
    assert plan.grid == user.blocks + -(-user.warps // (plan.threads // 32))
    assert plan.waves == 1


def test_step_plan_prefers_the_larger_block_on_equal_waves_and_the_warp_form_alone():
    descs = _plan_descs("hub k30")  # 4 rows in blocks: one wave either way
    plan = bell.step_plan(descs, 30, 8, 132, _residency(30, 8))
    assert (plan.threads, plan.waves) == (512, 1)
    assert plan.chunk == min(512, bell.ROW_BYTES // (30 * 8))
    # No row in the block form: no chunk, and the warps alone set the grid.
    data = bell.make_bell_inputs(checks.hub_spec(30), np.float64)
    warp = [bell.side_warps(s, bell.WARP_FORM) for s in (data.meta.user, data.meta.item)]
    plan = bell.step_plan(warp, 30, 8, 132, _residency(30, 8))
    assert len(plan.order) == 0 and plan.chunk == 0
    assert plan.grid == -(-(warp[0].warps + warp[1].warps) // (plan.threads // 32))


def test_step_plan_with_no_rows_fitting_one_wave_keeps_the_widest_first():
    # gen-inst1e6-like: a million narrow user rows and 100 item rows of
    # ~20,000 slots at k = 700: no size fits one wave, the hub rows lead.
    user = bell.SideDesc(np.array([[0, 0, 0, 1_000_000, 3, 10]], np.int64), 100_000, np.zeros((0, 6), np.int64), 0)
    item = bell.SideDesc(np.zeros((0, 6), np.int64), 0, np.array([[0, 0, 0, 100, 20_000, 1]], np.int64), 100)
    plan = bell.step_plan([user, item], 700, 8, 132, _residency(700, 8, {128: 2, 512: 1}))
    assert plan.waves > 1 and plan.threads == 512
    assert plan.order.tolist() == [(b << 1) | 1 for b in range(100)]
    assert plan.chunk == bell.ROW_BYTES // (700 * 8)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _no_ratings():
    from recsys_tpu_torch.config import ProblemSpec

    none = np.zeros(0, np.int32)
    return ProblemSpec(iters=4, alpha=1e-4, features=30, users=50, items=70, rows=none, cols=none,
                       vals=np.zeros(0))


FUSED_SPECS = {
    "instML100k": SPECS["instML100k"],
    "hub k30": lambda: checks.hub_spec(30),
    "hub k700": lambda: checks.hub_spec(700, 1),
    # One hub user of 1500 items among 39 of 1 to 20: the user side has a
    # row in the block form, the item side none.
    "item side warps alone": lambda: checks.hub_spec(30, users=40, items=4000),
    "no ratings": _no_ratings,  # neither side has a rated row: nothing to launch
}
STEPS = 20


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(FUSED_SPECS))
def test_fused_step_equals_two_launches_and_twin(name, dtype):
    from recsys_tpu_torch.probes import bell_wide

    dev = _cuda()
    spec = FUSED_SPECS[name]()
    data, L, R, t = bell_wide.tensors(spec, dtype, dev)
    a2, meta = 2.0 * spec.alpha, data.meta
    before = bell.bell_side_update.launches
    fused = bell.bell_train(L, R, t, a2, meta, STEPS)
    launches = bell.bell_side_update.launches - before
    two = bell_wide.two_launch_train(L, R, t, meta, a2, STEPS)
    twin = bell.bell_train_plain(L, R, t, a2, meta, STEPS)
    torch.cuda.synchronize()
    assert launches == (STEPS if spec.nnz else 0)  # one launch a step
    assert checks.same_bits(fused, two)
    assert checks.same_bits(fused, twin)
    if name == "item side warps alone":
        plan = bell.step_launch((meta.user, meta.item), dev, spec.features, dtype)
        assert plan.descs[0].blocks > 0 and plan.descs[1].blocks == 0
        assert set((plan.plan.order & 1).tolist()) == {0}


@pytest.mark.cuda
def test_fused_step_f64_is_the_reference_binary():
    dev = _cuda()
    spec = SPECS["instML100k"]()
    data = bell.make_bell_inputs(spec, np.float64)
    st = init_factors(spec.users, spec.items, spec.features)
    L, R = (torch.from_numpy(x).to(dev) for x in bell.pad_factors_for_bell(st, data, np.float64))
    t = bell.device_tables(data.tables, dev)
    got = bell.bell_train(L, R, t, 2 * spec.alpha, data.meta, STEPS)
    short = dataclasses.replace(spec, iters=STEPS)
    want = _native.serial_gd(short, st.L.copy(), st.R.copy())
    Lo, Ro = bell.unpermute_factors(got[0].cpu().numpy(), got[1].cpu().numpy(), data)
    assert np.array_equal(Lo, want[0]) and np.array_equal(Ro, want[1])


@pytest.mark.cuda
def test_run_counts_the_fused_steps_waves():
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.utils import timing

    dev = _cuda()
    spec = SPECS["instML100k"]()
    out = {}
    with timing.collect_phases(out):
        trainer.run(spec, RunConfig(dtype="float64"), dev)
    data = bell.make_bell_inputs(spec, np.float64)
    plan = bell.step_launch((data.meta.user, data.meta.item), dev, spec.features, torch.float64).plan
    assert timing.record_of(out).counts["bell_waves"] == plan.waves
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan.waves == bell.waves(plan.grid, sms, plan.resident)
    if sms >= 132:  # an H100 holds the whole step at once
        assert plan.waves == 1
