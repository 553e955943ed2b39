"""The BELL kernel's two forms on the CPU: ``bell.side_warps`` gives every
row of every bucket to exactly one warp or one block, at thresholds below,
at and above each bucket's width, and ``bell_train`` takes the threshold
without changing the twin's result.

The forms are held equal bit for bit on the card in tests/test_torch_cuda.py
and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.io import _native
from recsys_tpu_torch.io.generator import generate_instance
from recsys_tpu_torch.io.parser import load_problem
from recsys_tpu_torch.models.mf import init_factors
from recsys_tpu_torch.ops import bell

from helpers import FIXTURES

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
