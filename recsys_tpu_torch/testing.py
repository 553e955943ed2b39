"""How the fused dense kernel is held against its plain twin: the two
readings, their limits and the controls the limits must reject.  Shared
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card, and
checked on the CPU by ``tests/test_torch_dense_fused.py``.

Each reading is max |kernel - twin| over max |twin|, across Lt and Rt:

``factor_rel``
    The factors after 20 GD steps on real ratings.  Kernel and twin sum
    in f32 in different orders, and in ``default`` that difference can
    flip a bf16 rounding of e.  ``bf16x3`` and ``highest`` agree to f32
    noise here, so this reading cannot tell them apart.
``update_rel`` on ``precision_probe`` inputs
    One step from near-fit factors: every rating is 4 and every
    prediction is 4 within about 1%, so e = a - pred loses two digits to
    cancellation and shows the contraction's rounding about 100x larger.
    The reading compares the updates (out - in).  There the three modes
    lie orders of magnitude apart.

A limit sits between the sound readings (kernel and twin in one mode)
and the controls (kernel in one mode, twin in another), with room on
both sides.  A control stands for a kernel that skips the bf16 rounding
of ``default`` or the split of ``bf16x3``, or drops ``highest`` to split
products, and must exceed the limit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from recsys_tpu_torch.ops import dense_fused

# Set from H100 readings at the instML100k shape (PERF.md, "Tolerances
# from readings"): each limit is 4x or more above the sound readings and
# 4x or more below the controls.  The `default` update limit also leaves
# room for a few bf16 roundings of e that summation order flips (each
# moves one cell's e by 2^-8).
FACTOR_RTOL = {"highest": 1e-6, "bf16x3": 1e-6, "default": 1.5e-5}
UPDATE_RTOL = {"highest": 3e-5, "bf16x3": 5e-6, "default": 5e-3}
# (kernel precision, twin precision): readings that must exceed the twin
# precision's limit.
FACTOR_CONTROLS = (("highest", "default"),)
UPDATE_CONTROLS = (("highest", "default"), ("highest", "bf16x3"), ("bf16x3", "highest"))
# Steps of the factor reading; the probe takes one step of this size.
FACTOR_ITERS = 20
PROBE_ALPHA2 = 1.0


def factor_rel(got, want) -> float:
    """max |got - want| over max |want|, across the (Lt, Rt) of two
    ``resident_train_top1`` results (or any two pairs of tensors)."""
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got[:2], want[:2]))
    return err / max(float(w.abs().max()) for w in want[:2])


def update_rel(got, want, Lt, Rt) -> float:
    """``factor_rel`` of the updates: each result minus the inputs (Lt, Rt)."""
    lt, rt = Lt.double(), Rt.double()
    return factor_rel((got[0].double() - lt, got[1].double() - rt), (want[0].double() - lt, want[1].double() - rt))


def precision_probe(spec, a_dtype: torch.dtype, device, *, seed: int = 0, spread: float = 1e-2):
    """(Lt, Rt, At) on ``device`` in ``spec``'s padded shape and rating
    pattern, with every rating 4 and factors s * (1 + spread * N(0, 1)),
    k * s^2 = 4: every prediction is 4 within about ``spread``."""
    r = dense_fused.round_up
    U, I, K = r(spec.users, 128), r(spec.items, 128), r(spec.features, 8)
    At =dense_fused.device_dense_AT(dataclasses.replace(spec, vals=np.full_like(spec.vals, 4.0)),
                                     U, I, a_dtype, device)
    g = torch.Generator().manual_seed(seed)
    k, s = spec.features, (4.0 / spec.features) ** 0.5
    Lt, Rt = torch.zeros((K, U)), torch.zeros((K, I))
    Lt[:k, : spec.users] = s * (1 + spread * torch.randn((k, spec.users), generator=g))
    Rt[:k, : spec.items] = s * (1 + spread * torch.randn((k, spec.items), generator=g))
    return Lt.to(device), Rt.to(device), At
