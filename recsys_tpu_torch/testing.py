"""How the dense kernels are held against their plain twins: the two
readings, their limits and the controls the limits must reject.  Shared
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the card, and
checked on the CPU by ``tests/test_torch_dense_fused.py`` and
``tests/test_torch_tiled.py``.

Each reading is max |kernel - twin| over max |twin|, across the two
factor tables:

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

from recsys_tpu_torch.ops import dense_fused, dense_tiled

# Set from H100 readings at the instML100k shape (PERF.md, "Tolerances
# from readings"): each limit is 4x or more above the sound readings and
# 4x or more below the controls.  The `default` update limit also leaves
# room for a few bf16 roundings of e that summation order flips (each
# moves one cell's e by 2^-8).
FACTOR_RTOL = {"highest": 1e-6, "bf16x3": 1e-6, "default": 1.5e-5}
UPDATE_RTOL = {"highest": 3e-5, "bf16x3": 5e-6, "default": 5e-3}
# B5's limits, set from H100 readings at the gen-instML1M and
# gen-inst1e6-100-700-1-3 shapes (PERF.md, "Findings"), where its sums over
# K = 704 and over up to 20,000 users per item read larger than the
# limits above allow with 4x room: factor_rel up to 3.9e-7 / 3.9e-7 /
# 6.3e-6 and update_rel up to 8.6e-6 / 6.8e-7 / 1.4e-6 (highest / bf16x3
# / default).  Each limit is 4x or more above those and 4x or more below
# the controls there (factor 1.7e-4; update 0.15, 2.1e-4, 2.1e-4).
TILED_FACTOR_RTOL = {"highest": 2e-6, "bf16x3": 2e-6, "default": 3e-5}
TILED_UPDATE_RTOL = {"highest": 4e-5, "bf16x3": 5e-6, "default": 5e-3}
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


def tiled_probe(spec, a_dtype: torch.dtype, device, *, seed: int = 0, spread: float = 1e-2):
    """``precision_probe``'s inputs in the tiled kernel's layout: (L (U,
    K), R (I, K), A (U, I)) on ``device``, K padded to 32."""
    Lt, Rt, At = precision_probe(spec, a_dtype, "cpu", seed=seed, spread=spread)
    K = dense_fused.round_up(spec.features, dense_tiled.K_ALIGN)
    L, R = torch.zeros((Lt.shape[1], K)), torch.zeros((Rt.shape[1], K))
    L[:, : Lt.shape[0]] = Lt.T
    R[:, : Rt.shape[0]] = Rt.T
    return L.to(device), R.to(device), At.T.contiguous().to(device)
