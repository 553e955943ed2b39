"""``bell_side_update``'s block form against its warp form on the card: the
same bits, and which is faster.

    python -m recsys_tpu_torch.probes.bell_wide

Run from the root of a checkout on a machine with a CUDA card.  At
instML100k and at a spec with one hub row far wider than the rest
(``testing.hub_spec``), in f64, f32 and bf16, it holds ``bell_train`` with wide
rows in the block form (``bell.WIDE_MIN``, and a threshold low enough that
every bucket of 16 slots or more takes it) equal bit for bit to the warp
form alone (``bell.WARP_FORM``) and to the plain twin.  Then it times
each side's update and one step of each threshold at instML100k f64, in
turns in one window (CUDA events, medians).  ``chip_smoke.py`` runs the
same at gen-inst1e6's shape.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import bell
from recsys_tpu_torch.utils.timing import alternating_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Thresholds timed at instML100k: the block form from 32, 128 and 512
# slots, and the warp form alone.
SWEEP = (32, 128, 512, bell.WARP_FORM)
LOW = 16  # a threshold that sends every bucket of 16 slots or more to the block form


def tensors(spec, dtype: torch.dtype, device):
    """(data, L, R, device tables) of ``spec`` in ``dtype`` from the glibc init."""
    from recsys_tpu_torch.models.mf import init_factors

    return bell.bell_tensors(spec, init_factors(spec.users, spec.items, spec.features), dtype, device)


def compare(name, L, R, t, meta, alpha2: float, steps: int, *, twin: bool = True) -> dict:
    """``steps`` steps at ``bell.WIDE_MIN`` and at ``LOW`` against the warp
    form alone, and against the twin when ``twin``: {reading: bool}.
    Raises on a failure."""
    warp = bell.bell_train(L, R, t, alpha2, meta, steps, wide=bell.WARP_FORM)
    readings = {}
    for wide in (bell.WIDE_MIN, LOW):
        got = bell.bell_train(L, R, t, alpha2, meta, steps, wide=wide)
        readings[f"wide={wide} = warp form"] = checks.same_bits(got, warp)
        del got
    if twin:
        plain = bell.bell_train_plain(L, R, t, alpha2, meta, steps)
        readings["warp form = twin"] = checks.same_bits(plain, warp)
    torch.cuda.synchronize()
    blocks = [bell.side_warps(s, bell.WIDE_MIN).blocks for s in (meta.user, meta.item)]
    bad = [k for k, v in readings.items() if not v]
    print(f"[probe] bell block vs warp form {name} {L.dtype} {steps} steps (widest "
          f"{max(w for *_, w in meta.user.bounds)}/{max(w for *_, w in meta.item.bounds)} slots, "
          f"{blocks[0]}+{blocks[1]} rows in blocks at wide={bell.WIDE_MIN}): "
          f"{' '.join(f'{k}: {v}' for k, v in readings.items())} {'ok' if not bad else 'FAIL'}", flush=True)
    if bad:
        raise AssertionError(f"bell block vs warp form {name}: {bad}")
    return readings


def step_ms(name, L, R, t, meta, alpha2: float, widths, steps: int = 1, rounds: int = 9) -> dict:
    """{wide: ms per step} of ``steps``-step ``bell_train`` calls at each
    threshold, in turns in one window."""
    fns = {w: (lambda w=w: bell.bell_train(L, R, t, alpha2, meta, steps, wide=w)) for w in widths}
    ms = {w: v / steps for w, v in alternating_ms(fns, rounds).items()}
    for w, v in ms.items():
        label = "warp form alone" if w == bell.WARP_FORM else f"block form from {w} slots"
        print(f"[probe] bell step {name} {L.dtype} {label}: {v!r} ms a step ({steps} steps a call)", flush=True)
    return ms


def side_ms(name, L, R, t, meta, alpha2: float, wide: int = bell.WIDE_MIN, rounds: int = 9) -> dict:
    """{"user", "item": ms} of one side update each at ``wide``, in turns
    in one window: the step's split between the two sides."""
    oL, oR = L.clone(), R.clone()
    fns = {"user": lambda: bell.bell_side_update(L, R, t.ucols, t.uvals, meta.user, alpha2, out=oL, wide=wide),
           "item": lambda: bell.bell_side_update(R, L, t.irows, t.ivals, meta.item, alpha2, out=oR, wide=wide)}
    ms = alternating_ms(fns, rounds)
    print(f"[probe] bell step {name} {L.dtype} by side at wide={wide}: user side {ms['user']!r} ms, item side "
          f"{ms['item']!r} ms", flush=True)
    return ms


def run(device) -> dict:
    """The comparisons at instML100k and the hub spec, then the threshold
    sweep at instML100k f64; returns {wide: ms per step}."""
    from recsys_tpu_torch.io.parser import load_problem

    ml = load_problem(os.path.join(ROOT, "tests", "fixtures", "instML100k.in"))
    for name, spec in (("instML100k", ml), ("hub 300x2000 k30", checks.hub_spec(30)),
                       ("hub 300x2000 k700", checks.hub_spec(700, 1))):
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            data, L, R, t = tensors(spec, dtype, device)
            compare(name, L, R, t, data.meta, 2.0 * spec.alpha, checks.FACTOR_ITERS if spec is ml else spec.iters)
    data, L, R, t = tensors(ml, torch.float64, device)
    side_ms("instML100k", L, R, t, data.meta, 2.0 * ml.alpha)
    return step_ms("instML100k", L, R, t, data.meta, 2.0 * ml.alpha, SWEEP, steps=20)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bell_wide: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi}", flush=True)
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
