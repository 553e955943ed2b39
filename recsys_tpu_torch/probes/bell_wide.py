"""The BELL step on the card: its forms hold the same bits, and which is faster.

    python -m recsys_tpu_torch.probes.bell_wide [--big]

Run from the root of a checkout on a machine with a CUDA card.  At
instML100k and at a spec with one hub row far wider than the rest
(``testing.hub_spec``), in f64, f32 and bf16, it holds ``bell_train`` with wide
rows in the block form (``bell.WIDE_MIN``, and a threshold low enough that
every bucket of 16 slots or more takes it) equal bit for bit to the warp
form alone (``bell.WARP_FORM``), to the plain twin, and to the form the
fused step replaced: two launches a step, one a side
(``two_launch_train``).  Then, at instML100k f64, it times the fused step
against the two launches in turns in one window, each side's update alone,
and one step of each threshold (CUDA events, medians).  ``--big`` does the
fused step against the two launches at gen-inst1e6's shape (built in
memory, ~30 s; its factors drawn on the card) in f64 and f32, as
``chip_smoke.py`` does.
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
INST1E6 = "gen-inst1e6-100-700-1-3"


def tensors(spec, dtype: torch.dtype, device):
    """(data, L, R, device tables) of ``spec`` in ``dtype`` from the glibc init."""
    from recsys_tpu_torch.models.mf import init_factors

    return bell.bell_tensors(spec, init_factors(spec.users, spec.items, spec.features), dtype, device)


def side_preps(L, t, meta, wide: int = bell.WIDE_MIN):
    """Each side's launch of its own (``bell.side_prep``), user side first."""
    k = L.shape[1]
    return (bell.side_prep(t.ucols, t.uvals, meta.user, meta.item.size, k, wide),
            bell.side_prep(t.irows, t.ivals, meta.item, meta.user.size, k, wide))


def two_launch_train(L, R, t, meta, alpha2: float, steps: int, preps=None):
    """``steps`` steps as two ``bell_side_update`` launches each, the user
    side and then the item side, each side on its own launch plan
    (``side_preps``): the form the fused step replaced.  The inputs are left
    as they are."""
    pu, pi = side_preps(L, t, meta) if preps is None else preps
    bl, br = [L.clone(), L.clone()], [R.clone(), R.clone()]
    lc, rc = L, R
    for it in range(steps):
        ln, rn = bl[it % 2], br[it % 2]
        bell.bell_side_update(lc, rc, t.ucols, t.uvals, meta.user, alpha2, out=ln, prep=pu)
        bell.bell_side_update(rc, lc, t.irows, t.ivals, meta.item, alpha2, out=rn, prep=pi)
        lc, rc = ln, rn
    return lc, rc


def compare(name, L, R, t, meta, alpha2: float, steps: int, *, twin: bool = True) -> dict:
    """``steps`` steps at ``bell.WIDE_MIN`` and at ``LOW`` against the warp
    form alone, the fused step against two launches a step, and each
    against the twin when ``twin``: {reading: bool}.  Raises on a failure."""
    warp = bell.bell_train(L, R, t, alpha2, meta, steps, wide=bell.WARP_FORM)
    fused = bell.bell_train(L, R, t, alpha2, meta, steps)
    readings = {"fused = two launches": checks.same_bits(fused, two_launch_train(L, R, t, meta, alpha2, steps))}
    for wide in (bell.WIDE_MIN, LOW):
        got = fused if wide == bell.WIDE_MIN else bell.bell_train(L, R, t, alpha2, meta, steps, wide=wide)
        readings[f"wide={wide} = warp form"] = checks.same_bits(got, warp)
        del got
    if twin:
        plain = bell.bell_train_plain(L, R, t, alpha2, meta, steps)
        readings["warp form = twin"] = checks.same_bits(plain, warp)
    torch.cuda.synchronize()
    launch = bell.step_launch((meta.user, meta.item), L.device, L.shape[1], L.dtype)
    plan = launch.plan
    bad = [k for k, v in readings.items() if not v]
    print(f"[probe] bell forms {name} {L.dtype} {steps} steps (widest "
          f"{max(w for *_, w in meta.user.bounds)}/{max(w for *_, w in meta.item.bounds)} slots, "
          f"{launch.descs[0].blocks}+{launch.descs[1].blocks} rows in blocks at wide={bell.WIDE_MIN}; fused step "
          f"{plan.threads} threads, chunks of {plan.chunk} slots, {plan.grid} blocks, {plan.resident} an SM, "
          f"{plan.waves} wave(s)): {' '.join(f'{k}: {v}' for k, v in readings.items())} "
          f"{'ok' if not bad else 'FAIL'}", flush=True)
    if bad:
        raise AssertionError(f"bell forms {name}: {bad}")
    return readings


def fused_ms(name, L, R, t, meta, alpha2: float, steps=(20, 60), rounds: int = 9) -> dict:
    """{"fused", "two launches": ms a step}: the fused step
    (``bell_train``) against two launches a step (``two_launch_train``),
    each as the slope between ``steps`` steps, the calls in turns in one
    window, so the calls' fixed costs (plans, copies) drop out."""
    preps = side_preps(L, t, meta)
    forms = {"fused": lambda n: bell.bell_train(L, R, t, alpha2, meta, n),
             "two launches": lambda n: two_launch_train(L, R, t, meta, alpha2, n, preps)}
    n0, n1 = steps
    ms = alternating_ms({(f, n): (lambda fn=fn, n=n: fn(n)) for f, fn in forms.items() for n in steps}, rounds)
    out = {f: (ms[f, n1] - ms[f, n0]) / (n1 - n0) for f in forms}
    print(f"[probe] bell step {name} {L.dtype}, slope of {n1} against {n0} steps in turns: fused "
          f"{out['fused']!r} ms a step, two launches {out['two launches']!r} ms a step "
          f"({out['fused'] / out['two launches']!r} of it)", flush=True)
    return out


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
    in one window: the two launches' split between the two sides."""
    oL, oR = L.clone(), R.clone()
    pu, pi = side_preps(L, t, meta, wide)
    fns = {"user": lambda: bell.bell_side_update(L, R, t.ucols, t.uvals, meta.user, alpha2, out=oL, prep=pu),
           "item": lambda: bell.bell_side_update(R, L, t.irows, t.ivals, meta.item, alpha2, out=oR, prep=pi)}
    ms = alternating_ms(fns, rounds)
    print(f"[probe] bell step {name} {L.dtype} by side at wide={wide}: user side {ms['user']!r} ms, item side "
          f"{ms['item']!r} ms", flush=True)
    return ms


def run(device) -> dict:
    """The comparisons at instML100k and the hub specs, then at instML100k
    f64 the fused step against two launches and the threshold sweep;
    returns {wide: ms per step, "fused"/"two launches": ms a step}."""
    from recsys_tpu_torch.io.parser import load_problem

    ml = load_problem(os.path.join(ROOT, "tests", "fixtures", "instML100k.in"))
    for name, spec in (("instML100k", ml), ("hub 300x2000 k30", checks.hub_spec(30)),
                       ("hub 300x2000 k700", checks.hub_spec(700, 1))):
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            data, L, R, t = tensors(spec, dtype, device)
            compare(name, L, R, t, data.meta, 2.0 * spec.alpha, checks.FACTOR_ITERS if spec is ml else spec.iters)
    data, L, R, t = tensors(ml, torch.float64, device)
    out = fused_ms("instML100k", L, R, t, data.meta, 2.0 * ml.alpha)
    side_ms("instML100k", L, R, t, data.meta, 2.0 * ml.alpha)
    out.update(step_ms("instML100k", L, R, t, data.meta, 2.0 * ml.alpha, SWEEP, steps=20))
    return out


def big(device, spec=None) -> dict:
    """The fused step against two launches a step at gen-inst1e6's shape
    (``spec``, built here if not given) in f64 and f32, one step's bits
    and the slope of 3 against 1 steps in turns; {dtype: ms a step by
    form}.  The factors are drawn on the card at the glibc init's scale."""
    if spec is None:
        from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

        spec = generate_instance(**GEN_SPECS[INST1E6])
    g = torch.Generator(device=device).manual_seed(0)
    L64, R64 = (torch.rand((n + 1, spec.features), generator=g, dtype=torch.float64, device=device)
                .div_(spec.features) for n in (spec.users, spec.items))
    L64[-1], R64[-1] = 0.0, 0.0
    out, a2 = {}, 2.0 * spec.alpha
    for dtype in (torch.float64, torch.float32):
        data = bell.make_bell_inputs(spec, bell.HOST_DTYPE[dtype])
        t = bell.device_tables(data.tables, device, dtype)
        L, R = L64.to(dtype), R64.to(dtype)
        fused = bell.bell_train(L, R, t, a2, data.meta, 1)
        same = checks.same_bits(fused, two_launch_train(L, R, t, data.meta, a2, 1))
        del fused
        torch.cuda.synchronize()
        plan = bell.step_launch((data.meta.user, data.meta.item), device, spec.features, dtype).plan
        print(f"[probe] bell forms {INST1E6} {dtype} 1 step: fused = two launches: {same} (fused step "
              f"{plan.threads} threads, chunks of {plan.chunk} slots, {plan.grid} blocks, {plan.resident} an SM, "
              f"{plan.waves} waves)", flush=True)
        if not same:
            raise AssertionError(f"bell forms {INST1E6} {dtype}: the fused step differs from two launches")
        out[dtype] = fused_ms(INST1E6, L, R, t, data.meta, a2, steps=(1, 3), rounds=3)
        del L, R, t, data
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bell_wide: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    run(dev)
    if "--big" in argv:
        big(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
