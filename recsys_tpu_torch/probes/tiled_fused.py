"""B5's fused step against the composition it replaced on the card: the same
bits, and which is faster.

    python -m recsys_tpu_torch.probes.tiled_fused [iters]     # default 20

Run from the root of a checkout on a machine with a CUDA card.  The
composition is ``dense_tiled.tiled_train_deltas``: B5's raw deltas
(``tiled_deltas``) and the torch update ``_apply`` each step, as the
engine ran the tiled plan before the fused step.  At the small spec (k =
10, 700 and 1000), the gen-instML1M shape and the gen-inst1e6-100-700-1-3
shape (built in memory: ~15 s and ~10 GB of host memory), in every
precision and A storage (int8, bf16, f32), it holds ``tiled_train`` after
``iters`` steps, in each form of the L pass that fits the shape (``warp``
and ``ring``), equal to the composition in raw bits, equal to itself on a
second run, within ``testing.TILED_FACTOR_RTOL`` of the plain twin, and
the caller's L and R unchanged, and B5's raw deltas against the twin's at
gen-inst1e6's shape.  Then it times, in turns in one window
(CUDA events, medians), ``tiled_train`` in each form against the
composition at 3 * n and n steps, and prints each slope: ms per step at
gen-inst1e6 (n = 5) and us per step at gen-instML1M tiled (n = 200); and
the seconds ``tiled_train`` takes to make its buffers at gen-inst1e6, fresh
and from the allocator's cache.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_tiled
from recsys_tpu_torch.utils.timing import alternating_ms

MODES = ("highest", "bf16x3", "default")
STORAGES = (torch.int8, torch.bfloat16, torch.float32)
INST1E6 = "gen-inst1e6-100-700-1-3"
# Steps of the slopes: a form's time at 3 * n minus at n, over 2 * n.
INST1E6_STEPS, ML1M_STEPS = 5, 200
BASELINE = "deltas+apply"


def small_spec(features: int = 10):
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(200, 300, features, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)


def gen_spec(name: str):
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    return generate_instance(**GEN_SPECS[name])


def factors(spec, device):
    """(L, R) of the tiled plan on ``device``: the glibc factors, padded."""
    L, R, _ = dense_tiled.pad_factors_lane_major(spec)
    return torch.from_numpy(L).to(device), torch.from_numpy(R).to(device)


def forms_for(L, R, A) -> tuple[str, ...]:
    """The L pass's forms that take this shape: ``warp`` always, ``ring``
    where its stages fit a block's shared memory."""
    fits = dense_tiled.ring_bytes(L.shape[1], R.shape[0], A.dtype) <= dense_tiled._SMEM_MAX
    return ("warp", "ring") if fits else ("warp",)


def check(name, spec, device, iters: int = checks.FACTOR_ITERS, LR=None) -> dict:
    """Every form after ``iters`` steps in every precision and A storage:
    {(storage, precision): {"same": ..., "rel": factor_rel against the
    twin, "max_abs_err": against the twin}}.  Raises on a failure."""
    L, R = LR if LR is not None else factors(spec, device)
    L0, R0 = L.clone(), R.clone()
    U, I = L.shape[0], R.shape[0]
    out, failed = {}, []
    for a_dtype in STORAGES:
        A = dense_tiled.device_dense_A(spec, U, I, a_dtype, device)
        forms = forms_for(L, R, A)
        storage = str(a_dtype).split(".")[-1]
        for precision in MODES:
            kw = dict(iters=iters, alpha2=2.0 * spec.alpha, precision=precision)
            base = dense_tiled.tiled_train_deltas(L, R, A, **kw)
            fused = {form: dense_tiled.tiled_train(L, R, A, form=form, **kw) for form in forms}
            again = dense_tiled.tiled_train(L, R, A, form=forms[-1], **kw)
            twin = dense_tiled.tiled_train_plain(L, R, A, **kw)
            torch.cuda.synchronize()
            same = {form: checks.same_bits(got, base) for form, got in fused.items()}
            same["two runs"] = checks.same_bits(again, fused[forms[-1]])
            kept = torch.equal(L, L0) and torch.equal(R, R0)
            rel = checks.factor_rel(fused[forms[-1]], twin)
            err = max(float((g - w).abs().max()) for g, w in zip(fused[forms[-1]], twin))
            ok = all(same.values()) and kept and rel <= checks.TILED_FACTOR_RTOL[precision]
            print(f"[probe] B5 fused vs deltas+apply {name} (U={U} I={I} K={L.shape[1]}, A {storage}, {iters} "
                  f"steps) {precision:7s}: = composition bit for bit {same} | inputs unchanged {kept} | factor_rel "
                  f"{rel!r} (limit {checks.TILED_FACTOR_RTOL[precision]}) max_abs_err {err!r} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            out[storage, precision] = {"same": all(same.values()), "rel": rel, "max_abs_err": err}
            if not ok:
                failed.append(f"{storage} {precision}")
            del base, fused, again, twin
        del A
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"B5 fused vs deltas+apply {name}: {failed}")
    return out


def deltas_err(name, spec, device, LR) -> float:
    """B5's raw deltas (``tiled_deltas``) against the twin's on the tiled
    plan's inputs in `highest`, one step: max |kernel - twin| over dL and
    dR."""
    from recsys_tpu_torch.engine import trainer

    plan = trainer.dense_plan(spec, tiled=True)
    A = dense_tiled.device_dense_A(spec, plan.U, plan.I, plan.a_dtype, device)
    got, want = dense_tiled.tiled_deltas(*LR, A), dense_tiled.tiled_deltas_plain(*LR, A)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = checks.factor_rel(got, want)
    print(f"[probe] B5 raw deltas vs the twin's at {name} (highest, one step): max_abs_err {err!r}, "
          f"relative to the largest delta {rel!r}", flush=True)
    del A, got, want
    torch.cuda.empty_cache()
    return err


def slopes(name, spec, device, n: int, rounds: int = 5, LR=None, unit: str = "ms") -> dict:
    """``tiled_train`` in each form and the composition at ``spec``'s shape
    (tiled plan's A storage, `highest`) in turns: {form: {"ms": ms at 3n
    steps, "ms_n": at n, "per_step": slope in ``unit``}}."""
    from recsys_tpu_torch.engine import trainer

    plan = trainer.dense_plan(spec, tiled=True)
    L, R = LR if LR is not None else factors(spec, device)
    A = dense_tiled.device_dense_A(spec, plan.U, plan.I, plan.a_dtype, device)
    kw = dict(alpha2=2.0 * spec.alpha)
    fns = {BASELINE: lambda m: dense_tiled.tiled_train_deltas(L, R, A, iters=m, **kw)}
    for form in forms_for(L, R, A):
        fns[form] = lambda m, form=form: dense_tiled.tiled_train(L, R, A, iters=m, form=form, **kw)
    auto = dense_tiled.step_form(plan.K, plan.I, plan.a_dtype)
    calls = {(form, m): (lambda f=f, m=m: f(m)) for form, f in fns.items() for m in (3 * n, n)}
    ms = alternating_ms(calls, rounds)
    scale = 1.0 if unit == "ms" else 1e3
    out = {form: {"ms": ms[form, 3 * n], "ms_n": ms[form, n],
                  "per_step": (ms[form, 3 * n] - ms[form, n]) / (2 * n) * scale} for form in fns}
    for form, r in out.items():
        print(f"[probe] B5 step {form}{' (auto)' if form == auto else ''} at {name}: {r['ms']!r} ms for {3 * n} "
              f"steps, {r['ms_n']!r} ms for {n}; slope {r['per_step']!r} {unit}/step", flush=True)
    out["auto"] = out[auto]
    del L, R, A
    torch.cuda.empty_cache()
    return out


def buffer_seconds(name, LR, A, device) -> tuple[float, float]:
    """Seconds to make ``tiled_train``'s buffers (``train_buffers``) with
    the allocator's cache emptied first, then again from its cache."""
    out = []
    for fresh in (True, False):
        if fresh:
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bufs = dense_tiled.train_buffers(*LR, A, 10)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        del bufs
    print(f"[probe] tiled_train's buffers at {name}: {out[0]!r} s with the allocator's cache emptied, {out[1]!r} s "
          f"from its cache", flush=True)
    return out[0], out[1]


def run(device, iters: int = checks.FACTOR_ITERS, big=None) -> tuple[dict, dict]:
    """The checks, then the slopes; ``big`` is gen-inst1e6's spec, built
    here if not given.  Returns ({shape: readings, "deltas": B5's raw
    deltas' max abs error}, {shape: slopes, "buffers": ``buffer_seconds``})."""
    readings = {}
    for k in (10, 700, 1000):
        readings[f"small k{k}"] = check(f"small 200x300 k{k}", small_spec(k), device, iters)
    ml1m = gen_spec("gen-instML1M")
    readings["gen-instML1M"] = check("gen-instML1M", dataclasses.replace(ml1m, iters=iters), device, iters)
    if big is None:
        big = gen_spec(INST1E6)
    t0 = time.perf_counter()
    LR = factors(big, device)
    print(f"[probe] {INST1E6} factors on the card in {time.perf_counter() - t0!r} s", flush=True)
    readings[INST1E6] = check(INST1E6, dataclasses.replace(big, iters=iters), device, iters, LR=LR)
    readings["deltas"] = deltas_err(INST1E6, big, device, LR)
    times = {INST1E6: slopes(INST1E6, big, device, INST1E6_STEPS, LR=LR)}
    plan_A = dense_tiled.device_dense_A(big, LR[0].shape[0], LR[1].shape[0], torch.int8, device)
    times["buffers"] = buffer_seconds(INST1E6, LR, plan_A, device)
    del plan_A
    del LR
    torch.cuda.empty_cache()
    times["gen-instML1M"] = slopes("gen-instML1M", ml1m, device, ML1M_STEPS, unit="us")
    return readings, times


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    iters = int(args[0]) if args else checks.FACTOR_ITERS
    if not torch.cuda.is_available():
        raise SystemExit("tiled_fused: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi} | iters={iters}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    run(torch.device("cuda", 0), iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
