"""B1's and B2's sparse form against their dense form on the card: the same
bits, and which form is faster.

    python -m recsys_tpu_torch.probes.resident_sparse [iters]     # default 20

Run from the root of a checkout on a machine with a CUDA card.  At the
small spec (int8, bf16 and f32 A), at k = 40 and 64 (G = 2) and at the
instML100k and gen-instML1M shapes it holds ``dense_fused.resident_train_top1``
in both sparse forms (the persistent kernel, the engine's, and the loop of
two launches a step) and ``resident_train`` equal bit for bit (raw bits)
to ``resident_train_top1_dense`` after ``iters`` steps in every precision,
the top-1 equal, and within ``testing.py``'s factor limit of the plain
twin.  Then it times, in turns in one window (CUDA events, medians), at
3 * n and n steps, and prints each slope in us per step:

* instML100k in every precision: the dense form, the loop and the
  persistent kernel (n = 1000);
* the resident/stream line: the engine's resident form against B3's
  sparse ``stream_train`` at instML100k (n = 1000) and gen-instML1M
  (n = 200), in `highest`.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_fused, dense_stream
from recsys_tpu_torch.utils.timing import alternating_ms

MODES = ("highest", "bf16x3", "default")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ML100K = os.path.join(ROOT, "tests", "fixtures", "instML100k.in")
# Steps of the slopes: a form's time at 3 * n minus at n, over 2 * n.
ML100K_STEPS, ML1M_STEPS = 1000, 200


def small_spec(features: int = 10):
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(200, 300, features, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)


def ml100k_spec():
    from recsys_tpu_torch.io.parser import load_problem

    return load_problem(ML100K)


def ml1m_spec():
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    return generate_instance(**GEN_SPECS["gen-instML1M"])


def inputs(spec, device, a_dtype=torch.int8):
    """(Lt, Rt, At) of the resident plan on ``device``: the glibc factors, padded."""
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, device)
    return torch.from_numpy(Lt).to(device), torch.from_numpy(Rt).to(device), At


def check(name, spec, device, iters: int, a_dtype=torch.int8) -> dict:
    """Every form after ``iters`` steps in every precision: {precision:
    (all equal to the dense form bit for bit, factor_rel against the twin,
    max abs error against the twin)}.  Raises on a failure."""
    Lt, Rt, At = inputs(spec, device, a_dtype)
    walk = dense_fused.resident_walk(At, Lt.shape[0])
    out, failed = {}, []
    for precision in MODES:
        kw = dict(iters=iters, alpha2=2.0 * spec.alpha, precision=precision)
        top = dict(items_true=spec.items)
        dense = dense_fused.resident_train_top1_dense(Lt, Rt, At, **kw, **top)
        persistent = dense_fused.resident_train_top1(Lt, Rt, At, **kw, **top, walk=walk, form="persistent")
        loop = dense_fused.resident_train_top1(Lt, Rt, At, **kw, **top, walk=walk, form="loop")
        b2 = dense_fused.resident_train(Lt, Rt, At, **kw, walk=walk)
        b2_dense = dense_fused.resident_train_dense(Lt, Rt, At, **kw)
        twin = dense_fused.resident_train_plain(Lt, Rt, At, **kw)
        torch.cuda.synchronize()
        same = {
            "persistent": checks.same_bits(persistent[:2], dense[:2]) and torch.equal(persistent[2], dense[2]),
            "loop": checks.same_bits(loop[:2], dense[:2]) and torch.equal(loop[2], dense[2]),
            "B2": checks.same_bits(b2, dense[:2]),
            "B2 dense": checks.same_bits(b2_dense, dense[:2]),
        }
        rel = checks.factor_rel(persistent[:2], twin)
        err = max(float((s - w).abs().max()) for s, w in zip(persistent[:2], twin))
        derr = max(float((s - w).abs().max()) for s, w in zip(dense[:2], twin))
        ok = all(same.values()) and rel <= checks.FACTOR_RTOL[precision]
        print(f"[probe] B1/B2 sparse vs dense {name} ({Lt.shape[1]}x{At.shape[0]} K={Lt.shape[0]}, "
              f"A {str(a_dtype).split('.')[-1]}, {iters} steps) {precision:7s}: = dense bit for bit {same} | "
              f"factor_rel {rel!r} (limit {checks.FACTOR_RTOL[precision]}) max_abs_err {err!r} "
              f"(dense form {derr!r}) {'ok' if ok else 'FAIL'}", flush=True)
        out[precision] = (all(same.values()), rel, err, derr)
        if not ok:
            failed.append(precision)
    if failed:
        raise AssertionError(f"B1/B2 sparse vs dense {name}: {failed}")
    return out


def _slopes(fns: dict, n: int, rounds: int) -> dict:
    """{form: {"ms": ms at 3n steps, "us_per_step": slope}}, the forms and
    step counts of ``fns`` ({form: f(iters)}) in turns in one window."""
    calls = {(form, m): (lambda f=f, m=m: f(m)) for form, f in fns.items() for m in (3 * n, n)}
    ms = alternating_ms(calls, rounds)
    return {form: {"ms": ms[form, 3 * n], "ms_n": ms[form, n],
                   "us_per_step": (ms[form, 3 * n] - ms[form, n]) / (2 * n) * 1e3} for form in fns}


def form_slopes(spec, device, precision: str, n: int = ML100K_STEPS, rounds: int = 5) -> dict:
    """The dense form, the loop and the persistent kernel of B1 at
    ``spec``'s shape in ``precision``, in turns."""
    Lt, Rt, At = inputs(spec, device)
    walk = dense_fused.resident_walk(At, Lt.shape[0])
    kw = dict(alpha2=2.0 * spec.alpha, precision=precision, items_true=spec.items)
    fns = {
        "dense": lambda m: dense_fused.resident_train_top1_dense(Lt, Rt, At, iters=m, **kw),
        "loop": lambda m: dense_fused.resident_train_top1(Lt, Rt, At, iters=m, walk=walk, form="loop", **kw),
        "persistent": lambda m: dense_fused.resident_train_top1(Lt, Rt, At, iters=m, walk=walk,
                                                                form="persistent", **kw),
    }
    out = _slopes(fns, n, rounds)
    for form, r in out.items():
        print(f"[probe] B1 {form} form at instML100k {precision}: {r['ms']!r} ms for {3 * n} steps, "
              f"{r['ms_n']!r} ms for {n}; slope {r['us_per_step']!r} us/step", flush=True)
    return out


def plan_slopes(name, spec, device, n: int, rounds: int = 5) -> dict:
    """The resident/stream line: the engine's resident form (B2's steps) and
    B3's sparse ``stream_train`` at ``spec``'s shape in `highest`, each with
    its walk built ahead as the engine builds it, in turns."""
    Lt, Rt, At = inputs(spec, device)
    K = Lt.shape[0]
    rw, sw = dense_fused.resident_walk(At, K), dense_stream.stream_walk(At, K)
    a2 = 2.0 * spec.alpha
    fns = {"resident": lambda m: dense_fused.resident_train(Lt, Rt, At, iters=m, alpha2=a2, walk=rw),
           "stream": lambda m: dense_stream.stream_train(Lt, Rt, At, iters=m, alpha2=a2, walk=sw)}
    out = _slopes(fns, n, rounds)
    for plan, r in out.items():
        print(f"[probe] {name} {plan} plan (sparse forms): {r['ms']!r} ms for {3 * n} steps, {r['ms_n']!r} ms "
              f"for {n}; slope {r['us_per_step']!r} us/step", flush=True)
    return out


def run(device, iters: int = checks.FACTOR_ITERS) -> tuple[dict, dict]:
    """The checks, then the slopes; returns ({spec: readings}, {name: slopes})."""
    readings = {}
    for a_dtype in (torch.int8, torch.bfloat16, torch.float32):
        readings[f"small {a_dtype}"] = check("small 200x300 k10", small_spec(), device, iters, a_dtype)
    for k in (40, 64):
        readings[f"small k{k}"] = check(f"small 200x300 k{k}", small_spec(k), device, iters)
    ml100k, ml1m = ml100k_spec(), ml1m_spec()
    for name, spec in (("instML100k", ml100k), ("gen-instML1M", ml1m)):
        readings[name] = check(name, dataclasses.replace(spec, iters=iters), device, iters)
    slopes = {f"instML100k {p}": form_slopes(ml100k, device, p) for p in MODES}
    slopes["plans instML100k"] = plan_slopes("instML100k", ml100k, device, ML100K_STEPS)
    slopes["plans gen-instML1M"] = plan_slopes("gen-instML1M", ml1m, device, ML1M_STEPS)
    return readings, slopes


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    iters = int(args[0]) if args else checks.FACTOR_ITERS
    if not torch.cuda.is_available():
        raise SystemExit("resident_sparse: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi} | iters={iters}", flush=True)
    run(torch.device("cuda", 0), iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
