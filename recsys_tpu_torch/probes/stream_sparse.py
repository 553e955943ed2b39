"""B3's sparse form against its dense form on the card: the same bits, and
which is faster.

    python -m recsys_tpu_torch.probes.stream_sparse [iters]     # default 20

Run from the root of a checkout on a machine with a CUDA card.  At the
small spec (int8, bf16 and f32 A), at a spec with k > 32 (G > 1) and at
gen-instML1M's shape (built in memory from ``GEN_SPECS``) it holds
``dense_stream.stream_train`` (the sparse walk, the engine's form) equal
bit for bit to ``stream_train_dense`` (every cell of each A^T tile) after
``iters`` steps in every precision, and within ``testing.py``'s factor
limit of the plain twin.  Then it times the two forms at gen-instML1M in
`highest`, in turns in one window (dense, sparse, sparse, dense, ...; CUDA
events, medians), at 3 * n and n steps, and prints each form's slope in
us per step.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_fused, dense_stream
from recsys_tpu_torch.utils.timing import alternating_ms

MODES = ("highest", "bf16x3", "default")
# Steps of the slope: the form's time at 3 * SLOPE_STEPS minus at
# SLOPE_STEPS, over the difference.
SLOPE_STEPS = 200


def small_spec(features: int = 10):
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(200, 300, features, 2, 30, iters=checks.FACTOR_ITERS, alpha=0.001, seed=5)


def ml1m_spec():
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    return generate_instance(**GEN_SPECS["gen-instML1M"])


def inputs(spec, device, a_dtype=torch.int8):
    """(Lt, Rt, At) of the stream plan on ``device``: the glibc factors,
    padded."""
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, device)
    return torch.from_numpy(Lt).to(device), torch.from_numpy(Rt).to(device), At


def check(name, spec, device, iters: int, a_dtype=torch.int8) -> dict:
    """Both forms after ``iters`` steps in every precision: {precision:
    (= dense bit for bit, factor_rel against the twin, max abs error against
    the twin)}.  Raises on a failure."""
    Lt, Rt, At = inputs(spec, device, a_dtype)
    out, failed = {}, []
    for precision in MODES:
        kw = dict(iters=iters, alpha2=2.0 * spec.alpha, precision=precision)
        sparse = dense_stream.stream_train(Lt, Rt, At, **kw)
        dense = dense_stream.stream_train_dense(Lt, Rt, At, **kw)
        twin = dense_stream.stream_train_plain(Lt, Rt, At, **kw)
        torch.cuda.synchronize()
        same = checks.same_bits(sparse, dense)
        rel = checks.factor_rel(sparse, twin)
        err = max(float((s - w).abs().max()) for s, w in zip(sparse, twin))
        ok = same and rel <= checks.FACTOR_RTOL[precision]
        print(f"[probe] B3 sparse vs dense {name} ({Lt.shape[1]}x{At.shape[0]} K={Lt.shape[0]}, "
              f"A {str(a_dtype).split('.')[-1]}, {iters} steps) {precision:7s}: = dense bit for bit {same} | "
              f"factor_rel {rel!r} (limit {checks.FACTOR_RTOL[precision]}) max_abs_err {err!r} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        out[precision] = (same, rel, err)
        if not ok:
            failed.append(precision)
    if failed:
        raise AssertionError(f"B3 sparse vs dense {name}: {failed}")
    return out


def slopes(spec, device, n: int = SLOPE_STEPS, rounds: int = 5) -> dict:
    """{form: {"ms": ms at 3n steps, "us_per_step": slope}} in `highest`,
    the two forms and two step counts in turns in one window."""
    Lt, Rt, At = inputs(spec, device)
    a2 = 2.0 * spec.alpha
    forms = {"dense": dense_stream.stream_train_dense, "sparse": dense_stream.stream_train}
    fns = {(form, m): (lambda f=f, m=m: f(Lt, Rt, At, iters=m, alpha2=a2))
           for form, f in forms.items() for m in (3 * n, n)}
    ms = alternating_ms(fns, rounds)
    out = {}
    for form in forms:
        out[form] = {"ms": ms[form, 3 * n], "us_per_step": (ms[form, 3 * n] - ms[form, n]) / (2 * n) * 1e3}
        print(f"[probe] B3 {form} form at gen-instML1M: {ms[form, 3 * n]!r} ms for {3 * n} steps, "
              f"{ms[form, n]!r} ms for {n}; slope {out[form]['us_per_step']!r} us/step", flush=True)
    print(f"[probe] B3 dense / sparse slope: {out['dense']['us_per_step'] / out['sparse']['us_per_step']!r}x",
          flush=True)
    return out


def run(device, iters: int = checks.FACTOR_ITERS) -> tuple[dict, dict]:
    """The checks at the small specs and gen-instML1M's shape, then the
    slopes; returns ({spec: readings}, {form: timings})."""
    readings = {}
    for a_dtype in (torch.int8, torch.bfloat16, torch.float32):
        readings[f"small {a_dtype}"] = check("small 200x300 k10", small_spec(), device, iters, a_dtype)
    readings["small k40"] = check("small 200x300 k40", small_spec(40), device, iters)
    ml1m = ml1m_spec()
    readings["gen-instML1M"] = check("gen-instML1M", dataclasses.replace(ml1m, iters=iters), device, iters)
    return readings, slopes(ml1m, device)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    iters = int(args[0]) if args else checks.FACTOR_ITERS
    if not torch.cuda.is_available():
        raise SystemExit("stream_sparse: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi} | iters={iters}", flush=True)
    run(torch.device("cuda", 0), iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
