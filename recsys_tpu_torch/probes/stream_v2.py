"""The H100 counterpart of the TPU probe P3 (``scripts/probe_stream_v2.py``):
does a strip-packed R table change the streamed GD step's time?

    python -m recsys_tpu_torch.probes.stream_v2 [iters]     # default 300

Run from the root of a checkout on a machine with a CUDA card.  It holds
P3's sparse form (``ops/stream_v2.py::stream_v2_train``, B3's sparse walk on
the packed layout) against its twin within ``testing.STREAM_V2_RTOL``, with
the `default` control rejected, and in raw bits against itself (two runs),
its dense form (``stream_v2_train_dense``) and B3 in both forms
(``dense_stream.stream_train`` and ``stream_train_dense``) on the same
factors, ``testing.FACTOR_ITERS`` steps: at the script's small spec
(``check_bitwise``, :143) in every A storage and at k = 40, and at the two
shapes of its ``time_shape`` (:181-193): gen-instML1M (U 6144, I 4096 in 8
strips of 512, K 32) and inst200-10000-50-100-300 (U 256, I 10240 in 20
strips, K 56), int8 A.  Then it times four forms by slope, in turns in one
window (CUDA events, medians; each walk built before the window): B3 dense
("v1 dense", on A^T), B3 sparse ("v1 sparse"), P3 dense ("v2 dense", on A)
and P3 sparse ("v2 sparse"), the time of ``iters`` steps minus that of
``iters // 3`` over the difference.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_fused, dense_stream, dense_tiled, stream_v2
from recsys_tpu_torch.utils.timing import alternating_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STRIP = 512
SMALL_STRIP = 128


def small_spec(features: int = 8):
    """``check_bitwise``'s instance (:143), or the same at ``features``."""
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(40, 700, features, 2, 8, iters=5, alpha=0.01, seed=7)


def shapes() -> dict:
    """The script's two timing instances: gen-instML1M built in memory from
    ``GEN_SPECS``, inst200-10000-50-100-300 from the fixtures."""
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance
    from recsys_tpu_torch.io.parser import load_problem

    return {"gen-instML1M": generate_instance(**GEN_SPECS["gen-instML1M"]),
            "inst200-10000": load_problem(os.path.join(ROOT, "tests", "fixtures", "inst200-10000-50-100-300.in"))}


def inputs(spec, strip: int, device, a_dtype=torch.int8):
    """(Lt, Rt, Rp, A, At) on ``device``: the glibc factors K-major with U
    padded to 128 and I to ``strip``, Rt packed, A (U, I) and A^T (I, U)."""
    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec, i_mult=strip)
    Lt, Rt = torch.from_numpy(Lt).to(device), torch.from_numpy(Rt).to(device)
    A = dense_tiled.device_dense_A(spec, U, I, a_dtype, device)
    At = dense_fused.device_dense_AT(spec, U, I, a_dtype, device)
    return Lt, Rt, stream_v2.pack_R(Rt, strip), A, At


def check(name, spec, strip: int, device, iters: int = checks.FACTOR_ITERS, a_dtype=torch.int8) -> dict:
    """P3's sparse form against its twin (within the limit, control
    rejected), itself (two runs), its dense form and B3's two forms in raw
    bits, ``iters`` steps; returns the readings.  Raises on a failure."""
    Lt, Rt, Rp, A, At = inputs(spec, strip, device, a_dtype)
    K = Lt.shape[0]
    kw = dict(iters=iters, alpha2=2.0 * spec.alpha, strip=strip)
    walk = stream_v2.v2_walk(A, K)
    got = stream_v2.stream_v2_train(Lt, Rp, A, walk=walk, **kw)
    again = stream_v2.stream_v2_train(Lt, Rp, A, walk=walk, **kw)
    dense = stream_v2.stream_v2_train_dense(Lt, Rp, A, **kw)
    twin = stream_v2.stream_v2_train_plain(Lt, Rp, A, **kw)
    ctrl = checks.factor_rel(checks.stream_v2_default(Lt, Rp, A, **kw), twin)
    b3 = dense_stream.stream_train(Lt, Rt, At, iters=iters, alpha2=kw["alpha2"])
    b3d = dense_stream.stream_train_dense(Lt, Rt, At, iters=iters, alpha2=kw["alpha2"])
    torch.cuda.synchronize()
    packed = (lambda f: (f[0], stream_v2.pack_R(f[1], strip)))
    r = {"rel": checks.factor_rel(got, twin), "control": ctrl,
         "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, twin)),
         "dense_max_abs_err": max(float((d - w).abs().max()) for d, w in zip(dense, twin)),
         "two runs same": checks.same_bits(got, again),
         "= dense": checks.same_bits(got, dense),
         "= B3": checks.same_bits(got, packed(b3)) and checks.same_bits(got, packed(b3d)),
         "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    ok = (r["rel"] <= checks.STREAM_V2_RTOL < r["control"] and r["two runs same"] and r["= dense"] and r["= B3"]
          and r["finite"])
    print(f"[probe] P3 {name} ({Lt.shape[1]}x{A.shape[1]} K={K}, {A.shape[1] // strip} strips of {strip}, "
          f"A {str(a_dtype).split('.')[-1]}, {iters} steps): max_abs_err={r['max_abs_err']!r} "
          f"(dense form {r['dense_max_abs_err']!r}) "
          f"factor_rel={r['rel']!r} (limit {checks.STREAM_V2_RTOL}) control (default) {ctrl!r} | raw bits: two runs "
          f"{r['two runs same']} = dense form {r['= dense']} = B3 (sparse, dense) {r['= B3']} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"P3 {name}: {r}")
    return r


def slope(name, spec, iters: int, device, strip: int = STRIP, rounds: int = 5) -> dict:
    """ms per step of B3 on A^T ("v1 dense", "v1 sparse") and P3 on A ("v2
    dense", "v2 sparse") by slope between ``iters`` and ``iters // 3``
    steps, all in turns in one window by CUDA events; the walks are built
    before it."""
    Lt, Rt, Rp, A, At = inputs(spec, strip, device)
    a2, lo = 2.0 * spec.alpha, iters // 3
    v1_walk, v2_walk = dense_stream.stream_walk(At, Lt.shape[0]), stream_v2.v2_walk(A, Lt.shape[0])
    forms = {
        "v1 dense": lambda n: dense_stream.stream_train_dense(Lt, Rt, At, iters=n, alpha2=a2),
        "v1 sparse": lambda n: dense_stream.stream_train(Lt, Rt, At, iters=n, alpha2=a2, walk=v1_walk),
        "v2 dense": lambda n: stream_v2.stream_v2_train_dense(Lt, Rp, A, iters=n, alpha2=a2, strip=strip),
        "v2 sparse": lambda n: stream_v2.stream_v2_train(Lt, Rp, A, iters=n, alpha2=a2, strip=strip, walk=v2_walk),
    }
    ms = alternating_ms({(f, n): (lambda f=f, n=n: forms[f](n)) for f in forms for n in (iters, lo)}, rounds)
    out = {}
    for f in forms:
        out[f] = {"ms": ms[f, iters], "per_step_ms": (ms[f, iters] - ms[f, lo]) / (iters - lo)}
        print(f"[probe] P3 {name} {f}: {ms[f, iters]!r} ms for {iters} steps, slope "
              f"{out[f]['per_step_ms']!r} ms/step ({A.shape[1] // strip} strips; in turns)", flush=True)
    return out


def run(device, iters: int = 300) -> tuple[dict, dict]:
    """The checks at the small spec (every A storage, and k = 40) and both
    shapes, then the slopes; returns ({shape: readings}, {shape: timings})."""
    specs = shapes()
    readings = {"small": check("small 40x700 k8", small_spec(), SMALL_STRIP, device)}
    for a_dtype in (torch.bfloat16, torch.float32):
        check("small 40x700 k8", small_spec(), SMALL_STRIP, device, a_dtype=a_dtype)
    check("small 40x700 k40", small_spec(40), SMALL_STRIP, device)
    for name, spec in specs.items():
        readings[name] = check(name, dataclasses.replace(spec, iters=checks.FACTOR_ITERS), STRIP, device)
    return readings, {name: slope(name, spec, iters, device) for name, spec in specs.items()}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    iters = int(args[0]) if args else 300
    if not torch.cuda.is_available():
        raise SystemExit("stream_v2: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[probe] {smi} | iters={iters}", flush=True)
    run(torch.device("cuda", 0), iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
