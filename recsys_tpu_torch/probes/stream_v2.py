"""The H100 counterpart of the TPU probe P3 (``scripts/probe_stream_v2.py``):
does a strip-packed R table change the streamed GD step's time?

    python -m recsys_tpu_torch.probes.stream_v2 [iters]     # default 300

Run from the root of a checkout on a machine with a CUDA card.  It holds
P3 (``ops/stream_v2.py``) against its twin within
``testing.STREAM_V2_RTOL``, with the `default` control rejected, and
against B3's dense form (``dense_stream.stream_train_dense``, which the
engine's sparse form equals bit for bit) on the same factors bit for bit:
P3 sums in B3's order, so this replaces the script's bitwise v1 = v2 check,
which its drivers no longer run.  Then it times "v1 stream" (B3 on A^T)
against "v2 packed" (P3 on A) by slope, the time of ``iters`` steps (CUDA
events) minus that of ``iters // 3`` over the difference, at the shapes of the
script's ``time_shape`` (:181-193): gen-instML1M (U 6144, I 4096 in 8
strips of 512, K 32) and inst200-10000-50-100-300 (U 256, I 10240 in 20
strips, K 56), int8 A.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import torch

from recsys_tpu_torch import testing as checks
from recsys_tpu_torch.ops import dense_fused, dense_stream, dense_tiled, stream_v2
from recsys_tpu_torch.utils.timing import cuda_event_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STRIP = 512
SMALL_STRIP = 128


def small_spec():
    """``check_bitwise``'s instance (:143)."""
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(40, 700, 8, 2, 8, iters=5, alpha=0.01, seed=7)


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
    """P3 against its twin (within the limit, control rejected), two runs
    and against B3 bit for bit, ``iters`` steps; returns the readings.
    Raises on a failure."""
    Lt, Rt, Rp, A, At = inputs(spec, strip, device, a_dtype)
    kw = dict(iters=iters, alpha2=2.0 * spec.alpha, strip=strip)
    got = stream_v2.stream_v2_train(Lt, Rp, A, **kw)
    again = stream_v2.stream_v2_train(Lt, Rp, A, **kw)
    twin = stream_v2.stream_v2_train_plain(Lt, Rp, A, **kw)
    ctrl = checks.factor_rel(checks.stream_v2_default(Lt, Rp, A, **kw), twin)
    b3 = dense_stream.stream_train_dense(Lt, Rt, At, iters=iters, alpha2=kw["alpha2"])
    K = Lt.shape[0]
    r = {"rel": checks.factor_rel(got, twin), "control": ctrl,
         "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, twin)),
         "two runs same": all(torch.equal(g, a) for g, a in zip(got, again)),
         "= B3": torch.equal(got[0], b3[0]) and torch.equal(stream_v2.unpack_R(got[1], K), b3[1]),
         "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    ok = (r["rel"] <= checks.STREAM_V2_RTOL < r["control"] and r["two runs same"] and r["= B3"] and r["finite"])
    print(f"[probe] P3 {name} ({Lt.shape[1]}x{A.shape[1]} K={K}, {A.shape[1] // strip} strips of {strip}, "
          f"A {str(a_dtype).split('.')[-1]}, {iters} steps): max_abs_err={r['max_abs_err']!r} "
          f"factor_rel={r['rel']!r} (limit {checks.STREAM_V2_RTOL}) control (default) {ctrl!r} | two runs same "
          f"{r['two runs same']} = B3 bit for bit {r['= B3']} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"P3 {name}: {r}")
    return r


def slope(name, spec, iters: int, device, strip: int = STRIP) -> dict:
    """ms per step of B3 on A^T ("v1 stream") and P3 on A ("v2 packed") by
    slope between ``iters`` and ``iters // 3`` steps, by CUDA events."""
    Lt, Rt, Rp, A, At = inputs(spec, strip, device)
    a2, lo = 2.0 * spec.alpha, iters // 3
    variants = {
        "v1 stream": lambda n: dense_stream.stream_train_dense(Lt, Rt, At, iters=n, alpha2=a2),
        "v2 packed": lambda n: stream_v2.stream_v2_train(Lt, Rp, A, iters=n, alpha2=a2, strip=strip),
    }
    out = {}
    for vname, fn in variants.items():
        hi_ms, lo_ms = cuda_event_ms(lambda: fn(iters), 2), cuda_event_ms(lambda: fn(lo), 2)
        out[vname] = {"ms": hi_ms, "per_step_ms": (hi_ms - lo_ms) / (iters - lo)}
        print(f"[probe] P3 {name} {vname}: {hi_ms!r} ms for {iters} steps, slope "
              f"{out[vname]['per_step_ms']!r} ms/step ({A.shape[1] // strip} strips)", flush=True)
    return out


def run(device, iters: int = 300) -> tuple[dict, dict]:
    """The checks at the small spec and both shapes, then the slopes;
    returns ({shape: readings}, {shape: timings})."""
    specs = shapes()
    readings = {"small": check("small 40x700 k8", small_spec(), SMALL_STRIP, device, iters=5)}
    for a_dtype in (torch.bfloat16, torch.float32):
        check("small 40x700 k8", small_spec(), SMALL_STRIP, device, iters=5, a_dtype=a_dtype)
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
