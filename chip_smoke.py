#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases,
each printed as it runs:

1. device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions.  No CUDA device -> exit 1 at once.
2. build: the CUDA kernels from ``recsys_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source).
3. B1 vs its plain twin on the card, every precision x A storage, on a
   small generated instance and on the instML100k shape: the factors
   after 20 iterations and the update of one step from near-fit factors,
   each within its limit (``recsys_tpu_torch/testing.py``); then the
   controls each limit must reject, and the all-ones tie case.
4. B2, B3, B4 and B6 vs their twins, every precision x A storage, on the
   small instance and at the instML100k and gen-instML1M shapes (the
   main paths' shapes of B2 and of B3, B4): the same readings, the
   controls at gen-instML1M's shape, and the identities B2 = B1's factors,
   B4 = B1's top-1 and B6 = B3 then B4, bit for bit; B3 within the factor
   limit of B2; the tie case for B4 and B6.
5. B5 vs its twin, every precision x A storage, on the small instance and
   at the gen-instML1M and gen-inst1e6-100-700-1-3 shapes (20 steps): the
   same readings, two runs bit for bit, the controls at both large shapes,
   and B5's training within the factor limit of B3's at gen-instML1M's.
6. main path, instML100k: ``trainer.run`` in highest, bf16x3 and default on
   the auto plan (resident) and with the stream kind forced, held against
   the golden ``.out`` with launch counts, phase times, the slope and the
   plain twin's train time.
7. main path, gen-instML1M (built in memory from ``GEN_SPECS``): the same on
   the auto plan (stream: B3 then B4) and with the resident and tiled
   kinds forced.
8. main path, ``--checkpoint``: the CLI on instML100k in chunks of 1000
   iterations (B2) against an unchunked ``factorize`` + ``recommend``.
9. main path, gen-inst1e6-100-700-1-3 (k = 700, built in memory): ``run``
   with ``path="pallas"`` in every mode on the auto plan (tiled: B5 once
   per step, then ``recommend`` on the factors left on the card) against
   the golden ``.out``, with launch counts and phase times; then one
   tiled step's device time by kernel (``torch.profiler``) at its shape
   and at gen-instML1M's.

Every main path runs with the launch counts set to 0 just before it and
read just after.  The last two lines are a JSON object of the kernels'
numbers and ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before them.  It imports nothing of JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ML100K = os.path.join(ROOT, "tests", "fixtures", "instML100k")
ML1M_OUT = os.path.join(ROOT, "tests", "fixtures", "gen-instML1M.out")
INST1E6 = "gen-inst1e6-100-700-1-3"
INST1E6_OUT = os.path.join(ROOT, "tests", "fixtures", INST1E6 + ".out")
MODES = ("highest", "bf16x3", "default")
STORAGES = ("int8", "bfloat16", "float32")
# Argmax agreement floors against the f64 golden: the f32 tiers match it
# fully on the reference chip; single-pass bf16 is held to the bench's
# 98% floor (recsys_tpu/bench/sweep.py:93) on instML100k.  gen-instML1M's
# bf16 floor is 0.95: the JAX package itself reads 0.9669 there
# (bench_results.jsonl).
AGREEMENT_FLOOR = {"highest": 0.99, "bf16x3": 0.99, "default": 0.98}
ML1M_FLOOR = {"highest": 0.99, "bf16x3": 0.99, "default": 0.95}
# gen-inst1e6's f32 run reads 0.9938 in the JAX package's tiled route
# (bench_results.jsonl); `default` runs as `highest` on the tiled route.
INST1E6_FLOOR = {"highest": 0.99, "bf16x3": 0.98, "default": 0.99}
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): f32 on the CUDA
# cores, bf16 on the tensor cores, HBM bandwidth.
F32_FLOPS, BF16_FLOPS, HBM_BYTES_S = 67e12, 989e12, 3.35e12
FORCE_RESIDENT = 1 << 62

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "resident_train_top1": ("recsys_tpu_torch/csrc/dense_fused.cu", "recsys_tpu/ops/pallas_dense.py:663"),
    "resident_train": ("recsys_tpu_torch/csrc/dense_fused.cu", "recsys_tpu/ops/pallas_dense.py:238"),
    "stream_train": ("recsys_tpu_torch/csrc/dense_stream.cu", "recsys_tpu/ops/pallas_dense.py:420"),
    "stream_top1": ("recsys_tpu_torch/csrc/dense_fused.cu", "recsys_tpu/ops/pallas_dense.py:473"),
    "stream_train_top1": ("recsys_tpu_torch/csrc/dense_stream.cu", "recsys_tpu/ops/pallas_dense.py:433"),
    "tiled_deltas": ("recsys_tpu_torch/csrc/dense_tiled.cu", "recsys_tpu/ops/pallas_dense.py:566"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def _wrappers():
    from recsys_tpu_torch.ops import dense_fused, dense_stream, dense_tiled

    return {
        "resident_train_top1": dense_fused.resident_train_top1,
        "resident_train": dense_fused.resident_train,
        "stream_train": dense_stream.stream_train,
        "stream_top1": dense_stream.stream_top1,
        "stream_train_top1": dense_stream.stream_train_top1,
        "tiled_deltas": dense_tiled.tiled_deltas,
    }


@contextlib.contextmanager
def counted(into: dict):
    """Every kernel's launch count set to 0 on entry; the counts on exit
    go into ``into``."""
    fns = _wrappers()
    for fn in fns.values():
        fn.launches = 0
    yield
    into.update({name: fn.launches for name, fn in fns.items()})


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from recsys_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc} | "
        f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def build_phase():
    from recsys_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {time.perf_counter() - t0:.3f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _inputs(spec, a_dtype, dev, torch):
    from recsys_tpu_torch.ops import dense_fused

    Lt, Rt, (U, I, _) = dense_fused.pad_factors_for_pallas(spec)
    A = dense_fused.device_dense_AT(spec, U, I, a_dtype, dev)
    return torch.from_numpy(Lt).to(dev), torch.from_numpy(Rt).to(dev), A


def _small_spec(iters):
    from recsys_tpu_torch.io.generator import generate_instance

    return generate_instance(200, 300, 10, 2, 30, iters=iters, alpha=0.001, seed=5)


def _ml1m_spec():
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    return generate_instance(**GEN_SPECS["gen-instML1M"])


def _inst1e6_spec():
    from recsys_tpu_torch.io.generator import GEN_SPECS, generate_instance

    t0 = time.perf_counter()
    spec = generate_instance(**GEN_SPECS[INST1E6])
    log(f"[main] {INST1E6} generated in memory in {time.perf_counter() - t0!r} s: {spec.users}x{spec.items} "
        f"k={spec.features} nnz={spec.nnz} iters={spec.iters}")
    return spec


def _tiled_inputs(spec, a_dtype, dev, torch, factors):
    """(L, R, A) on ``dev`` in the tiled layout, from the host tables
    ``factors`` of ``dense_tiled.pad_factors_lane_major``."""
    from recsys_tpu_torch.ops import dense_tiled

    L, R, (U, I, _) = factors
    A = dense_tiled.device_dense_A(spec, U, I, a_dtype, dev)
    return torch.from_numpy(L).to(dev), torch.from_numpy(R).to(dev), A


def kernel_vs_plain_phase(torch, dev):
    """The kernel-vs-twin readings of ``recsys_tpu_torch/testing.py`` for
    B1, every precision x A storage, then the controls each limit must
    reject.  Returns the highest-precision max abs error at the instML100k
    shape."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.ops import dense_fused

    kernel, plain = dense_fused.resident_train_top1, dense_fused.resident_train_top1_plain

    def factor_run(spec, a_dtype, precision, twin_precision):
        Lt, Rt, A = _inputs(spec, a_dtype, dev, torch)
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, items_true=spec.items)
        got = kernel(Lt, Rt, A, precision=precision, **kw)
        want = plain(Lt, Rt, A, precision=twin_precision, **kw)
        torch.cuda.synchronize()
        return A, kw, got, want

    def probe_rel(spec, a_dtype, precision, twin_precision):
        Lt, Rt, A = checks.precision_probe(spec, a_dtype, dev)
        kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2, items_true=spec.items)
        got = kernel(Lt, Rt, A, precision=precision, **kw)
        return checks.update_rel(got, plain(Lt, Rt, A, precision=twin_precision, **kw), Lt, Rt)

    small = _small_spec(checks.FACTOR_ITERS)
    ml = dataclasses.replace(load_problem(ML100K + ".in"), iters=checks.FACTOR_ITERS)
    worst, failed = {}, []
    for name, spec in (("small 200x300 k10", small), ("instML100k shape", ml)):
        for precision in MODES:
            for a_dtype in (torch.int8, torch.bfloat16, torch.float32):
                A, kw, (Lk, Rk, tk), (Lp, Rp, tp) = factor_run(spec, a_dtype, precision, precision)
                err = max(float((Lk - Lp).abs().max()), float((Rk - Rp).abs().max()))
                rel = checks.factor_rel((Lk, Rk), (Lp, Rp))
                upd = probe_rel(spec, a_dtype, precision, precision)
                finite = bool(torch.isfinite(Lk).all() and torch.isfinite(Rk).all())
                # The top-1 pass alone, from identical final factors.
                _, _, t0k = kernel(Lk, Rk, A, precision=precision, **{**kw, "iters": 0})
                _, _, t0p = plain(Lk, Rk, A, precision=precision, **{**kw, "iters": 0})
                top_same = float((tk == tp).float().mean())
                top0_same = float((t0k == t0p).float().mean())
                ok = (finite and rel <= checks.FACTOR_RTOL[precision] and upd <= checks.UPDATE_RTOL[precision]
                      and top0_same == 1.0 and (spec is not small or top_same == 1.0))
                log(f"[kernel] B1 {name} {precision:7s} A={str(a_dtype).split('.')[-1]:8s} "
                    f"max_abs_err={err!r} factor_rel={rel!r} (limit {checks.FACTOR_RTOL[precision]}) "
                    f"probe update_rel={upd!r} (limit {checks.UPDATE_RTOL[precision]}) "
                    f"top1_same={top_same!r} top1_pass_same={top0_same!r} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{name} {precision} {a_dtype}")
                if spec is ml:
                    worst[precision] = max(worst.get(precision, 0.0), err)
    # Controls: the kernel in another mode than the twin stands for a kernel
    # that skips the bf16 rounding of `default` or the split of `bf16x3`, or
    # that drops `highest` to split products.  Each limit must reject it.
    controls = [("factor", kp, tp, checks.factor_rel(*factor_run(ml, torch.int8, kp, tp)[2:]),
                 checks.FACTOR_RTOL[tp]) for kp, tp in checks.FACTOR_CONTROLS]
    controls += [("probe update", kp, tp, probe_rel(ml, torch.int8, kp, tp), checks.UPDATE_RTOL[tp])
                 for kp, tp in checks.UPDATE_CONTROLS]
    failed += _report_controls("B1 instML100k shape", controls)
    K, U = 8, 128
    ones = torch.ones((K, U), device=dev)
    _, _, tie = kernel(ones, torch.ones((K, U), device=dev), torch.zeros((U, U), device=dev),
                       iters=0, alpha2=0.0, items_true=U)
    if not bool((tie == 0).all()):
        failed.append("tie case: lowest index must win")
    log(f"[kernel] B1 all-ones tie case -> all zeros {'ok' if bool((tie == 0).all()) else 'FAIL'}")
    if failed:
        raise AssertionError(f"kernel vs plain twin failed: {failed}")
    return worst


def _report_controls(where, controls):
    failed = []
    for kind, kp, tp, rel, limit in controls:
        ok = rel > limit
        log(f"[control] {where} {kind}: kernel {kp} vs twin {tp} rel={rel!r} (limit {limit}) "
            f"{'rejected ok' if ok else 'FAIL: the limit does not reject it'}")
        if not ok:
            failed.append(f"control {where} {kind} {kp} vs {tp}")
    return failed


def stream_kernels_phase(torch, dev):
    """B2, B3, B4 and B6 against their twins and against each other.
    Returns {kernel: max abs error in highest at the shape its main path
    gives it}: instML100k's for B2 (``--checkpoint``), gen-instML1M's for
    B3, B4 and B6."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.ops import dense_fused as df
    from recsys_tpu_torch.ops import dense_stream as ds

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def probe_rel(train, twin, spec, a_dtype, precision, twin_precision):
        Lt, Rt, A = checks.precision_probe(spec, a_dtype, dev)
        kw = dict(iters=1, alpha2=checks.PROBE_ALPHA2)
        got = train(Lt, Rt, A, precision=precision, **kw)
        return checks.update_rel(got, twin(Lt, Rt, A, precision=twin_precision, **kw), Lt, Rt)

    small = _small_spec(checks.FACTOR_ITERS)
    ml = dataclasses.replace(load_problem(ML100K + ".in"), iters=checks.FACTOR_ITERS)
    ml1m = dataclasses.replace(_ml1m_spec(), iters=checks.FACTOR_ITERS)
    worst, failed = {}, []
    for name, spec in (("small 200x300 k10", small), ("instML100k shape", ml), ("gen-instML1M shape", ml1m)):
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha)
        for precision in MODES:
            for storage in STORAGES:
                Lt, Rt, A = _inputs(spec, getattr(torch, storage), dev, torch)
                L1, R1, t1 = df.resident_train_top1(Lt, Rt, A, precision=precision, items_true=spec.items, **kw)
                b2 = df.resident_train(Lt, Rt, A, precision=precision, **kw)
                b3 = ds.stream_train(Lt, Rt, A, precision=precision, **kw)
                b4 = ds.stream_top1(*b3, A, precision=precision, items_true=spec.items)
                b6 = ds.stream_train_top1(Lt, Rt, A, precision=precision, items_true=spec.items, **kw)
                twin2 = df.resident_train_plain(Lt, Rt, A, precision=precision, **kw)
                twin = ds.stream_train_plain(Lt, Rt, A, precision=precision, **kw)
                twin_top = ds.stream_top1_plain(*b3, A, precision=precision, items_true=spec.items)
                b1_top = df.resident_train_top1(*b3, A, precision=precision, items_true=spec.items,
                                                iters=0, alpha2=0.0)[2]
                torch.cuda.synchronize()
                r2 = checks.factor_rel(b2, twin2)
                r3 = checks.factor_rel(b3, twin)
                r32 = checks.factor_rel(b3, b2)
                u2 = probe_rel(df.resident_train, df.resident_train_plain, spec, getattr(torch, storage),
                               precision, precision)
                u3 = probe_rel(ds.stream_train, ds.stream_train_plain, spec, getattr(torch, storage),
                               precision, precision)
                err2 = max(float((k - p).abs().max()) for k, p in zip(b2, twin2))
                err3 = max(float((k - p).abs().max()) for k, p in zip(b3, twin))
                finite = all(bool(torch.isfinite(x).all()) for x in (*b2, *b3))
                checks_ok = {
                    "B2=B1 factors": same(b2, (L1, R1)),
                    "B2 vs twin": r2 <= checks.FACTOR_RTOL[precision] and u2 <= checks.UPDATE_RTOL[precision],
                    "B3 vs twin": r3 <= checks.FACTOR_RTOL[precision] and u3 <= checks.UPDATE_RTOL[precision],
                    "B3 vs B2": r32 <= checks.FACTOR_RTOL[precision],
                    "B4=twin": torch.equal(b4, twin_top),
                    "B4=B1 top-1": torch.equal(b4, b1_top),
                    "B6=B3+B4": same(b6, (*b3, b4)),
                    "finite": finite,
                }
                bad = [k for k, v in checks_ok.items() if not v]
                log(f"[kernel] B2-B6 {name} {precision:7s} A={storage:8s} "
                    f"B2 max_abs_err={err2!r} factor_rel={r2!r} update_rel={u2!r} | "
                    f"B3 max_abs_err={err3!r} factor_rel={r3!r} update_rel={u3!r} vs_B2={r32!r} "
                    f"(limits {checks.FACTOR_RTOL[precision]} / {checks.UPDATE_RTOL[precision]}) | "
                    f"B2=B1 {checks_ok['B2=B1 factors']} B4=twin {checks_ok['B4=twin']} "
                    f"B4=B1 {checks_ok['B4=B1 top-1']} B6=B3+B4 {checks_ok['B6=B3+B4']} "
                    f"{'ok' if not bad else 'FAIL ' + ','.join(bad)}")
                if bad:
                    failed.append(f"{name} {precision} {storage}: {bad}")
                if spec is ml and precision == "highest":
                    worst["resident_train"] = max(worst.get("resident_train", 0.0), err2)
                if spec is ml1m and precision == "highest":
                    worst["stream_train"] = max(worst.get("stream_train", 0.0), err3)
                    worst["stream_top1"] = max(worst.get("stream_top1", 0.0),
                                               float((b4 - twin_top).abs().max()))
                    worst["stream_train_top1"] = max(worst.get("stream_train_top1", 0.0), err3)

    def factor_control(kp, tp):
        Lt, Rt, A = _inputs(ml1m, torch.int8, dev, torch)
        kw = dict(iters=ml1m.iters, alpha2=2.0 * ml1m.alpha)
        return checks.factor_rel(ds.stream_train(Lt, Rt, A, precision=kp, **kw),
                                 ds.stream_train_plain(Lt, Rt, A, precision=tp, **kw))

    controls = [("factor", kp, tp, factor_control(kp, tp), checks.FACTOR_RTOL[tp])
                for kp, tp in checks.FACTOR_CONTROLS]
    controls += [("probe update", kp, tp,
                  probe_rel(ds.stream_train, ds.stream_train_plain, ml1m, torch.int8, kp, tp),
                  checks.UPDATE_RTOL[tp]) for kp, tp in checks.UPDATE_CONTROLS]
    failed += _report_controls("B3 gen-instML1M shape", controls)
    K, U = 8, 128
    ones, zeros = torch.ones((K, U), device=dev), torch.zeros((U, U), device=dev)
    tie4 = ds.stream_top1(ones, ones, zeros, items_true=U)
    tie6 = ds.stream_train_top1(ones, ones, zeros, iters=0, alpha2=0.0, items_true=U)[2]
    tie_ok = bool((tie4 == 0).all()) and bool((tie6 == 0).all())
    log(f"[kernel] B4/B6 all-ones tie case -> all zeros {'ok' if tie_ok else 'FAIL'}")
    if not tie_ok:
        failed.append("B4/B6 tie case: lowest index must win")
    if failed:
        raise AssertionError(f"B2-B6 vs twins failed: {failed}")
    return worst


def tiled_kernel_phase(torch, dev, big):
    """B5 against its twin, every precision x A storage, on the small
    instance and at the gen-instML1M and gen-inst1e6 (``big``) shapes, 20
    steps: the factor and probe-update readings, two runs bit for bit, the
    controls at both large shapes, and B5's training against B3's at
    gen-instML1M's shape.  Returns B5's max abs error in highest at
    gen-inst1e6's shape."""
    from recsys_tpu_torch import testing as checks
    from recsys_tpu_torch.ops import dense_fused as df
    from recsys_tpu_torch.ops import dense_stream as ds
    from recsys_tpu_torch.ops import dense_tiled as dt

    def readings(spec, L, R, A, probe, precision, twin_precision):
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha)
        got = dt.tiled_train(L, R, A, precision=precision, **kw)
        twin = dt.tiled_train_plain(L, R, A, precision=twin_precision, **kw)
        pL, pR, pA = probe
        upd = checks.update_rel(dt.tiled_gd_step(pL, pR, pA, alpha2=checks.PROBE_ALPHA2, precision=precision),
                                dt.tiled_train_plain(pL, pR, pA, iters=1, alpha2=checks.PROBE_ALPHA2,
                                                     precision=twin_precision), pL, pR)
        return got, twin, checks.factor_rel(got, twin), upd

    small = _small_spec(checks.FACTOR_ITERS)
    ml1m = dataclasses.replace(_ml1m_spec(), iters=checks.FACTOR_ITERS)
    big = dataclasses.replace(big, iters=checks.FACTOR_ITERS)
    worst, failed = 0.0, []
    for name, spec in (("small 200x300 k10", small), ("gen-instML1M shape", ml1m), ("gen-inst1e6 shape", big)):
        t0 = time.perf_counter()
        factors = dt.pad_factors_lane_major(spec)
        probe8 = checks.tiled_probe(spec, torch.int8, dev)
        for storage in STORAGES:
            a_dtype = getattr(torch, storage)
            L, R, A = _tiled_inputs(spec, a_dtype, dev, torch, factors)
            probe = (*probe8[:2], df.load_at(probe8[2]).to(a_dtype) if storage != "int8" else probe8[2])
            for precision in MODES:
                got, twin, rel, upd = readings(spec, L, R, A, probe, precision, precision)
                again = dt.tiled_train(L, R, A, iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision)
                torch.cuda.synchronize()
                err = max(float((k - p).abs().max()) for k, p in zip(got, twin))
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                finite = all(bool(torch.isfinite(x).all()) for x in got)
                ok = (finite and same and rel <= checks.TILED_FACTOR_RTOL[precision]
                      and upd <= checks.TILED_UPDATE_RTOL[precision])
                log(f"[kernel] B5 {name} {precision:7s} A={storage:8s} max_abs_err={err!r} factor_rel={rel!r} "
                    f"(limit {checks.TILED_FACTOR_RTOL[precision]}) probe update_rel={upd!r} "
                    f"(limit {checks.TILED_UPDATE_RTOL[precision]}) two runs same bits {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"B5 {name} {precision} {storage}")
                if spec is big and precision == "highest":
                    worst = max(worst, err)
                del got, twin, again
        if spec is ml1m:  # B5's training against B3's, same inputs
            L, R, A = _tiled_inputs(spec, torch.int8, dev, torch, factors)
            Lt, Rt, At = _inputs(spec, torch.int8, dev, torch)
            k, u, i = spec.features, spec.users, spec.items
            for precision in MODES:
                kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision)
                L5, R5 = dt.tiled_train(L, R, A, **kw)
                L3, R3 = ds.stream_train(Lt, Rt, At, **kw)
                rel = checks.factor_rel((L5[:u, :k], R5[:i, :k]), (L3[:k, :u].T, R3[:k, :i].T))
                ok = rel <= checks.TILED_FACTOR_RTOL[precision]
                log(f"[kernel] B5 vs B3 {name} {precision:7s} factor_rel={rel!r} "
                    f"(limit {checks.TILED_FACTOR_RTOL[precision]}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"B5 vs B3 {name} {precision}")
        if spec is not small:
            L, R, A = _tiled_inputs(spec, torch.int8, dev, torch, factors)
            controls = [("factor", kp, tp, readings(spec, L, R, A, probe8, kp, tp)[2],
                         checks.TILED_FACTOR_RTOL[tp]) for kp, tp in checks.FACTOR_CONTROLS]
            controls += [("probe update", kp, tp, readings(spec, L, R, A, probe8, kp, tp)[3],
                          checks.TILED_UPDATE_RTOL[tp]) for kp, tp in checks.UPDATE_CONTROLS]
            failed += _report_controls(f"B5 {name}", controls)
        del factors, probe8, L, R, A
        torch.cuda.empty_cache()
        log(f"[kernel] B5 {name}: {time.perf_counter() - t0!r} s")
    if failed:
        raise AssertionError(f"B5 vs its twin failed: {failed}")
    return worst


def _run(spec, precision, dev, torch, path="auto", **plan):
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.utils.timing import collect_phases

    cfg = RunConfig(dtype="float32", path=path, precision=precision)
    phases = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with collect_phases(phases):
        out, _ = trainer.run(spec, cfg, dev, **plan)
    wall = time.perf_counter() - t0
    return out, wall, phases


def _agreement(out, golden_lines):
    got = out.splitlines()
    return sum(a == b for a, b in zip(got, golden_lines)) / len(golden_lines), len(got)


def _plain_seconds(fn, torch, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path_runs(name, spec, golden, floors, dev, torch, launches, kinds):
    """``trainer.run`` on ``spec`` in every mode for each plan kind in
    ``kinds`` ({label: plan kwargs}), each kind's runs in one launch-count
    window.  Returns {(label, mode): train seconds}."""
    from recsys_tpu_torch.engine import trainer

    want = golden.splitlines()
    train = {}
    for label, plan in kinds.items():
        for precision in MODES:  # warm-up
            _run(dataclasses.replace(spec, iters=10), precision, dev, torch, **plan)
        counts = {}
        with counted(counts):
            for precision in MODES:
                out, wall, ph = _run(spec, precision, dev, torch, **plan)
                agree, lines = _agreement(out, want)
                _, _, ph1k = _run(dataclasses.replace(spec, iters=1000), precision, dev, torch, **plan)
                slope = (ph["train"] - ph1k["train"]) / (spec.iters - 1000)
                train[label, precision] = ph["train"]
                log(f"[main] {name} {label} plan={trainer.dense_plan(spec, **plan).kind} {precision}: "
                    f"agreement {agree!r} byte_match {out == golden} lines {lines} | wall {wall!r} s "
                    f"prep {ph['prep']!r} upload {ph['upload']!r} train {ph['train']!r} top1 {ph['top1']!r} "
                    f"| slope {slope * 1e6!r} us/iter (1000 vs {spec.iters} iters)")
                if lines != len(want) or agree < floors[precision]:
                    raise AssertionError(f"{name} {label} {precision}: agreement {agree} below {floors[precision]}")
        log(f"[main] {name} {label} launches in the main-path runs: {counts}")
        launches[name, label] = counts
    return train


def ml100k_phase(torch, dev, launches):
    """instML100k through ``run()``: the auto plan (resident, B1) and the
    stream kind forced; the plain twin's train time."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.engine.oracle import run_oracle
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.ops import dense_fused

    spec = load_problem(ML100K + ".in")
    with open(ML100K + ".out") as f:
        golden = f.read()
    path = trainer.choose_path(spec, RunConfig(dtype="float32"), dev)
    log(f"[main] instML100k {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} "
        f"iters={spec.iters}: path={path} plan={trainer.dense_plan(spec)}")
    if path != "pallas" or trainer.dense_plan(spec).kind != "resident":
        raise AssertionError(f"instML100k must take the resident dense route, got {path!r}")
    small = _small_spec(50)
    for precision in MODES:  # a small run held against the f64 oracle, both kinds
        for plan in ({}, {"a_max_bytes": 0}):
            out, _, _ = _run(small, precision, dev, torch, path="pallas", **plan)
            agree, _ = _agreement(out, run_oracle(small).splitlines())
            log(f"[main] small 200x300 {precision} {plan or 'auto'}: agreement with f64 oracle {agree!r}")
            if precision != "default" and agree < 1.0:
                raise AssertionError("small instance disagrees with the f64 oracle")
    train = main_path_runs("instML100k", spec, golden, AGREEMENT_FLOOR, dev, torch, launches,
                           {"auto": {}, "stream forced": {"a_max_bytes": 0}})
    if launches["instML100k", "auto"]["resident_train_top1"] <= 0:
        raise AssertionError("the instML100k main path did not launch B1")

    plan = trainer.dense_plan(spec)
    Lt, Rt, A = _inputs(spec, plan.a_dtype, dev, torch)
    want = golden.splitlines()
    plain = {}
    for precision in MODES:
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision, items_true=spec.items)
        dense_fused.resident_train_top1_plain(Lt, Rt, A, **{**kw, "iters": 10})  # warm-up
        (_, _, top), plain_s = _plain_seconds(dense_fused.resident_train_top1_plain, torch, Lt, Rt, A, **kw)
        idx = top.cpu().numpy()[0, : spec.users]
        keep = spec.rated_counts() < spec.items
        agree = sum(str(int(i)) == w for i, w in zip(idx[keep], want)) / len(want)
        plain[precision] = plain_s
        log(f"[main] instML100k plain twin {precision}: train {plain_s!r} s vs kernel "
            f"{train['auto', precision]!r} s (stream forced {train['stream forced', precision]!r} s)"
            f" | plain agreement {agree!r}")
    return spec, train, plain


def ml1m_phase(torch, dev, launches):
    """gen-instML1M through ``run()``: the auto plan (stream: B3 then B4)
    and the resident and tiled kinds forced; the plain twin's train time."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.ops import dense_stream

    spec = _ml1m_spec()
    with open(ML1M_OUT) as f:
        golden = f.read()
    path = trainer.choose_path(spec, RunConfig(dtype="float32"), dev)
    plan = trainer.dense_plan(spec)
    log(f"[main] gen-instML1M {spec.users}x{spec.items} k={spec.features} nnz={spec.nnz} "
        f"iters={spec.iters}: path={path} plan={plan}")
    if path != "pallas" or plan.kind != "stream":
        raise AssertionError(f"gen-instML1M must take the stream dense route, got {path!r} {plan.kind!r}")
    train = main_path_runs("gen-instML1M", spec, golden, ML1M_FLOOR, dev, torch, launches,
                           {"auto": {}, "resident forced": {"a_max_bytes": FORCE_RESIDENT},
                            "tiled forced": {"tiled": True}})
    counts = launches["gen-instML1M", "auto"]
    if counts["stream_train"] <= 0 or counts["stream_top1"] <= 0:
        raise AssertionError(f"the gen-instML1M main path did not launch B3 and B4: {counts}")
    if launches["gen-instML1M", "tiled forced"]["tiled_deltas"] <= 0:
        raise AssertionError("gen-instML1M with the tiled kind forced did not launch B5")

    Lt, Rt, A = _inputs(spec, plan.a_dtype, dev, torch)
    want = golden.splitlines()
    keep = spec.rated_counts() < spec.items
    plain = {}
    for precision in MODES:
        kw = dict(iters=spec.iters, alpha2=2.0 * spec.alpha, precision=precision)
        dense_stream.stream_train_plain(Lt, Rt, A, **{**kw, "iters": 10})  # warm-up
        (Lp, Rp), plain_s = _plain_seconds(dense_stream.stream_train_plain, torch, Lt, Rt, A, **kw)
        top = dense_stream.stream_top1_plain(Lp, Rp, A, precision=precision, items_true=spec.items)
        idx = top.cpu().numpy()[0, : spec.users]
        agree = sum(str(int(i)) == w for i, w in zip(idx[keep], want)) / len(want)
        plain[precision] = plain_s
        log(f"[main] gen-instML1M plain twin {precision}: train {plain_s!r} s vs kernel "
            f"{train['auto', precision]!r} s (resident forced {train['resident forced', precision]!r} s, "
            f"tiled forced {train['tiled forced', precision]!r} s)"
            f" | plain agreement {agree!r}")
    return spec, train, plain


def checkpoint_phase(torch, dev, launches):
    """The CLI's ``--checkpoint`` route on instML100k in chunks of 1000
    iterations (B2) against one unchunked ``factorize`` + ``recommend``."""
    from recsys_tpu_torch import cli
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.io.parser import load_problem
    from recsys_tpu_torch.io.writers import format_recommendations

    spec = load_problem(ML100K + ".in")
    cfg = RunConfig(dtype="float32")
    state = trainer.factorize(spec, cfg, dev)
    want = format_recommendations(trainer.recommend(state, spec, cfg, dev), spec.rated_counts(), spec.items)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with counted(counts), contextlib.redirect_stdout(buf):
            rc = cli.main(["run", ML100K + ".in", "--device", str(dev), "--dtype", "float32", "--no-time",
                           "--checkpoint", os.path.join(tmp, "ck.npz"), "--checkpoint-every", "1000"])
    launches["instML100k checkpoint", "auto"] = counts
    same = rc == 0 and buf.getvalue() == want
    log(f"[main] instML100k --checkpoint --checkpoint-every 1000: stdout equal to unchunked "
        f"factorize + recommend {same} | launches {counts}")
    if not same or counts["resident_train"] <= 0:
        raise AssertionError("the checkpoint route differs from the unchunked run or did not launch B2")


def inst1e6_phase(torch, dev, launches, spec):
    """gen-inst1e6-100-700-1-3 through ``run()`` with ``path="pallas"`` in
    every mode: the auto plan is tiled (B5 once per step, then
    ``recommend`` on the factors left on the card)."""
    from recsys_tpu_torch.config import RunConfig
    from recsys_tpu_torch.engine import trainer

    with open(INST1E6_OUT) as f:
        want = f.read().splitlines()
    plan = trainer.dense_plan(spec)
    log(f"[main] {INST1E6}: path={trainer.choose_path(spec, RunConfig(dtype='float32', path='pallas'), dev)} "
        f"plan={plan}")
    if plan.kind != "tiled":
        raise AssertionError(f"{INST1E6} must take the tiled plan, got {plan.kind!r}")
    counts = {}
    with counted(counts):
        for precision in MODES:
            torch.cuda.reset_peak_memory_stats(dev)
            out, wall, ph = _run(spec, precision, dev, torch, path="pallas")
            agree, lines = _agreement(out, want)
            log(f"[main] {INST1E6} auto plan=tiled {precision}: agreement {agree!r} lines {lines} | wall {wall!r} s "
                f"prep {ph['prep']!r} upload {ph['upload']!r} train {ph['train']!r} top1 {ph['top1']!r} "
                f"| peak device memory {torch.cuda.max_memory_allocated(dev)!r} B")
            if lines != len(want) or agree < INST1E6_FLOOR[precision]:
                raise AssertionError(f"{INST1E6} {precision}: agreement {agree} below {INST1E6_FLOOR[precision]}")
    log(f"[main] {INST1E6} auto launches in the main-path runs: {counts}")
    launches[INST1E6, "auto"] = counts
    if counts["tiled_deltas"] != len(MODES) * spec.iters:
        raise AssertionError(f"{INST1E6} must launch B5 {spec.iters} times per run: {counts}")


def _timing_inputs(spec, dev, torch):
    """(L, R, A, At) of the tiled plan at ``spec``'s shape, for timing:
    ``spec``'s ratings and random factors (the time does not depend on
    their values)."""
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.ops import dense_tiled

    plan = trainer.dense_plan(spec, tiled=True)
    g = torch.Generator(device=dev).manual_seed(0)
    L = torch.rand((plan.U, plan.K), generator=g, device=dev) / spec.features
    R = torch.rand((plan.I, plan.K), generator=g, device=dev) / spec.features
    A = dense_tiled.device_dense_A(spec, plan.U, plan.I, plan.a_dtype, dev)
    return L, R, A, A.t().contiguous()


def tiled_step_profile(torch, dev, spec, name):
    """Device time by kernel of one ``tiled_gd_step`` at ``spec``'s shape
    (tiled plan, `highest`), from ``torch.profiler`` over 5 steps: B5's
    passes beside the torch update.  Logged only."""
    from recsys_tpu_torch.ops import dense_tiled as dt

    L, R, A, At = _timing_inputs(spec, dev, torch)
    step = dict(alpha2=2.0 * spec.alpha, At=At)
    dt.tiled_gd_step(L, R, A, **step)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            dt.tiled_gd_step(L, R, A, **step)
        torch.cuda.synchronize()
    rows = [(getattr(e, "device_time_total", 0.0) / 5, e.key) for e in prof.key_averages()]
    rows = sorted((t, k) for t, k in rows if t > 0)[::-1]
    if not rows:
        log(f"[profile] B5 step at {name}: the profiler saw no device time")
    for t, key in rows:
        log(f"[profile] B5 step at {name}: {t!r} us per step {key[:90]}")
    del L, R, A, At


def _bound(flops, nbytes):
    """(bound_ms, bound_by) in `highest`: f32 operations on the CUDA cores
    against bytes over HBM, whichever takes longer."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_records(torch, dev, ml100k, ml1m, big, launches, errs, times):
    """The kernels line: every number measured in this run, in `highest`.
    The train kernels' bound counts 6*k FLOP per rated cell and step, the
    top-1's 2*k per (user, item); bytes count each input tensor read once
    and each output written once.  B5's numbers are one launch, one step's
    deltas, at gen-inst1e6's shape (``big``)."""
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.ops import dense_fused as df
    from recsys_tpu_torch.ops import dense_stream as ds
    from recsys_tpu_torch.ops import dense_tiled as dt
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    def shapes(spec):
        plan = trainer.dense_plan(spec)
        a_bytes = torch.empty((), dtype=plan.a_dtype).element_size() * plan.U * plan.I
        factors = 4 * plan.K * (plan.U + plan.I)
        train_flops = 6.0 * spec.nnz * spec.features * spec.iters
        top_flops = 2.0 * spec.users * spec.items * spec.features
        return plan, a_bytes, factors, train_flops, top_flops

    out = []

    def add(name, spec_launches, err, ms, plain_ms, flops, nbytes):
        bound_ms, bound_by = _bound(flops, nbytes)
        source, replaces = KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": spec_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    plan, a_b, f_b, tr, tp = shapes(ml100k)
    add("resident_train_top1", launches["instML100k", "auto"]["resident_train_top1"], errs["B1"],
        times["B1"][0] * 1e3, times["B1"][1] * 1e3, tr + tp, a_b + 2 * f_b + 4 * plan.U)
    Lt, Rt, A = _inputs(ml100k, plan.a_dtype, dev, torch)
    kw = dict(iters=ml100k.iters, alpha2=2.0 * ml100k.alpha, precision="highest")
    b2_ms = cuda_event_ms(lambda: df.resident_train(Lt, Rt, A, **kw))
    b2_plain = cuda_event_ms(lambda: df.resident_train_plain(Lt, Rt, A, **kw))
    add("resident_train", launches["instML100k checkpoint", "auto"]["resident_train"], errs["resident_train"],
        b2_ms, b2_plain, tr, a_b + 2 * f_b)

    plan, a_b, f_b, tr, tp = shapes(ml1m)
    Lt, Rt, A = _inputs(ml1m, plan.a_dtype, dev, torch)
    kw = dict(iters=ml1m.iters, alpha2=2.0 * ml1m.alpha, precision="highest")
    Lf, Rf = ds.stream_train(Lt, Rt, A, **kw)
    counts = launches["gen-instML1M", "auto"]
    add("stream_train", counts["stream_train"], errs["stream_train"],
        times["B3"][0] * 1e3, times["B3"][1] * 1e3, tr, a_b + 2 * f_b)
    b4_ms = cuda_event_ms(lambda: ds.stream_top1(Lf, Rf, A, precision="highest", items_true=ml1m.items), 20)
    b4_plain = cuda_event_ms(lambda: ds.stream_top1_plain(Lf, Rf, A, precision="highest", items_true=ml1m.items), 5)
    add("stream_top1", counts["stream_top1"], errs["stream_top1"], b4_ms, b4_plain, tp, a_b + f_b + 4 * plan.U)
    b6_ms = cuda_event_ms(lambda: ds.stream_train_top1(Lt, Rt, A, items_true=ml1m.items, **kw))
    b6_plain = cuda_event_ms(lambda: ds.stream_train_top1_plain(Lt, Rt, A, items_true=ml1m.items, **kw))
    add("stream_train_top1", counts["stream_train_top1"], errs["stream_train_top1"], b6_ms, b6_plain,
        tr + tp, a_b + 2 * f_b + 4 * plan.U)

    plan, a_b, f_b, _, _ = shapes(big)
    L, R, A, At = _timing_inputs(big, dev, torch)
    b5_ms = cuda_event_ms(lambda: dt.tiled_deltas(L, R, A, At=At), 10)
    b5_plain = cuda_event_ms(lambda: dt.tiled_deltas_plain(L, R, A), 5)
    add("tiled_deltas", launches[INST1E6, "auto"]["tiled_deltas"], errs["tiled_deltas"], b5_ms, b5_plain,
        6.0 * big.nnz * big.features, a_b + 2 * f_b)
    log(f"[kernels] tiled_deltas dense count at {INST1E6}: 8*U*I*K = {8.0 * plan.U * plan.I * plan.K!r} FLOP, "
        f"{_bound(8.0 * plan.U * plan.I * plan.K, a_b + 2 * f_b)[0]!r} ms at the f32 peak")
    del L, R, A, At
    for rec in out:
        log(f"[kernels] {rec['name']}: {rec['ms']!r} ms vs bound {rec['bound_ms']!r} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']!r} ms, launches {rec['launches']}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "recsys_tpu_torch")):
        print("chip_smoke: run from the root of a recsys-tpu checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        device_phase(torch)
        build_phase()
        dev = torch.device("cuda", 0)
        errs = {"B1": kernel_vs_plain_phase(torch, dev)["highest"]}
        errs.update(stream_kernels_phase(torch, dev))
        big = _inst1e6_spec()
        errs["tiled_deltas"] = tiled_kernel_phase(torch, dev, big)
        launches = {}
        ml100k, train1, plain1 = ml100k_phase(torch, dev, launches)
        ml1m, train2, plain2 = ml1m_phase(torch, dev, launches)
        checkpoint_phase(torch, dev, launches)
        inst1e6_phase(torch, dev, launches, big)
        tiled_step_profile(torch, dev, big, INST1E6)
        tiled_step_profile(torch, dev, ml1m, "gen-instML1M")
        times = {"B1": (train1["auto", "highest"], plain1["highest"]),
                 "B3": (train2["auto", "highest"], plain2["highest"])}
        kernels = kernel_records(torch, dev, ml100k, ml1m, big, launches, errs, times)
    except Exception as e:  # noqa: BLE001 - report any failed phase, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "recsys_tpu.")) or m == "recsys_tpu")
    if leaked:
        print(f"chip_smoke: the JAX package or jax was imported: {leaked}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
