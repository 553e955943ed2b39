"""Where B5's L pass waits: phase clocks of one fused step at
gen-inst1e6-100-700-1-3's shape, in both forms of the pass.

    python -m recsys_tpu_torch.probes.tiled_clocks

Run from the root of a checkout on a machine with a CUDA card and nvcc
(gen-inst1e6 is built in memory: ~15 s and a few GB of host memory).  It
copies ``csrc/dense_tiled.cu``, marks the L pass with ``clock64()`` by text
substitution, builds the copy with the port's nvcc flags into
``build/recsys_tpu_torch/tiled_clocks.so`` and runs one ``tiled_gd_step``
in `highest` through the ordinary wrapper with that library in place of
the built one, once in each form.

* Warp form (``dl_pass``): per user, the cycles until its own L row has
  arrived (a compare reads it), the walk of its A line and rated R rows,
  and the issue of its stores; the walk's cycles fitted against the user's
  rated cells give a fixed part (the A line) and a part per rated cell.
* Ring form (``dl_ring``): per warp, the cycles spent waiting for a user's
  stage (cp.async), on its cells, and issuing its stores, summed over the
  warp's users; printed per user.

Each mark forces the value it follows to arrive by a compare before it
reads the clock, which serialises what the kernel overlaps (the own row's
load with the A line's), so the probe prints one step's time with the
marks off and on.  The kernels of the built library are not changed;
nothing of this runs in the engine.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops import dense_tiled as dt

MARKS = 4  # a user's (warp form) or a warp's (ring form) slots
# A compare that reads x, so the clock read after it waits for x.
_WAIT = "if (g_marks && ({x}) == 1.2345e-38f) g_marks[0] = 0;"
_CLOCK = "const long long {t} = clock64();"


def instrumented_source() -> str:
    """dense_tiled.cu with the marks and their setter."""
    with open(os.path.join(_build.CSRC, "dense_tiled.cu")) as f:
        src = f.read()
    put = "if (lane == 0 && g_marks) g_marks[static_cast<size_t>(u) * 4 + {j}] = {v};"
    subs = [
        ("namespace {\n", "namespace {\n__device__ long long* g_marks = nullptr;\n"),
        # warp form: start, own row in, walk done, stores issued
        ("  if (u >= U) return;  // warp-uniform\n",
         "  if (u >= U) return;  // warp-uniform\n  " + _CLOCK.format(t="t0_") + "\n"),
        ("  own.load(L + static_cast<size_t>(u) * K, nk, lane);\n",
         "  own.load(L + static_cast<size_t>(u) * K, nk, lane);\n  "
         + _WAIT.format(x="own.h[0] + own.h[KPL / 2]") + _CLOCK.format(t="t1_") + "\n"),
        ("  walk<P, KPL, true>(A, a_kind, static_cast<size_t>(u) * I, 0, I, own, R, K, nk, lane, acc);\n",
         "  walk<P, KPL, true>(A, a_kind, static_cast<size_t>(u) * I, 0, I, own, R, K, nk, lane, acc);\n  "
         + _WAIT.format(x="acc[0] + acc[KPL - 1]") + _CLOCK.format(t="t2_") + "\n"),
        ("    out[idx] = FUSE ? apply(__ldg(L + idx), acc[m], a2) : acc[m];\n  }\n}\n",
         "    out[idx] = FUSE ? apply(__ldg(L + idx), acc[m], a2) : acc[m];\n  }\n  "
         + _CLOCK.format(t="t3_") + put.format(j=0, v="t1_ - t0_") + put.format(j=1, v="t2_ - t1_")
         + put.format(j=2, v="t3_ - t2_") + put.format(j=3, v="1") + "\n}\n"),
        # ring form: per warp sums of the stage wait, the cells and the stores
        ("  bool ahead = false;", "  long long w_wait = 0, w_cells = 0, w_store = 0;\n  bool ahead = false;"),
        ("    fetch(i + RING - 1);", "    " + _CLOCK.format(t="c0_") + "\n    fetch(i + RING - 1);"),
        ("    cp_async_wait<RING - 2>();  // users i and i + 1 have landed\n    __syncwarp();\n",
         "    cp_async_wait<RING - 2>();  // users i and i + 1 have landed\n    __syncwarp();\n    "
         + _WAIT.format(x="reinterpret_cast<const float*>(mine + (i % RING) * stage)[lane]")
         + _CLOCK.format(t="c1_") + " w_wait += c1_ - c0_;\n"),
        ("    const size_t u = gw + static_cast<size_t>(i) * W;\n#pragma unroll",
         "    " + _WAIT.format(x="acc[0] + acc[KPL - 1]") + _CLOCK.format(t="c2_") + " w_cells += c2_ - c1_;\n"
         "    const size_t u = gw + static_cast<size_t>(i) * W;\n#pragma unroll"),
        ("    __syncwarp();  // every lane is done with the stage before it is refilled\n",
         "    w_store += clock64() - c2_;\n"
         "    __syncwarp();  // every lane is done with the stage before it is refilled\n"),
        ("  cp_async_wait<0>();\n}\n",
         "  cp_async_wait<0>();\n  if (lane == 0 && g_marks) { long long* w = g_marks + static_cast<size_t>(gw) * 4;"
         " w[0] = w_wait; w[1] = w_cells; w[2] = w_store; w[3] = n; }\n}\n"),
    ]
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"dense_tiled.cu no longer has one {old.strip()[:60]!r}: update the probe")
        src = src.replace(old, new)
    return src + '\nextern "C" int rs_set_marks(long long* p) { return cudaMemcpyToSymbol(g_marks, &p, sizeof(p)); }\n'


def build() -> ctypes.CDLL:
    """The instrumented library, its entry points declared as the port's."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "tiled_clocks.cu")
    so = os.path.join(_build.BUILD_DIR, "tiled_clocks.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-shared", "-o", so, cu], check=True,
                   capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(so)
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = argtypes
    lib.rs_set_marks.argtypes = [ctypes.c_void_p]
    return lib


def _stats(x) -> str:
    return f"median {float(np.median(x))!r} mean {float(np.mean(x))!r} p90 {float(np.percentile(x, 90))!r}"


def run(device, spec=None) -> dict:
    """{form: per-phase cycles} of one fused step at ``spec``'s shape
    (default gen-inst1e6), `highest`, the tiled plan's A storage."""
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.probes import tiled_fused
    from recsys_tpu_torch.utils.timing import cuda_event_ms

    if spec is None:
        spec = tiled_fused.gen_spec(tiled_fused.INST1E6)
    plan = trainer.dense_plan(spec, tiled=True)
    g = torch.Generator(device=device).manual_seed(0)
    L = torch.rand((plan.U, plan.K), generator=g, device=device) / spec.features
    R = torch.rand((plan.I, plan.K), generator=g, device=device) / spec.features
    A = dt.device_dense_A(spec, plan.U, plan.I, plan.a_dtype, device)
    At = A.t().contiguous()
    rated = (A != 0).sum(1).cpu().numpy()
    lib = build()
    prev, _build._lib = _build._lib, lib  # the wrappers call the instrumented library
    out = {}
    try:
        for form in ("warp", "ring"):
            marks = torch.zeros(plan.U * MARKS, dtype=torch.int64, device=device)
            step = lambda: dt.tiled_gd_step(L, R, A, alpha2=2.0 * spec.alpha, At=At, form=form)  # noqa: E731
            unmarked = cuda_event_ms(step, 5)
            if lib.rs_set_marks(ctypes.c_void_p(marks.data_ptr())) != 0:
                raise RuntimeError("rs_set_marks failed")
            marked = cuda_event_ms(step, 1)
            lib.rs_set_marks(ctypes.c_void_p(0))
            print(f"[clocks] {form} form: one step {unmarked!r} ms with the marks off, {marked!r} ms with them on "
                  f"(each mark waits for the value before it)", flush=True)
            m = marks.view(plan.U, MARKS).cpu().numpy().astype(np.float64)
            if form == "warp":
                own, walk, store = m[:, 0], m[:, 1], m[:, 2]
                slope, fixed = np.polyfit(rated, walk, 1)
                print(f"[clocks] L pass, warp form, {plan.U} users ({float(rated.mean())!r} rated cells a user): "
                      f"cycles a user: own L row in {_stats(own)}; walk {_stats(walk)}; stores {_stats(store)}; "
                      f"walk fitted {fixed!r} + {slope!r} a rated cell", flush=True)
                out[form] = {"own": own, "walk": walk, "store": store, "fixed": fixed, "per_cell": slope}
            else:
                warps = m[m[:, 3] > 0]
                users = warps[:, 3].sum()
                per_user = {name: warps[:, j].sum() / users for j, name in enumerate(("wait", "cells", "store"))}
                print(f"[clocks] L pass, ring form, {len(warps)} warps, {int(users)} users: cycles a user: stage wait "
                      f"{per_user['wait']!r}, cells {per_user['cells']!r}, stores {per_user['store']!r}", flush=True)
                out[form] = per_user
        return out
    finally:
        _build._lib = prev


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tiled_clocks: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[clocks] {smi}", flush=True)
    run(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
