"""Where a step of B1's and B2's sparse form goes: phase clocks of one loop-form
step at instML100k's shape.

    python -m recsys_tpu_torch.probes.resident_clocks

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
copies ``csrc/dense_fused.cu``, marks each phase of ``grad_unit`` with
``clock64()`` (and the unit's start and end with the global timer) by text
substitution, builds the copy with the port's nvcc flags into
``build/recsys_tpu_torch/resident_clocks.so`` and runs three loop-form steps
through the ordinary wrapper with that library in place of the built one.
The marks of the last step give, per unit, the cycles of: staging its own
columns (a round trip), staging the sub-strip's rows and cells (a round
trip), phase A, phase B and the partial's write.  It does this with the
blocks an SM the kernel's shared memory allows and again with one and two
blocks an SM (shared memory padded), so contention for the SM and the
latency of one round trip can be told apart.  Then, with the built
library, one step by kernel (``torch.profiler``) in the dense and loop forms
and the loop and persistent forms' slopes in turns (``step_split``).  The
sparse form's own kernels are not changed; nothing of this runs in the
engine.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops import dense_fused as df
from recsys_tpu_torch.probes import resident_sparse

PHASES = ("own columns", "rows + cells", "phase A", "phase B", "write")
# Shared memory a block asks for, to hold the blocks an SM at 1 and 2.
FORCED = {"as many as fit": 0, "1 block an SM": 150 << 10, "2 blocks an SM": 100 << 10}


def _mark(j: int) -> str:
    return f"if (threadIdx.x == 0 && g_marks) g_marks[blockIdx.x * 8 + {j}] = clock64();"


def _timer(j: int) -> str:
    return ("if (threadIdx.x == 0 && g_marks) { long long gt; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
            f": \"=l\"(gt)); g_marks[blockIdx.x * 8 + {j}] = gt; }}")


def instrumented_source() -> str:
    """dense_fused.cu with the phase marks, a shared-memory floor and their setters."""
    with open(os.path.join(_build.CSRC, "dense_fused.cu")) as f:
        src = f.read()
    subs = [
        ("namespace {\n", "namespace {\n__device__ long long* g_marks = nullptr;\nsize_t g_smem_floor = 0;\n"),
        ("  __syncthreads();  // the block's previous unit is done with shared memory\n",
         "  __syncthreads();  // the block's previous unit is done with shared memory\n" + _timer(6) + _mark(0) + "\n"),
        ("    __syncthreads();  // this segment's bounds are in; the previous sub-strip's readers are done\n",
         "    __syncthreads();  // this segment's bounds are in; the previous sub-strip's readers are done\n"
         "    if (sub == 0) { " + _mark(1) + " }\n"),
        ("    __syncthreads();\n\n    // (A) pred", "    __syncthreads();\n    if (sub == 0) { " + _mark(2) + " }\n\n    // (A) pred"),
        ("    __syncthreads();\n\n    // (B)", "    __syncthreads();\n    if (sub == 0) { " + _mark(3) + " }\n\n    // (B)"),
        ("  __syncthreads();  // phase A's readers of the X columns are done\n",
         "  __syncthreads();  // phase A's readers of the X columns are done\n  " + _mark(4) + "\n"),
        ("    sd.part[(static_cast<size_t>(s) * K + k) * sd.N + c0 + cc] = tp[idx];\n  }\n}\n",
         "    sd.part[(static_cast<size_t>(s) * K + k) * sd.N + c0 + cc] = tp[idx];\n  }\n  "
         + _mark(5) + _timer(7) + "\n}\n"),
        ("  const size_t smem = sparse_smem_bytes(G, P, a.SR, a.cap);\n",
         "  const size_t smem = std::max(sparse_smem_bytes(G, P, a.SR, a.cap), g_smem_floor);\n"),
    ]
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"dense_fused.cu no longer has one {old.strip()[:60]!r}: update the probe")
        src = src.replace(old, new)
    return src + ('\nextern "C" int rs_set_marks(long long* p) { return cudaMemcpyToSymbol(g_marks, &p, sizeof(p)); }\n'
                  'extern "C" void rs_smem_floor(long long b) { g_smem_floor = (size_t)b; }\n')


def build() -> ctypes.CDLL:
    """The instrumented library, its entry points declared as the port's."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "resident_clocks.cu")
    so = os.path.join(_build.BUILD_DIR, "resident_clocks.so")
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
    lib.rs_smem_floor.argtypes = [ctypes.c_longlong]
    return lib


def unit_cells(walk: df.Walk) -> np.ndarray:
    """Cells of each unit in the order the loop form launches them."""
    G, chunk_l, _, chunk_r, _ = walk.split
    BC = df.UNIT_COLS // G
    per_side = []
    for off, chunk in ((walk.l_off, chunk_l), (walk.r_off, chunk_r)):
        off = off.long().cpu().numpy()
        per_side.append(np.diff(off[:: BC * -(-chunk // walk.sub)]))
    return np.concatenate(per_side)[walk.units.cpu().numpy()]


def run(device) -> dict:
    """{setting: (per-phase cycles (units, 5), unit start and end in ns)} at
    instML100k's shape, `highest`."""
    lib = build()
    prev, _build._lib = _build._lib, lib  # the wrappers call the instrumented library
    try:
        spec = resident_sparse.ml100k_spec()
        Lt, Rt, At = resident_sparse.inputs(spec, device)
        walk = df.resident_walk(At, Lt.shape[0])
        cells = unit_cells(walk)
        n = walk.units.numel()
        kw = dict(iters=3, alpha2=2.0 * spec.alpha, precision="highest", walk=walk, form="loop")
        out = {}
        for label, floor in FORCED.items():
            lib.rs_smem_floor(floor)
            marks = torch.zeros(n * 8, dtype=torch.int64, device=device)
            df.resident_train(Lt, Rt, At, **kw)  # warm
            if lib.rs_set_marks(ctypes.c_void_p(marks.data_ptr())) != 0:
                raise RuntimeError("rs_set_marks failed")
            df.resident_train(Lt, Rt, At, **kw)
            torch.cuda.synchronize()
            lib.rs_set_marks(ctypes.c_void_p(0))
            m = marks.view(n, 8).cpu().numpy().astype(np.float64)
            phases = np.diff(m[:, :6], axis=1)
            start, end = m[:, 6] - m[:, 6].min(), m[:, 7] - m[:, 6].min()
            out[label] = (phases, start, end)
            print(f"[clocks] {label}: {n} units, cells median {float(np.median(cells))!r} max {int(cells.max())}; "
                  f"step span {float(end.max()) / 1e3!r} us, unit wall median "
                  f"{float(np.median(end - start)) / 1e3!r} us", flush=True)
            marked = np.all((phases >= 0) & (phases < 1e9), axis=1)  # an empty first sub-strip skips A and B
            for j, name in enumerate(PHASES):
                ok = phases[marked, j]
                print(f"[clocks] {label} {name}: cycles median {float(np.median(ok))!r} "
                      f"p90 {float(np.percentile(ok, 90))!r} max {float(ok.max())!r}", flush=True)
        return out
    finally:
        lib.rs_smem_floor(0)
        _build._lib = prev


def _kernel_us(fn, n: int, name: str, reps: int = 3) -> float:
    """Mean device µs of one launch of the kernel whose name holds
    ``name``, from ``torch.profiler`` over ``reps`` calls of ``fn()`` that
    each launch it ``n`` times.  A profile can miss launches (see
    ``timing.cuda_event_ms``), so this raises unless it saw every one."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == cuda and name in e.name]
    if len(us) != reps * n:
        raise RuntimeError(f"the profiler saw {len(us)} launches of {name}, not {reps * n}")
    return sum(us) / len(us)


def step_split(device, n: int = 200) -> dict:
    """One step at instML100k's shape in `highest` by kernel, from
    ``torch.profiler``'s device time over ``n`` steps (the built library,
    one launch of each kernel a step):
    the dense form's ``grad_pass`` and ``apply_update``, the loop form's
    ``sparse_grad`` and ``sparse_update``; then the loop and persistent
    forms' slopes in turns (n and 3n steps).  The persistent form's step
    less the loop form's two kernels is what its two grid barriers and its
    dealing of units cost beyond the loop form's kernels."""
    from recsys_tpu_torch.utils.timing import alternating_ms

    spec = resident_sparse.ml100k_spec()
    Lt, Rt, At = resident_sparse.inputs(spec, device)
    walk = df.resident_walk(At, Lt.shape[0])
    kw = dict(alpha2=2.0 * spec.alpha, precision="highest")
    out = {}
    for form, fn, names in (
            ("dense", lambda m: df.resident_train_dense(Lt, Rt, At, iters=m, **kw), ("grad_pass", "apply_update")),
            ("loop", lambda m: df.resident_train(Lt, Rt, At, iters=m, walk=walk, form="loop", **kw),
             ("sparse_grad", "sparse_update"))):
        for name in names:
            out[name] = _kernel_us(lambda: fn(n), n, name)
            print(f"[clocks] {form} form, {name}: {out[name]!r} us of device time a step", flush=True)
    forms = {f: (lambda m, f=f: df.resident_train(Lt, Rt, At, iters=m, walk=walk, form=f, **kw))
             for f in ("loop", "persistent")}
    ms = alternating_ms({(f, m): (lambda fn=fn, m=m: fn(m)) for f, fn in forms.items() for m in (3 * n, n)})
    for f in forms:
        out[f] = (ms[f, 3 * n] - ms[f, n]) / (2 * n) * 1e3
    kernels = out["sparse_grad"] + out["sparse_update"]
    print(f"[clocks] slopes in turns: loop {out['loop']!r} us a step (its kernels {kernels!r}), persistent "
          f"{out['persistent']!r} (beyond the loop form's kernels: {out['persistent'] - kernels!r})", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("resident_clocks: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[clocks] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    run(dev)
    step_split(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
