"""Build and load the port's CUDA kernels (nvcc -> .so -> ctypes).

``csrc/*.cu`` compile at first use into ``build/recsys_tpu_torch/`` at
the repository root, one nvcc process per source, all started together,
and link into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds).  The library's name
carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  A failed build raises: nothing falls
back to the plain torch path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "recsys_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH_FLAGS]

_lock = threading.Lock()
_lib = None
# ptxas's report of the last build (registers, shared memory, spills).
build_log = ""


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if no library for these sources exists; returns its path."""
    global build_log
    srcs = sources()
    so = os.path.join(BUILD_DIR, f"librecsys_tpu_torch_{_digest(srcs)}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{so}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in srcs]
    procs = [
        subprocess.Popen([nvcc_path(), *FLAGS, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)
    ]
    logs, failed = [], False
    for proc in procs:
        out, _ = proc.communicate(timeout=900)
        logs.append(out)
        failed |= proc.returncode != 0
    if not failed:
        r = subprocess.run([nvcc_path(), *ARCH_FLAGS, "-shared", "-o", f"{tag}.tmp", *objs],
                           capture_output=True, text=True, timeout=300)
        logs.append(r.stdout + r.stderr)
        failed = r.returncode != 0
    build_log = "".join(logs)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    os.replace(f"{tag}.tmp", so)
    return so


_P, _I, _F, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_double
# Each C entry point's arguments (csrc/*.cu); pointers and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints.
SIGNATURES = {
    # At, a_kind, Lt_in .. top1 (11 pointers), K, U, I, G, iters, alpha2,
    # precision, items_true, chunk_l, s_l, chunk_r, s_r, stream
    "rs_resident_train_top1": [_P, _I, *[_P] * 11, *[_I] * 5, _F, _I, _I, *[_I] * 4, _P],
    # At, a_kind, Lt_in .. part_r (8 pointers), K, U, I, G, iters, alpha2,
    # precision, chunk_l, s_l, chunk_r, s_r, stream
    "rs_resident_train": [_P, _I, *[_P] * 8, *[_I] * 5, _F, _I, *[_I] * 4, _P],
    # the walk's 9 tables, tickets, cap, Lt_in .. part_r (8 pointers), K, U,
    # I, G, iters, alpha2, precision, chunk_l, s_l, chunk_r, s_r, SR, form,
    # stream
    "rs_resident_sparse_train": [*[_P] * 10, _I, *[_P] * 8, *[_I] * 5, _F, *[_I] * 7, _P],
    # the walk's 9 tables, tickets, cap, At, a_kind, Lt_in .. part_r, ops,
    # top_val, top_idx, top1 (12 pointers), K, U, I, G, iters, alpha2,
    # precision, items_true, chunk_l, s_l, chunk_r, s_r, SR, form,
    # top_chunk, top_S, stream
    "rs_resident_sparse_train_top1": [*[_P] * 10, _I, _P, _I, *[_P] * 12, *[_I] * 5, _F, *[_I] * 10, _P],
    # At, a_kind, Lt, Rt, ops, top_val, top_idx, top1, best, K, U, I, G,
    # precision, items_true, chunk, S, form, stream
    "rs_stream_top1": [_P, _I, *[_P] * 7, *[_I] * 9, _P],
    # At, a_kind, Lt_in .. part_r (8 pointers), K, U, I, G, C, iters, alpha2,
    # precision, chunk, S, stream
    "rs_stream_train": [_P, _I, *[_P] * 8, *[_I] * 6, _F, *[_I] * 3, _P],
    # the walk's 8 tables, cap, Lt_in .. part_r (8 pointers), K, U, I, G,
    # C, iters, alpha2, precision, chunk, S, SR, stream
    "rs_stream_sparse_train": [*[_P] * 8, _I, *[_P] * 8, *[_I] * 6, _F, *[_I] * 4, _P],
    # the walk's 8 tables, cap, At, a_kind, Lt_in .. part_r, ops, top_val,
    # top_idx, top1 (12 pointers), K, U, I, G, C, iters, alpha2, precision,
    # items_true, chunk, S, SR, top_chunk, top_S, stream
    "rs_stream_train_top1": [*[_P] * 8, _I, _P, _I, *[_P] * 12, *[_I] * 6, _F, *[_I] * 7, _P],
    # the walk's 8 tables, cap, Lt_in, Rp_in .. part_r (8 pointers), K, U,
    # I, strip, G, C, iters, alpha2, chunk, S, SR, stream
    "rs_stream_v2_sparse_train": [*[_P] * 8, _I, *[_P] * 8, *[_I] * 7, _F, *[_I] * 3, _P],
    # A, At, a_kind, L, R, dL, dR, part, U, I, K, precision, chunk, S, stream
    "rs_tiled_deltas": [_P, _P, _I, *[_P] * 5, *[_I] * 6, _P],
    # A, At, a_kind, L, R, Lout, Rout, part, U, I, K, precision, chunk, S,
    # alpha2, form, stream
    "rs_tiled_step": [_P, _P, _I, *[_P] * 5, *[_I] * 6, _F, _I, _P],
    # own, other, out, idx, vals, narrow, nb_narrow, warps, wide, nb_wide,
    # blocks, order, k, pad, alpha2, dtype, threads, chunk, stream
    "rs_bell_side_update": [*[_P] * 6, _I, _LL, _P, _I, _LL, _P, _I, _I, _D, _I, _I, _I, _P],
    # the same arguments; out receives each row's change (the delta form)
    "rs_bell_side_delta": [*[_P] * 6, _I, _LL, _P, _I, _LL, _P, _I, _I, _D, _I, _I, _I, _P],
    # L, R, l0, l1, r0, r1; per side (user, item): cols, vals, narrow,
    # nb_narrow, warps, wide, nb_wide, blocks; order, iters, k, users,
    # items, alpha2, dtype, threads, chunk, stream
    "rs_bell_train": [*[_P] * 6, *[_P, _P, _P, _I, _LL, _P, _I, _LL] * 2, _P, *[_I] * 4, _D, *[_I] * 3, _P],
    # dtype, k, threads, chunk
    "rs_bell_resident": [_I, _I, _I, _I],
    # table, idx, out, S, K, stream
    "rs_gather_rows": [_P, _P, _P, _LL, _I, _P],
    # table, idx, vals, out, S, K, blk, stream
    "rs_gather_err_grad": [*[_P] * 4, _LL, _I, _I, _P],
    "rs_gather_err_grad_direct": [*[_P] * 4, _LL, _I, _I, _P],
    # tab, idx, out, scratch, S, W, t, grid, span, threads, slots, stream
    "rs_lane_gather_loop": [*[_P] * 4, *[_I] * 7, _P],
    # tab, idx, out, S, W, t, grid, span, threads, stream
    "rs_lane_gather_loop_direct": [*[_P] * 3, *[_I] * 6, _P],
    # x, out, S, W, C, t, clusters, stream
    "rs_lane_cumsum_loop": [*[_P] * 2, *[_I] * 4, _P, _P],
    # x, out, S, W, t, stream
    "rs_lane_cumsum_loop_block": [*[_P] * 2, *[_I] * 3, _P],
    # jumps, count, segment, log_threads, window (host), out, n, scale,
    # words, stream
    "rs_glibc_init": [_P, _I, _I, _I, _P, _P, _LL, _F, _I, _P],
    # A, a_kind, Lt_in .. part_r (8 pointers), K, U, I, strip, G, C, iters,
    # alpha2, chunk, S, stream
    "rs_stream_v2_train": [_P, _I, *[_P] * 8, *[_I] * 7, _F, _I, _I, _P],
}


def load() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
    return _lib
