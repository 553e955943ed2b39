"""ctypes loader for the native host-ingest library: a copy of
``recsys_tpu/io/_native.py``, kept in the port so that it imports nothing
of the JAX package, plus the port's own printed-list entry.

It builds two sources with ``cc`` on first use, with the same flags as
the JAX package, into one ``build/recsys_tpu_torch/librecsys_native.so``
at the repository root: ``recsys_tpu_torch/csrc/recsys_native.c`` (a
copy of ``native/recsys_native.c``) and the port-only
``recsys_tpu_torch/csrc/recsys_format.c`` (``rs_format_top1``, the
printed top-1 list).  A cached library older than either source is
rebuilt.  Every entry point degrades to the numpy implementation when the
toolchain or the build is missing, so the package never hard-depends on
a compiler at runtime; a library without ``rs_format_top1`` leaves only
``format_top1`` to its numpy twin.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "recsys_native.c")
_FORMAT_SRC = os.path.join(_PKG, "csrc", "recsys_format.c")
_SO = os.path.join(os.path.dirname(_PKG), "build", "recsys_tpu_torch", "librecsys_native.so")
_HOSTSIG = _SO + ".host"
_lock = threading.Lock()
_lib = None
_failed = False
_format = None  # rs_format_top1, where the loaded library has it
_INT32 = np.iinfo(np.int32)


def _host_signature() -> str:
    """CPU-feature fingerprint of this host: a -march=native .so built
    elsewhere (repo copied between machines) could SIGILL here, so a
    cached library is only reused when the fingerprint matches."""
    import hashlib
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return hashlib.sha256((platform.machine() + flags).encode()).hexdigest()[:16]


def _build() -> bool:
    # -march=native lets the correctly-rounded software division in
    # rs_glibc_rand01 lower to vfmadd instead of a libm call, and (unlike
    # a bare -mfma) only emits instructions the build host itself has, so
    # the cached .so can never SIGILL on the machine that built it.
    # -ffp-contract=off: rs_serial_gd's bit-exact-trajectory contract
    # forbids implicit a*b+c fusion (the reference binary is built
    # without optimization and never contracts); explicit fma() calls —
    # the Newton division — are unaffected by the flag.
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for flags in (["-O3", "-march=native", "-ffp-contract=off"], ["-O3", "-ffp-contract=off"]):
        for cc in ("cc", "gcc", "clang"):
            try:
                r = subprocess.run(
                    [cc, *flags, "-shared", "-fPIC", "-o", tmp, _SRC, _FORMAT_SRC, "-lm"],
                    capture_output=True,
                    timeout=120,
                )
                if r.returncode == 0:
                    # Another process may build at the same time: each
                    # writes its own file and renames it into place.
                    os.replace(tmp, _SO)
                    with open(_HOSTSIG, "w") as f:
                        f.write(_host_signature())
                    return True
            except (OSError, subprocess.TimeoutExpired):
                continue
    return False


def _load():
    global _lib, _failed, _format
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            stale = not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
                os.path.getmtime(_SRC), os.path.getmtime(_FORMAT_SRC))
            if not stale:
                try:
                    with open(_HOSTSIG) as f:
                        stale = f.read().strip() != _host_signature()
                except OSError:
                    stale = True  # unsigned .so: possibly built elsewhere
            if stale:
                if not _build():
                    _failed = True
                    return None
            lib = ctypes.CDLL(_SO)
            lib.rs_parse_entries.restype = ctypes.c_long
            lib.rs_parse_entries.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.rs_rand01_sequence.restype = None
            lib.rs_rand01_sequence.argtypes = [ctypes.c_long, ctypes.c_int32, ctypes.c_void_p]
            lib.rs_format_entries.restype = ctypes.c_long
            lib.rs_format_entries.argtypes = [
                ctypes.c_long,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.rs_serial_gd.restype = None
            lib.rs_serial_gd.argtypes = [
                ctypes.c_long,
                ctypes.c_double,
                *([ctypes.c_long] * 4),
                *([ctypes.c_void_p] * 7),
            ]
            lib.rs_bell_side.restype = ctypes.c_long
            lib.rs_bell_side.argtypes = [
                ctypes.c_long,                 # nnz
                *([ctypes.c_void_p] * 5),      # own, other, vals, inv_own, inv_other
                *([ctypes.c_long] * 4),        # dim, other_dim, total, nb
                *([ctypes.c_void_p] * 3),      # b0, b1, base
                ctypes.c_void_p,               # cols_flat
                ctypes.c_void_p,               # vals_flat
                ctypes.c_int,                  # vals_f64
                *([ctypes.c_void_p] * 2),      # slot_next, bkt_of
            ]
            try:
                fmt = lib.rs_format_top1
            except AttributeError:
                fmt = None  # a library built without recsys_format.c
            else:
                fmt.restype = ctypes.c_long
                fmt.argtypes = [ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_void_p]
            _format = fmt
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def parse_entries(body: bytes, nnz: int):
    """Parse nnz 'row col value' lines; None on unavailable/fallback."""
    lib = _load()
    if lib is None:
        return None
    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=np.float64)
    got = lib.rs_parse_entries(
        body,
        len(body),
        nnz,
        rows.ctypes.data,
        cols.ctypes.data,
        vals.ctypes.data,
    )
    if got != nnz:  # truncated (>=0) or exotic-float fallback (<0)
        return None
    return rows, cols, vals


def load_problem(path: str):
    """Full native-path load of a .in file; None to fall back."""
    lib = _load()
    if lib is None:
        return None
    from recsys_tpu_torch.config import ProblemSpec
    from recsys_tpu_torch.io.parser import ParseError

    with open(path, "rb") as f:
        data = f.read()
    off = 0
    fields = []
    for _ in range(4):
        nl = data.find(b"\n", off)
        if nl < 0:
            raise ParseError("truncated header")
        fields.append(data[off:nl])
        off = nl + 1
    try:
        iters = int(fields[0])
        alpha = float(fields[1])
        features = int(fields[2])
        users, items, nnz = (int(t) for t in fields[3].split())
    except Exception as e:  # noqa: BLE001
        raise ParseError(f"malformed header: {e}") from e
    if min(iters, features, users, items) <= 0 or nnz < 0:
        raise ParseError("non-positive dimension in header")
    parsed = parse_entries(data[off:], nnz)
    if parsed is None:
        return None
    rows, cols, vals = parsed
    if rows.size and (
        rows.max() >= users or cols.max() >= items or rows.min() < 0 or cols.min() < 0
    ):
        raise ParseError("entry index out of range")
    return ProblemSpec(
        iters=iters,
        alpha=alpha,
        features=features,
        users=users,
        items=items,
        rows=rows,
        cols=cols,
        vals=vals,
    )


def rand01(n: int, seed: int):
    """First n glibc RAND01 draws after srandom(seed); None to fall back."""
    lib = _load()
    if lib is None:
        return None
    # THP-backed output: into fresh 4 KB pages the generator is
    # fault-bound at ~18 M draws/s on this host class; hugepages restore
    # the ~190 M draws/s the code actually runs at (utils/hostmem.py).
    from recsys_tpu_torch.utils.hostmem import hugepage_empty

    out = hugepage_empty(n, np.float64)
    lib.rs_rand01_sequence(n, seed, out.ctypes.data)
    return out


def serial_gd(spec, L: np.ndarray, R: np.ndarray):
    """Run the full sequential GD trajectory in place on (users,k) L and
    (items,k) R float64 arrays — the reference's serial regime
    (``matFact.c:29-59``) as this framework's sub-dispatch-floor engine.
    Returns (L, R) or None to fall back (no native toolchain)."""
    lib = _load()
    if lib is None:
        return None
    L = np.ascontiguousarray(L, np.float64)
    R = np.ascontiguousarray(R, np.float64)
    rows = np.ascontiguousarray(spec.rows, np.int32)
    cols = np.ascontiguousarray(spec.cols, np.int32)
    vals = np.ascontiguousarray(spec.vals, np.float64)
    Ls = np.empty_like(L)
    Rs = np.empty_like(R)
    lib.rs_serial_gd(
        spec.iters,
        spec.alpha,
        spec.features,
        spec.users,
        spec.items,
        spec.nnz,
        rows.ctypes.data,
        cols.ctypes.data,
        vals.ctypes.data,
        L.ctypes.data,
        R.ctypes.data,
        Ls.ctypes.data,
        Rs.ctypes.data,
    )
    return L, R


def bell_side_tables(own, other, vals, inv_own, inv_other, other_dim, bounds, dtype):
    """One BELL side's flat (cols, vals) tables in a single native pass
    -- bit-identical to the numpy builder (ops/bell.py::_side_tables
    fallback).  ``bounds``: ((b0, b1, w), ...) bucket tuples.  Returns
    (cols_flat int32[S], vals_flat dtype[S]) or None to fall back
    (no toolchain, or a dtype the C side does not handle -- bf16)."""
    lib = _load()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None  # bf16 tables keep the numpy path
    from recsys_tpu_torch.utils.hostmem import hugepage_empty

    nb = len(bounds)
    b0 = np.ascontiguousarray([b[0] for b in bounds], np.int64)
    b1 = np.ascontiguousarray([b[1] for b in bounds], np.int64)
    sizes = [int(w * (hi - lo)) for (lo, hi, w) in bounds]
    base = np.ascontiguousarray(np.concatenate([[0], np.cumsum(sizes)[:-1]]) if nb else [], np.int64)
    total = int(sum(sizes))
    dim = len(inv_own)
    own = np.ascontiguousarray(own, np.int32)
    other = np.ascontiguousarray(other, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    inv_own = np.ascontiguousarray(inv_own, np.int32)
    inv_other = np.ascontiguousarray(inv_other, np.int32)
    cols_flat = hugepage_empty(total, np.int32)
    vals_flat = hugepage_empty(total, dt)
    slot_next = np.zeros(dim, np.int32)
    bkt_of = np.empty(dim, np.int32)
    rc = lib.rs_bell_side(
        len(own),
        own.ctypes.data, other.ctypes.data, vals.ctypes.data,
        inv_own.ctypes.data, inv_other.ctypes.data,
        dim, int(other_dim), total, nb,
        b0.ctypes.data, b1.ctypes.data, base.ctypes.data,
        cols_flat.ctypes.data, vals_flat.ctypes.data,
        1 if dt == np.dtype(np.float64) else 0,
        slot_next.ctypes.data, bkt_of.ctypes.data,
    )
    if rc != 0:
        return None
    return cols_flat, vals_flat


def format_entries(rows, cols, vals) -> bytes | None:
    """'row col v.vvvvvv\\n' lines for the .in writer; None to fall back."""
    lib = _load()
    if lib is None:
        return None
    nnz = len(rows)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    buf = ctypes.create_string_buffer(nnz * 32 + 16)
    n = lib.rs_format_entries(
        nnz, rows.ctypes.data, cols.ctypes.data, vals.ctypes.data, buf
    )
    return buf.raw[:n]


def format_top1(top1: np.ndarray, rated_counts: np.ndarray, items: int) -> str | None:
    """The printed top-1 list (``rs_format_top1``); None to fall back: no
    library, or an item that int32 does not hold.  The engine's int32
    arrays go to C as they are: a fresh copy of a 1M-user array costs more
    in first-touch page faults than the pass itself (``utils/hostmem.py``)."""
    if _load() is None or _format is None or not 0 <= items <= _INT32.max:
        return None
    n = len(top1)
    lo, hi = (int(top1.min()), int(top1.max())) if n else (0, 0)
    if lo < _INT32.min or hi > _INT32.max:
        return None
    top1 = np.ascontiguousarray(top1, np.int32)
    if rated_counts.dtype != np.int32:
        rated_counts, items = (rated_counts >= items).astype(np.int32), 1
    rated_counts = np.ascontiguousarray(rated_counts)
    width = len(str(max(-lo, hi))) + (lo < 0) + 1  # digits, sign, newline
    out = np.empty(n * width + 8, np.uint8)  # + the last word store's slack
    wrote = _format(n, top1.ctypes.data, rated_counts.ctypes.data, int(items), out.ctypes.data)
    return str(out.data[:wrote], "ascii")
