"""Host staging-buffer allocation at hugepage speed, with reuse.  A copy
of ``recsys_tpu/utils/hostmem.py``, kept in the port so that it imports
nothing of the JAX package.

Two measured pathologies of this virtualized host class shape every
GB-scale staging buffer here:

* First-touch page faults cost ~5 us per 4 KB page, so a freshly
  allocated buffer is written at ~200 MB/s no matter how fast the
  writer is (the native RNG runs ~190 M draws/s into warm pages, 18 M
  into fresh ones).  ``MADV_HUGEPAGE`` cuts the fault count 512x
  (measured 9.4x faster first touch).
* Page *supply* is throttled beyond a ~3 GB burst: later fresh
  allocations fault in at ~0.05-0.2 GB/s even with hugepages, while
  REWRITING already-faulted pages runs ~2.4 GB/s.  No cgroup limit is
  set; this is hypervisor-level.  The only fix is reuse — hence the
  pool: freed buffers (detected by refcount, so a live view can never
  be handed out twice) are recycled by exact size.

Anonymous mmap pages read as zero on first touch; recycled buffers are
re-zeroed explicitly (a warm memset, which is the cheap case).
"""

from __future__ import annotations

import ctypes
import math
import mmap
import sys

import numpy as np

_MADV_HUGEPAGE = 14
# Below this, regular allocation is fine (few pages; THP granule is 2 MB).
_MIN_BYTES = 4 << 20

# size-in-bytes -> [mmap, ...] of previously handed-out buffers. A buffer
# is reusable iff nothing outside this list references it (refcount 2:
# the list entry + the getrefcount argument); live numpy views keep a
# base chain to the mmap, so reuse can never alias live data.
_pool: dict[int, list[mmap.mmap]] = {}
_POOL_CAP_BYTES = 48 << 30
_pool_bytes = 0


def _alloc(nbytes: int):
    """-> (mmap, fresh: bool), hugepage-advised."""
    global _pool_bytes
    for buf in _pool.get(nbytes, ()):
        if sys.getrefcount(buf) == 3:  # list + loop var + argument
            return buf, False
    buf = mmap.mmap(-1, nbytes)
    try:
        addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        ctypes.CDLL(None).madvise(
            ctypes.c_void_p(addr), ctypes.c_size_t(nbytes), _MADV_HUGEPAGE
        )
    except Exception:  # pragma: no cover - madvise is advisory anyway
        pass
    if _pool_bytes + nbytes <= _POOL_CAP_BYTES:
        _pool.setdefault(nbytes, []).append(buf)
        _pool_bytes += nbytes
    return buf, True


def hugepage_empty(shape, dtype) -> np.ndarray:
    """np.empty on pooled THP-backed pages for large buffers. Contents
    are arbitrary (zero only when the backing mmap is brand new)."""
    dtype = np.dtype(dtype)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    nbytes = math.prod(shape) * dtype.itemsize
    if nbytes < _MIN_BYTES:
        return np.empty(shape, dtype)
    buf, _ = _alloc(nbytes)
    return np.frombuffer(buf, dtype).reshape(shape)


def hugepage_zeros(shape, dtype) -> np.ndarray:
    """Zero-initialized THP-backed pooled buffer."""
    dtype = np.dtype(dtype)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    nbytes = math.prod(shape) * dtype.itemsize
    if nbytes < _MIN_BYTES:
        return np.zeros(shape, dtype)
    buf, fresh = _alloc(nbytes)
    a = np.frombuffer(buf, dtype).reshape(shape)
    if not fresh:
        a[...] = 0  # warm memset: ~2.4 GB/s vs ~0.2 fresh
    return a


def take_cast(src: np.ndarray, idx: np.ndarray, out: np.ndarray, chunk: int = 1 << 16):
    """``out[:len(idx)] = src[idx].astype(out.dtype)`` without
    materializing the gathered array in the source dtype (an f64->f32
    factor permute at 1M x 1000 would otherwise stage an 8 GB temp
    through cold pages).  np.take requires matching dtypes, so casts go
    through one reusable chunk-sized temp."""
    n = len(idx)
    tmp = None if src.dtype == out.dtype else np.empty((min(chunk, n), *src.shape[1:]), src.dtype)
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        if tmp is None:
            np.take(src, idx[i:j], axis=0, out=out[i:j])
        else:
            np.take(src, idx[i:j], axis=0, out=tmp[: j - i])
            out[i:j] = tmp[: j - i]
    return out
