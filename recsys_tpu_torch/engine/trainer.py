"""Single-device training engine and end-to-end ``run`` (port of
``recsys_tpu/engine/trainer.py``).

Routes, chosen by ``choose_path`` in the JAX engine's decision order:

* ``host``   -- the native serial engine (``rs_serial_gd``) plus the
  numpy top-1, for problems too small for any device (the port's own
  copy of the native library).
* ``pallas`` -- the route key is kept so ``RunConfig`` stays shared; here
  it is the dense CUDA kernels, or their plain torch twins on a CPU
  device, on the plan ``dense_plan`` picks: ``resident`` (B1
  ``dense_fused.resident_train_top1`` for ``run``, B2
  ``dense_fused.resident_train`` for ``factorize``), ``stream`` (B3
  ``dense_stream.stream_train``, then B4 ``dense_stream.stream_top1`` in
  ``run``) or ``tiled`` (B5's fused step ``dense_tiled.tiled_step`` once
  per step, then ``recommend`` on the factors left on the device in
  ``run``).
* ``bell``   -- the degree-bucketed sparse route in f32, bf16 or exact
  f64: ``bell.bell_train``, one launch of ``bell_step`` (P2's engine form,
  both sides) a step, then ``recommend`` on the factors left on the device
  in ``run``.  In f64 it
  follows the reference's order and gives its factors bit for bit, from
  the host glibc init; in bf16 it computes the JAX package's bf16 step;
  in f32 and bf16 above ``DEVICE_INIT_MIN_DRAWS`` the initial factors are
  drawn on the device (``ops/device_rng.py``).
* ``dense``  -- the three-matmul step of ``ops/dense.py`` in the run's
  dtype (f64 DGEMM on the card), then ``recommend``.
* ``coo``    -- the COO step of ``ops/coo.py`` in the run's dtype: the
  prefix-sum form for the speed dtypes on the card when the ratings
  outnumber the rows (``_coo_use_cumsum``), else the sorted segment sums;
  then ``recommend``.
* A mesh (``cfg.mesh_shape``) hands ``run`` and ``factorize`` to the
  sharded engine, ``parallel/engine.py``, as the JAX CLI's ``_dispatch_run``
  does; its shards all sit on ``device``.  Nothing falls back to another
  route.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from recsys_tpu_torch import convert
from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.models.mf import MFState, init_factors
from recsys_tpu_torch.ops import bell, coo, dense, dense_fused, dense_stream, dense_tiled, device_rng, topk
from recsys_tpu_torch.ops.bell import bell_slot_ratio
from recsys_tpu_torch.utils.timing import count, h2d, phase, span

# Decision constants, unchanged from the JAX engine (trainer.py:62-94).
DENSE_BUDGET_BYTES = 2 << 30
DENSE_BELL_CROSSOVER = 32
DENSE_BELL_CROSSOVER_F64 = 2
DENSE_A_TRANSFER_BUDGET = 256 << 20
HOST_SERIAL_WORK = 50_000_000
HOST_SERIAL_TOP1_FLOPS = 200_000_000

# Device memory the fused dense route may take: half of an 80 GB H100,
# leaving the rest to the caller and to the plain twin it is checked
# against.  See ``dense_plan`` for what is counted.
DEVICE_BUDGET_BYTES = 40 << 30

# Largest A^T, in its storage dtype, that the dense route keeps on the
# resident kernels; above it the stream kernel reads A^T once per step.
# On an H100 at 4.6-4.7% density, whole runs in highest and default
# are faster resident at 3.0 MB of A^T and faster streamed at 5.5 MB and
# above (PERF.md, RESIDENT_A_MAX_BYTES): instML100k (1.8 MB int8) stays
# resident and gen-instML1M (24.4 MB) streams, as the JAX package's
# routes do.
RESIDENT_A_MAX_BYTES = 4 << 20

_ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}

# Above this many glibc draws, ``(users + items) * k``, the f32 and bf16 BELL
# routes draw their initial factors on the device (trainer.py:364): the host init
# of gen-inst1e6-100-700-1-3's 700M draws dominates its wall (PERF.md).
# Every byte-exact golden sits far below it.
DEVICE_INIT_MIN_DRAWS = 200_000_000

# Device dtypes of the bell, dense and coo routes.
_TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _host_serial_ok(spec: ProblemSpec) -> bool:
    """trainer.py:97."""
    from recsys_tpu_torch.io import _native

    return (
        spec.iters * spec.nnz * spec.features <= HOST_SERIAL_WORK
        and spec.users * spec.items * spec.features <= HOST_SERIAL_TOP1_FLOPS
        and _native.available()
    )


def mxu_precision(cfg: RunConfig) -> str:
    """Matmul precision of the f32 dense kernel (trainer.py:107): "auto"
    is true f32 for float32 and one bf16 pass for bfloat16."""
    if cfg.precision != "auto":
        return cfg.precision
    return "default" if cfg.dtype == "bfloat16" else "highest"


def choose_path(spec: ProblemSpec, cfg: RunConfig, device, n_devices: int = 1, allow_host: bool = True) -> str:
    """The JAX engine's path selection (trainer.py:120), with each
    ``jax.default_backend() == "tpu"`` gate read as ``device.type == "cuda"``."""
    if cfg.path != "auto":
        return cfg.path
    if allow_host and n_devices == 1 and _host_serial_ok(spec):
        return "host"
    on_card = torch.device(device).type == "cuda"
    dense_fits = 2 * spec.users * spec.items * _ITEMSIZE[cfg.dtype] <= DENSE_BUDGET_BYTES * n_devices
    if spec.nnz == 0:
        return "dense" if dense_fits else "coo"
    cells = spec.users * spec.items
    slots = 2.0 * spec.nnz * bell_slot_ratio(spec)
    crossover = DENSE_BELL_CROSSOVER_F64 if cfg.dtype == "float64" else DENSE_BELL_CROSSOVER
    if cells > crossover * slots or not dense_fits:
        return "bell"
    if cfg.dtype != "float64" and on_card and cells * 4 > DENSE_A_TRANSFER_BUDGET and cells > 4 * slots:
        return "bell"
    if cfg.dtype in ("float32", "bfloat16") and on_card and dense_fused.mask_is_implicit(spec):
        return "pallas"
    return "dense"


def _factorize_host_serial(spec: ProblemSpec, state: MFState | None = None) -> MFState:
    """The native sequential trajectory (trainer.py:336): exact f64,
    bit-identical to the reference binary."""
    from recsys_tpu_torch.io import _native

    if state is None:
        state = init_factors(spec.users, spec.items, spec.features)
    out = _native.serial_gd(
        spec,
        np.array(state.L, np.float64, order="C"),
        np.array(state.R, np.float64, order="C"),
    )
    if out is None:  # no native toolchain: the numpy oracle is the same math
        from recsys_tpu_torch.engine.oracle import factorize_numpy

        return factorize_numpy(spec, state=state)[0]
    return MFState(L=out[0], R=out[1])


def _a_storage(spec: ProblemSpec) -> tuple[torch.dtype, int]:
    """(dtype, bytes) of the most compact EXACT A storage (trainer.py:423):
    int8 at 2x the rating, else bf16, else f32.  Every choice gives the
    kernel the same f32 values."""
    if dense_fused.vals_int8_exact(spec):
        return torch.int8, 1
    if dense_fused.vals_bf16_exact(spec):
        return torch.bfloat16, 2
    return torch.float32, 4


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """The dense route's layout: kernel kind (``resident``, ``stream`` or
    ``tiled``), A storage, padded dims, and the device bytes it needs at
    most."""

    kind: str
    a_dtype: torch.dtype
    U: int
    I: int
    K: int
    device_bytes: int


def _top1_block(spec: ProblemSpec, block_items: int) -> int:
    """Items per block of ``recommend``'s top-1, the JAX engine's block and
    cap rule (trainer.py:658-660): at most 16M (user, item) cells a tile."""
    cap = (16_000_000 // max(spec.users, 1)) // 128 * 128
    return max(min(block_items, -(-spec.items // 128) * 128, max(cap, 128)), 128)


def dense_plan(spec: ProblemSpec, *, a_max_bytes: int = RESIDENT_A_MAX_BYTES, tiled: bool = False) -> DensePlan:
    """Hopper plan in place of the TPU's ``_pallas_plan`` (trainer.py:482)
    and ``stream_vmem_bytes`` (pallas_dense.py:507).

    VMEM strips and budgets are TPU facts and have no counterpart: the
    whole problem lives in device memory and the kernels tile it
    themselves.  The plan picks the A storage, pads U and I to 128, and
    picks the kind:

    * K (k padded to 8) up to ``dense_fused.MAX_K``: ``resident`` when A^T
      in its storage dtype takes at most ``a_max_bytes``, else ``stream``.
      Bytes: dense A^T, the six factor tables (input, output and ping-pong
      for each side), the training kernel's partial sums and the sparse
      walk's tables (for ``resident`` the sums at their largest, one chunk
      per 32 reduction columns, and the tables as ``dense_fused.walk_bytes``
      counts them on an H100; for ``stream`` as
      ``dense_stream.stream_partial_bytes`` and ``stream_walk_bytes`` count
      them), and the tiled top-1's buffers in `bf16x3`, the precision that
      needs the most (``dense_fused.top1_bytes``).
    * ``tiled`` for wider factors (K padded to 32, up to
      ``dense_tiled.MAX_K``), when the other kinds need more than
      ``DEVICE_BUDGET_BYTES``, or when ``tiled`` forces it.  Bytes: what
      ``dense_tiled.tiled_train`` holds (``dense_tiled.train_bytes``: A and
      its transpose, L and R as input and two sets of next factors, the dR
      partial sums on an H100), and ``recommend``'s (users, block) f32 tile
      with its masked copy.

    A plan above ``DEVICE_BUDGET_BYTES`` raises.  It does not depend on the
    device, so CPU runs take the card's routes.
    """
    a_dtype, a_bytes = _a_storage(spec)
    U = dense_fused.round_up(spec.users, 128)
    I = dense_fused.round_up(spec.items, 128)
    K = dense_fused.round_up(spec.features, 8)
    if not tiled and K <= dense_fused.MAX_K:
        kind = "resident" if a_bytes * U * I <= a_max_bytes else "stream"
        partials = (4 * 2 * K * U * I // 32 + dense_fused.walk_bytes(K, U, I, spec.nnz) if kind == "resident"
                    else dense_stream.stream_partial_bytes(K, U, I) + dense_stream.stream_walk_bytes(K, U, I, spec.nnz))
        need = a_bytes * U * I + 4 * 3 * K * (U + I) + partials + dense_fused.top1_bytes(K, U, I, "bf16x3")
        if need <= DEVICE_BUDGET_BYTES:
            return DensePlan(kind=kind, a_dtype=a_dtype, U=U, I=I, K=K, device_bytes=need)
    K = dense_fused.round_up(spec.features, dense_tiled.K_ALIGN)
    if K > dense_tiled.MAX_K:
        raise NotImplementedError(f"k={spec.features} exceeds the tiled kernel's K <= {dense_tiled.MAX_K}")
    need = dense_tiled.train_bytes(U, I, K, a_dtype) + 8 * spec.users * _top1_block(spec, RunConfig.block_items)
    if need > DEVICE_BUDGET_BYTES:
        raise NotImplementedError(f"the tiled plan needs {need} B > DEVICE_BUDGET_BYTES; no dense plan fits")
    return DensePlan(kind="tiled", a_dtype=a_dtype, U=U, I=I, K=K, device_bytes=need)


def _dense_inputs(spec: ProblemSpec, plan: DensePlan, device, state: MFState | None = None):
    """(Lt, Rt, A^T, train keywords) on ``device`` in the plan's layout,
    timed as the ``prep`` and ``upload`` phases.  On the card the keywords
    hold the training kernel's walk of the rated cells, built here (the
    ``walk`` span): B3's on ``stream``, B1's and B2's on ``resident``."""
    with phase("prep"):
        Lt, Rt, _ = dense_fused.pad_factors_for_pallas(spec, state=state)
    with phase("upload") as psync:
        A = dense_fused.device_dense_AT(spec, plan.U, plan.I, plan.a_dtype, device)
        Lt, Rt = h2d(Lt, device), h2d(Rt, device)
        walk = None
        if A.is_cuda:  # the sparse walks' tables: B3's on stream, B1's and B2's on resident
            build = dense_stream.stream_walk if plan.kind == "stream" else dense_fused.resident_walk
            with span("walk"):
                walk = build(A, Lt.shape[0])
        psync((A, Lt, Rt, walk.tables if walk else ()))
    return Lt, Rt, A, ({"walk": walk} if walk else {})


def _pallas_fused_top1(spec: ProblemSpec, plan: DensePlan, precision: str, device) -> np.ndarray:
    """Training loop + masked top-1 on the plan's kernels (trainer.py:683):
    one B1 call on ``resident``; on ``stream``, B3 in the ``train`` phase
    and then B4 in the ``top1`` phase, as the JAX code splits them."""
    Lt, Rt, A, train_kw = _dense_inputs(spec, plan, device)
    kw = dict(alpha2=2.0 * spec.alpha, precision=precision)
    if plan.kind == "stream":
        with phase("train") as psync:
            Lt, Rt = dense_stream.stream_train(Lt, Rt, A, iters=spec.iters, **kw, **train_kw)
            psync((Lt, Rt))
        with phase("top1"):
            top1 = dense_stream.stream_top1(Lt, Rt, A, precision=precision, items_true=spec.items)
            return top1.cpu().numpy()[0, : spec.users]
    with phase("train") as psync:
        _, _, top1 = dense_fused.resident_train_top1(Lt, Rt, A, iters=spec.iters, items_true=spec.items, **kw)
        psync(top1)
    with phase("top1"):
        return top1.cpu().numpy()[0, : spec.users]


def _tiled_train(spec: ProblemSpec, plan: DensePlan, precision: str, device, state: MFState | None = None):
    """The tiled route's ``prep``, ``upload`` and ``train`` phases
    (trainer.py:543-562): lane-major factors and A on ``device``, then
    ``dense_tiled.tiled_train`` (one fused ``tiled_step`` a step).  ``default`` runs as ``highest`` here, as
    the JAX engine does (:550-559); an explicit ``bf16x3`` is honoured.
    Returns the padded (L, R) on ``device``."""
    with phase("prep"):
        L, R, _ = dense_tiled.pad_factors_lane_major(spec, state=state)
    with phase("upload") as psync:
        A = dense_tiled.device_dense_A(spec, plan.U, plan.I, plan.a_dtype, device)
        L, R = h2d(L, device), h2d(R, device)
        psync((A, L, R))
    with phase("train") as psync:
        L, R = dense_tiled.tiled_train(L, R, A, iters=spec.iters, alpha2=2.0 * spec.alpha,
                                       precision="highest" if precision == "default" else precision)
        psync((L, R))
    return L, R


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return device


def _dense_route_ok(spec: ProblemSpec, cfg: RunConfig) -> None:
    if cfg.dtype == "float64":
        raise ValueError("the fused dense route computes in float32; exact float64 takes the bell or dense route")
    if not dense_fused.mask_is_implicit(spec):
        raise ValueError("pallas path requires all ratings non-zero (implicit mask)")


def _route_plan(spec: ProblemSpec, cfg: RunConfig, device, a_max_bytes: int,
                tiled: bool) -> tuple[str, DensePlan | None]:
    """The route (``choose_path``) and, on ``pallas``, its checks and
    ``dense_plan``, timed as the ``plan`` span."""
    with span("plan"):
        path = choose_path(spec, cfg, device)
        if path == "host" or path in _DEVICE_ROUTES:
            return path, None
        if path != "pallas":
            raise ValueError(f"unknown path {path!r}")
        _dense_route_ok(spec, cfg)
        return path, dense_plan(spec, a_max_bytes=a_max_bytes, tiled=tiled)


def format_top1(top1: np.ndarray, spec: ProblemSpec) -> str:
    """The printed list of ``top1`` (``format_recommendations`` with the
    rated counts), timed as the ``format`` span."""
    from recsys_tpu_torch.io.writers import format_recommendations

    with span("format"):
        return format_recommendations(top1, spec.rated_counts(), spec.items)


def _device_init(spec: ProblemSpec, cfg: RunConfig, state: MFState | None) -> bool:
    """The f32 and bf16 BELL routes draw their initial factors on the
    device when no state is given and the draws reach
    ``DEVICE_INIT_MIN_DRAWS`` (trainer.py:378-382; bf16 rounds the f32
    draws).  f64 keeps the host init, which is exact."""
    draws = (spec.users + spec.items) * spec.features
    return state is None and draws >= DEVICE_INIT_MIN_DRAWS and cfg.dtype in ("float32", "bfloat16")


def _permute_pad(F: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """``F``'s rows in ``perm``'s order plus a zero row at the end, by one
    ``index_select`` (the JAX engine's ``take(..., mode="fill")``,
    trainer.py:388-391): the pad row's index reads row 0 and is zeroed."""
    idx = h2d(np.append(perm, 0).astype(np.int64), F.device)
    out = F.index_select(0, idx)
    out[-1] = 0
    return out


def _factorize_bell_device(spec: ProblemSpec, cfg: RunConfig, device, state: MFState | None = None) -> MFState:
    """BELL training with the result left on ``device`` in original row
    order (trainer.py:367-406): ``prep`` builds the tables and, for the
    host init, the glibc draws and the degree-permuted factors with their
    zero rows; ``upload`` copies them to the device, or draws the factors
    there (``_device_init``; the ``init`` span, which counts the stream
    kernel's launches as ``init_launches`` and waits for the card while
    phases are collected) and permutes them on the device (the
    ``permute`` span); ``train`` runs ``bell.bell_train``; the un-permute
    is a device ``index_select`` (exact).  bf16 builds the host tables and
    factors in f32 and rounds them in ``upload``, or rounds the device
    draws before the permute."""
    tdt = _TORCH_DTYPE[cfg.dtype]
    dt = bell.HOST_DTYPE[tdt]
    on_device = _device_init(spec, cfg, state)
    with phase("prep"):
        data = bell.make_bell_inputs(spec, dtype=dt)
        if not on_device:
            if state is None:
                state = init_factors(spec.users, spec.items, spec.features)
            Lp0, Rp0 = bell.pad_factors_for_bell(state, data, dt)
            del state
    with phase("upload") as psync:
        if on_device:
            with span("init"):
                launches = device_rng.glibc_stream.launches
                L, R = device_rng.device_init_factors(spec.users, spec.items, spec.features, device=device)
                count("init_launches", device_rng.glibc_stream.launches - launches)
                psync((L, R))
            with span("permute"):
                L0 = _permute_pad(L.to(tdt), data.user_perm)
                del L
                R0 = _permute_pad(R.to(tdt), data.item_perm)
                del R
        else:
            L0, R0 = (h2d(torch.from_numpy(x).to(tdt), device) for x in (Lp0, Rp0))
            del Lp0, Rp0
        tables = bell.device_tables(data.tables, device, tdt)
        psync((L0, R0, *tables))
    with phase("train") as psync:
        Lp, Rp = bell.bell_train(L0, R0, tables, 2.0 * spec.alpha, data.meta, spec.iters, donate=True)
        psync((Lp, Rp))
    del L0, R0, tables
    with span("unpermute"):
        L = Lp.index_select(0, h2d(data.inv_user_perm, device, torch.int64))
        R = Rp.index_select(0, h2d(data.inv_item_perm, device, torch.int64))
    return MFState(L=L, R=R)


def _factorize_dense(spec: ProblemSpec, cfg: RunConfig, device, state: MFState | None = None) -> MFState:
    """The ``dense`` route (trainer.py:292-311) on ``device`` in the run's
    dtype; the factors stay there."""
    dt = _TORCH_DTYPE[cfg.dtype]
    with phase("prep"):
        if state is None:
            state = init_factors(spec.users, spec.items, spec.features)
        A, M = dense.make_dense_inputs(spec, dtype=np.float64 if dt == torch.float64 else np.float32)
    with phase("upload") as psync:
        L0, R0 = (h2d(np.asarray(x), device, dt) for x in state)
        A, M = (h2d(x, device, dt) for x in (A, M))
        psync((L0, R0, A, M))
    with phase("train") as psync:
        L, R = dense.dense_train(L0, R0, A, M, 2.0 * spec.alpha, spec.iters)
        psync((L, R))
    return MFState(L=L, R=R)


def _coo_use_cumsum(spec: ProblemSpec, cfg: RunConfig, device) -> bool:
    """The prefix-sum COO step for the speed dtypes on the card when the
    ratings outnumber the rows it gathers (trainer.py:210-222, its
    ``jax.default_backend() == "tpu"`` read as a CUDA device); exact f64,
    the CPU and hyper-sparse shapes keep the segment sums."""
    return (cfg.dtype in ("float32", "bfloat16") and torch.device(device).type == "cuda"
            and spec.nnz >= spec.users + spec.items)


def _factorize_coo(spec: ProblemSpec, cfg: RunConfig, device, state: MFState | None = None) -> MFState:
    """The ``coo`` route (trainer.py:287-298, :315-330) on ``device`` in the
    run's dtype: the glibc init and the entry tables in ``prep``, both on
    the device in ``upload``, the step loop in ``train``; the factors stay
    there."""
    dt = _TORCH_DTYPE[cfg.dtype]
    cumsum = _coo_use_cumsum(spec, cfg, device)
    with phase("prep"):
        if state is None:
            state = init_factors(spec.users, spec.items, spec.features)
        data = (coo.make_coo_seg_inputs if cumsum else coo.make_coo_inputs)(spec, dtype=np.float64)
    with phase("upload") as psync:
        L, R = (h2d(np.asarray(x), device, dt) for x in state)
        data = coo.to_device(data, device, dt)
        psync((L, R, *data))
    step = coo.coo_gd_step_cumsum if cumsum else coo.coo_gd_step
    alpha2 = 2.0 * spec.alpha
    with phase("train") as psync:
        for _ in range(spec.iters):
            L, R = step(L, R, data, alpha2)
        psync((L, R))
    return MFState(L=L, R=R)


_DEVICE_ROUTES = {"bell": _factorize_bell_device, "dense": _factorize_dense, "coo": _factorize_coo}


def _host_state(state: MFState) -> MFState:
    """Device factors as host arrays; bf16 ones as float32 arrays holding
    the bf16 values (numpy has no bf16; the upcast is exact)."""
    return MFState(*(np.ascontiguousarray((x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy())
                     for x in state))


def factorize(spec: ProblemSpec, cfg: RunConfig = RunConfig(), device="cuda", state: MFState | None = None, *,
              a_max_bytes: int = RESIDENT_A_MAX_BYTES, tiled: bool = False) -> MFState:
    """The full GD loop on ``device`` from ``state`` (default: the glibc
    initial factors); returns host factors (trainer.py:268, :518-562).

    The ``host`` route runs the native f64 trajectory; the ``pallas`` route
    runs the plan's training kernel, B2 ``resident_train``, B3
    ``stream_train`` or B5's fused ``tiled_step``, and returns f32 factors at
    their true shapes; the ``bell`` and ``dense`` routes return factors in
    the run's dtype, as does ``coo``.  ``a_max_bytes`` and ``tiled`` force a plan kind, as in
    ``run``.  With ``cfg.mesh_shape`` the sharded engine trains (its shards
    on ``device``) and the factors come back at their true shapes.
    """
    device = _check_device(device)
    if cfg.mesh_shape is not None:
        from recsys_tpu_torch.parallel import engine as parallel_engine

        sharded, _ = parallel_engine.factorize_sharded(spec, cfg, state=state, device=device)
        return _host_state(MFState(sharded.L[: spec.users, : spec.features],
                                   sharded.R[: spec.items, : spec.features]))
    path, plan = _route_plan(spec, cfg, device, a_max_bytes, tiled)
    if path == "host":
        return _factorize_host_serial(spec, state)
    if path in _DEVICE_ROUTES:
        return _host_state(_DEVICE_ROUTES[path](spec, cfg, device, state))
    if plan.kind == "tiled":
        return convert.tiled_to_state(*_tiled_train(spec, plan, mxu_precision(cfg), device, state), spec)
    Lt, Rt, A, train_kw = _dense_inputs(spec, plan, device, state)
    train = dense_fused.resident_train if plan.kind == "resident" else dense_stream.stream_train
    with phase("train") as psync:
        Lt, Rt = train(Lt, Rt, A, iters=spec.iters, alpha2=2.0 * spec.alpha, precision=mxu_precision(cfg),
                       **train_kw)
        psync((Lt, Rt))
    return convert.to_state(Lt, Rt, spec)


def _on(device, x) -> torch.Tensor:
    """A factor table as a contiguous tensor on ``device``: a tensor moves
    there (no copy through the host when it is there already), a host
    array is copied up."""
    if isinstance(x, torch.Tensor):
        return x.to(device).contiguous()
    return h2d(np.ascontiguousarray(x), device)


def recommend(state: MFState, spec: ProblemSpec, cfg: RunConfig = RunConfig(), device="cuda") -> np.ndarray:
    """Top-1 unrated item per user (int32 (users,)), computed blockwise on
    ``device`` (trainer.py:645) from host factors or from tensors, which
    stay on the device (:661-668), with the JAX engine's block and cap rule
    (:658-660): the rated-items table masks unless some user rated most of
    the item space.  The ``rated`` span holds the table or the mask blocks
    and their copy; the ``scan`` span R's padding, the item-block loop
    (its blocks counted as ``scan_blocks``) and the result's copy to the
    host, which waits for the device."""
    device = _check_device(device)
    block = _top1_block(spec, cfg.block_items)
    items_pad = -(-spec.items // block) * block
    L, R = _on(device, state.L), _on(device, state.R)
    if cfg.dtype == "bfloat16" and choose_path(spec, cfg, device) in _DEVICE_ROUTES:
        # factorize() hands these routes' bf16 factors back as float32
        # arrays: score in bf16, as run() and the JAX engine do (exact cast).
        L, R = L.to(torch.bfloat16), R.to(torch.bfloat16)
    with span("rated"):
        max_rated = int(np.bincount(spec.rows, minlength=spec.users).max()) if spec.nnz else 0
        if max_rated <= max(spec.items // 8, 128):
            rated, mask_blocks = h2d(topk.make_rated_table(spec), device), None
        else:
            rated, mask_blocks = None, h2d(topk.make_mask_blocks(spec, block), device)
    with span("scan"):
        count("scan_blocks", items_pad // block)
        R_pad = torch.nn.functional.pad(R, (0, 0, 0, items_pad - spec.items))
        if mask_blocks is None:
            top1 = topk.top1_rated_blocked(L, R_pad, rated, block, spec.items)
        else:
            top1 = topk.top1_blocked(L, R_pad, mask_blocks, block)
        return top1.cpu().numpy()


def run(spec: ProblemSpec, cfg: RunConfig, device, *, a_max_bytes: int = RESIDENT_A_MAX_BYTES,
        tiled: bool = False) -> tuple[str, np.ndarray]:
    """Factorize + recommend on ``device``; returns (stdout payload, top1).
    ``a_max_bytes`` moves the plan's resident/stream line and ``tiled``
    forces the tiled kind (tests and ``chip_smoke.py`` force each kind with
    them).  On the tiled kind and the bell, dense and coo routes the
    trained factors stay on the device for ``recommend``
    (trainer.py:763-767)."""
    device = _check_device(device)
    if cfg.mesh_shape is not None:
        from recsys_tpu_torch.parallel import engine as parallel_engine

        return parallel_engine.run(spec, cfg, device)
    path, plan = _route_plan(spec, cfg, device, a_max_bytes, tiled)
    if path == "host":
        from recsys_tpu_torch.engine.oracle import top1_numpy

        with phase("train"):
            state = _factorize_host_serial(spec)
        with phase("top1"):
            top1 = top1_numpy(np.asarray(state.L), np.asarray(state.R), spec)
    elif path in _DEVICE_ROUTES:
        state = _DEVICE_ROUTES[path](spec, cfg, device)
        with phase("top1"):
            top1 = recommend(state, spec, cfg, device)
    elif plan.kind == "tiled":
        L, R = _tiled_train(spec, plan, mxu_precision(cfg), device)
        with phase("top1"):
            top1 = recommend(convert.tiled_views(L, R, spec), spec, cfg, device)
    else:
        top1 = _pallas_fused_top1(spec, plan, mxu_precision(cfg), device)
    return format_top1(top1, spec), top1
