"""The sharded engine end to end: ingest, shard, train, top-1 (port of
``recsys_tpu/parallel/engine.py``).

One process drives every shard of a (pu, pi) mesh (``mesh.make_mesh``): by
default all on the run's device, so an H100 holds a 2x2 or 2x4 mesh as the
JAX tests' 8 virtual CPU devices do.  On a multi-process mesh
(``parallel/multihost.py``) each rank runs the same code over the shards it
owns: host ``prep`` stays whole on every rank, as in JAX, and ``upload``
puts only the blocks of this rank's shards on its device (JAX's
``putter``).  Factors come from the glibc init in
the serial draw order (or, for f32 and bf16 BELL above
``trainer.DEVICE_INIT_MIN_DRAWS``, from the same stream drawn on the
device), are laid into blocks, trained by ``parallel/step.py`` and handed
back as whole padded tables on the mesh's first device (on every rank, by
one gather a table, ``step.gather``).  Routes follow
the JAX engine: f32/bf16 with an implicit mask on ``dense``/``pallas``
take B5's raw deltas per shard (``tiled``), ``bell`` the checkerboard
BELL, f32/bf16 with at least users + items ratings the prefix-sum COO
(``coo_seg``), the rest the segment-sum COO (``coo``) or, where the route
is ``dense``, the dense step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from recsys_tpu_torch.config import ProblemSpec, RunConfig
from recsys_tpu_torch.models.mf import MFState, init_factors
from recsys_tpu_torch.ops import bell, dense_fused, dense_tiled, device_rng, topk
from recsys_tpu_torch.parallel import sharding as shp
from recsys_tpu_torch.parallel import step
from recsys_tpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS, Mesh, make_mesh
from recsys_tpu_torch.utils.timing import phase

_TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _choose_path(spec: ProblemSpec, cfg: RunConfig, device, n_devices: int) -> str:
    """The single-device ``choose_path`` with the dense budget scaled by
    the shard count and no host route (JAX ``engine.py:31``)."""
    from recsys_tpu_torch.engine.trainer import choose_path

    return choose_path(spec, cfg, device, n_devices=n_devices, allow_host=False)


def sharded_route(spec: ProblemSpec, cfg: RunConfig, mesh: Mesh) -> str:
    """The form ``factorize_sharded`` trains with: ``tiled``, ``bell``,
    ``dense``, ``coo_seg`` or ``coo`` (JAX ``engine.py:66-111``)."""
    pu, pi = mesh.shape
    path = _choose_path(spec, cfg, mesh.home, pu * pi)
    speed = cfg.dtype in ("float32", "bfloat16")
    if path in ("dense", "pallas") and speed and spec.nnz and dense_fused.mask_is_implicit(spec):
        return "tiled"
    if path == "bell" and spec.nnz:
        return "bell"
    if path == "dense":
        return "dense"
    return "coo_seg" if speed and spec.nnz >= spec.users + spec.items else "coo"


def _on(x: np.ndarray, device, dtype) -> torch.Tensor:
    """A host array as a tensor of ``dtype`` on ``device`` (numpy has no
    bf16: an f32 array is rounded by torch, to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(device)


def _host(x: np.ndarray, dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype`` (no copy when it has it):
    ``step.replicate`` copies only the blocks this rank reads from it."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _local(mesh: Mesh, make) -> list[list]:
    """``make(ub, ib, device)`` for each shard this rank owns, None for the
    others', as a (pu, pi) grid."""
    return [[None if dev is None else make(ub, ib, dev) for ib, dev in enumerate(row)]
            for ub, row in enumerate(mesh.devices)]


def _blocks(X: np.ndarray, u_blk: int, i_blk: int, mesh: Mesh, dtype) -> list[list[torch.Tensor | None]]:
    """Shard (ub, ib)'s block of a (users_pad, items_pad) host array on its
    device, for this rank's shards."""
    return _local(mesh, lambda ub, ib, dev: _on(X[ub * u_blk:(ub + 1) * u_blk, ib * i_blk:(ib + 1) * i_blk], dev,
                                                dtype))


def factorize_sharded(spec: ProblemSpec, cfg: RunConfig = RunConfig(), state: MFState | None = None,
                      mesh: Mesh | None = None, device="cuda") -> tuple[MFState, Mesh]:
    """Train over the mesh (default: ``cfg.mesh_shape``'s shards all on
    ``device``); returns (padded factors on the mesh's first device, mesh);
    on a multi-process mesh this rank trains its shards and every rank
    gets the whole factors.
    The tables are padded as the route pads them: to mesh-axis multiples,
    and on ``tiled`` each block to 128 rows and k to 32 columns; slice
    ``[:users, :k]`` for the factors.  Phases ``prep``, ``upload`` and
    ``train`` go to ``utils.timing``."""
    if mesh is None:
        mesh = make_mesh(spec.users, spec.items, shape=cfg.mesh_shape, device=device)
    route = sharded_route(spec, cfg, mesh)
    if route == "tiled":
        from recsys_tpu_torch.engine.trainer import mxu_precision

        return _factorize_sharded_tiled(spec, mesh, state, mxu_precision(cfg)), mesh
    if route == "bell":
        return _factorize_sharded_bell(spec, cfg, mesh, state), mesh
    pu, pi = mesh.shape
    tdt = _TORCH_DTYPE[cfg.dtype]
    ndt = np.float64 if tdt == torch.float64 else np.float32
    alpha2 = 2.0 * spec.alpha
    with phase("prep"):
        if state is None:
            state = init_factors(spec.users, spec.items, spec.features)
        L0, R0 = shp.pad_factors(np.asarray(state.L, ndt), np.asarray(state.R, ndt), pu, pi)
        if route == "dense":
            A, M = shp.dense_blocks(spec, pu, pi, dtype=ndt)
            u_blk, i_blk = A.shape[0] // pu, A.shape[1] // pi
        else:
            bucket = shp.bucket_coo_seg if route == "coo_seg" else shp.bucket_coo
            shards, u_blk, i_blk = bucket(spec, pu, pi, dtype=ndt)
    with phase("upload") as psync:
        L = step.replicate(_host(L0, tdt), u_blk, mesh, AXIS_USERS)
        R = step.replicate(_host(R0, tdt), i_blk, mesh, AXIS_ITEMS)
        if route == "dense":
            data = (_blocks(A, u_blk, i_blk, mesh, tdt), _blocks(M, u_blk, i_blk, mesh, tdt))
        elif route == "coo":
            data = (_local(mesh, lambda ub, ib, dev: step.coo_shard(type(shards)(*(x[ub, ib] for x in shards)),
                                                                    u_blk, i_blk, dev, tdt)),)
        else:
            data = (_local(mesh, lambda ub, ib, dev: tuple(
                _on(x[ub, ib], dev, tdt if name.startswith(("vals", "w")) else torch.int64)
                for name, x in zip(shards._fields, shards))),)
        psync((L, R, data))
    train = {"dense": step.dense_train, "coo": step.coo_train, "coo_seg": step.coo_seg_train}[route]
    with phase("train") as psync:
        train(mesh, L, R, *data, alpha2, spec.iters)
        psync((L, R))
    return MFState(L=step.gather(L, mesh, AXIS_USERS), R=step.gather(R, mesh, AXIS_ITEMS)), mesh


def _lay(F: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Rows of ``F`` by the gather map ``idx`` (``bell.sharded_lay_index``),
    on ``F``'s device; an index of ``len(F)`` reads a zero row (JAX's
    ``take(mode="fill")``)."""
    i = torch.from_numpy(idx.astype(np.int64)).to(F.device)
    out = F.index_select(0, i.clamp(max=F.shape[0] - 1))
    out[i == F.shape[0]] = 0
    return out


def _lay_blocks(F: torch.Tensor, idx: np.ndarray, blk: int, mesh: Mesh, axis: str):
    """``step.replicate`` of ``_lay(F, idx)``, each block laid out by its
    own slice of ``idx``, and only the blocks this rank's shards read."""
    return step.replicate_blocks(lambda b: _lay(F, idx[b * blk:(b + 1) * blk]), mesh, axis)


def bell_inputs(spec: ProblemSpec, cfg: RunConfig, mesh: Mesh, state: MFState | None = None):
    """The checkerboard BELL's ``prep`` and ``upload`` phases: (data, L, R,
    tables), L and R the block-strided degree-permuted factors as
    ``step.replicate`` holds them, ``tables[ub][ib]`` shard (ub, ib)'s
    ``BellTables`` on its device, for this rank's shards.  The factors come
    from ``state``, the host glibc init, or (``trainer._device_init``) the
    same stream drawn whole on the rank's device, where only the blocks its
    shards read are laid out, by ``index_select``."""
    from recsys_tpu_torch.engine import trainer

    pu, pi = mesh.shape
    tdt = _TORCH_DTYPE[cfg.dtype]
    hdt = bell.HOST_DTYPE[tdt]
    on_device = trainer._device_init(spec, cfg, state)
    with phase("prep"):
        data = bell.make_sharded_bell(spec, pu, pi, dtype=hdt)
        m = data.meta
        if not on_device:
            if state is None:
                state = init_factors(spec.users, spec.items, spec.features)
            L0, R0 = bell.pad_factors_sharded_bell(state, data, hdt)
            del state
    with phase("upload") as psync:
        if on_device:
            Ld, Rd = device_rng.device_init_factors(spec.users, spec.items, spec.features, device=mesh.home)
            L = _lay_blocks(Ld.to(tdt), bell.sharded_lay_index(data.user_perm, m.u_blk, pu), m.u_blk + 1, mesh,
                            AXIS_USERS)
            del Ld
            R = _lay_blocks(Rd.to(tdt), bell.sharded_lay_index(data.item_perm, m.i_blk, pi), m.i_blk + 1, mesh,
                            AXIS_ITEMS)
            del Rd
        else:
            L = step.replicate(_host(L0, tdt), m.u_blk + 1, mesh, AXIS_USERS)
            R = step.replicate(_host(R0, tdt), m.i_blk + 1, mesh, AXIS_ITEMS)
        tables = _local(mesh, lambda ub, ib, dev: bell.shard_tables(data.tables, ub, ib, dev, tdt))
        psync((L, R, tables))
    return data, L, R, tables


def _factorize_sharded_bell(spec: ProblemSpec, cfg: RunConfig, mesh: Mesh, state: MFState | None) -> MFState:
    """Checkerboard BELL training (JAX ``engine.py:115``): ``bell_inputs``,
    ``step.bell_train`` (``bell.bell_side_delta`` on each side of each
    shard, then the axis sums), and the result un-permuted on the device
    into the standard padded layout."""
    pu, pi = mesh.shape
    data, L, R, tables = bell_inputs(spec, cfg, mesh, state)
    m = data.meta
    with phase("train") as psync:
        step.bell_train(mesh, L, R, tables, 2.0 * spec.alpha, spec.iters, m)
        psync((L, R))
    del tables
    uidx = bell.sharded_unpermute_index(data.inv_user_perm, m.u_blk, pu * m.u_blk)
    iidx = bell.sharded_unpermute_index(data.inv_item_perm, m.i_blk, pi * m.i_blk)
    return MFState(L=_lay(step.gather(L, mesh, AXIS_USERS), uidx), R=_lay(step.gather(R, mesh, AXIS_ITEMS), iidx))


def tiled_dims(spec: ProblemSpec, pu: int, pi: int) -> tuple[int, int, int, int, int]:
    """(users_pad, u_blk, items_pad, i_blk, K) of the sharded tiled route:
    each shard's block a multiple of 128 rows (B5's quantum), k padded to
    32.  The JAX route pads a user block to 8 and k to 128 (its TPU tiles)."""
    users_pad, u_blk, _ = shp.pallas_block_dims(spec.users, pu, 128, 128)
    items_pad, i_blk, _ = shp.pallas_block_dims(spec.items, pi, 128, 128)
    return users_pad, u_blk, items_pad, i_blk, dense_fused.round_up(spec.features, dense_tiled.K_ALIGN)


def tiled_inputs(spec: ProblemSpec, mesh: Mesh, state: MFState | None = None):
    """The sharded tiled route's ``prep`` and ``upload`` phases: (L, R, A,
    At), f32 factors as ``step.replicate`` holds them and each of this
    rank's shards' block of A (its most compact exact storage) and its
    transpose on the shard's device, each built from that block's ratings
    alone, once for the run.  Padding rows and columns hold A = 0 and zero
    factors, so they add exact zeros."""
    from recsys_tpu_torch.engine.trainer import _a_storage

    pu, pi = mesh.shape
    users_pad, u_blk, items_pad, i_blk, K = tiled_dims(spec, pu, pi)
    with phase("prep"):
        if state is None:
            state = init_factors(spec.users, spec.items, spec.features)
        L0 = np.zeros((users_pad, K), np.float32)
        L0[: spec.users, : spec.features] = state.L
        R0 = np.zeros((items_pad, K), np.float32)
        R0[: spec.items, : spec.features] = state.R
    storage = _a_storage(spec)[0]
    ub_of, ib_of = spec.rows // u_blk, spec.cols // i_blk

    def a_block(ub, ib, dev):
        on = (ub_of == ub) & (ib_of == ib)
        block = dataclasses.replace(spec, users=u_blk, items=i_blk, rows=spec.rows[on] - ub * u_blk,
                                    cols=spec.cols[on] - ib * i_blk, vals=spec.vals[on])
        return dense_tiled.device_dense_A(block, u_blk, i_blk, storage, dev)

    with phase("upload") as psync:
        Ab = _local(mesh, a_block)
        At = [[None if a is None else a.t().contiguous() for a in row] for row in Ab]
        L = step.replicate(_host(L0, torch.float32), u_blk, mesh, AXIS_USERS)
        R = step.replicate(_host(R0, torch.float32), i_blk, mesh, AXIS_ITEMS)
        psync((L, R, Ab, At))
    return L, R, Ab, At


def _factorize_sharded_tiled(spec: ProblemSpec, mesh: Mesh, state: MFState | None, precision: str) -> MFState:
    """Per-shard B5 raw deltas and the axis sums (JAX ``engine.py:192``)
    on ``tiled_inputs``."""
    L, R, Ab, At = tiled_inputs(spec, mesh, state)
    with phase("train") as psync:
        step.tiled_train(mesh, L, R, Ab, At, 2.0 * spec.alpha, spec.iters, precision)
        psync((L, R))
    return MFState(L=step.gather(L, mesh, AXIS_USERS), R=step.gather(R, mesh, AXIS_ITEMS))


def sharded_top1_device(state: MFState, spec: ProblemSpec, mesh: Mesh) -> torch.Tensor:
    """Distributed masked top-1 (JAX ``engine.py:222``): int32
    (users_pad,) global item indices on the mesh's first device (on every
    rank's), from the padded tables ``state`` (block sizes from their
    shapes; on a multi-process mesh every rank passes the whole tables).  The rated-items
    table masks unless some user rated most of the item space; then the
    dense mask (``sharding.rated_mask_padded``)."""
    pu, pi = mesh.shape
    users_pad, items_pad = state.L.shape[0], state.R.shape[0]
    u_blk, i_blk = users_pad // pu, items_pad // pi
    L = step.replicate(state.L.to(mesh.home), u_blk, mesh, AXIS_USERS)
    R = step.replicate(state.R.to(mesh.home), i_blk, mesh, AXIS_ITEMS)
    max_rated = int(np.bincount(spec.rows, minlength=spec.users).max()) if spec.nnz else 0
    if max_rated <= max(spec.items // 8, 128):
        table = topk.make_rated_table(spec)
        tpad = np.full((users_pad, table.shape[1]), -1, np.int32)
        tpad[: spec.users] = table
        cap = (16_000_000 // max(u_blk, 1)) // 128 * 128
        block = min(max(cap, 128), -(-i_blk // 128) * 128)
        rated = step.replicate(torch.from_numpy(tpad), u_blk, mesh, AXIS_USERS)
        tops = step.top1_rated(mesh, L, R, rated, i_blk, spec.items, block)
    else:
        mask = shp.rated_mask_padded(spec, pu, pi, users_pad=users_pad, items_pad=items_pad)
        tops = step.top1_dense(mesh, L, R, _blocks(mask, u_blk, i_blk, mesh, torch.bool), i_blk)
    return torch.cat(step.share(tops, mesh, AXIS_USERS))


def recommend_sharded(state: MFState, spec: ProblemSpec, mesh: Mesh) -> np.ndarray:
    """Distributed masked top-1: int32 (users,) on the host."""
    return sharded_top1_device(state, spec, mesh).cpu().numpy()[: spec.users]


def run(spec: ProblemSpec, cfg: RunConfig, device="cuda") -> tuple[str, np.ndarray]:
    """``factorize_sharded`` on ``cfg.mesh_shape``'s shards on ``device``,
    then ``recommend_sharded`` (the ``top1`` phase); returns (stdout
    payload, top1)."""
    from recsys_tpu_torch.io.writers import format_recommendations

    state, mesh = factorize_sharded(spec, cfg, device=device)
    with phase("top1"):
        top1 = recommend_sharded(state, spec, mesh)
    return format_recommendations(top1, spec.rated_counts(), spec.items), top1


def dryrun(n_devices: int, device="cuda") -> None:
    """Validate the sharded engine numerically on ``n_devices`` shards on
    ``device`` (JAX ``engine.py:276``), so that a systematic sharding bug
    that keeps shapes intact fails here:

    1. a tiny smoke: one step of the dense, COO and BELL formulations + top-1;
    2. 200x300, 5 iters: each formulation's factors against the
       single-device engine's ``coo`` route, and the sharded top-1 against
       the numpy oracle on those factors (rated-table branch);
    3. a hub user past the rated-table cap: the dense-mask branch against
       the numpy oracle.

    The tolerances are the JAX check's for true f32 (rtol 3e-4, atol 1e-5,
    agreement 1.0): on the card the port's f32 is true f32 (TF32 off), so
    the JAX package's looser TPU bounds (one bf16 pass) do not apply."""
    from recsys_tpu_torch.engine import trainer
    from recsys_tpu_torch.engine.oracle import top1_numpy
    from recsys_tpu_torch.io.generator import generate_instance

    pu = next(c for c in range(int(n_devices ** 0.5), 0, -1) if n_devices % c == 0)
    mesh = make_mesh(0, 0, shape=(pu, n_devices // pu), device=device)
    rtol, atol, min_top1_agree = 3e-4, 1e-5, 1.0

    spec = generate_instance(12, 20, 4, 1, 5, iters=1, alpha=0.01, seed=7)
    for path in ("dense", "coo", "bell"):
        state, _ = factorize_sharded(spec, RunConfig(dtype="float32", path=path), mesh=mesh)
        if recommend_sharded(state, spec, mesh).shape != (spec.users,):
            raise AssertionError(f"sharded top-1 ({path}): wrong shape")

    def agreement(state, spec, label):
        L = state.L[: spec.users, : spec.features].double().cpu().numpy()
        R = state.R[: spec.items, : spec.features].double().cpu().numpy()
        agree = float((recommend_sharded(state, spec, mesh) == top1_numpy(L, R, spec)).mean())
        if agree < min_top1_agree:
            raise AssertionError(f"sharded top-1 ({label}): agreement {agree:.3f} with the numpy oracle "
                                 f"on the same factors (floor {min_top1_agree})")

    spec2 = generate_instance(200, 300, 8, 1, 6, iters=5, alpha=0.02, seed=11)
    ref = trainer.factorize(spec2, RunConfig(dtype="float32", path="coo"), device)
    for path in ("dense", "coo", "bell"):
        state, _ = factorize_sharded(spec2, RunConfig(dtype="float32", path=path), mesh=mesh)
        for name, got, want, n in (("L", state.L, ref.L, spec2.users), ("R", state.R, ref.R, spec2.items)):
            np.testing.assert_allclose(got[:n, : spec2.features].cpu().numpy(), np.asarray(want), rtol=rtol,
                                       atol=atol, err_msg=f"sharded {path}: {name} drifted from the "
                                                          "single-device engine")
        agreement(state, spec2, f"{path}, rated-table branch")

    # Hub instance: user 0 rates 2/3 of the item space, past the
    # rated-table cap (max(items // 8, 128)): the dense-mask branch.
    rng = np.random.default_rng(13)
    tail_rows, tail_cols = [], []
    for u in range(1, 40):
        cs = np.unique(rng.integers(0, 300, size=4))
        tail_rows += [u] * len(cs)
        tail_cols += list(cs)
    rows = np.concatenate([np.zeros(200, np.int64), np.array(tail_rows)])
    cols = np.concatenate([np.arange(200, dtype=np.int64), np.array(tail_cols)])
    vals = rng.integers(1, 6, size=len(rows)).astype(np.float64)
    spec3 = ProblemSpec(iters=3, alpha=0.02, features=4, users=40, items=300,
                        rows=rows.astype(np.int32), cols=cols.astype(np.int32), vals=vals)
    if int(np.bincount(spec3.rows).max()) <= max(spec3.items // 8, 128):
        raise AssertionError("the hub instance no longer reaches the dense-mask branch")
    state, _ = factorize_sharded(spec3, RunConfig(dtype="float32", path="coo"), mesh=mesh)
    agreement(state, spec3, "dense-mask branch")
