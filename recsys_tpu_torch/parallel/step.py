"""Sharded training and inference steps over the 2-D mesh (port of
``recsys_tpu/parallel/step.py``).

JAX runs each step as one ``shard_map`` program: every shard computes its
partial ΔL and ΔR from its block of A and its blocks of L and R, then
``psum(ΔL, 'i')`` and ``psum(ΔR, 'u')`` sum them along the mesh axes and
every shard adds the sum to its copy of the factors.  Here each factory
is a plain loop over steps and shards with the same shape:

* Factor tables are held as ``replicate`` lays them out: block b of L on
  the device of every shard of mesh row b (``P('u', None)``), block b of R
  on every shard of mesh column b (``P('i', None)``).  Shards on one device
  share one tensor.  A rank holds only the blocks its own shards read.
* ``axis_sum`` is the psum: the shards' partials added in ascending shard
  order, one add at a time, on the first shard's device, then the sum
  copied to each device that holds the block (no copy on the same card).
  No float atomics, no ``index_add_``: two runs give the same bits, and a
  two-wide axis is exact whatever the order (a + b = b + a in IEEE).  On a
  multi-process mesh (``mesh.groups``) the partials of one block are first
  gathered over that mesh row's or column's process group (unless one
  rank holds the whole row or column), their raw bytes moved by
  ``all_gather``, and every rank that holds the block adds them in the
  same order: the bits are the one process's.  No
  ``all_reduce(SUM)``: neither NCCL nor gloo fixes its order of adds.
* Every partial of a step reads the snapshot: all shards' partials are
  taken before any block is updated (``matFact.c:38-39``).

The per-shard work is the single-device route's: the dense step's three
matmuls and the COO step's gathers and segment sums (plain torch, as they
are plain XLA in JAX), B5's raw ``dense_tiled.tiled_deltas`` (the tiled
route) and ``bell.bell_side_delta`` (the checkerboard BELL).  The top-1s
take each shard's best (value, global index) over its item block, stack
them along 'i' in ascending block order and keep the first maximum: the
lowest global index wins a tie (``matFact-mpi.c:23-28``); across ranks
the pairs go over the row's group first.  ``share`` hands whole tables (and
the top-1's u-blocks) to every rank: one ``all_gather``, each block from
the lowest rank that holds it (JAX's global arrays, ``process_allgather``).
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.ops import bell, coo, dense_tiled, topk
from recsys_tpu_torch.ops.dense_fused import exact_f32
from recsys_tpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS, Mesh


def _readers(mesh: Mesh, axis: str, b: int) -> list:
    """Devices of the shards that read block b of an ``axis`` table, in
    ascending shard order along the other axis; None where another rank
    owns the shard."""
    if axis == AXIS_USERS:
        return list(mesh.devices[b])
    return [row[b] for row in mesh.devices]


def replicate(F: torch.Tensor, blk: int, mesh: Mesh, axis: str) -> list[list[torch.Tensor | None]]:
    """``F`` cut into blocks of ``blk`` rows along ``axis``: ``out[b][j]`` is
    block b as the j-th shard reading it holds it, on that shard's device,
    or None where another rank owns that shard.  Shards on one device share
    one tensor; on ``F``'s device the block is a view of ``F``, so updates to
    it write ``F``.  A block no shard of this rank reads is never copied."""
    return replicate_blocks(lambda b: F.narrow(0, b * blk, blk), mesh, axis)


def replicate_blocks(block, mesh: Mesh, axis: str) -> list[list[torch.Tensor | None]]:
    """``replicate`` of the blocks ``block(b)`` gives, called only for the
    blocks this rank's shards read."""
    out = []
    for b in range(mesh.shape[0] if axis == AXIS_USERS else mesh.shape[1]):
        readers = _readers(mesh, axis, b)
        held: dict = {}
        if any(d is not None for d in readers):
            x = block(b)
            for d in readers:
                if d is not None and d not in held:
                    held[d] = x.to(d)
        out.append([None if d is None else held[d] for d in readers])
    return out


def _exchange(mine: list[torch.Tensor], order: list[int], like: torch.Tensor, ranks: list[int], group) -> list:
    """Tensors of ``like``'s shape and dtype gathered over ``group`` (of
    ``ranks``): ``order`` names the rank that gives each one, in output
    order, and each rank gives its own (``mine``) in that order.  Each
    rank's tensors go as one stack padded to the largest count, as raw
    bytes, so every dtype keeps its bits."""
    import torch.distributed as dist

    stack = torch.zeros((max(order.count(r) for r in ranks), *like.shape), dtype=like.dtype, device=like.device)
    for i, x in enumerate(mine):
        stack[i].copy_(x)
    raw = stack.view(torch.uint8)
    bufs = [torch.empty_like(raw) for _ in ranks]
    dist.all_gather(bufs, raw, group=group)
    stacks = {r: buf.view(like.dtype) for r, buf in zip(ranks, bufs)}
    seen = dict.fromkeys(ranks, 0)
    out = []
    for r in order:
        out.append(stacks[r][seen[r]])
        seen[r] += 1
    return out


def _gathered(parts: list, mesh: Mesh, axis: str, b: int) -> list[torch.Tensor]:
    """Every shard's partial of block b (``parts``: this rank's, None for the
    others', in ascending shard order), gathered over the block's process
    group; the same list, in the same order, on every rank that holds it.
    A group of one rank holds them all already: nothing moves."""
    ranks, group = mesh.groups[axis, b]
    if len(ranks) == 1:
        return parts
    mine = [p for p in parts if p is not None]
    return _exchange(mine, mesh.line(axis, b), mine[0], ranks, group)


def share(blocks: list, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Every block of an ``axis`` table on this rank's home device
    (``blocks[b]``: this rank's copy, or None where it holds none).  On a
    multi-process mesh one ``all_gather`` over the world hands each block
    from the lowest rank that holds it to every rank; all blocks share one
    shape and dtype."""
    if mesh.groups is None:
        return [x.to(mesh.home) for x in blocks]
    import torch.distributed as dist

    src = [mesh.holders(axis, b)[0] for b in range(len(blocks))]
    mine = [x.to(mesh.home) for b, x in enumerate(blocks) if src[b] == mesh.rank]
    like = next(x for x in blocks if x is not None).to(mesh.home)
    return _exchange(mine, src, like, list(range(dist.get_world_size())), None)


def gather(copies: list[list[torch.Tensor | None]], mesh: Mesh, axis: str) -> torch.Tensor:
    """The whole ``axis`` table, its blocks in order, on this rank's home
    device (every rank's, on a multi-process mesh)."""
    return torch.cat(share([next((c for c in held if c is not None), None) for held in copies], mesh, axis))


def axis_sum(parts: list[torch.Tensor], devices: list) -> list[torch.Tensor]:
    """The psum over one mesh axis: ``parts`` (one partial a shard, in
    ascending shard order) added one at a time on ``parts[0]``'s device,
    then the sum on each of ``devices`` (one copy a device; none where it
    already is)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    held: dict = {}
    for d in devices:
        if d not in held:
            held[d] = total.to(d)
    return [held[d] for d in devices]


def _update(mesh: Mesh, axis: str, copies: list[list], parts: list[list], apply) -> None:
    """Sum each block's partials along the axis and ``apply(F, total)`` to
    every distinct copy F of the block this rank holds."""
    for b, held in enumerate(copies):
        local = [F for F in held if F is not None]
        if not local:
            continue
        block_parts = parts[b] if mesh.groups is None else _gathered(parts[b], mesh, axis, b)
        sums = axis_sum(block_parts, [F.device for F in local])
        done = set()
        for F, total in zip(local, sums):
            if id(F) not in done:
                done.add(id(F))
                apply(F, total)


def _scaled_add(alpha2: float):
    """F += a2 * d with a2 in F's dtype (JAX's ``dt.type(2 * alpha)``; a
    bf16 a2 is rounded, ``bell._alpha``): the product rounded, then the
    sum, in place."""
    def apply(F, d):
        F.add_(d * bell._alpha(alpha2, F.dtype))
    return apply


def _grid(mesh: Mesh):
    pu, pi = mesh.shape
    return [[None] * pi for _ in range(pu)], [[None] * pu for _ in range(pi)]


def dense_train(mesh: Mesh, L, R, A, M, alpha2: float, iters: int) -> None:
    """JAX ``make_dense_train`` (:33), in place: L, R as ``replicate``
    holds them, ``A[ub][ib]``, ``M[ub][ib]`` the shards' blocks.  Per shard
    E = M * (A - L R^T), ΔL = E R, ΔR = E^T L; then L += 2a ΣΔL, R += 2a ΣΔR."""
    apply = _scaled_add(alpha2)
    for _ in range(iters):
        dL, dR = _grid(mesh)
        for ub, ib, dev in mesh.shards():
            l, r = L[ub][ib], R[ib][ub]
            with exact_f32(dev):
                E = M[ub][ib] * (A[ub][ib] - l @ r.T)
                dL[ub][ib], dR[ib][ub] = E @ r, E.T @ l
        _update(mesh, AXIS_USERS, L, dL, apply)
        _update(mesh, AXIS_ITEMS, R, dR, apply)


def coo_train(mesh: Mesh, L, R, shards, alpha2: float, iters: int) -> None:
    """JAX ``make_coo_train`` (:59), in place; ``shards[ub][ib]`` from
    ``coo_shard``.  err = w 2a (v - <L[r], R[c]>); ΔL sums err R[c] per
    local row over the row-sorted bucket, ΔR err L[r] per local column over
    its column-sorted order, each a ``segment_reduce`` in entry order (the
    bucket's padding entries, weight 0, in a segment of their own after
    the rows)."""
    for _ in range(iters):
        dL, dR = _grid(mesh)
        for ub, ib, _ in mesh.shards():
            rows, cols, vals, w, perm, row_len, col_len = shards[ub][ib]
            l, r = L[ub][ib][rows], R[ib][ub][cols]
            err = w * bell._alpha(alpha2, l.dtype) * (vals - torch.sum(l * r, dim=-1))
            d = torch.segment_reduce(err[:, None] * r, "sum", lengths=row_len, axis=0, unsafe=True)
            dL[ub][ib] = d[: L[ub][ib].shape[0]]
            dR[ib][ub] = torch.segment_reduce((err[:, None] * l)[perm], "sum", lengths=col_len, axis=0,
                                              unsafe=True)
        _update(mesh, AXIS_USERS, L, dL, lambda F, d: F.add_(d))
        _update(mesh, AXIS_ITEMS, R, dR, lambda F, d: F.add_(d))


def coo_shard(shard, u_blk: int, i_blk: int, device, dtype):
    """One shard's ``sharding.CooShards`` bucket (numpy, [ub, ib] taken) as
    ``coo_train``'s tensors on ``device``: int64 indices, values and weights
    in ``dtype``, and the segment lengths: each local row's entries then
    the padding tail, each local column's entries (padding entries sort
    into column 0, where they add ±0)."""
    real = shard.weight != 0
    row_len = np.append(np.bincount(shard.rows[real], minlength=u_blk), int((~real).sum()))
    col_len = np.bincount(shard.cols_sorted, minlength=i_blk)

    def t(x, dt=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    return (t(shard.rows), t(shard.cols), t(shard.vals, dtype), t(shard.weight, dtype), t(shard.perm),
            t(row_len), t(col_len))


def coo_seg_train(mesh: Mesh, L, R, shards, alpha2: float, iters: int) -> None:
    """JAX ``make_coo_seg_train`` (:139), in place; ``shards[ub][ib]`` the
    ``sharding.CooSegShards`` fields of shard (ub, ib) as tensors (int64
    indices).  Each segment sum is the difference of two rows of one
    prefix sum (``coo._segment_diffs``)."""
    for _ in range(iters):
        dL, dR = _grid(mesh)
        for ub, ib, _ in mesh.shards():
            rows, cols, vals, w, rows_cs, cols_cs, vals_cs, w_cs, row_start, col_start = shards[ub][ib]
            Lc, Rc = L[ub][ib], R[ib][ub]
            a2 = bell._alpha(alpha2, Lc.dtype)
            r = Rc[cols]
            err = w * a2 * (vals - torch.sum(Lc[rows] * r, dim=-1))
            dL[ub][ib] = coo._segment_diffs(err[:, None] * r, row_start)
            l2 = Lc[rows_cs]
            err2 = w_cs * a2 * (vals_cs - torch.sum(l2 * Rc[cols_cs], dim=-1))
            dR[ib][ub] = coo._segment_diffs(err2[:, None] * l2, col_start)
        _update(mesh, AXIS_USERS, L, dL, lambda F, d: F.add_(d))
        _update(mesh, AXIS_ITEMS, R, dR, lambda F, d: F.add_(d))


def tiled_train(mesh: Mesh, L, R, A, At, alpha2: float, iters: int, precision: str = "highest") -> None:
    """JAX ``make_pallas_dense_train`` (:106), in place: per shard B5's raw
    deltas, ``dense_tiled.tiled_deltas`` (the kernel on the card, its twin
    on the CPU), on its block of A (``A[ub][ib]``, transpose ``At[ub][ib]``
    made once for the run); then L += 2a ΣΔL, R += 2a ΣΔR in f32."""
    apply = _scaled_add(alpha2)
    for _ in range(iters):
        dL, dR = _grid(mesh)
        for ub, ib, dev in mesh.shards():
            at = At[ub][ib] if dev.type == "cuda" else None
            dL[ub][ib], dR[ib][ub] = dense_tiled.tiled_deltas(L[ub][ib], R[ib][ub], A[ub][ib],
                                                               precision=precision, At=at)
        _update(mesh, AXIS_USERS, L, dL, apply)
        _update(mesh, AXIS_ITEMS, R, dR, apply)


def bell_preps(mesh: Mesh, tables, meta):
    """Each of this rank's shards' ``bell.side_prep`` of both sides, made
    once for a run (None for the others' shards)."""
    return [[None if t is None else (bell.side_prep(t.ucols, t.uvals, meta.user, meta.i_blk),
                                     bell.side_prep(t.irows, t.ivals, meta.item, meta.u_blk))
             for t in row] for row in tables]


def bell_partials(mesh: Mesh, L, R, tables, alpha2: float, meta, preps):
    """Every shard's (ΔL, ΔR) of one checkerboard BELL step from the
    snapshot: ``bell.bell_side_delta`` per side (``preps`` from
    ``bell_preps``); None for a side with no nonzero-degree rows (JAX
    ``_delta_side``'s None)."""
    dL, dR = _grid(mesh)
    for ub, ib, _ in mesh.shards():
        t, l, r = tables[ub][ib], L[ub][ib], R[ib][ub]
        if meta.user.n_nz:
            dL[ub][ib] = bell.bell_side_delta(l, r, t.ucols, t.uvals, meta.user, alpha2, prep=preps[ub][ib][0])
        if meta.item.n_nz:
            dR[ib][ub] = bell.bell_side_delta(r, l, t.irows, t.ivals, meta.item, alpha2, prep=preps[ub][ib][1])
    return dL, dR


def bell_train(mesh: Mesh, L, R, tables, alpha2: float, iters: int, meta) -> None:
    """JAX ``make_bell_train`` (:185), in place: L, R the block-strided
    degree-permuted tables (``bell.pad_factors_sharded_bell``; a block's
    zero row last), ``tables[ub][ib]`` shard (ub, ib)'s ``BellTables``.
    Per step ``bell_partials``, then rows [0, n_nz) of each block += the
    partials' sum along the axis."""
    nU, nI = meta.user.n_nz, meta.item.n_nz
    preps = bell_preps(mesh, tables, meta)
    for _ in range(iters):
        dL, dR = bell_partials(mesh, L, R, tables, alpha2, meta, preps)
        if nU:
            _update(mesh, AXIS_USERS, L, dL, lambda F, d: F[:nU].add_(d))
        if nI:
            _update(mesh, AXIS_ITEMS, R, dR, lambda F, d: F[:nI].add_(d))


def _first_max(vals: list[torch.Tensor], idxs: list[torch.Tensor]) -> torch.Tensor:
    """Across shards in ascending item-block order: the index of the first
    maximum (``torch.argmax`` returns the first), on ``vals[0]``'s device."""
    dev = vals[0].device
    win = torch.argmax(torch.stack([v.to(dev) for v in vals]), dim=0)
    return torch.stack([i.to(dev) for i in idxs]).gather(0, win[None, :])[0]


def _row_first_max(mesh: Mesh, ub: int, vals: list, idxs: list) -> torch.Tensor | None:
    """``_first_max`` over mesh row ``ub`` (``vals``, ``idxs``: this rank's
    shards' bests, None for the others'); on a multi-process mesh the bests
    go over the row's group first.  None where this rank owns no shard of
    the row."""
    if all(v is None for v in vals):
        return None
    if mesh.groups is not None:
        vals, idxs = _gathered(vals, mesh, AXIS_USERS, ub), _gathered(idxs, mesh, AXIS_USERS, ub)
    return _first_max(vals, idxs)


def top1_rated(mesh: Mesh, L, R, rated, i_blk: int, items_true: int, block: int) -> list[torch.Tensor | None]:
    """JAX ``make_sharded_top1_rated`` (:241): per shard
    ``topk.top1_rated_scan`` over its item block (``rated[ub][ib]``: the
    u-block's rows of the rated-items table, global item ids, -1 pad),
    then the first maximum across the mesh row.  Returns each u-block's
    int32 global indices on its first shard's device (None for a u-block
    no shard of this rank reads)."""
    best = [[(None, None)] * mesh.shape[1] for _ in range(mesh.shape[0])]
    for ub, ib, _ in mesh.shards():
        best[ub][ib] = topk.top1_rated_scan(L[ub][ib], R[ib][ub], rated[ub][ib], block, items_true, ib * i_blk)
    return [_row_first_max(mesh, ub, [b[0] for b in row], [b[1] for b in row]) for ub, row in enumerate(best)]


def top1_dense(mesh: Mesh, L, R, mask, i_blk: int) -> list[torch.Tensor | None]:
    """JAX ``make_sharded_top1`` (:281): per shard the masked scores of its
    block (``mask[ub][ib]`` True where rated or padding), their max and
    first argmax, then the first maximum across the mesh row."""
    vals, idxs = _grid(mesh)[0], _grid(mesh)[0]
    for ub, ib, dev in mesh.shards():
        with exact_f32(dev):
            b = torch.where(mask[ub][ib], -torch.inf, L[ub][ib] @ R[ib][ub].T)
        vals[ub][ib] = b.max(dim=1).values
        idxs[ub][ib] = torch.argmax(b, dim=1).to(torch.int32) + ib * i_blk
    return [_row_first_max(mesh, ub, vals[ub], idxs[ub]) for ub in range(mesh.shape[0])]
