"""Top-1 recommendation from host factors: masked argmax without
materializing B.  Port of ``recsys_tpu/ops/topk.py`` in plain torch (the
JAX module is XLA code with no Pallas kernel): ``top1_blocked`` :23,
``top1_rated_scan`` :54, ``top1_rated_blocked`` :121, ``make_rated_table``
:128 and ``make_mask_blocks`` :147.

A loop over item blocks keeps a running (best value, best index) per user,
reconstructing one (users x block) tile of B per step with a matmul in the
factors' dtype: true f32 on a CUDA device (TF32 is off for the call), or
a DGEMM for the f64 factors of the ``bell`` and ``dense`` routes.  Tie-break as the
reference's strictly-greater scan: a new block's value must exceed the
incumbent, and within a block ``torch.argmax`` picks the first maximum, so
the lowest item index wins.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.config import ProblemSpec
from recsys_tpu_torch.ops.dense_fused import exact_f32


def top1_blocked(L, R, mask_blocks, block_items: int):
    """Masked top-1 item per user (``top1_blocked`` :23).

    ``mask_blocks``: bool (num_blocks, users, block_items), True where rated
    (excluded); items padded past the true count are masked True by the
    caller.  Returns int32 (users,) item indices."""
    users = L.shape[0]
    best_val = torch.full((users,), -torch.inf, dtype=L.dtype, device=L.device)
    best_idx = torch.zeros((users,), dtype=torch.int32, device=L.device)
    with exact_f32(L.device):
        for blk in range(mask_blocks.shape[0]):
            b = L @ R[blk * block_items:(blk + 1) * block_items].T
            b = torch.where(mask_blocks[blk], -torch.inf, b)
            val, idx = _block_best(b)
            take = val > best_val  # strictly greater: the incumbent (lower index) wins ties
            best_val = torch.where(take, val, best_val)
            best_idx = torch.where(take, idx + blk * block_items, best_idx)
    return best_idx


def _block_best(b):
    val = b.max(dim=1).values
    # argmax returns the first maximum: the lowest index within the block.
    return val, torch.argmax(b, dim=1).to(torch.int32)


def top1_rated_scan(L, R, rated, block_items: int, items_true: int, col0: int = 0):
    """(best value, best GLOBAL item index) of the masked top-1 with the mask
    held as a compact rated-items table (``top1_rated_scan`` :54).

    ``rated``: int32 (users, P), each user's rated item indices in global
    item space, padded with -1.  ``col0`` is the global item id of R's row
    0.  Rows of R past its end and global items at or past ``items_true``
    are masked.  A user with everything masked keeps (-inf, col0).

    Each block's mask is built by scattering the table's entries that fall
    in the block; the JAX function compares every table column with the
    block's indices.  Both give the same boolean mask."""
    users = L.shape[0]
    rows = R.shape[0]
    num_blocks = -(-rows // block_items)
    best_val = torch.full((users,), -torch.inf, dtype=L.dtype, device=L.device)
    best_idx = torch.full((users,), col0, dtype=torch.int32, device=L.device)
    urow = torch.arange(users, device=L.device)[:, None].expand_as(rated)
    lcol = torch.arange(block_items, device=L.device)
    with exact_f32(L.device):
        for blk in range(num_blocks):
            start = blk * block_items
            b = L @ R[start:start + block_items].T
            if b.shape[1] < block_items:  # the last block of an unpadded R
                b = torch.nn.functional.pad(b, (0, block_items - b.shape[1]))
            local = rated.long() - col0 - start
            hit = (rated >= 0) & (local >= 0) & (local < block_items)
            is_rated = torch.zeros((users, block_items), dtype=torch.bool, device=L.device)
            is_rated[urow[hit], local[hit]] = True
            gcol = lcol + start + col0
            b = torch.where(is_rated | (lcol + start >= rows) | (gcol >= items_true), -torch.inf, b)
            val, idx = _block_best(b)
            take = val > best_val
            best_val = torch.where(take, val, best_val)
            best_idx = torch.where(take, idx + start + col0, best_idx)
    return best_val, best_idx


def top1_rated_blocked(L, R, rated, block_items: int, items_true: int):
    """Single-device rated-table masked top-1 (``top1_rated_blocked``
    :121): int32 (users,) item indices."""
    return top1_rated_scan(L, R, rated, block_items, items_true)[1]


def make_rated_table(spec: ProblemSpec) -> np.ndarray:
    """int32 (users, P) table of each user's rated item indices, -1 pad
    (P = max rated count, min 1), as ``make_rated_table`` :128."""
    counts = np.bincount(spec.rows, minlength=spec.users)
    P = max(int(counts.max()) if counts.size else 0, 1)
    start = np.zeros(spec.users + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    # Group per user without assuming row-major entry order.
    order = np.argsort(spec.rows, kind="stable")
    rows_s = spec.rows[order]
    slot = np.arange(spec.nnz, dtype=np.int64) - start[rows_s]
    table = np.full((spec.users, P), -1, np.int32)
    table[rows_s, slot] = spec.cols[order]
    return table


def make_mask_blocks(spec: ProblemSpec, block_items: int) -> np.ndarray:
    """Host rated mask padded along items to a block multiple, as
    (num_blocks, users, block_items); padding is masked True
    (``make_mask_blocks`` :147)."""
    items_pad = -(-spec.items // block_items) * block_items
    m = np.zeros((spec.users, items_pad), dtype=bool)
    m[spec.rows, spec.cols] = True
    m[:, spec.items:] = True
    return np.ascontiguousarray(
        m.reshape(spec.users, items_pad // block_items, block_items).transpose(1, 0, 2)
    )
