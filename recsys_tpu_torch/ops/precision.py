"""The three matmul precision modes of the fused dense kernels, in plain torch.

Port of ``recsys_tpu/ops/pallas_dense.py`` ``_bsplit`` / ``_maybe_split``
/ ``_dot`` (:107-152).  The CUDA device functions in
``csrc/dense_fused.cu`` (``bsplit``, ``round_bf16``) mirror these
exactly:

- ``"highest"``: true f32 products.  No TF32 anywhere: on CUDA tensors
  ``dense_fused.resident_train_top1_plain`` turns
  ``torch.backends.cuda.matmul.allow_tf32`` off for its call.
- ``"bf16x3"``: each operand is split into bf16 hi + lo; a·b is
  ``(ah·bl + al·bh) + ah·bh`` in f32 (the lo·lo term is dropped), in
  ``_dot``'s term order (:148).
- ``"default"``: one bf16 pass, both operands rounded to bf16 and the
  products accumulated in f32.

Split parts are kept as float32 tensors holding bf16-representable
values: a product of two bf16 values is exact in f32, so computing it
in f32 is the same as the bf16 pass with an f32 accumulator.
"""

from __future__ import annotations

import torch


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 (ties to even), returned as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bsplit(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-term bf16 decomposition of an f32 tensor (``_bsplit`` :107):
    ``hi`` is x rounded to bf16, ``lo`` the bf16-rounded residual."""
    hi = round_bf16(x)
    lo = round_bf16(x - hi)
    return hi, lo


def maybe_split(x: torch.Tensor, precision: str):
    """Pre-split an operand shared by several ``dot`` calls (``_maybe_split``
    :116); only bf16x3 splits."""
    return bsplit(x) if precision == "bf16x3" else x


def transpose(x):
    """``.T`` of a 2-D tensor or of a pre-split (hi, lo) pair."""
    if isinstance(x, tuple):
        return x[0].T, x[1].T
    return x.T


def dot(a, b, precision: str) -> torch.Tensor:
    """``a @ b`` (a: (M, C), b: (C, N), f32) under ``precision``.
    Operands may be pre-split (hi, lo) pairs from ``maybe_split``."""
    if precision == "bf16x3":
        ah, al = a if isinstance(a, tuple) else bsplit(a)
        bh, bl = b if isinstance(b, tuple) else bsplit(b)
        # Small terms first, as _dot does.
        return (ah @ bl + al @ bh) + ah @ bh
    if precision == "default":
        return round_bf16(a) @ round_bf16(b)
    if precision == "highest":
        return a @ b
    raise ValueError(f"unknown precision {precision!r}")


def cell_prod(a, b, precision: str):
    """Elementwise a * b under ``precision``, as ``dot`` forms each
    product: bf16x3 ``(ah*bl + al*bh) + ah*bh``, default both bf16."""
    if precision == "bf16x3":
        (ah, al), (bh, bl) = bsplit(a), bsplit(b)
        return (ah * bl + al * bh) + ah * bh
    if precision == "default":
        return round_bf16(a) * round_bf16(b)
    return a * b


def pred_cells(y, x, precision: str):
    """Per cell (column), the dot of two (K, n) tables under ``precision``."""
    if precision == "bf16x3":
        (yh, yl), (xh, xl) = bsplit(y), bsplit(x)
        return (yh * xl + yl * xh).sum(0) + (yh * xh).sum(0)
    if precision == "default":
        return (round_bf16(y) * round_bf16(x)).sum(0)
    return (y * x).sum(0)
