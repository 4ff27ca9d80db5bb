"""Exact integer selection by one-hot, and int32 arithmetic that wraps.

The counterpart of ``ra_tpu/ops/exact.py``.  The reference contracts a
{0,1} one-hot f32 tensor against int32 values split into two 16-bit
halves on the TPU's matrix unit, and recombines the halves bitwise.
Each one-hot row holds at most one 1, so the product is a selection:
row ``a`` takes ``values[r]`` where ``onehot[a, r]`` is set, or 0 where
no column is.  Here that selection is a gather of the int32 values
themselves, exact bit for bit (negative values included) with no float
in the way, so no matmul precision setting (TF32) can touch it.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def split16_matmul(onehot: Tensor, values: Tensor) -> Tensor:
    """``onehot`` [..., A, R] (bool, or a float/int {0,1} tensor) with
    int32 ``values`` [..., R, C] -> int32 [..., A, C]: row ``a`` is the
    values row at the column set in ``onehot[..., a, :]``, or zeros."""
    hot = onehot != 0
    # argmax of a 0/1 tensor is the first set column (0 for an empty row,
    # masked below), as jnp.argmax over a bool
    col = torch.argmax(hot.to(torch.uint8), dim=-1)              # [..., A]
    lead = torch.broadcast_shapes(col.shape[:-1], values.shape[:-2])
    A, C = col.shape[-1], values.shape[-1]
    idx = col.expand(lead + (A,))[..., None].expand(lead + (A, C))
    picked = torch.gather(values.expand(lead + values.shape[-2:]), -2, idx)
    return torch.where(hot.any(dim=-1)[..., None], picked, 0)


def place16(onehot: Tensor, values: Tensor) -> Tensor:
    """:func:`split16_matmul` for a value vector: [..., A, R] x [..., R]
    -> [..., A]."""
    return split16_matmul(onehot, values[..., None])[..., 0]


def add32(a: Tensor, b) -> Tensor:
    """``a + b`` in int32 that wraps modulo 2**32 as XLA's int32 add does
    (the sum is taken in int64 and cut back to its low 32 bits)."""
    return (a.to(torch.int64) + b).to(torch.int32)


def sum32(x: Tensor, dim: int = -1) -> Tensor:
    """The int32 sum over ``dim``, wrapping as XLA's int32 reduction."""
    return x.sum(dim=dim, dtype=torch.int64).to(torch.int32)
