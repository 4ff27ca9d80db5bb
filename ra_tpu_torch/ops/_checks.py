"""Argument checks shared by the kernel wrappers: a kernel takes only
contiguous tensors of the dtype and shape it was written for, all on one
CUDA device, and the wrapper raises on anything else."""
from __future__ import annotations

import torch


def check_kernel_args(args, ref: str) -> torch.device:
    """``args``: ``(name, tensor, dtype, shape)`` tuples.  Raises
    ``TypeError`` on a wrong dtype and ``ValueError`` on a wrong shape, a
    non-contiguous tensor, or a tensor that is not on the CUDA device of
    the one named ``ref``.  Returns that device."""
    for name, t, dtype, shape in args:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = next(t.device for name, t, _d, _s in args if name == ref)
    for name, t, _dtype, _shape in args:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be on one CUDA device with "
                             f"{ref}, got {t.device}")
    return dev
