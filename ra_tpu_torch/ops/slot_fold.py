"""The in-order window fold of the cell-file machines (registers, KV,
TTL-KV) and its hand-written Hopper kernel, ``csrc/slot_fold.cu``.

It replaces the reference's ``lax.scan`` lowering of
``JitMachine.sequential_window_fold`` (``ra_tpu/core/machine.py:252-279``)
for ``RegisterMachine``, ``JitKvMachine`` and ``TtlKvMachine``: the cas
fallback of the first two, and every window of the third.

* The plain version is the machine's ``sequential_window_fold`` (a torch
  loop of ``jit_apply`` over the window).
* :func:`slot_fold_cuda` is the checked wrapper of the kernel: one launch,
  built by ``_build`` on first use, writing the fold into output buffers.
  It allocates nothing, never synchronises, and launches on the current
  stream.
* :func:`slot_fold_dispatch` is what the machines call: the plain version
  for tensors on the CPU, the kernel for tensors on one CUDA device, and
  an error for anything else.  There is no fallback from the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ._fold import check_fold_operands, fold_device, kernel_operands, \
    strides

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

#: the kernel's op decoders, by the machine's ``slot_fold_kind``
KINDS = {"registers": 0, "kv": 1, "ttl_kv": 2}

_PTRS = ("cells", "out_cells", "exp", "out_exp", "watch", "out_watch",
         "clock", "out_clock", "cmds", "mask", "index")


class _Args(ctypes.Structure):
    """``RaSlotFoldArgs`` of csrc/slot_fold.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in _PTRS] + [
        ("cmd_stride", ctypes.c_longlong * 4),
        ("mask_stride", ctypes.c_longlong * 3),
        ("index_stride", ctypes.c_longlong * 3)] + [
        (name, ctypes.c_int) for name in ("n", "p", "a", "s")]


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from . import _build
        lib = _build.load("slot_fold")
        size = lib.ra_slot_fold_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != ctypes.sizeof(_Args):
            raise RuntimeError(
                f"csrc/slot_fold.cu takes {size()} bytes of arguments, the "
                f"wrapper passes {ctypes.sizeof(_Args)}")
        fn = lib.ra_slot_fold
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _cell_leaves(kind: str, state) -> list:
    """The kernel's leaves: [cells] or, for TTL-KV, [vals, exp, watch,
    clock] (dict keys, in the kernel's order)."""
    if kind == "ttl_kv":
        return [state[k] for k in ("vals", "exp", "watch", "clock")]
    return [state]


def slot_fold_cuda(kind: str, commands, mask, index, state, out) -> None:
    """Fold the window into ``out`` in one kernel launch.  ``commands`` int32 [N,P,A,4+],
    ``mask`` bool and ``index`` int32 [N,P,A], any strides; ``state`` and
    ``out`` the machine's state (``kind``'s leaves: int32 [N,P,S], and
    for TTL-KV the clock [N,P]), contiguous, ``out`` sharing no memory
    with ``state``.  Raises on anything else, and if the launch fails."""
    global LAUNCHES
    if kind not in KINDS:
        raise ValueError(f"unknown slot-fold kind {kind!r}")
    ins, outs = _cell_leaves(kind, state), _cell_leaves(kind, out)
    dev = check_fold_operands(commands, mask, index, ins, outs, width=4)
    N, P, A = mask.shape
    S = ins[0].shape[-1]
    if any(t.shape != (N, P, S) for t in ins[:3]) or \
            (kind == "ttl_kv" and ins[3].shape != (N, P)):
        raise ValueError(f"{kind} state leaves must be [N, P, S] (and the "
                         f"clock [N, P]), got {[tuple(t.shape) for t in ins]}")
    if N * P == 0:
        return
    ptrs = [t.data_ptr() for pair in zip(ins, outs) for t in pair]
    ptrs += [None] * (8 - len(ptrs))
    ptrs += [commands.data_ptr(), mask.data_ptr(), index.data_ptr()]
    args = _Args(*ptrs, strides(commands), strides(mask), strides(index),
                 N, P, A, S)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), KINDS[kind],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slot-fold kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1


def slot_fold_dispatch(machine, meta, commands, mask, state):
    """``machine``'s in-order window fold: the plain version for tensors
    on the CPU, the kernel on a CUDA device, else raise."""
    if fold_device(commands, mask, state) == "cpu":
        return machine.sequential_window_fold(meta, commands, mask, state)
    cmds, msk, index, st, out_k, out = kernel_operands(
        meta, commands, mask, state)
    slot_fold_cuda(machine.slot_fold_kind, cmds, msk, index, st, out_k)
    return out

