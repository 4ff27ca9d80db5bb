"""The in-order window fold of the cell-file machines (registers, KV,
TTL-KV, the stream) and its hand-written Hopper kernel,
``csrc/slot_fold.cu``.

It replaces the reference's ``lax.scan`` lowering of
``JitMachine.sequential_window_fold`` (``ra_tpu/core/machine.py:252-279``)
for ``RegisterMachine``, ``JitKvMachine``, ``TtlKvMachine`` and
``StreamMachine``: the cas fallback of the second, every window of the
third, and the stream's windows holding a cursor commit or a truncate.

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
KINDS = {"registers": 0, "kv": 1, "ttl_kv": 2, "stream": 3}

#: each kind's state leaves, by the kernel's argument names: a tensor
#: state (``None``) or dict keys
_LEAVES = {"registers": {"cells": None}, "kv": {"cells": None},
           "ttl_kv": {"cells": "vals", "exp": "exp", "watch": "watch",
                      "clock": "clock"},
           "stream": {"cells": "buf", "cursors": "cursors", "tail": "tail",
                      "base": "base"}}

#: the kinds whose decoder reads the commands' index
_READS_INDEX = frozenset({"ttl_kv"})

_STATE_PTRS = ("cells", "exp", "watch", "clock", "cursors", "tail", "base")
_PTRS = tuple(x for name in _STATE_PTRS for x in (name, "out_" + name)) + \
    ("cmds", "mask", "index")


class _Args(ctypes.Structure):
    """``RaSlotFoldArgs`` of csrc/slot_fold.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in _PTRS] + [
        ("cmd_stride", ctypes.c_longlong * 4),
        ("mask_stride", ctypes.c_longlong * 3),
        ("index_stride", ctypes.c_longlong * 3)] + [
        (name, ctypes.c_int) for name in ("n", "p", "a", "s", "g", "c")]


def _kernel_fn():
    from . import _build
    return _build.kernel("slot_fold", "ra_slot_fold", [
        ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p], _Args)


def _cell_leaves(kind: str, state) -> dict:
    """The kernel's state leaves by argument name: ``cells``, and TTL-KV's
    ``exp``, ``watch`` and ``clock`` or the stream's ``cursors``,
    ``tail`` and ``base``."""
    keys = _LEAVES[kind]
    if None in keys.values():
        fits = isinstance(state, torch.Tensor)
    else:
        fits = isinstance(state, dict) and set(state) == set(keys.values())
    if not fits:
        have = sorted(state) if isinstance(state, dict) else "a tensor"
        want = sorted(k for k in keys.values() if k) or "a tensor"
        raise ValueError(f"the {kind!r} slot-fold kind takes {want} as "
                         f"its state, got {have}")
    return {name: state if key is None else state[key]
            for name, key in keys.items()}


def slot_fold_cuda(kind: str, commands, mask, index, state, out) -> None:
    """Fold the window into ``out`` in one kernel launch.  ``commands``
    int32 [N,P,A,C] (C >= 4, the stream's 3), ``mask`` bool and ``index``
    int32 [N,P,A] (read by TTL-KV alone, and dropped for the other
    kinds), any strides; ``state`` and ``out`` the machine's state
    (``kind``'s leaves: int32 [N,P,S] files, TTL-KV's clock [N,P], the
    stream's cursors [N,P,G] and tail and base [N,P]), contiguous,
    ``out`` sharing no memory with ``state``.  Raises on anything else,
    and if the launch fails."""
    global LAUNCHES
    if kind not in KINDS:
        raise ValueError(f"unknown slot-fold kind {kind!r}")
    if kind not in _READS_INDEX:
        index = None
    elif index is None:
        raise ValueError(f"the {kind!r} decoder reads the commands' index")
    ins, outs = _cell_leaves(kind, state), _cell_leaves(kind, out)
    dev = check_fold_operands(commands, mask, index, list(ins.values()),
                              list(outs.values()),
                              width=3 if kind == "stream" else 4)
    N, P, A = mask.shape
    S = ins["cells"].shape[-1]
    G = ins["cursors"].shape[-1] if kind == "stream" else 0
    want = {"cells": (N, P, S), "exp": (N, P, S), "watch": (N, P, S),
            "clock": (N, P), "cursors": (N, P, G), "tail": (N, P),
            "base": (N, P)}
    if any(tuple(t.shape) != want[name] for name, t in ins.items()):
        raise ValueError(
            f"{kind} state leaves must be {[want[k] for k in ins]} with "
            f"[N, P] = {(N, P)}, got {[tuple(t.shape) for t in ins.values()]}")
    if N * P == 0:
        return
    if kind == "stream" and (S < 1 or G < 1):
        raise ValueError("a stream needs a ring and a cursor a row")
    ptrs = []
    for name in _STATE_PTRS:
        ptrs += [ins[name].data_ptr(), outs[name].data_ptr()] \
            if name in ins else [None, None]
    ptrs += [commands.data_ptr(), mask.data_ptr(),
             None if index is None else index.data_ptr()]
    args = _Args(*ptrs, strides(commands), strides(mask),
                 (0, 0, 0) if index is None else strides(index),
                 N, P, A, S, G, commands.shape[-1])
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

