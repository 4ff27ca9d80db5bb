"""The in-order window fold of the FIFO machine and its hand-written
Hopper kernel, ``csrc/fifo_fold.cu``.

It replaces the reference's ``lax.scan`` lowering of
``JitMachine.sequential_window_fold`` (``ra_tpu/core/machine.py:252-279``)
for ``JitFifoMachine`` (``ra_tpu/models/jit_fifo.py:134-330``, the
requeue merge included): every window that holds an op above 2.

* The plain version is the machine's ``sequential_window_fold``.
* :func:`fifo_fold_cuda` is the checked wrapper of the kernel: one launch,
  built by ``_build`` on first use, writing the fold into output buffers.
  It allocates nothing, never synchronises, and launches on the current
  stream.
* :func:`fifo_fold_dispatch` is what the machine calls: the plain version
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

#: the state's keys in the kernel's leaf order (the dict's sorted order)
LEAVES = ("buf", "co_dc", "co_id", "co_mid", "co_owner", "co_val",
          "con_credit", "con_pid", "dc", "head", "mid", "n_dropped",
          "next_id", "next_mid", "tail")

#: the largest checkout table the kernel takes (kMaxCheckout)
MAX_CHECKOUT = 32
#: the longest ring the kernel keeps in shared memory (kMaxSharedRing); a
#: longer one folds in device memory, which the kernel does only for a
#: capacity that is a power of two
MAX_SHARED_RING = 19328


def kernel_takes_capacity(q: int) -> bool:
    """Whether the kernel folds a ring of ``q`` slots."""
    return 1 <= q <= MAX_SHARED_RING or (q > 0 and q & (q - 1) == 0)


class _Args(ctypes.Structure):
    """``RaFifoFoldArgs`` of csrc/fifo_fold.cu."""

    _fields_ = [("in_", ctypes.c_void_p * len(LEAVES)),
                ("out", ctypes.c_void_p * len(LEAVES)),
                ("cmds", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("cmd_stride", ctypes.c_longlong * 4),
                ("mask_stride", ctypes.c_longlong * 3)] + [
        (name, ctypes.c_int)
        for name in ("n", "p", "a", "q", "k", "c", "drop_head")]


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from . import _build
        lib = _build.load("fifo_fold")
        size = lib.ra_fifo_fold_args_size
        size.argtypes, size.restype = [], ctypes.c_int
        if size() != ctypes.sizeof(_Args):
            raise RuntimeError(
                f"csrc/fifo_fold.cu takes {size()} bytes of arguments, the "
                f"wrapper passes {ctypes.sizeof(_Args)}")
        fn = lib.ra_fifo_fold
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fifo_fold_cuda(commands, mask, state, out, *, drop_head: bool) -> None:
    """Fold the window into ``out`` in one kernel launch.  ``commands``
    int32 [N,P,A,3+] and ``mask`` bool [N,P,A], any strides; ``state`` and
    ``out`` the FIFO's 15-leaf dicts with leading dims [N,P] (buf/dc/mid
    [Q], co_* [K], con_* [C], five scalars), int32 and contiguous, ``out``
    sharing no memory with ``state``; 1 <= K <= 32, C >= 1, and
    1 <= Q <= 19328 or Q a power of two.  Raises on anything else, and if
    the launch fails."""
    global LAUNCHES
    if sorted(state) != list(LEAVES) or sorted(out) != list(LEAVES):
        raise ValueError(f"fifo state must have the keys {LEAVES}")
    Q, K, C = (state["buf"].shape[-1], state["co_id"].shape[-1],
               state["con_pid"].shape[-1])
    if not (1 <= K <= MAX_CHECKOUT and C >= 1 and kernel_takes_capacity(Q)):
        raise ValueError(f"the fifo-fold kernel takes 1 <= K <= "
                         f"{MAX_CHECKOUT} checkout slots, C >= 1 consumer "
                         f"slots and a capacity 1 <= Q <= {MAX_SHARED_RING} "
                         f"or a power of two; got K={K}, C={C}, Q={Q}")
    ins, outs = [state[k] for k in LEAVES], [out[k] for k in LEAVES]
    dev = check_fold_operands(commands, mask, None, ins, outs, width=3)
    N, P, A = mask.shape
    want = {"buf": Q, "dc": Q, "mid": Q, "co_dc": K, "co_id": K,
            "co_mid": K, "co_owner": K, "co_val": K, "con_credit": C,
            "con_pid": C}
    for k, t in zip(LEAVES, ins):
        shape = (N, P, want[k]) if k in want else (N, P)
        if tuple(t.shape) != shape:
            raise ValueError(f"fifo state {k} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if N * P == 0:
        return
    args = _Args((ctypes.c_void_p * len(LEAVES))(*(t.data_ptr()
                                                   for t in ins)),
                 (ctypes.c_void_p * len(LEAVES))(*(t.data_ptr()
                                                   for t in outs)),
                 commands.data_ptr(), mask.data_ptr(),
                 strides(commands), strides(mask),
                 N, P, A, Q, K, C, int(bool(drop_head)))
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fifo-fold kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1


def fifo_fold_dispatch(machine, meta, commands, mask, state):
    """The FIFO's in-order window fold: the plain version for tensors on
    the CPU, the kernel on a CUDA device, else raise."""
    if fold_device(commands, mask, state) == "cpu":
        return machine.sequential_window_fold(meta, commands, mask, state)
    cmds, msk, _index, st, out_k, out = kernel_operands(
        meta, commands, mask, state)
    fifo_fold_cuda(cmds, msk, st, out_k,
                   drop_head=machine.overflow == "drop_head")
    return out

