"""The commit-quorum kernel: the CUDA counterpart of the reference's
Pallas TPU kernel (``ra_tpu/ops/pallas_quorum.py``; this module keeps
that name so a reader finds the pair).

:func:`evaluate_quorum_cuda` is the checked wrapper around the
hand-written Hopper kernel in ``csrc/quorum.cu`` (built by ``_build`` on
first use); its plain version is ``ops.quorum.evaluate_quorum``.  The
engine's step does not call it: its commit quorum runs inside the fused
commit-phase kernel (``ops.commit_phase``).
"""
from __future__ import annotations

import ctypes

import torch

from ._checks import check_kernel_args

#: largest member count the kernel holds in registers (RA_MAX_MEMBERS)
MAX_MEMBERS = 16

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from . import _build
        fn = _build.load("quorum").ra_evaluate_quorum
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def evaluate_quorum_cuda(commit_index: torch.Tensor,
                         match_index: torch.Tensor,
                         voter_mask: torch.Tensor,
                         term_start_index: torch.Tensor) -> torch.Tensor:
    """``evaluate_quorum`` on the card: commit_index int32[N],
    match_index int32[N,P], voter_mask bool[N,P], term_start_index
    int32[N], all contiguous on one CUDA device, 1 <= P <= 16.  Returns
    int32[N].  Raises on anything else, and if the launch fails."""
    global LAUNCHES
    if match_index.dim() != 2:
        raise ValueError(f"match_index must be [N, P], got "
                         f"{tuple(match_index.shape)}")
    N, P = match_index.shape
    if not 1 <= P <= MAX_MEMBERS:
        raise ValueError(f"the quorum kernel takes 1..{MAX_MEMBERS} "
                         f"members, got {P}")
    dev = check_kernel_args(
        (("commit_index", commit_index, torch.int32, (N,)),
         ("match_index", match_index, torch.int32, (N, P)),
         ("voter_mask", voter_mask, torch.bool, (N, P)),
         ("term_start_index", term_start_index, torch.int32, (N,))),
        "match_index")
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = fn(match_index.data_ptr(), voter_mask.data_ptr(),
                 commit_index.data_ptr(), term_start_index.data_ptr(),
                 out.data_ptr(), N, P,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quorum kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out

