"""The commit phase of a lockstep step: phases 4, 4a and 4b of
``engine/lockstep.py::_step`` as one function, and its hand-written
Hopper kernel.

Per lane it folds the replies into the leader's match and send cursors,
runs the commit quorum (the work of the reference's Pallas kernel,
``ra_tpu/ops/pallas_quorum.py::_kernel``) with the §5.4.2 term gate,
broadcasts the commit to the members, extends or revokes the leader
lease, registers an arriving read batch, and runs the consistent-query
heartbeat quorum (the surrounding XLA of ``ra_tpu/engine/lockstep.py``
phases 4-4b).

* :func:`commit_phase` is the plain torch version: the code of
  ``_step`` moved here unchanged, on the CPU and as the kernel's oracle.
* :func:`commit_phase_cuda` is the checked wrapper of the fused kernel
  in ``csrc/commit_phase.cu`` (one launch, built by ``_build`` on first
  use).
* :func:`commit_phase_dispatch` is what the engine calls: the plain
  version for tensors on the CPU, the kernel for tensors on one CUDA
  device, and an error for anything else.  There is no fallback from
  the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ._checks import check_kernel_args
from .quorum import election_quorum, evaluate_quorum, query_quorum, \
    update_match_next

Tensor = torch.Tensor
I32 = torch.int32
B8 = torch.bool

#: largest member count the kernel is built for (RA_MAX_MEMBERS)
MAX_MEMBERS = 16

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

#: the inputs, in argument order: (name, dtype, "np" for [N,P] or "n")
INPUTS = (
    ("match0", I32, "np"), ("next0", I32, "np"),
    ("last_index", I32, "np"), ("last_written", I32, "np"),
    ("commit", I32, "np"), ("peer_query", I32, "np"),
    ("active", B8, "np"), ("voter", B8, "np"),
    ("term_start", I32, "n"), ("leader_slot", I32, "n"),
    ("elect_ok", B8, "n"), ("leader_up", B8, "n"),
    ("total_committed", I32, "n"), ("read_clock", I32, "n"),
    ("lease_until", I32, "n"), ("n_read", I32, "n"), ("read_n", I32, "n"),
    ("read_ix", I32, "n"), ("read_reg", I32, "n"),
    ("query_mask", B8, "n"), ("query_index", I32, "n"),
    ("read_tok", I32, "n"))


class CommitPhase(NamedTuple):
    """What phases 5-5c and the new ``LaneState`` read of the commit
    phase: int32 unless marked bool."""

    match: Tensor            # [N,P] leader's view after the reply fold
    next_index: Tensor       # [N,P] send cursors
    commit: Tensor           # [N,P] member commits after the broadcast
    peer_query: Tensor       # [N,P] confirmed query indexes
    total_committed: Tensor  # [N]
    delta: Tensor            # [N]   leader commit moved this step
    leader_commit: Tensor    # [N]   the leader's new commit
    read_clock: Tensor       # [N]
    lease_until: Tensor      # [N]
    lease_ok: Tensor         # [N]   bool: the lease is live
    acc_lane: Tensor         # [N]   bool: a read batch registered
    r_shed_now: Tensor       # [N]   reads shed at arrival
    read_ix: Tensor          # [N]
    read_reg: Tensor         # [N]
    read_n1: Tensor          # [N]   pending reads after registration
    query_index: Tensor      # [N]
    read_tok: Tensor         # [N]
    query_agreed: Tensor     # [N]


def _take(x: Tensor, slot: Tensor) -> Tensor:
    """``x[lane, slot[lane]]`` for every lane: x [N,P], slot int32[N]."""
    return torch.gather(x, 1, slot.long()[:, None])[:, 0]


#: the bool outputs; the first four outputs are [N,P], the rest [N]
_OUT_DTYPES = {"lease_ok": B8, "acc_lane": B8}


def commit_phase(match0, next0, last_index, last_written, commit,
                 peer_query, active, voter, term_start, leader_slot,
                 elect_ok, leader_up, total_committed, read_clock,
                 lease_until, n_read, read_n, read_ix, read_reg, query_mask,
                 query_index, read_tok, *, lease_ttl: int, Kr: int,
                 supports_read: bool) -> CommitPhase:
    """Phases 4-4b of a step in plain torch ops.  ``commit``,
    ``peer_query``, ``total_committed``, ``read_clock``, ``lease_until``,
    ``read_n``, ``read_ix``, ``read_reg``, ``query_index`` and
    ``read_tok`` are the state's values before the step; ``match0`` and
    ``next0`` the cursors after the election reset; ``leader_slot``
    indexes ``[0, P)``.  ``Kr`` is the read window; with
    ``supports_read`` False every read is shed at arrival."""
    N = match0.shape[0]

    # -- 4. reply fold + quorum -------------------------------------------
    match, _ = update_match_next(match0, next0, active, last_written,
                                 last_index + 1)
    next_index = torch.where(active, last_index + 1, next0)
    leader_commit0 = _take(commit, leader_slot)
    # down members stay in the quorum denominator: a leader that lost a
    # majority stops committing
    new_leader_commit = evaluate_quorum(leader_commit0, match, voter,
                                        term_start)
    new_commit = torch.minimum(new_leader_commit[:, None], last_index)
    new_commit = torch.where(active, torch.maximum(new_commit, commit),
                             commit)
    delta = _take(new_commit, leader_slot) - leader_commit0
    total_committed = total_committed + delta

    # -- 4a. lease grant/expiry + read-batch registration ------------------
    read_clock = read_clock + 1
    lease_q = election_quorum(active & voter, voter)
    lease_until = torch.where(elect_ok, 0, lease_until)
    lease_until = torch.where(
        lease_q & leader_up,
        torch.maximum(lease_until, read_clock + lease_ttl), lease_until)
    lease_ok = read_clock < lease_until

    if supports_read:
        acc_lane = (n_read > 0) & leader_up & (read_n == 0)
    else:
        acc_lane = torch.zeros((N,), dtype=torch.bool, device=match0.device)
    r_acc = torch.where(acc_lane, torch.clamp(n_read, max=Kr), 0)
    r_shed_now = n_read - r_acc
    read_ix = torch.where(acc_lane, leader_commit0, read_ix)
    read_reg = torch.where(acc_lane, read_clock, read_reg)
    read_n1 = torch.where(acc_lane, r_acc, read_n)

    # -- 4b. consistent-query heartbeat quorum ------------------------------
    query_index = query_index + (query_mask | acc_lane).to(I32)
    read_tok = torch.where(acc_lane, query_index, read_tok)
    peer_q0 = torch.where(elect_ok[:, None], 0, peer_query)
    peer_query = torch.where(active, query_index[:, None], peer_q0)
    query_agreed = query_quorum(peer_query, voter)

    return CommitPhase(
        match=match, next_index=next_index, commit=new_commit,
        peer_query=peer_query, total_committed=total_committed,
        delta=delta, leader_commit=leader_commit0 + delta,
        read_clock=read_clock, lease_until=lease_until, lease_ok=lease_ok,
        acc_lane=acc_lane, r_shed_now=r_shed_now, read_ix=read_ix,
        read_reg=read_reg, read_n1=read_n1, query_index=query_index,
        read_tok=read_tok, query_agreed=query_agreed)


def sample_inputs(n: int, p: int, seed: int, Kr: int = 4) -> tuple:
    """Seeded numpy inputs in INPUTS order for holding the kernel against
    its plain version (and both against the reference): lanes with no
    voter, inactive members, won elections, down leaders, leases live and
    expired, and read batches accepted, shed (pending slot busy, leader
    down) and cut to ``Kr``."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    voter = rng.random((n, p)) < 0.8
    voter[:, 0] = True
    voter[rng.random(n) < 0.05] = False          # lanes with no voter
    match0 = ints(0, 100, (n, p))
    last_index = ints(0, 100, (n, p))
    read_clock = ints(0, 50, (n,))
    return (match0, match0 + ints(1, 6, (n, p)), last_index,
            np.maximum(last_index - ints(0, 4, (n, p)), 0),
            ints(0, 60, (n, p)), ints(0, 30, (n, p)),
            rng.random((n, p)) < 0.85, voter,
            ints(0, 80, (n,)), ints(0, p, (n,)),
            rng.random(n) < 0.2, rng.random(n) < 0.85,
            ints(0, 1000, (n,)), read_clock,
            read_clock + ints(-5, 10, (n,)),
            np.where(rng.random(n) < 0.5, ints(1, Kr + 3, (n,)),
                     0).astype(np.int32),
            np.where(rng.random(n) < 0.4, ints(1, Kr + 1, (n,)),
                     0).astype(np.int32),
            ints(0, 60, (n,)), ints(0, 50, (n,)),
            rng.random(n) < 0.3, ints(0, 30, (n,)), ints(0, 30, (n,)))


class _Args(ctypes.Structure):
    """``RaCommitPhaseArgs`` of csrc/commit_phase.cu: one pointer per
    input, then one per output, in the order of INPUTS and CommitPhase."""

    _fields_ = [(name, ctypes.c_void_p) for name, _d, _k in INPUTS] + \
        [("out_" + name, ctypes.c_void_p) for name in CommitPhase._fields]


def _kernel_fn():
    from . import _build
    return _build.kernel("commit_phase", "ra_commit_phase", [
        ctypes.POINTER(_Args)] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        _Args)


def commit_phase_cuda(*args, lease_ttl: int, Kr: int,
                      supports_read: bool) -> CommitPhase:
    """:func:`commit_phase` in one launch of the fused kernel.  Every
    input contiguous on one CUDA device with the dtype and shape of
    INPUTS, 1 <= P <= 16.  Outputs are fresh tensors (rows of three new
    buffers); no input is written.  Raises on anything else, and if the
    launch fails."""
    global LAUNCHES
    if len(args) != len(INPUTS):
        raise TypeError(f"commit_phase_cuda takes {len(INPUTS)} tensors, "
                        f"got {len(args)}")
    match0 = args[0]
    if match0.dim() != 2:
        raise ValueError(f"match0 must be [N, P], got "
                         f"{tuple(match0.shape)}")
    N, P = match0.shape
    if not 1 <= P <= MAX_MEMBERS:
        raise ValueError(f"the commit-phase kernel takes 1..{MAX_MEMBERS} "
                         f"members, got {P}")
    shapes = {"np": (N, P), "n": (N,)}
    dev = check_kernel_args(
        [(name, t, dtype, shapes[kind])
         for (name, dtype, kind), t in zip(INPUTS, args)], "match0")
    # three allocations, not eighteen (each is host time on every step):
    # the outputs are disjoint rows of one int32 [4,N,P], one int32
    # [12,N] and one bool [2,N] buffer
    rows = {I32: iter(torch.empty((12, N), dtype=I32, device=dev).unbind()),
            B8: iter(torch.empty((2, N), dtype=B8, device=dev).unbind())}
    out = CommitPhase(
        *torch.empty((4, N, P), dtype=I32, device=dev).unbind(),
        *(next(rows[_OUT_DTYPES.get(name, I32)])
          for name in CommitPhase._fields[4:]))
    if N == 0:
        return out
    fn = _kernel_fn()
    ptrs = _Args(*(t.data_ptr() for t in args + tuple(out)))
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = fn(ctypes.byref(ptrs), N, P, int(lease_ttl), int(Kr),
                 int(bool(supports_read)),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"commit-phase kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def commit_phase_dispatch(*args, lease_ttl: int, Kr: int,
                          supports_read: bool) -> CommitPhase:
    """The engine's commit phase: the plain version when every input lies
    on the CPU, the kernel when they lie on a CUDA device, else raise."""
    kw = dict(lease_ttl=lease_ttl, Kr=Kr, supports_read=supports_read)
    devs = {t.device.type for t in args}
    if devs == {"cpu"}:
        return commit_phase(*args, **kw)
    if devs == {"cuda"}:
        return commit_phase_cuda(*args, **kw)
    raise ValueError(f"commit_phase_dispatch: inputs on {sorted(devs)}; "
                     "expected all on the CPU or all on one CUDA device")
