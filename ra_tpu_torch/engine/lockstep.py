"""Lockstep multi-Raft lane engine on torch tensors.

The counterpart of ``ra_tpu/engine/lockstep.py``: all members of all
co-hosted Raft clusters live in SoA tensors with a leading lane axis, and
one ``step`` advances every cluster at once.  Per lane, ``_step`` runs:

  0. failures, divergent-tail clamp and the vote round;
  1. leader append into the ``[N,R,C]`` payload ring (with backpressure);
  2. replication under ``pipeline_credit``;
  3. write confirm: ``write_delay`` 0 or 1, or in durable mode the WAL's
     fsync horizon ``confirm_upto``;
  4. reply fold, the commit quorum and the commit broadcast; 4a. lease
     and read registration; 4b. the query quorum — all three on a CUDA
     engine one launch of the hand-written fused kernel
     (``ops.commit_phase``), on the CPU its plain torch version;
  5. the apply fold over the committed window;
  5b. per-lane telemetry; 5c. read serve or refuse;
  6. in durable mode, the compaction of the accepted rows for the WAL.

``superstep`` runs K rounds in one dispatch (``_superstep``, the
reference's ``lax.scan``): on a CUDA engine one replay of a captured CUDA
graph of the K steps (``engine/graph.py``), on the CPU a plain loop.
``DispatchAheadDriver`` (``engine/driver.py``) stages the next block
while the device runs the current one, and ``TelemetrySampler``
(``telemetry.py``) rides the same dispatch loop.

In durable mode (``attach_durability``, or ``engine.durable.open_engine``)
commits gate on real fsync confirms from a sharded WAL: every dispatch
takes the WAL's confirm horizon as an input, and its accepted entries,
compacted on the device, go to the WAL shards (``engine/durable.py``).

Every tensor keeps the reference's dtype (int32 or bool), and the state
after every step and dispatch equals the JAX engine's on the same inputs
(``tests/test_torch_engine.py``, ``tests/test_torch_superstep.py``).
``step`` and ``superstep`` never read the device back and never wait
on it: host masks and the confirm horizon are numpy data, copied to the
device from pinned memory without blocking.  The sequential-machine
apply path is not ported yet.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import devicewatch, trace
from ..convert import state_from_numpy, state_to_numpy
from ..core.machine import JitMachine
from ..core.tree import tree_map
from ..device import DeviceLike, resolve_device
from ..metrics import ENGINE_PIPELINE_FIELDS, TELEMETRY_FIELDS
from ..ops import commit_phase, pallas_quorum
from ..ops.commit_phase import commit_phase_dispatch
from ..ops.quorum import election_quorum, pipeline_credit
from ..readback import Readback
from ..telemetry import PhaseStats
from .graph import GraphCache

Tensor = torch.Tensor
I32 = torch.int32
_BIG = 2 ** 30   # above any index: the masked-min sentinel


def _take(x: Tensor, slot: Tensor) -> Tensor:
    """``x[lane, slot[lane]]`` for every lane: x [N,P,...], slot int32[N]."""
    idx = slot.long().reshape((-1, 1) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand((x.shape[0], 1) + x.shape[2:]))[:, 0]


def _ring_write(ring: Tensor, payloads: Tensor, leader_last: Tensor,
                n_acc: Tensor, elect_ok: Tensor) -> Tensor:
    """Append ``n_acc`` payload rows (entries leader_last+1..+n_acc at
    slots (idx-1) % R) plus, on a won election, the zero-payload
    term-opening noop.  Out of place.  Masked columns are parked on one
    dummy slot one past the write range and all write that slot's OLD
    value, so duplicate indexes write equal values and the result does
    not depend on scatter order (needs R >= K + 3, checked by the
    engine)."""
    N, R, C = ring.shape
    K = payloads.shape[1]
    vals = torch.cat([payloads.to(ring.dtype),
                      ring.new_zeros((N, 1, C))], dim=1)       # [N,K+1,C]
    k_idx = torch.arange(K + 1, dtype=I32, device=ring.device)
    dest = (leader_last[:, None] + k_idx[None, :]) % R          # [N,K+1]
    noop_col = k_idx[None, :] == n_acc[:, None]
    write_mask = (k_idx[None, :] < n_acc[:, None]) | \
        (noop_col & elect_ok[:, None])
    dummy = ((leader_last + K + 1) % R)[:, None]
    dest3 = torch.where(write_mask, dest, dummy).long()[..., None] \
        .expand(vals.shape)
    vals = torch.where(noop_col[..., None], 0, vals)
    old = torch.gather(ring, 1, dest3)
    vals = torch.where(write_mask[..., None], vals, old)
    return ring.scatter(1, dest3, vals)


def _ring_read_window(ring: Tensor, idx_lane: Tensor) -> Tensor:
    """Read the per-lane entry window ``idx_lane`` (int32[N,A]) from the
    ring: [N,A,C].  Slot mapping (idx-1) % R."""
    N, R, C = ring.shape
    slot = ((idx_lane - 1) % R).long()
    return torch.gather(ring, 1, slot[..., None].expand(slot.shape + (C,)))


class LaneTelemetry(NamedTuple):
    """Device-resident per-lane telemetry accumulators, int32[N] each;
    field meanings are ``metrics.TELEMETRY_FIELDS``'."""

    elections_requested: Tensor
    elections_won: Tensor
    leader_changes: Tensor
    leader_age: Tensor
    commit_lag: Tensor
    apply_lag: Tensor
    stall_steps: Tensor
    steps: Tensor


assert LaneTelemetry._fields == TELEMETRY_FIELDS  # registry parity


def _init_telemetry(n_lanes: int, device: torch.device) -> LaneTelemetry:
    # one zeros() PER field: a shared tensor would alias one buffer 8 ways
    return LaneTelemetry(*(torch.zeros((n_lanes,), dtype=I32, device=device)
                           for _ in LaneTelemetry._fields))


class LaneState(NamedTuple):
    """SoA state for N lanes x P member slots (the reference's 30 fields,
    same names, shapes and dtypes)."""

    term: Tensor           # int32[N]   shared current term
    leader_slot: Tensor    # int32[N]   which slot leads the lane
    term_start: Tensor     # int32[N]   index of this term's noop (§5.4.2)
    last_index: Tensor     # int32[N,P] per-member log tail
    last_written: Tensor   # int32[N,P] fsync-confirmed tail
    match: Tensor          # int32[N,P] leader's view (own slot = written)
    next_index: Tensor     # int32[N,P] per-peer send cursor
    commit: Tensor         # int32[N,P] per-member commit index
    applied: Tensor        # int32[N,P] per-member last applied
    voter: Tensor          # bool[N,P]  voting members
    active: Tensor         # bool[N,P]  member exists and is up
    ring: Tensor           # [N,R,C]    payload ring, slot (idx-1) % R
    ring_base: Tensor      # int32[N]   reclaim horizon
    total_committed: Tensor  # int32[N] cumulative committed entries
    query_index: Tensor    # int32[N]   consistent-query counter
    peer_query: Tensor     # int32[N,P] per-member confirmed query index
    query_agreed: Tensor   # int32[N]   majority-confirmed query index
    read_clock: Tensor     # int32[N]   monotone step clock (lease base)
    lease_until: Tensor    # int32[N]   leader lease expiry
    read_buf: Tensor       # [N,Kr,Cq]  pending read-query batch
    read_n: Tensor         # int32[N]   pending read count (0 = slot free)
    read_ix: Tensor        # int32[N]   captured read index
    read_tok: Tensor       # int32[N]   captured heartbeat token
    read_reg: Tensor       # int32[N]   registration clock
    read_served: Tensor    # int32[N]   cumulative reads served
    read_shed: Tensor      # int32[N]   cumulative reads shed at arrival
    read_stale: Tensor     # int32[N]   cumulative stale-refusals
    read_leased: Tensor    # int32[N]   served-under-lease subset
    telem: Any             # LaneTelemetry
    mac: Any               # machine state tree, leading dims [N,P]


#: per-field restore behaviour for archives written before the field
#: existed: "require" refuses a missing leaf, "zeros" zero-fills it,
#: "init" keeps the restoring engine's current value.  Same table as the
#: reference, so both engines restore the same archives the same way.
CHECKPOINT_FIELD_DEFAULTS = {
    "term": "require",
    "leader_slot": "require",
    "term_start": "require",
    "last_index": "require",
    "last_written": "require",
    "match": "require",
    "next_index": "require",
    "commit": "require",
    "applied": "require",
    "voter": "require",
    "active": "require",
    "ring": "require",
    "ring_base": "require",
    "total_committed": "require",
    "query_index": "require",
    "peer_query": "require",
    "query_agreed": "require",
    # a lease must never survive a restart, and a pending read batch's
    # client is gone; the cumulative read counters are health state
    "read_clock": "zeros",
    "lease_until": "zeros",
    "read_buf": "zeros",
    "read_n": "zeros",
    "read_ix": "zeros",
    "read_tok": "zeros",
    "read_reg": "zeros",
    "read_served": "zeros",
    "read_shed": "zeros",
    "read_stale": "zeros",
    "read_leased": "zeros",
    "telem": "zeros",
    "mac": "require",
}


def _init_state(n_lanes: int, n_members: int, ring_capacity: int,
                payload_width: int, mac_state: Any, device: torch.device,
                payload_dtype=I32, read_window: int = 1,
                query_width: int = 1, query_dtype=I32) -> LaneState:
    N, P, R, C = n_lanes, n_members, ring_capacity, payload_width

    def z(*s):
        return torch.zeros(s, dtype=I32, device=device)

    def ones(*s):
        return torch.ones(s, dtype=I32, device=device)

    return LaneState(
        term=ones(N),
        leader_slot=z(N),
        term_start=ones(N),
        last_index=z(N, P),
        last_written=z(N, P),
        match=z(N, P),
        next_index=ones(N, P),
        commit=z(N, P),
        applied=z(N, P),
        voter=torch.ones((N, P), dtype=torch.bool, device=device),
        active=torch.ones((N, P), dtype=torch.bool, device=device),
        ring=torch.zeros((N, R, C), dtype=payload_dtype, device=device),
        ring_base=z(N),
        total_committed=z(N),
        query_index=z(N),
        peer_query=z(N, P),
        query_agreed=z(N),
        read_clock=z(N),
        lease_until=z(N),
        read_buf=torch.zeros((N, read_window, query_width),
                             dtype=query_dtype, device=device),
        read_n=z(N),
        read_ix=z(N),
        read_tok=z(N),
        read_reg=z(N),
        read_served=z(N),
        read_shed=z(N),
        read_stale=z(N),
        read_leased=z(N),
        telem=_init_telemetry(N, device),
        mac=mac_state,
    )


def _step(state: LaneState, n_new: Tensor, payloads: Tensor,
          fail_mask: Tensor, elect_mask: Tensor, confirm_upto: Tensor,
          query_mask: Tensor, n_read: Tensor, read_q: Tensor, *,
          machine: JitMachine, ring_capacity: int, apply_window: int,
          pipeline_window: int, max_append_batch: int, write_delay: int,
          durable: bool = False, lease_ttl: int = 8,
          read_timeout: int = 64):
    """One lockstep round for every lane.  Pure: returns
    ``(new_state, aux)`` and leaves ``state`` untouched.  The phases and
    their Raft sources are those of the reference ``_step``
    (``ra_tpu/engine/lockstep.py``).

    ``confirm_upto`` (int32[N]) is the WAL's durable horizon: with
    ``durable=True`` ``last_written`` advances only to it, so the commit
    quorum counts nothing that is not fsynced, and the aux gains the
    step's accepted rows compacted for the WAL (``flat_rows``
    [N*K, C], ``row_csum`` int32[N]).  Without ``durable`` it is not
    read."""
    if not machine.supports_batch_apply:
        raise NotImplementedError(
            "the port's apply fold needs a machine with "
            "supports_batch_apply=True; sequential machines are not "
            "ported yet")
    N, P = state.last_index.shape
    R = ring_capacity
    dev = state.term.device
    slots = torch.arange(P, device=dev)

    # -- 0. failures, divergence repair, elections ------------------------
    active = state.active & ~fail_mask
    # an active non-leader's tail never extends past its leader's log
    leader_arm0 = slots[None, :] == state.leader_slot[:, None]
    cur_leader_last = _take(state.last_index, state.leader_slot)
    clamp = active & ~leader_arm0
    last_index0 = torch.where(
        clamp, torch.minimum(state.last_index, cur_leader_last[:, None]),
        state.last_index)
    last_written0 = torch.minimum(state.last_written, last_index0)

    # vote round: candidate = active voter with the longest durable log
    # (first one on ties); voters grant iff the candidate is up to date;
    # the candidacy needs a counted quorum of grants
    score = torch.where(active & state.voter, last_written0, -1)
    cand = torch.argmax(score, dim=-1).to(I32)
    cand_written = _take(last_written0, cand)
    grants = active & state.voter & (cand_written[:, None] >= last_written0)
    won = election_quorum(grants, state.voter)
    elect_ok = elect_mask & won

    leader_slot = torch.where(elect_ok, cand, state.leader_slot)
    term = torch.where(elect_ok, state.term + 1, state.term)
    leader_arm = slots[None, :] == leader_slot[:, None]
    leader_last = _take(last_index0, leader_slot)
    leader_written = _take(last_written0, leader_slot)
    # a new leader discards its unwritten tail and opens its term at
    # written+1 with a noop entry
    leader_last = torch.where(elect_ok, leader_written, leader_last)
    term_start = torch.where(elect_ok, leader_last + 1, state.term_start)
    n_noop = elect_ok.to(I32)
    leader_up = _take(active, leader_slot)

    # -- 1. leader append into the ring (with backpressure) ---------------
    min_applied = torch.where(active, state.applied, _BIG).amin(dim=-1)
    ring_base = torch.maximum(state.ring_base,
                              torch.minimum(min_applied, leader_last))
    headroom = torch.clamp(R - (leader_last - ring_base) - 1, min=0)
    n_acc = torch.minimum(torch.where(leader_up, n_new, 0), headroom)
    n_acc = torch.clamp(n_acc, max=payloads.shape[1])
    total_app = n_acc + torch.where(leader_up, n_noop, 0)
    ring = _ring_write(state.ring, payloads, leader_last, n_acc, elect_ok)
    new_leader_last = leader_last + total_app

    # -- 2. replication, governed by per-peer pipeline credit --------------
    # a won election resets peer cursors (next := last+1, match := 0)
    next0 = torch.where(elect_ok[:, None], new_leader_last[:, None] + 1,
                        state.next_index)
    match0 = torch.where(elect_ok[:, None],
                         torch.where(leader_arm, leader_written[:, None], 0),
                         state.match)
    zeros_n = torch.zeros((N,), dtype=I32, device=dev)
    n_send, _needs = pipeline_credit(next0, match0, new_leader_last, zeros_n,
                                     torch.zeros_like(next0),
                                     pipeline_window, max_append_batch)
    send_hi = next0 + n_send - 1
    # adopt only when entries actually ship
    last_index = torch.where(active & (n_send > 0),
                             torch.maximum(last_index0, send_hi),
                             last_index0)
    last_index = torch.where(leader_arm, new_leader_last[:, None],
                             last_index)
    # on a won election, follower tails cap at the NEW leader's log
    last_index = torch.where(elect_ok[:, None] & active,
                             torch.minimum(last_index,
                                           new_leader_last[:, None]),
                             last_index)

    # -- 3. write confirm -------------------------------------------------
    if durable:
        # real confirms: nothing beyond the WAL's fsync horizon enters the
        # quorum.  On a won election the horizon is also capped at the new
        # leader's pre-noop written tail: the truncated suffix's indexes
        # are reused by fresh entries, and a confirm of the old suffix
        # must not vouch for them
        eff_confirm = torch.where(elect_ok,
                                  torch.minimum(confirm_upto,
                                                leader_written),
                                  confirm_upto)
        last_written = torch.where(active,
                                   torch.minimum(last_index,
                                                 eff_confirm[:, None]),
                                   last_written0)
    elif write_delay == 0:
        last_written = torch.where(active, last_index, last_written0)
    else:
        # confirms lag one step: this step confirms the previous tail
        last_written = torch.where(active,
                                   torch.minimum(last_index, last_index0),
                                   last_written0)
    last_written = torch.minimum(last_written, last_index)

    # -- 4-4b. reply fold, commit quorum, lease, read registration and the
    # consistent-query quorum: one kernel launch on a CUDA engine.  Down
    # members stay in the quorum denominator: a leader that lost a
    # majority stops committing.
    supports_read = machine.query_spec is not None
    Kr = state.read_buf.shape[1]
    cp = commit_phase_dispatch(
        match0, next0, last_index, last_written, state.commit,
        state.peer_query, active, state.voter, term_start, leader_slot,
        elect_ok, leader_up, state.total_committed, state.read_clock,
        state.lease_until, n_read, state.read_n, state.read_ix,
        state.read_reg, query_mask, state.query_index, state.read_tok,
        lease_ttl=lease_ttl, Kr=Kr, supports_read=supports_read)
    commit, read_clock, lease_ok, read_n1 = \
        cp.commit, cp.read_clock, cp.lease_ok, cp.read_n1
    read_buf = torch.where(cp.acc_lane[:, None, None], read_q,
                           state.read_buf)

    # -- 5. apply fold over the (lane-uniform) committed window ------------
    applied0 = state.applied
    A = apply_window
    apply_to = torch.minimum(commit, applied0 + A)
    base = torch.where(active, applied0, _BIG).amin(dim=-1)
    base = torch.where(active.any(dim=-1), base, 0)             # [N]
    a_idx = torch.arange(A, dtype=I32, device=dev)
    idx_lane = base[:, None] + 1 + a_idx[None, :]              # [N,A]
    cmds_lane = _ring_read_window(ring, idx_lane)              # [N,A,C]
    idx = idx_lane[:, None, :]                                 # [N,1,A]
    do = (idx > applied0[..., None]) & (idx <= apply_to[..., None]) \
        & active[..., None]                                    # [N,P,A]
    cmds = cmds_lane[:, None].expand(do.shape + cmds_lane.shape[-1:])
    meta = {"index": idx.expand(do.shape), "term": term[:, None, None]}
    mac = machine.jit_apply_batch(meta, cmds, do, state.mac)
    applied = torch.where(
        active,
        torch.maximum(applied0,
                      torch.minimum(apply_to, (base + A)[:, None])),
        applied0)

    # -- 5b. per-lane telemetry accumulators -------------------------------
    tel = state.telem
    leader_commit_new = cp.leader_commit
    lane_applied = torch.where(active, applied, _BIG).amin(dim=-1)
    lane_applied = torch.where(active.any(dim=-1), lane_applied, 0)
    lead_changed = leader_slot != state.leader_slot
    backlog = new_leader_last > leader_commit_new
    telem = LaneTelemetry(
        elections_requested=tel.elections_requested + elect_mask.to(I32),
        elections_won=tel.elections_won + elect_ok.to(I32),
        leader_changes=tel.leader_changes + lead_changed.to(I32),
        # reset only when the leader actually moved
        leader_age=torch.where(lead_changed, 0, tel.leader_age + 1),
        commit_lag=new_leader_last - leader_commit_new,
        apply_lag=leader_commit_new - lane_applied,
        stall_steps=torch.where((cp.delta > 0) | ~backlog, 0,
                                tel.stall_steps + 1),
        steps=tel.steps + 1)

    # -- 5c. read serve/refuse ---------------------------------------------
    # authority: live lease OR the heartbeat quorum confirmed the batch's
    # token; freshness: the leader applied up to the captured read index
    lead_applied = _take(applied, leader_slot)
    authority = lease_ok | (cp.query_agreed >= cp.read_tok)
    can_serve = (read_n1 > 0) & leader_up & authority & \
        (lead_applied >= cp.read_ix)
    expired = (read_n1 > 0) & ~can_serve & \
        (read_clock - cp.read_reg >= read_timeout)
    if supports_read:
        replies = machine.jit_query(
            read_buf, tree_map(lambda x: _take(x, leader_slot), mac))
        replies = torch.where(can_serve[:, None, None], replies, 0)
    else:
        replies = torch.zeros((N, Kr, 1), dtype=I32, device=dev)
    read_done = torch.where(can_serve, read_n1, 0)
    stale_now = torch.where(expired, read_n1, 0)
    read_served = state.read_served + read_done
    read_shed_tot = state.read_shed + cp.r_shed_now
    read_stale_tot = state.read_stale + stale_now
    read_leased = state.read_leased + \
        torch.where(can_serve & lease_ok, read_n1, 0)

    new_state = LaneState(term=term, leader_slot=leader_slot,
                          term_start=term_start, last_index=last_index,
                          last_written=last_written, match=cp.match,
                          next_index=cp.next_index, commit=commit,
                          applied=applied, voter=state.voter, active=active,
                          ring=ring, ring_base=ring_base,
                          total_committed=cp.total_committed,
                          query_index=cp.query_index,
                          peer_query=cp.peer_query,
                          query_agreed=cp.query_agreed,
                          read_clock=read_clock, lease_until=cp.lease_until,
                          read_buf=read_buf,
                          read_n=torch.where(can_serve | expired, 0,
                                             read_n1),
                          read_ix=cp.read_ix, read_tok=cp.read_tok,
                          read_reg=cp.read_reg, read_served=read_served,
                          read_shed=read_shed_tot,
                          read_stale=read_stale_tot,
                          read_leased=read_leased, telem=telem, mac=mac)
    aux = {"appended_hi": new_leader_last, "n_acc": n_acc,
           "n_app": total_app,
           "read_done": read_done, "read_shed": cp.r_shed_now,
           "read_stale": stale_now,
           "read_watermark": torch.where(can_serve, lead_applied, -1),
           "read_replies": replies,
           "read_served_lanes": read_served,
           "read_shed_lanes": read_shed_tot,
           "read_stale_lanes": read_stale_tot}
    if durable:
        aux["flat_rows"], aux["row_csum"] = _compact_accepted(
            payloads.to(ring.dtype), n_acc)
    return new_state, aux


def _compact_accepted(payloads: Tensor, n_acc: Tensor):
    """Step 6 of the durable step: the accepted host rows, lane-major, in
    a dense ``[N*K, C]`` buffer (rows past the accepted total are zero),
    and the running accept total ``row_csum`` int32[N], so that the WAL
    reads back exactly rows ``[0, row_csum[-1])``.

    Output row j comes from lane ``searchsorted(csum, j, right=True)``:
    the reference's ``jnp.repeat(lanes, n_acc, total_repeat_length=N*K)``,
    which pads with the last lane id, as does the clamp here.  No host
    sync, no allocation that depends on the data: it captures in a CUDA
    graph (``torch.repeat_interleave`` would sync, or raise when the
    accepted total is not N*K)."""
    N, K, C = payloads.shape
    csum = torch.cumsum(n_acc, 0, dtype=I32)                    # [N]
    if N == 0:
        return payloads.reshape(0, C), csum
    j = torch.arange(N * K, dtype=I32, device=payloads.device)
    src_lane = torch.searchsorted(csum, j, right=True).clamp_(max=N - 1)
    row_base = csum[src_lane] - n_acc[src_lane]                 # [N*K]
    k_off = torch.clamp(j - row_base, 0, max(K - 1, 0))
    flat = payloads.reshape(N * K, C)[src_lane * K + k_off]
    valid = j < csum[-1]
    return torch.where(valid[:, None], flat, 0), csum


def _superstep(state: LaneState, n_new_blk: Tensor, payloads_blk: Tensor,
               fail_mask: Tensor, elect_blk: Tensor, confirm_upto: Tensor,
               query_blk: Tensor, n_read_blk: Tensor, read_q_blk: Tensor,
               **step_kwargs):
    """K lockstep rounds: the reference's ``lax.scan`` over ``_step``
    (``ra_tpu/engine/lockstep.py::_superstep``) as a loop of K steps.
    The schedule has a leading ``[K]`` axis (``n_new_blk`` [K,N],
    ``payloads_blk`` [K,N,Kc,C], elect/query masks [K,N], ``n_read_blk``
    [K,N], ``read_q_blk`` [K,N,Kr,Cq]); the fail mask and the durable
    confirm horizon ``confirm_upto`` are constant for the dispatch, so
    within a dispatch confirms only lag the real fsyncs.  Returns
    ``(new_state, aux)`` with every aux leaf stacked on a leading
    ``[K]`` axis, plus two watermarks per inner
    step: ``committed_lanes`` (cumulative committed per lane) and
    ``applied_lanes`` (the lane apply frontier over active members, 0
    for a lane with none).  Pure, with no host sync: on a CUDA engine it
    is captured as one graph."""
    auxes = []
    for j in range(n_new_blk.shape[0]):
        state, aux = _step(state, n_new_blk[j], payloads_blk[j], fail_mask,
                           elect_blk[j], confirm_upto, query_blk[j],
                           n_read_blk[j], read_q_blk[j], **step_kwargs)
        auxes.append({**aux, **step_watermarks(state)})
    return state, {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}


def step_watermarks(state: LaneState) -> dict:
    """The two watermarks ``_superstep`` adds to each inner step's aux:
    ``committed_lanes`` (cumulative committed per lane) and
    ``applied_lanes`` (the lowest ``applied`` over a lane's active
    members, 0 for a lane with none), int32[N] each."""
    applied = torch.where(state.active, state.applied, _BIG).amin(dim=-1)
    return {"committed_lanes": state.total_committed,
            "applied_lanes": torch.where(state.active.any(dim=-1),
                                         applied, 0)}


def _telemetry_summary(telem: LaneTelemetry, total_committed: Tensor,
                       reads: tuple, *, top_k: int, hist_buckets: int,
                       stall_threshold: int) -> dict:
    """Aggregate the per-lane telemetry on the device into a fixed-size
    snapshot (``metrics.TELEMETRY_SUMMARY_FIELDS``): scalar rollups, a
    log2-bucket commit-lag histogram and the ``top_k`` offender lanes.
    Its size does not depend on the lane count, so the sampler's
    readback is a few hundred bytes.  The dtypes are the reference's:
    float32 sums and means, int32 counts and lane ids.  ``torch.topk``
    breaks ties otherwise than ``lax.top_k``: lanes of equal score may
    come in another order."""
    f32, i32 = torch.float32, torch.int32
    lag = telem.commit_lag
    stalled = telem.stall_steps >= stall_threshold
    # any stalled lane outranks any merely laggy one; both parts are
    # clipped so that the packed int32 score cannot overflow
    score = (torch.clamp(telem.stall_steps, 0, (1 << 15) - 1) * (1 << 15)
             + torch.clamp(lag + telem.apply_lag, 0, (1 << 15) - 1))
    top_idx = torch.topk(score, top_k).indices
    # bucket b holds lags in [2^(b-1), 2^b) (bucket 0: lag 0); the last
    # bucket takes the tail
    bucket = torch.clamp(
        torch.ceil(torch.log2(torch.clamp(lag, min=0).to(f32) + 1.0))
        .to(i32), 0, hist_buckets - 1)
    hist = (bucket[:, None] == torch.arange(hist_buckets,
                                            device=lag.device)[None, :]
            ).sum(dim=0, dtype=i32)
    return {
        "steps": telem.steps.amax(),
        "elections_requested": telem.elections_requested.to(f32).sum(),
        "elections_won": telem.elections_won.to(f32).sum(),
        "leader_changes": telem.leader_changes.to(f32).sum(),
        "stalled_lanes": stalled.sum(dtype=i32),
        "commit_lag_max": lag.amax(),
        "commit_lag_mean": lag.to(f32).mean(),
        "apply_lag_max": telem.apply_lag.amax(),
        "apply_lag_mean": telem.apply_lag.to(f32).mean(),
        "leader_age_min": telem.leader_age.amin(),
        "commit_lag_hist": hist,
        "top_lanes": top_idx.to(i32),
        "top_commit_lag": lag[top_idx],
        "top_apply_lag": telem.apply_lag[top_idx],
        "top_stall_steps": telem.stall_steps[top_idx],
        # float32, as the reference: the node-wide sum can pass int32
        "committed_total": total_committed.to(f32).sum(),
        "read_served_total": reads[0].to(f32).sum(),
        "read_shed_total": reads[1].to(f32).sum(),
        "read_stale_total": reads[2].to(f32).sum(),
        "read_leased_total": reads[3].to(f32).sum(),
    }


def telemetry_summary_fn(top_k: int = 8, hist_buckets: int = 16,
                         stall_threshold: int = 8):
    """``_telemetry_summary`` with its aggregation geometry bound:
    ``fn(telem, total_committed, (served, shed, stale, leased))``."""
    return functools.partial(_telemetry_summary, top_k=top_k,
                             hist_buckets=hist_buckets,
                             stall_threshold=stall_threshold)


def _dtype(name: str) -> torch.dtype:
    """The torch dtype of a machine spec's dtype name (e.g. "int32")."""
    return getattr(torch, np.dtype(name).name)


class LockstepEngine:
    """Host API around the lockstep step.  Runs on ``device``: ``None``
    means the CUDA card (and raises where there is none); ``"cpu"`` runs
    the plain torch path on the CPU."""

    def __init__(self, machine: JitMachine, n_lanes: int, n_members: int = 3,
                 *, ring_capacity: int = 1024, max_step_cmds: int = 64,
                 apply_window: Optional[int] = None,
                 pipeline_window: int = 4096, max_append_batch: int = 128,
                 write_delay: int = 0, max_step_reads: int = 16,
                 lease_ttl: int = 8, read_timeout: int = 0,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.machine = machine
        self.n_lanes = n_lanes
        self.n_members = n_members
        if ring_capacity < max_step_cmds + 3:
            # the ring write parks masked columns one slot past the write
            # range (payload + noop + recovery-replay widths)
            raise ValueError("ring_capacity must be >= max_step_cmds + 3")
        self.ring_capacity = ring_capacity
        self.max_step_cmds = max_step_cmds
        self.apply_window = apply_window or (max_step_cmds + 2)
        dtype, shape = machine.command_spec
        self.payload_width = int(np.prod(shape)) if shape else 1
        self.payload_dtype = _dtype(dtype)
        # a machine without a query kernel still carries minimal [N,1,1]
        # read fields, so the checkpoint schema stays uniform
        self.reads_enabled = machine.query_spec is not None
        self.read_window = max(1, int(max_step_reads)) \
            if self.reads_enabled else 1
        if self.reads_enabled:
            qdtype, qshape = machine.query_spec
            self.query_width = int(np.prod(qshape)) if qshape else 1
            self.query_dtype = _dtype(qdtype)
            _rd, rshape = machine.query_reply_spec
            self.query_reply_width = int(np.prod(rshape)) if rshape else 1
        else:
            self.query_width = 1
            self.query_dtype = I32
            self.query_reply_width = 1
        self.lease_ttl = int(lease_ttl)
        self.read_timeout = int(read_timeout) if read_timeout \
            else 8 * self.lease_ttl
        # machine state broadcast over member slots: [N,...] -> [N,P,...];
        # clone, since an expanded view would alias one buffer P ways
        mac = tree_map(
            lambda x: x[:, None].expand(
                (n_lanes, n_members) + x.shape[1:]).clone(),
            machine.jit_init(n_lanes, self.device))
        self.state = _init_state(n_lanes, n_members, ring_capacity,
                                 self.payload_width, mac, self.device,
                                 self.payload_dtype, self.read_window,
                                 self.query_width, self.query_dtype)
        self._step_kwargs = dict(machine=machine,
                                 ring_capacity=ring_capacity,
                                 apply_window=self.apply_window,
                                 pipeline_window=pipeline_window,
                                 max_append_batch=max_append_batch,
                                 write_delay=write_delay,
                                 lease_ttl=self.lease_ttl,
                                 read_timeout=self.read_timeout)
        #: host-side dispatch bookkeeping (ENGINE_PIPELINE_FIELDS)
        self.pipeline_counters = {f: 0 for f in ENGINE_PIPELINE_FIELDS}
        #: host-side latency stamps of the dispatch path (PHASE_FIELDS)
        self.phases = PhaseStats()
        self._superstep_k_last = 0
        self._driver = None     # the attached DispatchAheadDriver
        self._telemetry = None  # the attached TelemetrySampler
        # the attached durability bridge (durable mode), or None
        self._dur = None  # ra-type: ra_tpu_torch.engine.durable.EngineDurability
        #: one captured graph of ``_superstep`` per (K, Kc, reads, durable)
        self._graphs = GraphCache() \
            if self.device.type == "cuda" else None
        dev = self.device
        self._zero_fail = torch.zeros((n_lanes, n_members), dtype=torch.bool,
                                      device=dev)
        self._zero_elect = torch.zeros((n_lanes,), dtype=torch.bool,
                                       device=dev)
        self._zero_nread = torch.zeros((n_lanes,), dtype=I32, device=dev)
        self._zero_confirm = self._zero_nread
        self._zero_readq = torch.zeros(
            (n_lanes, self.read_window, self.query_width),
            dtype=self.query_dtype, device=dev)
        self._fail_host = np.zeros((n_lanes, n_members), bool)

    def attach_durability(self, dur) -> None:
        """Switch the engine into durable mode: ``dur`` (an
        ``engine.durable.EngineDurability``) supplies the per-lane WAL
        confirm horizon before each dispatch and takes each step's
        compacted append outcome after it.  The engine adopts the
        bridge's latency phases, and graphs captured before are dropped:
        a durable dispatch has two more outputs."""
        self._dur = dur
        self.phases = dur.phases
        self._step_kwargs["durable"] = True
        if self._graphs is not None:
            self._graphs = GraphCache()

    # -- driving -----------------------------------------------------------

    def _dev(self, x, dtype: torch.dtype) -> Tensor:
        """Host data (numpy, lists) or a tensor, as ``dtype`` on the
        engine's device.  Host data goes to a card through a pinned copy
        with ``non_blocking=True``: a copy from pageable memory would make
        the host wait for all work already queued on the stream (the
        caching host allocator keeps the pinned block until its copy has
        run)."""
        t = torch.as_tensor(x, dtype=dtype)
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = torch.empty(t.shape, dtype=dtype, pin_memory=True).copy_(t)
        return t.to(self.device, non_blocking=True)

    def _host_mask(self, mask):
        """A HOST-side mask (election requests come from the host failure
        detector) on the device, and whether any lane is set, computed on
        the host (the durable engine drains its WAL after a dispatch that
        elected).  A CUDA tensor is refused: reading it here would be the
        device sync this helper exists to avoid."""
        arr = np.asarray(mask)  # ra02-ok: host data by contract; numpy refuses a CUDA tensor
        return self._dev(arr, torch.bool), bool(arr.any())

    def _fail_mask(self) -> Tensor:
        return (self._dev(self._fail_host, torch.bool)
                if self._fail_host.any() else self._zero_fail)

    def step(self, n_new, payloads, elect_mask=None, query_mask=None,
             n_read=None, read_q=None) -> dict:
        """Advance every lane one round.  n_new: int32[N]; payloads:
        [N, K, C] with K <= max_step_cmds.  Masks (bool[N]) are host data.
        ``n_read``/``read_q`` (int32[N], [N, Kr, Cq]) register
        consistent-read batches.  In durable mode the step waits out the
        WAL's backpressure window, gates its commits on the confirm
        horizon, and hands its compacted accepted rows to the WAL shards.
        Returns the step aux (device tensors)."""
        fail = self._fail_mask()
        elect, elect_any = (self._zero_elect, False) if elect_mask is None \
            else self._host_mask(elect_mask)
        query = self._zero_elect if query_mask is None \
            else self._dev(query_mask, torch.bool)
        nr = self._zero_nread if n_read is None else self._dev(n_read, I32)
        rq = self._zero_readq if read_q is None \
            else self._dev(read_q, self.query_dtype)
        self.pipeline_counters["dispatches"] += 1
        self.pipeline_counters["inner_steps"] += 1
        dur = self._dur
        confirm = self._confirm_horizon()
        with trace.span("engine.step", "engine", durable=dur is not None):
            self.state, aux = _step(self.state, self._dev(n_new, I32),
                                    self._dev(payloads, self.payload_dtype),
                                    fail, elect, confirm, query, nr, rq,
                                    **self._step_kwargs)
        if dur is not None:
            with trace.span("engine.wal_submit", "engine"):
                dur.submit(aux)
            if elect_any:
                # elections truncate and reuse indexes: drain now so the
                # next dispatch reads a horizon clamped at the new base
                dur.drain_all()
        if self._telemetry is not None:
            # after the dispatch, never blocking: the sampler only starts
            # device work and copies here
            self._telemetry.tick(1)
        return aux

    def superstep(self, n_new_blk, payloads_blk, elect_blk=None,
                  query_blk=None, n_read_blk=None,
                  read_q_blk=None) -> dict:
        """Advance every lane K rounds in one dispatch.  Inputs carry a
        leading inner-step axis: ``n_new_blk`` int32[K, N];
        ``payloads_blk`` [K, N, Kc, C]; optional elect/query schedules
        bool[K, N] (host data) for elections and queries inside the
        dispatch; ``n_read_blk``/``read_q_blk`` ([K, N], [K, N, Kr, Cq])
        a read schedule.  The fail mask, and in durable mode the WAL's
        confirm horizon, are sampled once per dispatch; a durable
        dispatch's K steps go to the WAL shards as K blocks.

        On a CUDA engine this is one replay of the CUDA graph captured
        for ``(K, Kc, reads, durable)`` (captured on first use; the
        commit-phase kernel runs K times inside it), on the CPU a loop of
        K steps.
        Returns the stacked per-inner-step aux (device tensors, a leading
        [K] axis on every leaf); ``committed_lanes`` [K, N] is the
        cumulative committed watermark after each inner step."""
        n_new = self._dev(n_new_blk, I32)
        payloads = self._dev(payloads_blk, self.payload_dtype)
        k, N = n_new.shape[0], self.n_lanes
        fail = self._fail_mask()
        elect, elect_any = (self._zero_elect.expand(k, N), False) \
            if elect_blk is None else self._host_mask(elect_blk)
        query = self._zero_elect.expand(k, N) if query_blk is None \
            else self._dev(query_blk, torch.bool)
        reads = n_read_blk is not None or read_q_blk is not None
        nr = self._dev(n_read_blk, I32) if n_read_blk is not None \
            else self._zero_nread.expand(k, N)
        rq = self._dev(read_q_blk, self.query_dtype) \
            if read_q_blk is not None \
            else self._zero_readq.expand((k,) + self._zero_readq.shape)
        self.pipeline_counters["dispatches"] += 1
        self.pipeline_counters["superstep_dispatches"] += 1
        self.pipeline_counters["inner_steps"] += k
        self._superstep_k_last = k
        dur = self._dur
        confirm = self._confirm_horizon()
        with trace.span("engine.superstep", "engine",
                        durable=dur is not None, k=k):
            if self._graphs is None:
                self.state, aux = _superstep(self.state, n_new, payloads,
                                             fail, elect, confirm, query,
                                             nr, rq, **self._step_kwargs)
            else:
                self.state, aux = self._graph_superstep(
                    n_new, payloads, fail, elect, confirm, query, nr, rq,
                    reads)
        if dur is not None:
            with trace.span("engine.wal_submit", "engine", k=k):
                dur.submit_block(aux, k)
            if elect_any:
                dur.drain_all()
        if self._telemetry is not None:
            self._telemetry.tick(k)
        return aux

    def _confirm_horizon(self) -> Tensor:
        """Durable mode: wait out the WAL's backpressure window, then the
        merged confirm horizon on the device, sampled once a dispatch
        (a pinned copy that does not block).  Volatile: zeros."""
        if self._dur is None:
            return self._zero_confirm
        with trace.span("engine.backpressure", "engine"):
            self._dur.backpressure()
        return self._dev(self._dur.confirm_upto, I32)

    def _graph_superstep(self, n_new, payloads, fail, elect, confirm, query,
                         nr, rq, reads: bool):
        """``_superstep`` as one replay of its captured CUDA graph.
        Without reads the zero read schedule is part of the graph, not an
        input copied in every dispatch.  Before a capture a durable engine
        drains its WAL shards: their workers copy rows off the device,
        and no other thread may touch the device while one captures."""
        durable = self._dur is not None
        args = (self.state, n_new, payloads, fail, elect, confirm, query)
        if reads:
            args += (nr, rq)
            fn = functools.partial(_superstep, **self._step_kwargs)
        else:
            fn = functools.partial(_superstep, n_read_blk=nr, read_q_blk=rq,
                                   **self._step_kwargs)
        k = n_new.shape[0]
        key = (k, payloads.shape[2], reads, durable)
        if durable and key not in self._graphs:
            self._dur.drain_all()
        g = self._graphs.get(
            key, fn, args, self.device,
            lambda: {"commit_phase": commit_phase.LAUNCHES,
                     "evaluate_quorum": pallas_quorum.LAUNCHES})
        if g.captured_launches["commit_phase"] != k:
            raise RuntimeError(
                f"the superstep graph captured "
                f"{g.captured_launches['commit_phase']} commit-phase "
                f"launches for {k} inner steps")
        return g(*args)

    def checkpoint(self) -> str:
        """Durable mode: quiesce the WAL, snapshot the full lane state and
        prune the WAL files the snapshot covers.  Returns its path."""
        if self._dur is None:
            raise RuntimeError("checkpoint() requires durable mode")
        return self._dur.checkpoint(self)

    def close(self) -> None:
        """Flush and close the durability bridge (no-op when volatile)."""
        if self._dur is not None:
            self._dur.close()

    def uniform_step(self, cmds_per_lane: int, payload_value=1) -> dict:
        """Every lane's leader receives the same number of commands this
        round (the bench shape)."""
        N, K, C = self.n_lanes, self.max_step_cmds, self.payload_width
        n_new = torch.full((N,), min(cmds_per_lane, K), dtype=I32,
                           device=self.device)
        payloads = torch.full((N, K, C), payload_value,
                              dtype=self.payload_dtype, device=self.device)
        return self.step(n_new, payloads)

    def uniform_superstep(self, k: int, cmds_per_lane: int,
                          payload_value=1) -> dict:
        """One dispatch of ``k`` rounds, every lane's leader receiving the
        same command count each round."""
        N, K, C = self.n_lanes, self.max_step_cmds, self.payload_width
        n_new = torch.full((k, N), min(cmds_per_lane, K), dtype=I32,
                           device=self.device)
        payloads = torch.full((k, N, K, C), payload_value,
                              dtype=self.payload_dtype, device=self.device)
        return self.superstep(n_new, payloads)

    def uniform_read_block(self, k: int, reads_per_lane: int,
                           query_value=0):
        """A ``(n_read_blk, read_q_blk)`` superstep read schedule (host
        numpy) registering one uniform batch of ``reads_per_lane``
        queries per lane at inner step 0 (a lane holds one pending batch
        at a time, so batches at later inner steps would only shed)."""
        N, Kr, Cq = self.n_lanes, self.read_window, self.query_width
        n_read = np.zeros((k, N), np.int32)
        n_read[0] = min(int(reads_per_lane), Kr)
        qdtype = np.dtype(self.machine.query_spec[0]) \
            if self.reads_enabled else np.int32
        read_q = np.full((k, N, Kr, Cq), query_value, qdtype)
        return n_read, read_q

    def _empty_step(self, **kw) -> dict:
        N, K, C = self.n_lanes, self.max_step_cmds, self.payload_width
        return self.step(torch.zeros((N,), dtype=I32, device=self.device),
                         torch.zeros((N, K, C), dtype=self.payload_dtype,
                                     device=self.device), **kw)

    # -- failure injection / elections ------------------------------------

    def fail_member(self, lane: int, slot: int) -> None:
        self._fail_host[lane, slot] = True

    def recover_member(self, lane: int, slot: int) -> None:
        """Re-activate a member by snapshot install from the lane leader
        (machine state and cursors copied from the leader's replica).
        Recovering the lane's CURRENT leader slot is refused: revive the
        others, ``trigger_election``, then recover the deposed slot."""
        if int(self.state.leader_slot[lane]) == slot:
            raise ValueError(
                f"slot {slot} is lane {lane}'s leader; recover the other "
                "members, trigger_election, then recover this slot")
        self._fail_host[lane, slot] = False
        self.state = self._snapshot_install(lane, slot)

    def recover_members(self, lanes, slots) -> None:
        """Vectorized :meth:`recover_member`: revive many (lane, slot)
        pairs in one masked snapshot install.  Same contract."""
        lanes = np.atleast_1d(np.asarray(lanes)).astype(np.int64)
        slots = np.atleast_1d(np.asarray(slots)).astype(np.int64)
        if not len(lanes):
            return
        leads = self.state.leader_slot.cpu().numpy()[lanes]
        if (leads == slots).any():
            bad = lanes[leads == slots]
            raise ValueError(
                f"lanes {bad[:8].tolist()}: slot is the lane's leader; "
                "recover the other members, trigger_election, then "
                "recover this slot")
        self._fail_host[lanes, slots] = False
        rv_host = np.zeros((self.n_lanes, self.n_members), bool)
        rv_host[lanes, slots] = True
        rv = self._dev(rv_host, torch.bool)
        st = self.state
        snap = _take(st.applied, st.leader_slot)[:, None]       # [N,1]

        def from_leader(x):
            lx = _take(x, st.leader_slot)[:, None]
            m = rv.reshape(rv.shape + (1,) * (x.dim() - 2))
            return torch.where(m, lx, x)

        self.state = st._replace(
            mac=tree_map(from_leader, st.mac),
            applied=torch.where(rv, snap, st.applied),
            commit=torch.where(rv, snap, st.commit),
            last_index=torch.where(rv, snap, st.last_index),
            last_written=torch.where(rv, snap, st.last_written),
            active=st.active | rv)

    @staticmethod
    def _set(x: Tensor, lane: int, slot: int, value) -> Tensor:
        """A copy of ``x`` with ``x[lane, slot] = value`` (state tensors
        are never edited in place: a step's aux may alias them)."""
        x = x.clone()
        x[lane, slot] = value
        return x

    def _snapshot_install(self, lane: int, slot: int) -> LaneState:
        """Seed a (re)joining member from the lane leader at the leader's
        APPLIED index, the state its copied machine state reflects."""
        st = self.state
        leader = int(st.leader_slot[lane])
        snap_idx = st.applied[lane, leader]
        return st._replace(
            mac=tree_map(lambda x: self._set(x, lane, slot, x[lane, leader]),
                         st.mac),
            applied=self._set(st.applied, lane, slot, snap_idx),
            commit=self._set(st.commit, lane, slot, snap_idx),
            last_index=self._set(st.last_index, lane, slot, snap_idx),
            last_written=self._set(st.last_written, lane, slot, snap_idx),
            active=self._set(st.active, lane, slot, True))

    # -- membership --------------------------------------------------------

    def add_member(self, lane: int, slot: int, voter: bool = False) -> None:
        """Bring a member slot into a lane's cluster, seeded from the
        leader's replica; it joins as a nonvoter unless ``voter``."""
        st = self._snapshot_install(lane, slot)
        self.state = st._replace(
            voter=self._set(st.voter, lane, slot, bool(voter)))
        self._fail_host[lane, slot] = False

    def promote_member(self, lane: int, slot: int) -> None:
        """Nonvoter -> voter once caught up."""
        self.state = self.state._replace(
            voter=self._set(self.state.voter, lane, slot, True))

    def remove_member(self, lane: int, slot: int) -> None:
        """Drop a member: it leaves the quorum denominator at once.
        Removing the lane's current leader is refused."""
        if int(self.state.leader_slot[lane]) == slot:
            raise ValueError(
                f"slot {slot} is lane {lane}'s leader; "
                "trigger_election first")
        st = self.state
        self.state = st._replace(
            active=self._set(st.active, lane, slot, False),
            voter=self._set(st.voter, lane, slot, False))

    def trigger_election(self, lanes) -> None:
        mask = np.zeros((self.n_lanes,), bool)
        mask[np.asarray(lanes)] = True
        self._empty_step(elect_mask=mask)

    # -- consistent (linearizable) reads -----------------------------------

    def consistent_read(self, lanes, fn=None, timeout_steps: int = 256):
        """Linearizable read of the lanes' leader machine state: register
        a query token, then drive empty rounds until a voter majority
        confirmed it and the leader applied its commit index as of
        registration.  Returns the state tree (numpy, leading lane axis),
        or ``fn(state)``.  Raises TimeoutError without a quorum."""
        lanes = np.atleast_1d(np.asarray(lanes))
        qm = np.zeros((self.n_lanes,), bool)
        qm[lanes] = True
        self._empty_step(query_mask=qm)
        st = self.state
        token = st.query_index.cpu().numpy()[lanes]
        lead = st.leader_slot.cpu().numpy()[lanes]
        commit_reg = st.commit.cpu().numpy()[lanes, lead]
        for _ in range(timeout_steps):
            st = self.state
            agreed = st.query_agreed.cpu().numpy()[lanes]
            lead = st.leader_slot.cpu().numpy()[lanes]
            applied = st.applied.cpu().numpy()[lanes, lead]
            if (agreed >= token).all() and (applied >= commit_reg).all():
                mac = tree_map(lambda x: x.cpu().numpy()[lanes, lead],
                               st.mac)
                return fn(mac) if fn is not None else mac
            self._empty_step()
        raise TimeoutError(
            "consistent_read: no heartbeat quorum within "
            f"{timeout_steps} rounds (leader lost its majority?)")

    def read_lanes(self, lanes, queries, timeout_steps: int = 256):
        """Consistent reads through the vectorized lease/read-index plane:
        one encoded query per lane (``queries`` [len(lanes), Cq]).
        Returns numpy ``(replies, watermark, ok)``; ``ok`` is False where
        the lane refused the read rather than serve it stale.  Raises
        TimeoutError if a batch neither serves nor refuses in time."""
        if not self.reads_enabled:
            raise ValueError("machine has no query kernel "
                             "(query_spec is None)")
        lanes = np.atleast_1d(np.asarray(lanes))
        n = len(lanes)
        q = np.asarray(queries).reshape(n, -1)
        nr = np.zeros((self.n_lanes,), np.int32)
        nr[lanes] = 1
        rq = np.zeros((self.n_lanes, self.read_window, self.query_width),
                      np.dtype(self.machine.query_spec[0]))
        rq[lanes, 0] = q
        replies = np.zeros((n, self.query_reply_width), np.int32)
        wm = np.full((n,), -1, np.int32)
        ok = np.zeros((n,), bool)
        settled = np.zeros((n,), bool)
        aux = self._empty_step(n_read=nr, read_q=rq)
        for _ in range(timeout_steps):
            done = aux["read_done"].cpu().numpy()[lanes] > 0
            # refused at arrival or by timeout: settles with ok=False
            stale = (aux["read_stale"].cpu().numpy()[lanes] > 0) | \
                (aux["read_shed"].cpu().numpy()[lanes] > 0)
            fresh = done & ~settled
            if fresh.any():
                rep = aux["read_replies"].cpu().numpy()[lanes[fresh], 0]
                replies[fresh] = rep.reshape(fresh.sum(), -1)
                wm[fresh] = aux["read_watermark"].cpu().numpy()[
                    lanes[fresh]]
                ok[fresh] = True
            settled |= done | stale
            if settled.all():
                return replies, wm, ok
            aux = self._empty_step()
        raise TimeoutError(
            f"read_lanes: {int((~settled).sum())} batches neither "
            f"served nor refused within {timeout_steps} rounds")

    # -- checkpoint / resume -------------------------------------------------

    def save(self, path: str) -> None:
        """Write the full lane state to one .npz (atomic replace), keys
        ``<field>:<leaf>`` as the reference engine writes them."""
        import os

        meta = {"n_lanes": self.n_lanes, "n_members": self.n_members,
                "ring_capacity": self.ring_capacity,
                "schema": list(LaneState._fields)}
        tmp = path + ".partial"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                repr(meta).encode(), dtype=np.uint8),
                **state_to_numpy(self.state))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def restore(self, path: str) -> None:
        """Load a schema-named .npz written by :meth:`save` (of either
        engine).  Geometry must match construction; fields the archive
        predates restore through ``CHECKPOINT_FIELD_DEFAULTS``."""
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        if not any(":" in k for k in arrays):
            raise ValueError("positional (pre-schema) checkpoints are not "
                             "supported by the torch engine")
        self.state = state_from_numpy(arrays, self.state, self.device,
                                      defaults=CHECKPOINT_FIELD_DEFAULTS)

    # -- readback ----------------------------------------------------------

    def committed_total(self) -> int:
        # per-lane counters are int32; the node-wide sum can exceed 2^31
        return int(self.state.total_committed.cpu().numpy()
                   .astype(np.int64).sum())

    def committed_per_lane(self) -> np.ndarray:
        return self.state.total_committed.cpu().numpy()

    def committed_lanes_async(self) -> Readback:
        """Per-lane cumulative committed counts with the host copy already
        in flight: poll ``.is_ready()``, then ``np.asarray`` it.  The next
        ``step`` can be dispatched at once."""
        h = Readback(self.state.total_committed)
        # the transfer ledger counts the copy when it starts
        devicewatch.record_d2h("lanes_async", h.nbytes)
        return h

    def machine_states(self) -> Any:
        return tree_map(lambda x: x.cpu().numpy(), self.state.mac)

    def block_until_ready(self) -> None:
        """Wait until the device has finished everything dispatched."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def overview(self, lane: int = 0) -> dict:
        s = self.state
        out = {
            "term": int(s.term[lane]),
            "leader_slot": int(s.leader_slot[lane]),
            "last_index": s.last_index[lane].tolist(),
            "last_written": s.last_written[lane].tolist(),
            "commit": s.commit[lane].tolist(),
            "applied": s.applied[lane].tolist(),
            "active": s.active[lane].tolist(),
            "total_committed": int(s.total_committed[lane]),
            "device": str(self.device),
        }
        # the dispatch pipeline: the last fused K, the attached driver's
        # stage-ahead depth and live in-flight count, and the counters
        drv = self._driver
        out["pipeline"] = {
            "superstep_k": self._superstep_k_last,
            "cmds_per_step": self.max_step_cmds,
            "dispatch_ahead": drv.max_in_flight if drv is not None else 0,
            "dispatches_in_flight": drv.in_flight() if drv is not None
            else 0,
            **self.pipeline_counters}
        if self.reads_enabled:
            def tot(x):
                return int(x.cpu().numpy().astype(np.int64).sum())

            served = tot(s.read_served)
            leased = tot(s.read_leased)
            out["reads"] = {
                "served_total": served,
                "shed_total": tot(s.read_shed),
                "stale_refusals": tot(s.read_stale),
                "leased_total": leased,
                "lease_coverage_pct": (100.0 * leased / served)
                if served else 0.0,
                "pending_lanes": int((s.read_n > 0).sum()),
                "lease_ttl": self.lease_ttl,
                "read_timeout": self.read_timeout,
                "read_window": self.read_window,
            }
        if self._dur is not None:
            # the durability plane: ENGINE_WAL_FIELDS and per-shard stats
            out["wal"] = self._dur.wal_overview()
        return out
