"""Batched quorum/commit arithmetic as plain torch ops.

The counterpart of ``ra_tpu/ops/quorum.py``: the per-cluster Raft
arithmetic lifted over a leading *lane* axis (one lane = one Raft
cluster).  Every function is shape-stable, branch-free and keeps the
reference's dtypes (int32 indexes, bool masks), so the engine's state
stays bit-identical to the JAX engine's.

* :func:`agreed_commit` — the voter-masked sorted-median quorum index.
* :func:`evaluate_quorum` — commit advancement with the §5.4.2 term gate
  (``agreed >= term_start``) and the rule that commit never moves back.
  It is the plain version of the hand-written CUDA kernel in
  ``ops/csrc/quorum.cu``: the CPU path and the kernel's checks use it.
* :func:`election_quorum` — vote counting.
* :func:`update_match_next` — the AER-reply success fold.
* :func:`query_quorum` — the consistent-query heartbeat quorum.
* :func:`pipeline_credit` — per-peer flow control.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def agreed_commit(match_index: Tensor, voter_mask: Tensor) -> Tensor:
    """Quorum-agreed index per lane: element ``n//2`` (0-based) of the
    descending sort of the voters' match indexes, ``n`` the voter count.

    match_index: int32[..., P]; voter_mask: bool[..., P].  Returns
    int32[...]; lanes with no voter give 0."""
    # -1 is a sentinel below any valid index (indexes are >= 0)
    masked = torch.where(voter_mask, match_index, -1)
    sorted_desc = torch.sort(masked, dim=-1, descending=True).values
    k = voter_mask.sum(dim=-1, dtype=torch.int32) // 2
    agreed = torch.gather(sorted_desc, -1, k[..., None].long())[..., 0]
    return torch.clamp(agreed, min=0)


def evaluate_quorum(commit_index: Tensor, match_index: Tensor,
                    voter_mask: Tensor, term_start_index: Tensor) -> Tensor:
    """Advance ``commit_index`` per lane iff a higher index is
    quorum-agreed AND lies in the leader's current term.

    commit_index: int32[...]; match_index: int32[..., P];
    voter_mask: bool[..., P]; term_start_index: int32[...]."""
    agreed = agreed_commit(match_index, voter_mask)
    ok = (agreed > commit_index) & (agreed >= term_start_index)
    return torch.where(ok, agreed, commit_index)


def update_match_next(match_index: Tensor, next_index: Tensor,
                      reply_success: Tensor, reply_last_index: Tensor,
                      reply_next_index: Tensor) -> tuple:
    """Fold a batch of successful AER replies into peer state.  All args
    broadcast over [..., P]; ``reply_success`` masks the slots that
    replied this step."""
    new_match = torch.where(reply_success,
                            torch.maximum(match_index, reply_last_index),
                            match_index)
    new_next = torch.where(reply_success,
                           torch.maximum(next_index, reply_next_index),
                           next_index)
    return new_match, new_next


def election_quorum(granted_mask: Tensor, voter_mask: Tensor) -> Tensor:
    """True per lane iff granted votes reach trunc(voters/2)+1.
    ``granted_mask`` must include the candidate's self-vote."""
    votes = (granted_mask & voter_mask).sum(dim=-1, dtype=torch.int32)
    needed = voter_mask.sum(dim=-1, dtype=torch.int32) // 2 + 1
    return votes >= needed


def query_quorum(peer_query_index: Tensor, voter_mask: Tensor) -> Tensor:
    """Majority-confirmed consistent-query index per lane: the same
    masked median as the commit index."""
    return agreed_commit(peer_query_index, voter_mask)


def pipeline_credit(next_index: Tensor, match_index: Tensor,
                    last_index: Tensor, commit_index: Tensor,
                    commit_index_sent: Tensor,
                    max_pipeline: int, max_batch: int) -> tuple:
    """How many entries to ship to each peer this step, bounded by the
    in-flight window and the batch size.  Returns
    ``(n_to_send[..., P], needs_rpc[..., P])``."""
    in_flight = next_index - match_index - 1
    headroom = torch.clamp(max_pipeline - in_flight, min=0)
    avail = torch.clamp(last_index[..., None] - next_index + 1, min=0)
    n = torch.clamp(torch.minimum(avail, headroom), max=max_batch)
    needs = (n > 0) | (commit_index_sent < commit_index[..., None])
    return n, needs
