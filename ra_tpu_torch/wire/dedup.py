"""Machine-level dedup: the exactly-once-observable half of the wire
contract.  Counterpart of ``ra_tpu/wire/dedup.py``; equal to it on every
state leaf and reply.

The ingress gate is at-most-once: a placed but unacked command can be
lost to a Raft-legal truncation, so an at-least-once client re-enqueues
unacked payloads under fresh seqnos after an epoch bump, and that
re-enqueue may duplicate a command whose first copy did commit.  Ra
splits the problem the same way: ``ra.erl pipeline_command`` resends
freely and the fifo machine dedups per-enqueuer seqnos machine-side.
:class:`DedupCounterMachine` is that machine-side half for the wire
plane's counter workload: every command carries a ``(slot, op_id)``
client identity and the machine applies each op at most once.

Command encoding (``command_spec`` int32[3]): ``[slot, op_id, delta]``

* ``slot`` -- the session's per-lane rank (assigned at connect; unique
  within a lane, < ``slots``).  An out-of-range slot is a no-op.
* ``op_id`` -- the client's monotone per-session operation id, starting
  at 1 (0 is the noop padding of empty command slots).
* ``delta`` -- the increment.

State per lane: ``{"value": int32, "seq": int32[slots]}``, ``seq[slot]``
the highest op applied for that client.  The batch fold is vectorised
and order-equivalent to the sequential masked apply: a row applies iff
its op exceeds both the slot's watermark at window entry and the op of
every earlier same-slot row of the window (a running-watermark prefix
max over an [A, A] block).  It stays torch ops on every device: the
reference computes it in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ..core.machine import JitMachine, encode_i32
from ..ops.exact import add32, sum32

I32 = torch.int32


def _scatter_max(seq, slot, val):
    """Per-row scatter-max into the slot axis (``seq`` [..., s], ``slot``
    and ``val`` [..., k]): duplicate slots resolve by max, and every slot
    named takes ``max(seq[slot], val)``, as the reference's
    ``.at[i].max``."""
    return seq.scatter_reduce(-1, slot.long(), val, "amax",
                              include_self=True)


class DedupCounterMachine(JitMachine):
    command_spec = ("int32", (3,))
    reply_spec = ("int32", ())
    version = 0
    supports_batch_apply = True

    def __init__(self, slots: int = 64) -> None:
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = int(slots)

    def jit_init(self, n_lanes: int, device: torch.device):
        return {"value": torch.zeros((n_lanes,), dtype=I32, device=device),
                "seq": torch.zeros((n_lanes, self.slots), dtype=I32,
                                   device=device)}

    def jit_apply(self, meta, command, state):
        s = self.slots
        raw = command[..., 0]
        ok = (raw >= 0) & (raw < s)
        slot = torch.clamp(raw, 0, s - 1)
        op = command[..., 1]
        delta = command[..., 2]
        cur = torch.gather(state["seq"], -1, slot[..., None].long())[..., 0]
        fresh = ok & (op > cur)
        value = add32(state["value"], torch.where(fresh, delta, 0))
        seq = _scatter_max(state["seq"], slot[..., None],
                           torch.where(fresh, op, 0)[..., None])
        return {"value": value, "seq": seq}, value

    def jit_apply_batch(self, meta, commands, mask, state):
        # commands [..., A, 3], mask bool [..., A]: exact sequential
        # equivalence through the running-watermark prefix max
        s = self.slots
        raw = commands[..., 0]
        ok = mask & (raw >= 0) & (raw < s)
        slot = torch.clamp(raw, 0, s - 1)
        op = commands[..., 1]
        delta = commands[..., 2]
        cur = torch.gather(state["seq"], -1, slot.long())
        a = op.shape[-1]
        same_slot = slot[..., :, None] == slot[..., None, :]
        earlier = torch.tril(torch.ones((a, a), dtype=torch.bool,
                                        device=op.device), diagonal=-1)
        prior_op = torch.where(same_slot & earlier & ok[..., None, :],
                               op[..., None, :], 0).amax(dim=-1)
        fresh = ok & (op > torch.maximum(cur, prior_op))
        value = add32(state["value"], sum32(torch.where(fresh, delta, 0)))
        seq = _scatter_max(state["seq"], slot, torch.where(fresh, op, 0))
        return {"value": value, "seq": seq}

    def encode_command(self, command):
        slot, op, delta = command
        return encode_i32([int(slot), int(op), int(delta)])

    def decode_reply(self, reply):
        return int(reply)
