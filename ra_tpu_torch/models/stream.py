"""StreamMachine: an offset-addressed log with consumer cursors, the
RabbitMQ-streams shape.  Counterpart of ``ra_tpu/models/stream.py``;
equal to it on every state leaf, reply and query reply.

An append-only log addressed by absolute offset, a retention window (the
newest ``capacity`` entries survive; older offsets fall off the tail),
and named consumer groups whose committed cursors only move forward.

State per lane: ``buf int32[capacity]`` ring (slot = offset mod
capacity), ``tail`` (next offset to write), ``base`` (oldest retained
offset: ``base <= offset < tail`` is readable), ``cursors int32[groups]``.

Command encoding (command_spec int32[3]): ``[op, a, b]``

  op 0 noop                   (term-opening entry)
  op 1 append(value)          reply [1, offset]        (value >= 0)
  op 2 commit_cursor(g, off)  reply [1, cursor]   (max-merge, clamped
                               to the tail: a cursor never outruns the log)
  op 3 truncate(upto)         reply [1, base]     (advance retention)

Reply is int32[2].  A bad group or a negative value degrades to a no-op
with reply [-2, -1].

Query encoding (query_spec int32[2]): ``[op, a]``

  op 0 bounds()        reply [tail, base]
  op 1 read(offset)    reply [1, value] if base <= offset < tail
                              else [0, -1]
  op 2 cursor(g)       reply [1, cursor]         (bad g -> [0, -1])

On the CPU, as in the reference, a window of only noops and appends (the
firehose) folds in one vectorised pass (:meth:`_batch_fast`), and a
window holding a cursor commit or a truncate takes the in-order fold, the
stream decoder of ``ops/csrc/slot_fold.cu`` on a card.  On a card a ring
whose capacity is a power of two takes the decoder for every window: the
two folds agree there.  Any other capacity keeps the reference's choice
on the card too, since at the int32 edge the in-order fold writes one
slot twice where ``tail`` wraps (``floor_mod(2^31 - 1, 5)`` and
``floor_mod(-2^31, 5)`` are both 2) and the fast fold does not.
"""
from __future__ import annotations

import torch

from ..core.machine import JitMachine, encode_i32
from ..ops.exact import add32
from ..ops.slot_fold import slot_fold_dispatch

I32 = torch.int32


def _mod(x, q: int):
    return torch.remainder(x, q)          # floor mod, as jnp.mod


def _clip(x, lo: int, hi):
    """``jnp.clip(x, lo, hi)`` for a tensor ``hi``: ``min(max(x, lo),
    hi)``, so ``hi`` wins where ``hi < lo``."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


class StreamMachine(JitMachine):
    command_spec = ("int32", (3,))
    reply_spec = ("int32", (2,))
    query_spec = ("int32", (2,))
    query_reply_spec = ("int32", (2,))
    version = 0
    #: append order is offset order: the batch fold folds the window in
    #: order (the fast fold only where the window holds no op 2 or 3)
    supports_batch_apply = True
    slot_fold_kind = "stream"

    def __init__(self, capacity: int = 64, groups: int = 4) -> None:
        self.capacity = capacity
        #: a capacity that is no power of two: the card selects between
        #: the two folds as the CPU does
        self.fast_fold_on_card = bool(capacity & (capacity - 1))
        self.groups = groups

    def jit_init(self, n_lanes: int, device: torch.device):
        N, Q, G = n_lanes, self.capacity, self.groups

        def z(*s):
            return torch.zeros(s, dtype=I32, device=device)

        return {"buf": z(N, Q), "tail": z(N), "base": z(N),
                "cursors": z(N, G)}

    def jit_apply(self, meta, command, state):
        Q, G = self.capacity, self.groups
        dev = command.device
        op = command[..., 0]
        a = command[..., 1]
        b = command[..., 2]
        buf, tail, base = state["buf"], state["tail"], state["base"]
        cursors = state["cursors"]

        app = (op == 1) & (a >= 0)
        slot = _mod(tail, Q)
        hot = (torch.arange(Q, device=dev) == slot[..., None]) & \
            app[..., None]
        buf = torch.where(hot, a[..., None], buf)
        new_tail = add32(tail, app.to(I32))

        g_ok = (a >= 0) & (a < G)
        commit = (op == 2) & g_ok
        g = torch.clamp(a, 0, G - 1)
        cur = torch.gather(cursors, -1, g[..., None].long())[..., 0]
        # max-merge clamped to the tail: replayed or duplicate commits are
        # no-ops and a cursor never points past the log end
        new_cur = _clip(torch.maximum(cur, b), 0, new_tail)
        chot = (torch.arange(G, device=dev) == g[..., None]) & \
            commit[..., None]
        cursors = torch.where(chot, new_cur[..., None], cursors)

        trunc = op == 3
        new_base = torch.where(trunc,
                               _clip(torch.maximum(base, a), 0, new_tail),
                               base)
        # retention: an append that laps the ring evicts the oldest offset
        new_base = torch.maximum(new_base, add32(new_tail, -Q))

        reply_v = torch.where(op == 1, tail,
                              torch.where(commit, new_cur,
                                          torch.where(trunc, new_base, 0)))
        ok = (op == 0) | app | commit | trunc
        code = torch.where(ok, torch.where(op == 0, 0, 1), -2).to(I32)
        reply = torch.stack([code, torch.where(ok, reply_v, -1)], dim=-1)
        new_state = {"buf": buf, "tail": new_tail, "base": new_base,
                     "cursors": cursors}
        return new_state, reply

    # -- one-shot window fold (engine batch path) --------------------------

    def jit_apply_batch(self, meta, commands, mask, state):
        return self.window_fold_dispatch(meta, commands, mask, state)

    def _fast_ok(self, commands, mask):
        # fast only for noop/append windows (the firehose steady state);
        # cursor commits and truncates read evolving state in order
        return ~torch.any(mask & (commands[..., 0] >= 2))

    def in_order_fold(self, meta, commands, mask, state):
        return slot_fold_dispatch(self, meta, commands, mask, state)

    def _batch_fast(self, commands, mask, state):
        """The append-only window in one pass.  Written slots are offsets
        ``tail .. tail + n_app - 1``; a window wider than the ring aliases
        slots and only the last append to a slot survives.  The reference
        places each slot's value with a [..., Q, A] one-hot matmul; here
        the append of the slot's rank is found by ``searchsorted`` on the
        running append count and gathered, the same selection in
        O(Q + A) a row."""
        Q = self.capacity
        dev = commands.device
        op = torch.where(mask, commands[..., 0], 0)            # [..., A]
        val = commands[..., 1]
        app = (op == 1) & (val >= 0)
        csum = torch.cumsum(app.to(I32), dim=-1, dtype=I32)   # inclusive
        n_app = csum[..., -1]
        tail = state["tail"]

        qr = torch.arange(Q, device=dev, dtype=I32)
        jd = _mod(add32(qr, -tail[..., None].long()), Q)       # [..., Q]
        written = jd < n_app[..., None]
        rank_win = jd + Q * torch.div(n_app[..., None] - 1 - jd, Q,
                                      rounding_mode="floor")
        # the append of exclusive rank r is the first command whose
        # running append count reaches r + 1
        src = torch.searchsorted(csum, (rank_win + 1).to(I32))
        placed = torch.gather(val, -1, src.clamp(max=op.shape[-1] - 1))

        new_tail = add32(tail, n_app)
        new_state = dict(state)
        new_state["buf"] = torch.where(written, placed, state["buf"])
        new_state["tail"] = new_tail
        new_state["base"] = torch.maximum(state["base"],
                                          add32(new_tail, -Q))
        return new_state

    # -- vectorized read path ----------------------------------------------

    def jit_query(self, queries, state):
        # queries [..., Kr, 2]; state buf [..., Q], tail/base [...],
        # cursors [..., G]: gathers only, the state is never changed
        Q, G = self.capacity, self.groups
        op = queries[..., 0]
        a = queries[..., 1]
        tail = state["tail"][..., None]                        # [..., 1]
        base = state["base"][..., None]

        off_ok = (a >= base) & (a < tail)
        slot = _mod(torch.clamp(a, min=0), Q)
        val = torch.gather(state["buf"], -1, slot.long())      # [..., Kr]
        g_ok = (a >= 0) & (a < G)
        g = torch.clamp(a, 0, G - 1)
        cur = torch.gather(state["cursors"], -1, g.long())

        code = torch.where(op == 0, tail,
                           torch.where(op == 1, off_ok.to(I32),
                                       g_ok.to(I32)))
        value = torch.where(op == 0, base,
                            torch.where(op == 1,
                                        torch.where(off_ok, val, -1),
                                        torch.where(g_ok, cur, -1)))
        return torch.stack([code, value], dim=-1)

    # -- host protocol -----------------------------------------------------

    def encode_command(self, command):
        try:
            if isinstance(command, tuple) and command:
                kind = command[0]
                if kind == "append" and len(command) == 2:
                    return encode_i32([1, int(command[1]), 0])
                if kind == "commit" and len(command) == 3:
                    return encode_i32([2, int(command[1]),
                                       int(command[2])])
                if kind == "truncate" and len(command) == 2:
                    return encode_i32([3, int(command[1]), 0])
        except (TypeError, ValueError, OverflowError):
            pass
        return torch.zeros((3,), dtype=I32)

    def decode_reply(self, reply):
        code, val = int(reply[..., 0]), int(reply[..., 1])
        return (code, None if val < 0 else val)

    def encode_query(self, query):
        try:
            if isinstance(query, tuple) and query:
                kind = query[0]
                if kind == "read" and len(query) == 2:
                    return encode_i32([1, int(query[1])])
                if kind == "cursor" and len(query) == 2:
                    return encode_i32([2, int(query[1])])
        except (TypeError, ValueError, OverflowError):
            pass
        return torch.zeros((2,), dtype=I32)  # bounds()

    def decode_query_reply(self, reply):
        code, val = int(reply[..., 0]), int(reply[..., 1])
        return (code, None if val < 0 else val)


def query_bounds(state) -> tuple:
    """(base, tail): the readable-offset window (a host-path query)."""
    return (int(state["base"]), int(state["tail"]))

