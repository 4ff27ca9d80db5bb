"""TtlKvMachine: a key space of ``n_keys`` cells a lane, each with a value,
an absolute expiry deadline and a watcher count.  Counterpart of
``ra_tpu/models/ttl_kv.py``; equal to it on every state leaf and reply.

Time is logical: the clock is the raft index of the last applied command,
``max(clock, meta["index"])`` per applied command.  A put with ``ttl > 0``
stamps ``exp = clock + ttl`` (0 = never expires); expiry is lazy, a cell
is absent once ``clock >= exp``.  Absence is ``val == -1``.

Command encoding (command_spec int32[4]): ``[op, key, value, ttl]``
  op 0 noop                 op 1 put(key, value, ttl)  reply [1, old]
  op 2 get(key)             reply [present, value]
  op 3 delete(key)          reply [present, old]
  op 4 watch(key)           reply [1, watchers]
A key outside [0, n_keys) (or a negative put value) degrades the command
to a no-op with reply [-2, -1].

Query encoding (query_spec int32[2]): ``[op, key]``
  op 0 size()  reply [n_live, clock];  op 1 get(key)  reply [present,
  value];  op 2 watchers(key)  reply [1, count]

Every put stamps its own index, so no window collapses: the batch apply is
always the in-order fold, on a card the ``ops/csrc/slot_fold.cu`` kernel.
"""
from __future__ import annotations

import torch

from ..core.machine import JitMachine, encode_i32
from ..ops.exact import add32
from ..ops.slot_fold import slot_fold_dispatch

I32 = torch.int32


class TtlKvMachine(JitMachine):
    command_spec = ("int32", (4,))
    reply_spec = ("int32", (2,))
    query_spec = ("int32", (2,))
    query_reply_spec = ("int32", (2,))
    version = 0
    #: the batch apply is the in-order fold
    supports_batch_apply = True
    slot_fold_kind = "ttl_kv"

    def __init__(self, n_keys: int = 64) -> None:
        self.n_keys = n_keys

    def jit_init(self, n_lanes: int, device: torch.device):
        N, S = n_lanes, self.n_keys
        return {
            "vals": torch.full((N, S), -1, dtype=I32, device=device),
            "exp": torch.zeros((N, S), dtype=I32, device=device),
            "watch": torch.zeros((N, S), dtype=I32, device=device),
            "clock": torch.zeros((N,), dtype=I32, device=device),
        }

    @staticmethod
    def _live(vals, exp, clock):
        # lazy expiry: a cell is live while unexpired (exp 0 = forever)
        return (vals >= 0) & ((exp == 0) | (exp > clock[..., None]))

    def jit_apply(self, meta, command, state):
        S = self.n_keys
        op = command[..., 0]
        raw_key = command[..., 1]
        value = command[..., 2]
        ttl = command[..., 3]
        key_ok = (raw_key >= 0) & (raw_key < S)
        key = torch.clamp(raw_key, 0, S - 1)[..., None].long()

        index = torch.as_tensor(meta["index"], device=op.device).to(I32)
        clock = torch.maximum(state["clock"], index)
        vals, exp, watch = state["vals"], state["exp"], state["watch"]
        live = self._live(vals, exp, clock)

        cur_live = torch.gather(live, -1, key)[..., 0]
        cur = torch.where(cur_live, torch.gather(vals, -1, key)[..., 0], -1)
        present = cur_live.to(I32)
        n_watch = torch.gather(watch, -1, key)[..., 0]

        val_bad = (op == 1) & (value < 0)
        put = (op == 1) & key_ok & ~val_bad
        dele = (op == 3) & key_ok
        wreg = (op == 4) & key_ok

        new_exp = torch.where(ttl > 0, add32(clock, ttl), 0)
        onehot = torch.arange(S, device=op.device) == key
        vals = torch.where(onehot & put[..., None], value[..., None],
                           torch.where(onehot & dele[..., None], -1, vals))
        exp = torch.where(onehot & put[..., None], new_exp[..., None], exp)
        watch = add32(watch, (onehot & wreg[..., None]).to(I32))

        code = torch.where(put | wreg, 1,
                           torch.where((op == 2) | dele, present, 0))
        val_out = torch.where(wreg, add32(n_watch, 1), cur)
        bad = ((op > 0) & ~key_ok) | val_bad
        code = torch.where(bad, -2, code)
        reply = torch.stack([code, torch.where(bad, -1, val_out)], dim=-1)
        return {"vals": vals, "exp": exp, "watch": watch,
                "clock": clock}, reply

    def jit_apply_batch(self, meta, commands, mask, state):
        return self.in_order_fold(meta, commands, mask, state)

    def in_order_fold(self, meta, commands, mask, state):
        return slot_fold_dispatch(self, meta, commands, mask, state)

    # -- vectorized read path ----------------------------------------------

    def jit_query(self, queries, state):
        # queries: [..., Kr, 2]; vals/exp/watch [..., S], clock [...]
        S = self.n_keys
        op = queries[..., 0]
        raw_key = queries[..., 1]
        key_ok = (raw_key >= 0) & (raw_key < S)
        key = torch.clamp(raw_key, 0, S - 1).long()
        live = self._live(state["vals"], state["exp"], state["clock"])
        val = torch.gather(state["vals"], -1, key)
        is_live = torch.gather(live, -1, key)
        n_w = torch.gather(state["watch"], -1, key)
        present = key_ok & is_live
        n_live = live.sum(dim=-1, dtype=I32)[..., None]
        code = torch.where(op == 0, n_live,
                           torch.where(op == 2, key_ok.to(I32),
                                       present.to(I32)))
        value = torch.where(op == 0, state["clock"][..., None],
                            torch.where(op == 2,
                                        torch.where(key_ok, n_w, -1),
                                        torch.where(present, val, -1)))
        return torch.stack([code, value], dim=-1)

    # -- host protocol -----------------------------------------------------

    def encode_command(self, command):
        try:
            if isinstance(command, tuple) and command:
                kind = command[0]
                if kind == "put" and len(command) in (3, 4):
                    ttl = int(command[3]) if len(command) == 4 else 0
                    return encode_i32([1, int(command[1]), int(command[2]),
                                       ttl])
                if kind in ("get", "delete", "watch") and len(command) == 2:
                    op = {"get": 2, "delete": 3, "watch": 4}[kind]
                    return encode_i32([op, int(command[1]), 0, 0])
        except (TypeError, ValueError, OverflowError):
            pass
        return torch.zeros((4,), dtype=I32)

    def decode_reply(self, reply):
        code, val = int(reply[..., 0]), int(reply[..., 1])
        return (code, None if val < 0 else val)

    def encode_query(self, query):
        try:
            if isinstance(query, tuple) and query:
                kind = query[0]
                if kind in ("get", "watchers") and len(query) == 2:
                    return encode_i32([1 if kind == "get" else 2,
                                       int(query[1])])
        except (TypeError, ValueError, OverflowError):
            pass
        return torch.zeros((2,), dtype=I32)  # size()

    def decode_query_reply(self, reply):
        code, val = int(reply[..., 0]), int(reply[..., 1])
        return (code, None if val < 0 else val)


def query_live(state) -> dict:
    """Query fun: live (unexpired) keys as a plain dict (host path)."""
    clock = int(state["clock"])
    return {k: v for k, (v, e) in enumerate(zip(state["vals"].tolist(),
                                                state["exp"].tolist()))
            if v >= 0 and (e == 0 or e > clock)}
