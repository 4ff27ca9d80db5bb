"""JitKvMachine: the replicated KV store on the device apply path, a fixed
key space of ``n_keys`` int32 cells a lane.  Counterpart of
``ra_tpu/models/jit_kv.py``; equal to it on every state leaf and reply.

Absence is -1, so stored values are >= 0.  Command encoding
(command_spec int32[4]): ``[op, key, value, expected]``

  op 0 noop
  op 1 put(key, value)            reply [1, old]         (old -1 if absent)
  op 2 get(key)                   reply [present, value]
  op 3 delete(key)                reply [present, old]
  op 4 cas(key, expected, value)  reply [ok, current]    (expected/value -1
                                   mean absent: expect-missing / delete-on-
                                   success)

A key outside [0, n_keys), a negative put value or a cas value below -1
makes the command a no-op with reply [-2, -1] (never aliased onto a
boundary cell).  On the CPU, as in the reference, a cas-free window folds
in one vectorised pass, last writer wins (:meth:`_batch_fast`), and a
window holding a cas takes the in-order fold.  On a card every window
takes the in-order fold, the ``ops/csrc/slot_fold.cu`` kernel.
"""
from __future__ import annotations

import torch

from ..core.machine import JitMachine, encode_i32
from ..ops.slot_fold import slot_fold_dispatch

I32 = torch.int32


class JitKvMachine(JitMachine):
    command_spec = ("int32", (4,))
    reply_spec = ("int32", (2,))
    version = 0
    supports_batch_apply = True
    slot_fold_kind = "kv"

    def __init__(self, n_keys: int = 64) -> None:
        self.n_keys = n_keys

    def jit_init(self, n_lanes: int, device: torch.device):
        return torch.full((n_lanes, self.n_keys), -1, dtype=I32,
                          device=device)

    def jit_apply(self, meta, command, state):
        S = self.n_keys
        op = command[..., 0]
        raw_key = command[..., 1]
        key_ok = (raw_key >= 0) & (raw_key < S)
        key = torch.clamp(raw_key, 0, S - 1)
        value = command[..., 2]
        expected = command[..., 3]
        cur = torch.gather(state, -1, key[..., None].long())[..., 0]
        present = (cur >= 0).to(I32)
        val_bad = ((op == 1) & (value < 0)) | ((op == 4) & (value < -1))
        put = (op == 1) & key_ok & ~val_bad
        dele = (op == 3) & key_ok
        cas_ok = (op == 4) & key_ok & ~val_bad & (cur == expected)
        new_val = torch.where(put, value,
                              torch.where(dele, -1,
                                          torch.where(cas_ok, value, cur)))
        write = put | dele | cas_ok
        onehot = torch.arange(S, device=state.device) == key[..., None]
        new_state = torch.where(onehot & write[..., None],
                                new_val[..., None], state)
        code = torch.where(put, 1,
                           torch.where(op == 4, cas_ok.to(I32),
                                       torch.where((op == 2) | dele, present,
                                                   0)))
        bad = ((op > 0) & ~key_ok) | val_bad
        code = torch.where(bad, -2, code)
        reply = torch.stack([code, torch.where(bad, -1, cur)], dim=-1)
        return new_state, reply

    def jit_apply_batch(self, meta, commands, mask, state):
        return self.window_fold_dispatch(meta, commands, mask, state)

    def _fast_ok(self, commands, mask):
        return ~torch.any(mask & (commands[..., 0] >= 4))   # no cas

    def in_order_fold(self, meta, commands, mask, state):
        return slot_fold_dispatch(self, meta, commands, mask, state)

    def _batch_fast(self, commands, mask, state):
        """The cas-free window: each key ends at its last write (a put's
        value, -1 for a delete).  The reference finds the last write by a
        max over an [..., S, A] one-hot and places it by matmul; here the
        window positions of the writes reduce into their keys with
        ``scatter_reduce(amax)`` and the winner's value is gathered, which
        is the same selection in O(A) memory a row, not O(S*A)."""
        S = self.n_keys
        A = commands.shape[-2]
        op = torch.where(mask, commands[..., 0], 0)            # [..., A]
        raw_key = commands[..., 1]
        value = commands[..., 2]
        key_ok = (raw_key >= 0) & (raw_key < S)
        is_write = ((op == 1) | (op == 3)) & key_ok & \
            ~((op == 1) & (value < 0))
        wval = torch.where(op == 1, value, -1)                 # delete = -1
        pos = torch.arange(A, dtype=I32, device=state.device)
        # writes land on their key, the rest on a spare column S
        dest = torch.where(is_write, raw_key, S).long()
        maxpos = torch.full(state.shape[:-1] + (S + 1,), -1, dtype=I32,
                            device=state.device).scatter_reduce(
            -1, dest, torch.where(is_write, pos, -1), "amax")[..., :S]
        placed = torch.gather(wval, -1, maxpos.clamp(min=0).long())
        return torch.where(maxpos >= 0, placed, state)

    def encode_command(self, command):
        def _v(x):
            return -1 if x is None else int(x)
        try:
            if isinstance(command, tuple) and command:
                kind = command[0]
                if kind == "put" and len(command) == 3:
                    return encode_i32([1, int(command[1]), _v(command[2]),
                                       0])
                if kind == "get" and len(command) == 2:
                    return encode_i32([2, int(command[1]), 0, 0])
                if kind == "delete" and len(command) == 2:
                    return encode_i32([3, int(command[1]), 0, 0])
                if kind == "cas" and len(command) == 4:
                    # host order: ("cas", key, expected, new)
                    return encode_i32([4, int(command[1]), _v(command[3]),
                                       _v(command[2])])
        except (TypeError, ValueError, OverflowError):
            pass
        return torch.zeros((4,), dtype=I32)

    def decode_reply(self, reply):
        code, val = int(reply[..., 0]), int(reply[..., 1])
        return (code, None if val < 0 else val)

    # -- vectorized read path ----------------------------------------------
    # Query encoding (query_spec int32[2]): ``[op, key]``
    #   op 0 size()    reply [n_present, 0]
    #   op 1 get(key)  reply [present, value]   (absent/bad key -> [0,-1])

    query_spec = ("int32", (2,))
    query_reply_spec = ("int32", (2,))

    def jit_query(self, queries, state):
        # queries: [..., Kr, 2]; state: [..., S]; reads never mutate state
        S = self.n_keys
        op = queries[..., 0]
        raw_key = queries[..., 1]
        key_ok = (raw_key >= 0) & (raw_key < S)
        key = torch.clamp(raw_key, 0, S - 1)
        val = torch.gather(state, -1, key.long())                # [..., Kr]
        present = key_ok & (val >= 0)
        size = (state >= 0).sum(dim=-1, dtype=I32)[..., None]    # [..., 1]
        code = torch.where(op == 0, size, present.to(I32))
        value = torch.where(op == 0, 0, torch.where(present, val, -1))
        return torch.stack([code, value], dim=-1)

    def encode_query(self, query):
        if isinstance(query, tuple) and query and query[0] == "get":
            return encode_i32([1, int(query[1])])
        return torch.zeros((2,), dtype=I32)  # size()

    def decode_query_reply(self, reply):
        code, val = int(reply[..., 0]), int(reply[..., 1])
        return (code, None if val < 0 else val)


def query_kv(state) -> dict:
    """Query fun: present keys as a plain dict (host path)."""
    return {k: v for k, v in enumerate(state.tolist()) if v >= 0}
