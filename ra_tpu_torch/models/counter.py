"""Counter machine: state is one int32 per lane-member, a command is one
int32 increment, the reply is the new value.  Payload 0 encodes a noop
(the term-opening entry).  Counterpart of ``ra_tpu/models/counter.py``.
"""
from __future__ import annotations

import torch

from ..core.machine import JitMachine


class CounterMachine(JitMachine):
    command_spec = ("int32", (1,))
    reply_spec = ("int32", ())
    version = 0

    def jit_init(self, n_lanes: int, device: torch.device):
        return torch.zeros((n_lanes,), dtype=torch.int32, device=device)

    supports_batch_apply = True

    def jit_apply(self, meta, command, state):
        # command: [..., 1] int32; state: [...] int32
        new_state = state + command[..., 0]
        return new_state, new_state

    def jit_apply_batch(self, meta, commands, mask, state):
        # commands: [..., A, 1]; mask: [..., A] — addition commutes, so a
        # whole committed window folds in one masked sum (int32, wrapping
        # as the reference does)
        inc = torch.where(mask, commands[..., 0], 0).sum(dim=-1,
                                                        dtype=torch.int32)
        return state + inc

    def encode_command(self, command):
        return torch.tensor([int(command)], dtype=torch.int32)

    def decode_reply(self, reply):
        return int(reply)

    # -- vectorized read path ----------------------------------------------

    query_spec = ("int32", (1,))
    query_reply_spec = ("int32", (1,))

    def jit_query(self, queries, state):
        # queries: [..., Kr, 1] (payload ignored); every query answers the
        # counter value at the serve watermark
        Kr = queries.shape[-2]
        return state[..., None, None].expand(state.shape + (Kr, 1))

    def encode_query(self, query):
        return torch.zeros((1,), dtype=torch.int32)

    def decode_query_reply(self, reply):
        return int(reply[..., 0])
