"""Register-file machine: a file of ``n_slots`` int32 registers a lane with
put / fetch-add / compare-and-set.  Counterpart of
``ra_tpu/models/registers.py``; equal to it on every state leaf and reply.

Encoding (command_spec int32[4]): ``[op, slot, value, expected]``
  op 0 = noop (term-opening entry)
  op 1 = put:  reg[slot] := value;                   reply old value
  op 2 = add:  reg[slot] += value (int32, wrapping); reply new value
  op 3 = cas:  if reg[slot] == expected: := value;   reply 1/0 (ok flag)
A slot outside [0, n_slots) is clipped to the file, as in the reference.

CAS makes the fold order-dependent.  On the CPU, as in the reference, a
cas-free window folds in one vectorised pass (:meth:`_batch_fast`) and a
window holding a cas takes the in-order fold.  On a card every window
takes the in-order fold, the ``ops/csrc/slot_fold.cu`` kernel.
"""
from __future__ import annotations

import torch

from ..core.machine import JitMachine, encode_i32
from ..ops.exact import add32, place16, sum32
from ..ops.slot_fold import slot_fold_dispatch

I32 = torch.int32


class RegisterMachine(JitMachine):
    command_spec = ("int32", (4,))
    reply_spec = ("int32", ())
    version = 0
    #: cas does not commute; the batch fold is still in order (vectorised
    #: for cas-free windows, the in-order fold else)
    supports_batch_apply = True
    #: the decoder of ``ops/csrc/slot_fold.cu`` this machine folds with
    slot_fold_kind = "registers"

    def __init__(self, n_slots: int = 8) -> None:
        self.n_slots = n_slots

    def jit_init(self, n_lanes: int, device: torch.device):
        return torch.zeros((n_lanes, self.n_slots), dtype=I32, device=device)

    def jit_apply(self, meta, command, state):
        # command: [..., 4]; state: [..., S]
        S = self.n_slots
        op = command[..., 0]
        slot = torch.clamp(command[..., 1], 0, S - 1)
        value = command[..., 2]
        expected = command[..., 3]
        current = torch.gather(state, -1, slot[..., None].long())[..., 0]
        cas_ok = current == expected
        new_val = torch.where(
            op == 1, value,
            torch.where(op == 2, add32(current, value),
                        torch.where((op == 3) & cas_ok, value, current)))
        write = (op == 1) | (op == 2) | ((op == 3) & cas_ok)
        onehot = torch.arange(S, device=state.device) == slot[..., None]
        updated = torch.where(onehot & write[..., None], new_val[..., None],
                              state)
        reply = torch.where(op == 1, current,
                            torch.where(op == 2, new_val,
                                        torch.where(op == 3, cas_ok.to(I32),
                                                    0)))
        return updated, reply

    def jit_apply_batch(self, meta, commands, mask, state):
        return self.window_fold_dispatch(meta, commands, mask, state)

    def _fast_ok(self, commands, mask):
        return ~torch.any(mask & (commands[..., 0] == 3))   # no cas

    def in_order_fold(self, meta, commands, mask, state):
        return slot_fold_dispatch(self, meta, commands, mask, state)

    def _batch_fast(self, commands, mask, state):
        """The cas-free window: a slot ends at the value of its last put
        plus the adds after it, or at its value plus all its adds."""
        S = self.n_slots
        A = commands.shape[-2]
        dev = state.device
        op = torch.where(mask, commands[..., 0], 0)            # [..., A]
        slot = torch.clamp(commands[..., 1], 0, S - 1)
        value = commands[..., 2]
        at_slot = slot[..., None, :] == \
            torch.arange(S, device=dev)[:, None]               # [..., S, A]
        hits_put = at_slot & (op == 1)[..., None, :]
        hits_add = at_slot & (op == 2)[..., None, :]
        pos = torch.arange(A, dtype=I32, device=dev)
        lastput = torch.where(hits_put, pos, -1).amax(dim=-1)  # [..., S]
        base_put = place16(hits_put & (pos == lastput[..., None]), value)
        base = torch.where(lastput >= 0, base_put, state)
        adds_after = sum32(torch.where(
            hits_add & (pos > lastput[..., None]), value[..., None, :], 0))
        return add32(base, adds_after)

    def encode_command(self, command) -> torch.Tensor:
        """Host commands: ("put", slot, v) | ("add", slot, v) |
        ("cas", slot, expected, new); anything else, malformed ones
        included, encodes as a noop (it runs on every member)."""
        try:
            if isinstance(command, tuple):
                if command[0] in ("put", "add") and len(command) == 3:
                    return encode_i32([1 if command[0] == "put" else 2,
                                       int(command[1]), int(command[2]), 0])
                if command[0] == "cas" and len(command) == 4:
                    return encode_i32([3, int(command[1]), int(command[3]),
                                       int(command[2])])
        except (TypeError, ValueError, IndexError, OverflowError):
            pass
        return torch.zeros((4,), dtype=I32)

    def decode_reply(self, reply) -> int:
        return int(reply)

