"""The ``JitMachine`` contract on torch tensors.

The counterpart of ``ra_tpu/core/machine.py::JitMachine``: committed
commands are dense tensors folded on the engine's device.  ``state`` is
a tree (see ``core.tree``) of fixed-shape tensors with leading lane
dims; every method is a pure function of its tensor arguments with no
data-dependent host control flow, so a step never waits on the device.
The host ``Machine`` bridge of the reference is not part of the port.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .tree import tree_map


class JitMachine:
    """Device-side state machine folded by the lane engine."""

    #: (dtype name, shape) of one encoded command, e.g. ("int32", (2,))
    command_spec: tuple = ("int32", ())
    #: (dtype name, shape) of one reply
    reply_spec: tuple = ("int32", ())
    #: (dtype name, shape) of one encoded query, or None when the machine
    #: has no query kernel (the engine's read plane then refuses reads)
    query_spec: Optional[tuple] = None
    #: (dtype name, shape) of one query reply
    query_reply_spec: tuple = ("int32", ())
    #: True when :meth:`jit_apply_batch` folds a committed window in one
    #: shot, order-equivalently to the sequential masked fold
    supports_batch_apply: bool = False

    def jit_init(self, n_lanes: int, device: torch.device) -> Any:
        """The initial state tree with a leading lane axis, on ``device``."""
        raise NotImplementedError

    def jit_apply(self, meta, command, state):
        """(meta tensors, encoded command, state) -> (state, reply)."""
        raise NotImplementedError

    def jit_query(self, queries, state):
        """Evaluate encoded queries ``[..., Kr, Cq]`` against one replica's
        state (same leading dims); returns replies ``[..., Kr, Wq]``.
        Never mutates state.  Only called when :attr:`query_spec` is set."""
        raise NotImplementedError

    def jit_apply_batch(self, meta, commands, mask, state):
        """Fold a window at once: commands ``[..., A, C]``, mask
        bool``[..., A]`` (True = apply), state leading dims = the ``...``
        prefix.  Returns the new state.  Default: the sequential fold."""
        return self.sequential_window_fold(meta, commands, mask, state)

    def sequential_window_fold(self, meta, commands, mask, state):
        """Masked in-order fold of :meth:`jit_apply` over the window axis,
        one Python iteration per window position."""
        idx = meta["index"]
        term = torch.broadcast_to(meta["term"], idx.shape)
        for a in range(commands.shape[-2]):
            do = mask[..., a]
            new, _reply = self.jit_apply(
                {"index": idx[..., a], "term": term[..., a]},
                commands[..., a, :], state)
            state = tree_map(
                lambda n, o: torch.where(
                    do.reshape(do.shape + (1,) * (n.dim() - do.dim())),
                    n, o),
                new, state)
        return state

    def encode_command(self, command: Any):
        raise NotImplementedError

    def decode_reply(self, reply_array) -> Any:
        return reply_array

    def encode_query(self, query: Any):
        raise NotImplementedError

    def decode_query_reply(self, reply_array) -> Any:
        return reply_array
