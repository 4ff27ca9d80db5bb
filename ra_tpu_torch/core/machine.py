"""The ``JitMachine`` contract on torch tensors.

The counterpart of ``ra_tpu/core/machine.py::JitMachine``: committed
commands are dense tensors folded on the engine's device.  ``state`` is
a tree (see ``core.tree``) of fixed-shape tensors with leading lane
dims; every method is a pure function of its tensor arguments with no
data-dependent host control flow, so a step never waits on the device.
The host ``Machine`` bridge of the reference is not part of the port.

The reference picks a window fold's branch with ``lax.cond``
(``cond_concrete``); a step here never reads a tensor on the host
(``bool(tensor)`` would wait for the device, and cannot be captured in a
CUDA graph).  On a card :meth:`JitMachine.window_fold_dispatch` needs no
branch: the machine's fold kernel folds every window in order, which the
fast fold equals wherever it is valid.  On the CPU it keeps the
reference's choice, with :func:`cond_select` computing both branches and
selecting on the tensor.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .tree import tree_map


def cond_select(pred, on_true, on_false):
    """The reference's ``cond_concrete(pred, ...)`` over two computed
    trees: leaf-wise ``torch.where(pred, t, f)`` on a bool scalar
    tensor, with no host sync."""
    return tree_map(lambda t, f: torch.where(pred, t, f), on_true, on_false)


def encode_i32(values) -> torch.Tensor:
    """An encoded host command or query: an int32 tensor of Python ints.
    A value outside int32 raises OverflowError, as the reference's
    ``jnp.asarray(..., jnp.int32)`` does (its encoders turn that into a
    noop)."""
    for v in values:
        if not -2 ** 31 <= v < 2 ** 31:
            raise OverflowError(f"{v} does not fit int32")
    return torch.tensor(values, dtype=torch.int32)


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
    #: True where the fast fold and the in-order fold of a clean window
    #: can differ: :meth:`window_fold_dispatch` then keeps the reference's
    #: choice on a card too
    fast_fold_on_card: bool = False

    def jit_init(self, n_lanes: int, device: torch.device) -> Any:
        """The initial state tree with a leading lane axis, on ``device``."""
        raise NotImplementedError

    def check_device(self, device: torch.device) -> None:
        """Raise if this machine cannot run on ``device``, where an engine
        is built; every device is taken unless a machine says otherwise."""

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

    def window_fold_dispatch(self, meta, commands, mask, state):
        """``jit_apply_batch`` for a machine with a fold kernel (its
        :meth:`in_order_fold`, the kernel's dispatcher) and a vectorised
        fold of the common window, ``self._batch_fast(commands, mask,
        state)``, valid where the bool scalar ``self._fast_ok(commands,
        mask)`` holds over the whole batch.  On a card the kernel alone
        folds every window: where the fast fold is valid the two agree,
        and the kernel is the faster at the full-width windows (PERF.md).
        On the CPU the reference's cond: both folds run and the fast one
        is kept where ``_fast_ok``; so too on a card for a machine whose
        :attr:`fast_fold_on_card` is set, where the two folds can differ."""
        folded = self.in_order_fold(meta, commands, mask, state)
        if mask.device.type != "cpu" and not self.fast_fold_on_card:
            return folded
        return cond_select(self._fast_ok(commands, mask),
                           self._batch_fast(commands, mask, state), folded)

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
