"""User state-machine behaviour: the port's own copy of
``ra_tpu/core/machine.py``.

:class:`Machine` is the classic host-side behaviour (the ra_machine
callback contract, ra_machine.erl:233-287): ``apply`` runs in Python,
may return effects, and state may be any Python object.
:class:`SimpleMachine` wraps a plain ``fun(command, state)``.

:class:`JitMachine` is the device variant on torch tensors: committed
commands are dense tensors folded on the engine's device.  ``state`` is
a tree (see ``core.tree``) of fixed-shape tensors with leading lane
dims; every method is a pure function of its tensor arguments with no
data-dependent host control flow, so a step never waits on the device.
A JitMachine also speaks the host protocol (:meth:`JitMachine.init`,
:meth:`JitMachine.apply`), so the same machine runs on the classic path
(``RaServer``/``RaNode``): there each committed command is one
``jit_apply`` on the machine's device, whose replica state stays there.
The reference caches one ``jax.jit`` of the host apply per class and
scalar config (``_HOST_APPLY_JIT_CACHE``); eager torch has nothing to
compile, so that cache has no counterpart here.

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

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..device import resolve_device
from .tree import tree_leaves, tree_map
from .types import Effects


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


@dataclass(frozen=True, slots=True)
class ApplyMeta:
    """Metadata passed to apply/3 (ra_machine:command_meta_data()).
    Slotted: one instance per applied command on every member — the
    apply fold is the classic plane's hottest loop."""

    index: int
    term: int
    system_time: float = 0.0
    machine_version: int = 0
    from_: Any = None
    reply_mode: Any = None


class Machine:
    """Base class for host-side state machines.

    Subclasses must override :meth:`init` and :meth:`apply`.  All other
    callbacks have no-op defaults matching the optional-callback semantics of
    the reference (ra_machine.erl:211-221).
    """

    #: bump when apply semantics change; see version gating in the core
    #: (ra_server.erl:2671-2732)
    version: int = 0

    def init(self, config: dict) -> Any:
        raise NotImplementedError

    def apply(self, meta: ApplyMeta, command: Any, state: Any):
        """Apply a committed user command.

        Returns ``(new_state, reply)`` or ``(new_state, reply, effects)``.
        """
        raise NotImplementedError

    #: OPTIONAL batched apply: when a machine sets this to a
    #: callable ``apply_batch(meta, commands, state) -> (state, replies)``
    #: (or ``(state, replies, effects)``), the core's apply fold hands it
    #: RUNS of contiguous same-term plain user commands in one call
    #: instead of one :meth:`apply` per entry.  ``meta`` describes the
    #: FIRST entry of the run; command ``i`` applied at ``meta.index + i``
    #: (machines that key on the index compute it that way).  ``replies``
    #: must be one reply per command, in order — they feed the same
    #: notify/await-consensus plumbing the per-entry path feeds.  The
    #: contract is exact order equivalence with folding :meth:`apply`
    #: over the run; machines whose apply has per-command effects should
    #: leave this None (the default) and take the per-entry path.
    apply_batch = None

    # -- optional callbacks -------------------------------------------------

    def state_enter(self, raft_state: str, state: Any) -> Effects:
        return []

    def tick(self, time_ms: float, state: Any) -> Effects:
        return []

    def snapshot_installed(self, meta, state, old_meta, old_state) -> Effects:
        return []

    def init_aux(self, name: str) -> Any:
        return None

    def handle_aux(self, raft_state: str, msg_type: str, msg: Any,
                   aux_state: Any, internal) -> tuple:
        """Returns (aux_state, effects)."""
        return aux_state, []

    def overview(self, state: Any) -> Any:
        return state

    def which_module(self, version: int) -> "Machine":
        """Machine-version dispatch (ra_machine.erl:346-362).  Return the
        machine implementing ``version``; default: self for all versions."""
        return self

    def snapshot_module(self):
        """Override to customise the snapshot format (ra_machine.erl:435)."""
        return None

    def live_indexes(self, state: Any) -> list:
        return []


class SimpleMachine(Machine):
    """Wraps a plain ``fun(command, state) -> state`` as a machine — the
    ``{simple, Fun, Init}`` config variant (ra_machine_simple.erl, selected in
    ra_server.erl:277-283).  Replies are the new state."""

    def __init__(self, fn: Callable[[Any, Any], Any], initial_state: Any):
        self._fn = fn
        self._initial = initial_state

    def init(self, config: dict) -> Any:
        return self._initial

    def apply(self, meta: ApplyMeta, command: Any, state: Any):
        new_state = self._fn(command, state)
        return new_state, new_state


class JitMachine(Machine):
    """Device-side state machine folded by the lane engine, and on the
    classic path one committed command at a time."""

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

    # -- host-side protocol so JitMachines also run on the classic path ----

    def init(self, config: dict) -> Any:
        """Lane 0 of ``jit_init(1, device)``, kept on the device named by
        ``config["device"]`` (None or absent: the card; the CPU by name
        only)."""
        dev = resolve_device((config or {}).get("device"))
        self.check_device(dev)
        return tree_map(lambda x: x[0], self.jit_init(1, dev))

    def place_state(self, state: Any, config: dict) -> Any:
        """A state recovered from a snapshot, on the device :meth:`init`
        would use for ``config``.  A reference snapshot's JAX arrays read
        as CPU tensors (``convert.loads``), so without this a card node
        would apply them on the CPU."""
        dev = resolve_device((config or {}).get("device"))
        self.check_device(dev)
        return tree_map(lambda x: x.to(dev), state)

    def apply(self, meta: ApplyMeta, command: Any, state: Any):
        """One committed command through :meth:`jit_apply` on the device
        the state lives on (a recovering server puts a snapshot's state
        on the machine's device first: :meth:`place_state`).  The meta scalars and the encoded command
        go there in one copy, from pinned memory on a card, so the copy
        waits for nothing; the only host sync is the reply's own read in
        :meth:`decode_reply`."""
        enc = self.encode_command(command)
        dev = tree_leaves(state)[0].device
        row = torch.cat([torch.tensor([meta.index, meta.term],
                                      dtype=torch.int32),
                         enc.reshape(-1).to(torch.int32)])
        if dev.type != "cpu":
            row = row.pin_memory().to(dev, non_blocking=True)
        meta_t = {"index": row[0], "term": row[1]}
        new_state, reply = self.jit_apply(meta_t,
                                          row[2:].reshape(enc.shape),
                                          state)
        return new_state, self.decode_reply(reply)

    def encode_query(self, query: Any):
        raise NotImplementedError

    def decode_query_reply(self, reply_array) -> Any:
        return reply_array
