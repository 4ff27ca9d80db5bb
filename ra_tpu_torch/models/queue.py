"""Minimal queue machine — the ra_queue.erl test fixture equivalent.

The reference keeps a deliberately tiny queue machine (test/ra_queue.erl)
next to the full ra_fifo: state is a list of pending items; ``enq`` adds,
``deq`` pops and sends the item to a pid as a send_msg effect.  Used by
the nemesis/partition tests where the workload must be easy to reason
about while still exercising SendMsg effects and state replication.

Commands:  ("enq", item)            -> reply "ok"
           ("deq", pid)             -> pops head, SendMsg(pid, ("item", x))
           ("deq",)                 -> pops head, reply ("item", x)
"""
from __future__ import annotations

from collections import deque
from typing import Any

from ..core.machine import ApplyMeta, Machine
from ..core.types import SendMsg


class QueueMachine(Machine):
    version = 0

    def init(self, config: dict) -> deque:
        return deque()

    def apply(self, meta: ApplyMeta, command: Any, state: deque):
        kind = command[0]
        if kind == "enq":
            state.append((meta.index, command[1]))
            return state, "ok"
        if kind == "deq":
            if not state:
                return state, "empty"
            _idx, item = state.popleft()
            if len(command) > 1 and command[1] is not None:
                return state, "ok", [SendMsg(command[1], ("item", item))]
            return state, ("item", item)
        return state, ("error", "unknown_command")

    def overview(self, state: deque) -> dict:
        return {"type": "queue", "len": len(state)}
