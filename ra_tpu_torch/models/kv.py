"""Replicated key-value store machine — the ra-kv-store role.

The reference ecosystem's capability proof for linearizability is a
Raft-backed KV store driven by Jepsen (README.md:33-35 points at
ra-kv-store).  This is that machine for ra_tpu_torch: put/delete/cas with
old-value replies, linearizable reads via consistent_query, and key
watchers built on the monitor effect vocabulary (ra_machine.erl:121-142
— send_msg + monitor/demonitor), so watcher death cleans up server
state exactly like ra_fifo's consumer monitors.

Snapshotting: a release_cursor is emitted every ``snapshot_interval``
applied commands (the ra_bench noop machine's release-cursor policy,
ra_bench.erl:43-49) — the whole KV map is the snapshot state.

Commands (all picklable tuples):
  ("put", key, value)          -> old value | None
  ("delete", key)              -> old value | None
  ("cas", key, expect, new)    -> ("ok", old) | ("failed", current)
                                  (new=None deletes on success)
  ("watch", key, pid)          -> "ok"; pid gets ("kv_event", key, value)
  ("unwatch", key, pid)        -> "ok"
  ("down", pid, reason)        -> builtin: drops every watch held by pid
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..core.machine import ApplyMeta, Machine
from ..core.types import Demonitor, Monitor, ReleaseCursor, SendMsg


@dataclasses.dataclass(frozen=True)
class KvState:
    data: dict
    #: key -> tuple of watcher pids
    watchers: dict

    def evolve(self, **kw: Any) -> "KvState":
        return dataclasses.replace(self, **kw)


class KvMachine(Machine):
    version = 0

    def __init__(self, snapshot_interval: int = 4096) -> None:
        self.snapshot_interval = snapshot_interval

    def init(self, config: dict) -> KvState:
        return KvState(data={}, watchers={})

    # -- helpers -----------------------------------------------------------

    def _notify(self, state: KvState, key: Any, value: Any,
                effects: list) -> None:
        for pid in state.watchers.get(key, ()):
            effects.append(SendMsg(pid, ("kv_event", key, value)))

    def _maybe_cursor(self, meta: ApplyMeta, state: KvState,
                      effects: list) -> None:
        if meta.index % self.snapshot_interval == 0:
            effects.append(ReleaseCursor(meta.index, state))

    # -- apply -------------------------------------------------------------

    def apply(self, meta: ApplyMeta, command: Any, state: KvState):
        effects: list = []
        reply: Any = "ok"
        op = command[0] if isinstance(command, tuple) and command else None

        if op == "put":
            _, key, value = command
            reply = state.data.get(key)
            data = dict(state.data)
            data[key] = value
            state = state.evolve(data=data)
            self._notify(state, key, value, effects)
        elif op == "delete":
            _, key = command
            reply = state.data.get(key)
            if key in state.data:
                data = dict(state.data)
                del data[key]
                state = state.evolve(data=data)
                self._notify(state, key, None, effects)
        elif op == "cas":
            _, key, expect, new = command
            current = state.data.get(key)
            if current == expect:
                data = dict(state.data)
                if new is None:
                    data.pop(key, None)
                else:
                    data[key] = new
                state = state.evolve(data=data)
                reply = ("ok", current)
                self._notify(state, key, new, effects)
            else:
                reply = ("failed", current)
        elif op == "watch":
            _, key, pid = command
            watchers = dict(state.watchers)
            if pid not in watchers.get(key, ()):
                watchers[key] = tuple(watchers.get(key, ())) + (pid,)
            state = state.evolve(watchers=watchers)
            effects.append(Monitor("process", pid))
        elif op == "unwatch":
            _, key, pid = command
            state = self._drop_watch(state, key, pid)
            if not any(pid in pids for pids in state.watchers.values()):
                effects.append(Demonitor("process", pid))
        elif op == "down":
            _, pid, _reason = command
            for key in [k for k, pids in state.watchers.items()
                        if pid in pids]:
                state = self._drop_watch(state, key, pid)
            reply = None
        else:
            # unknown/misspelled op: surface it instead of acking "ok"
            reply = ("error", "unknown_command")
        self._maybe_cursor(meta, state, effects)
        return state, reply, effects

    @staticmethod
    def _drop_watch(state: KvState, key: Any, pid: Any) -> KvState:
        pids = tuple(p for p in state.watchers.get(key, ()) if p != pid)
        watchers = dict(state.watchers)
        if pids:
            watchers[key] = pids
        else:
            watchers.pop(key, None)
        return state.evolve(watchers=watchers)

    def overview(self, state: KvState) -> Any:
        return {"num_keys": len(state.data),
                "num_watched_keys": len(state.watchers)}


# -- query functions (use with local/leader/consistent_query) --------------

def _get(key: Any, state: KvState) -> Optional[Any]:
    return state.data.get(key)


def query_get(key: Any):
    """Build a query fun reading one key.  functools.partial of a
    module-level function, NOT a lambda: query funs cross pickle
    boundaries on TCP-transport clusters."""
    import functools
    return functools.partial(_get, key)


def query_keys(state: KvState) -> list:
    return sorted(state.data)


def query_size(state: KvState) -> int:
    return len(state.data)
