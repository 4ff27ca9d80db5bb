"""FIFO queue state machine — the capability-proof machine.

The reference ships ``test/ra_fifo.erl`` (1,520 LoC), a full quorum-queue
state machine with per-enqueuer sequence deduplication, consumer checkout
credit, settlement/return/discard, process-down handling, and periodic
release-cursor emission — both a test fixture and the proof that the
machine behaviour contract is rich enough for real workloads
(SURVEY.md §4.6).  This module is the same capability proof for ra_tpu_torch,
designed fresh around :class:`ra_tpu_torch.core.machine.Machine`:

* commands are plain tuples (picklable — they travel through the WAL and
  snapshots),
* consumer/enqueuer "pids" are opaque hashable tokens; deliveries go out
  as :class:`SendMsg` effects which the node shell routes to callables
  (see models/fifo_client.py:Mailbox),
* process lifecycle uses the Monitor/Demonitor machine effects plus the
  ``("down", pid, reason)`` / ``("nodeup", node)`` builtin commands
  (ra_machine.erl builtin_command; ra_fifo.erl:308-368),
* the release cursor is emitted whenever the queue drains empty and every
  ``shadow_copy_interval`` raft indexes (ra_fifo.erl SHADOW_COPY_INTERVAL,
  :289-307 — there 4096).

Protocol (command tuples):

    ("enqueue", pid_or_None, seqno_or_None, raw_msg)
    ("checkout", spec, (tag, pid))     spec: ("auto", n) | ("once", n)
                                            | ("dequeue", "settled")
                                            | ("dequeue", "unsettled")
                                            | "cancel"
    ("settle", (msg_id, ...), (tag, pid))
    ("return", (msg_id, ...), (tag, pid))
    ("discard", (msg_id, ...), (tag, pid))
    ("purge",)
    ("down", pid, reason)              builtin, appended on monitor DOWN
    ("nodeup", node) / ("nodedown", node)

Deliveries sent to consumer pids:  ("delivery", tag, [(msg_id, header, msg)])
where header is a dict with "delivery_count".
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Optional

from ..core.machine import ApplyMeta, Machine
from ..core.types import Demonitor, Monitor, ReleaseCursor, SendMsg

#: emit a release cursor at least every this many raft indexes
SHADOW_COPY_INTERVAL = 4096


@dataclass
class Enqueuer:
    """Per-sender dedup/ordering state (ra_fifo.erl enqueuer record)."""

    next_seqno: Optional[int] = None     # next expected; None until first
    pending: dict = field(default_factory=dict)  # seqno -> (raft_idx, msg)
    status: str = "up"                   # up | suspected


@dataclass
class Consumer:
    """Per-consumer checkout state (ra_fifo.erl customer record)."""

    checked_out: dict = field(default_factory=dict)
    # msg_id -> (msg_in_id, raft_idx, header, raw_msg)
    next_msg_id: int = 0
    credit: int = 0                      # max simultaneous unsettled msgs
    seen: int = 0                        # lifetime deliveries (for "once")
    lifetime: str = "auto"               # auto | once
    suspected: bool = False


@dataclass
class FifoState:
    name: str = "fifo"
    # ready messages: msg_in_id -> (raft_idx, header, raw_msg); insertion
    # order of an OrderedDict is FIFO order (returns re-insert at the front
    # via a sorted rebuild, which is rare)
    messages: OrderedDict = field(default_factory=OrderedDict)
    next_msg_in_id: int = 0
    enqueuers: dict = field(default_factory=dict)      # pid -> Enqueuer
    consumers: dict = field(default_factory=dict)      # (tag,pid) -> Consumer
    service_queue: deque = field(default_factory=deque)  # (tag,pid) rotation
    # raft indexes still referenced by live (ready or unsettled) messages
    live: set = field(default_factory=set)
    last_release_cursor: int = 0


def _has_capacity(con: Consumer) -> bool:
    if con.suspected:
        return False
    if con.lifetime == "once" and con.seen >= con.credit:
        return False
    return len(con.checked_out) < con.credit


class FifoMachine(Machine):
    """A FIFO queue with consumer checkout semantics."""

    version = 1

    def __init__(self, name: str = "fifo",
                 shadow_copy_interval: int = SHADOW_COPY_INTERVAL) -> None:
        self.name = name
        self.shadow_copy_interval = shadow_copy_interval

    # -- lifecycle ----------------------------------------------------------

    def init(self, config: dict) -> FifoState:
        return FifoState(name=config.get("name", self.name))

    def state_enter(self, raft_state: str, state: FifoState) -> list:
        if raft_state == "leader":
            # re-establish monitors on every known external process
            # (ra_fifo.erl:370-380)
            effs: list = []
            for pid in set(state.enqueuers) | {p for _, p in state.consumers}:
                effs.append(Monitor("process", pid))
            return effs
        if raft_state == "eol":
            # cluster deleted: tell every attached process (ra_fifo.erl:381)
            pids = set(state.enqueuers) | {p for _, p in state.consumers}
            return [SendMsg(pid, ("eol", state.name))
                    for pid in pids]
        return []

    # -- apply --------------------------------------------------------------

    def apply(self, meta: ApplyMeta, command: Any, state: FifoState):
        effects: list = []
        reply: Any = "ok"
        kind = command[0] if isinstance(command, tuple) and command else None

        was_live = bool(state.messages) or bool(state.live)
        if kind == "enqueue":
            _, pid, seqno, raw = command
            self._enqueue(state, meta.index, pid, seqno, raw, effects)
        elif kind == "checkout":
            _, spec, cid = command
            reply = self._checkout(state, spec, cid, effects)
        elif kind in ("settle", "discard"):
            _, msg_ids, cid = command
            self._settle(state, msg_ids, cid, effects)
        elif kind == "return":
            _, msg_ids, cid = command
            self._return(state, msg_ids, cid)
        elif kind == "purge":
            count = len(state.messages)
            for (idx, _h, _m) in state.messages.values():
                state.live.discard(idx)
            state.messages.clear()
            reply = ("purge", count)
        elif kind == "down":
            _, pid, reason = command
            self._down(state, pid, reason, effects)
        elif kind == "nodeup":
            _, node = command
            for pid, enq in state.enqueuers.items():
                if getattr(pid, "node", None) == node:
                    enq.status = "up"
                    effects.append(Monitor("process", pid))
            for (tag, pid), con in state.consumers.items():
                if getattr(pid, "node", None) == node:
                    con.suspected = False
                    effects.append(Monitor("process", pid))
                    self._maybe_serve(state, (tag, pid))
        elif kind == "nodedown":
            pass
        # every state change may have freed capacity or added messages
        self._deliver_ready(state, effects)
        self._maybe_release_cursor(meta, state, effects, was_live)
        return state, reply, effects

    # -- enqueue path -------------------------------------------------------

    def _enqueue(self, state: FifoState, raft_idx: int, pid: Any,
                 seqno: Optional[int], raw: Any, effects: list) -> None:
        if pid is None or seqno is None:
            # untracked enqueue: no ordering/dedup guarantees
            self._add_ready(state, raft_idx, {"delivery_count": 0}, raw)
            return
        enq = state.enqueuers.get(pid)
        if enq is None:
            enq = state.enqueuers[pid] = Enqueuer()
            effects.append(Monitor("process", pid))
        if enq.next_seqno is None:
            # client seqnos start at 1 by contract (FifoClient); baselining
            # at the first *seen* seqno would silently drop seqno 1 when a
            # later enqueue commits first (resends can reorder commits)
            enq.next_seqno = 1
        if seqno < enq.next_seqno:
            return  # duplicate delivery of an applied enqueue: drop
        if seqno > enq.next_seqno:
            # out of order (an earlier enqueue is still in flight):
            # stash until the gap fills (ra_fifo pending enqueues)
            enq.pending[seqno] = (raft_idx, raw)
            return
        self._add_ready(state, raft_idx, {"delivery_count": 0}, raw)
        enq.next_seqno += 1
        while enq.next_seqno in enq.pending:
            idx, msg = enq.pending.pop(enq.next_seqno)
            self._add_ready(state, idx, {"delivery_count": 0}, msg)
            enq.next_seqno += 1

    def _add_ready(self, state: FifoState, raft_idx: int, header: dict,
                   raw: Any) -> None:
        state.messages[state.next_msg_in_id] = (raft_idx, header, raw)
        state.next_msg_in_id += 1
        state.live.add(raft_idx)

    # -- checkout path ------------------------------------------------------

    def _checkout(self, state: FifoState, spec: Any, cid: tuple,
                  effects: list) -> Any:
        tag, pid = cid
        if spec == "cancel":
            con = state.consumers.pop(cid, None)
            if con is not None:
                self._requeue_checked_out(state, con)
                if pid not in {p for _, p in state.consumers} and \
                        pid not in state.enqueuers:
                    effects.append(Demonitor("process", pid))
            return "ok"
        if isinstance(spec, tuple) and spec[0] == "dequeue":
            # one-shot pop, no standing consumer (ra_fifo.erl:254-279)
            mid = next(iter(state.messages), None)
            if mid is None:
                return ("dequeue", "empty")
            raft_idx, header, raw = state.messages.pop(mid)
            if spec[1] == "settled":
                state.live.discard(raft_idx)
                return ("dequeue", (header, raw))
            con = state.consumers.setdefault(cid, Consumer(lifetime="once"))
            con.credit = max(con.credit, 1)
            msg_id = con.next_msg_id
            con.next_msg_id += 1
            con.seen += 1
            con.checked_out[msg_id] = (mid, raft_idx, header, raw)
            effects.append(Monitor("process", pid))
            return ("dequeue", (msg_id, header, raw))
        lifetime, num = spec
        con = state.consumers.get(cid)
        if con is None:
            con = state.consumers[cid] = Consumer()
            effects.append(Monitor("process", pid))
        con.lifetime = lifetime
        con.credit = num
        con.suspected = False
        self._maybe_serve(state, cid)
        return "ok"

    def _maybe_serve(self, state: FifoState, cid: tuple) -> None:
        if cid not in state.service_queue and \
                cid in state.consumers and \
                _has_capacity(state.consumers[cid]):
            state.service_queue.append(cid)

    def _deliver_ready(self, state: FifoState, effects: list) -> None:
        """Round-robin ready messages to consumers with spare credit,
        batching one delivery effect per consumer (ra_fifo checkout loop)."""
        batches: dict = {}
        while state.messages and state.service_queue:
            cid = state.service_queue[0]
            con = state.consumers.get(cid)
            if con is None or not _has_capacity(con):
                state.service_queue.popleft()
                continue
            mid, (raft_idx, header, raw) = next(iter(state.messages.items()))
            del state.messages[mid]
            msg_id = con.next_msg_id
            con.next_msg_id += 1
            con.seen += 1
            con.checked_out[msg_id] = (mid, raft_idx, header, raw)
            batches.setdefault(cid, []).append((msg_id, header, raw))
            # rotate for fairness across consumers
            state.service_queue.rotate(-1)
        # prune exhausted consumers from the rotation
        state.service_queue = deque(
            cid for cid in state.service_queue
            if cid in state.consumers and _has_capacity(state.consumers[cid]))
        for (tag, pid), msgs in batches.items():
            effects.append(SendMsg(pid, ("delivery", tag, msgs)))

    # -- settlement ---------------------------------------------------------

    def _settle(self, state: FifoState, msg_ids: tuple, cid: tuple,
                effects: list) -> None:
        """Settle and discard share semantics until a dead-letter target
        exists (ra_fifo discard drops the message the same way)."""
        con = state.consumers.get(cid)
        if con is None:
            return
        for msg_id in msg_ids:
            entry = con.checked_out.pop(msg_id, None)
            if entry is not None:
                _mid, raft_idx, _header, _raw = entry
                state.live.discard(raft_idx)
        if con.lifetime == "once" and con.seen >= con.credit and \
                not con.checked_out:
            state.consumers.pop(cid, None)
            pid = cid[1]
            if pid not in {p for _, p in state.consumers} and \
                    pid not in state.enqueuers:
                effects.append(Demonitor("process", pid))
        else:
            self._maybe_serve(state, cid)

    def _return(self, state: FifoState, msg_ids: tuple, cid: tuple) -> None:
        con = state.consumers.get(cid)
        if con is None:
            return
        entries = []
        for msg_id in msg_ids:
            entry = con.checked_out.pop(msg_id, None)
            if entry is not None:
                entries.append(entry)
                con.seen = max(0, con.seen - 1)
        self._return_entries(state, entries)
        self._maybe_serve(state, cid)

    def _requeue_checked_out(self, state: FifoState, con: Consumer) -> None:
        if con.checked_out:
            self._return_entries(state, con.checked_out.values())
            con.checked_out.clear()

    def _return_entries(self, state: FifoState, entries) -> None:
        returned = []
        for (mid, raft_idx, header, raw) in entries:
            header = dict(header)
            header["delivery_count"] = header.get("delivery_count", 0) + 1
            returned.append((mid, (raft_idx, header, raw)))
        if returned:
            merged = sorted(list(state.messages.items()) + returned)
            state.messages = OrderedDict(merged)

    # -- process lifecycle --------------------------------------------------

    def _down(self, state: FifoState, pid: Any, reason: Any,
              effects: list) -> None:
        if reason == "noconnection":
            # connection loss is not death: suspect and await nodeup
            # (ra_fifo.erl:308-328)
            enq = state.enqueuers.get(pid)
            if enq is not None:
                enq.status = "suspected"
            for (tag, p), con in state.consumers.items():
                if p == pid:
                    con.suspected = True
            return
        state.enqueuers.pop(pid, None)
        dead = [cid for cid in state.consumers if cid[1] == pid]
        for cid in dead:
            con = state.consumers.pop(cid)
            self._requeue_checked_out(state, con)
            try:
                state.service_queue.remove(cid)
            except ValueError:
                pass

    # -- snapshots ----------------------------------------------------------

    def _maybe_release_cursor(self, meta: ApplyMeta, state: FifoState,
                              effects: list, was_live: bool) -> None:
        interval_hit = (meta.index - state.last_release_cursor >=
                        self.shadow_copy_interval)
        # only the command that *drained* the queue emits a cursor, and at
        # most every interval/8 indexes — a depth-0/1 request-reply
        # workload drains on every settle and must not snapshot per message
        drained = (was_live and not state.messages and not state.live and
                   meta.index - state.last_release_cursor >=
                   max(1, self.shadow_copy_interval // 8))
        if interval_hit or drained:
            state.last_release_cursor = meta.index
            effects.append(ReleaseCursor(meta.index, self.dehydrate(state)))

    def dehydrate(self, state: FifoState) -> FifoState:
        """Snapshot copy (ra_fifo:dehydrate_state) — deep enough that later
        mutation never aliases the snapshot."""
        import copy
        return copy.deepcopy(state)

    def live_indexes(self, state: FifoState) -> list:
        return sorted(state.live)

    # -- introspection ------------------------------------------------------

    def overview(self, state: FifoState) -> dict:
        return {
            "type": "fifo",
            "name": state.name,
            "messages_ready": len(state.messages),
            "messages_checked_out": sum(len(c.checked_out)
                                        for c in state.consumers.values()),
            "num_consumers": len(state.consumers),
            "num_enqueuers": len(state.enqueuers),
        }


# -- query functions for ra.local_query / leader_query ----------------------

def query_messages_ready(state: FifoState) -> int:
    return len(state.messages)


def query_messages_checked_out(state: FifoState) -> int:
    return sum(len(c.checked_out) for c in state.consumers.values())


def query_consumer_count(state: FifoState) -> int:
    return len(state.consumers)


def query_processes(state: FifoState) -> list:
    return sorted({repr(p) for p in state.enqueuers} |
                  {repr(p) for _, p in state.consumers})
