"""In-memory log backend.

Implements the per-server log contract the pure core depends on — the same
interface the durable log (ra_tpu_torch.log.durable) provides.  Modeled on the
reference's test double ra_log_memory.erl plus the parts
of the real facade contract the core observes (ra_log.erl):

* ``append``/``write`` are *asynchronous* with respect to durability: entries
  become readable immediately (memtable semantics) but ``last_written`` only
  advances when the owner processes a :class:`~ra_tpu_torch.core.types.WrittenEvent`
  (delivered via :meth:`take_events`).  The quorum arithmetic counts the
  leader's own ``last_written`` (ra_server.erl:2977-2987), so this async
  protocol is load-bearing even in memory.
* ``write`` at an index ≤ ``last_index`` truncates everything after the batch
  (overwrite semantics, ra_log.erl:315-330).
* meta (current_term / voted_for / last_applied) is stored synchronously,
  standing in for ra_log_meta.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from ..core.types import Entry, IdxTerm, SnapshotMeta, WrittenEvent
from ..metrics import LOG_FIELDS
from .snapshot import DEFAULT_SNAPSHOT_MODULE


class IntegrityError(Exception):
    pass


class MemoryLog:
    #: pluggable state serializer (Machine.snapshot_module override,
    #: ra_machine.erl:435-437); container format is module-agnostic
    #: True when term/voted_for/entries survive a process restart —
    #: gates supervised auto-restart (amnesia double-vote hazard)
    durable = False

    snapshot_module = DEFAULT_SNAPSHOT_MODULE

    def __init__(self, *, auto_written: bool = True,
                 first_index: int = 1) -> None:
        # idx -> Entry
        self._entries: dict[int, Entry] = {}
        self._last_index = first_index - 1
        self._last_term = 0
        self._first_index = first_index
        self._last_written = IdxTerm(first_index - 1, 0)
        self._auto_written = auto_written
        self._pending_events: list[WrittenEvent] = []
        # meta store (ra_log_meta stand-in)
        self._meta: dict[str, Any] = {"current_term": 0, "voted_for": None,
                                      "last_applied": 0}
        # snapshot: (SnapshotMeta, machine_state)
        self._snapshot: Optional[tuple] = None
        self._checkpoints: list[tuple] = []  # [(SnapshotMeta, machine_state)]
        # log-subsystem counters (RA_LOG_COUNTER_FIELDS, ra.hrl:236-268);
        # segment/WAL-specific fields stay 0 for the in-memory backend
        self.counters: dict[str, int] = {f: 0 for f in LOG_FIELDS}

    def log_metrics(self) -> dict:
        """Counter snapshot for key_metrics (ra.erl:1229-1257)."""
        return dict(self.counters)

    def wal_is_up(self) -> bool:
        """In-memory log has no WAL thread to die."""
        return True

    # -- ranges -------------------------------------------------------------

    def last_index_term(self) -> IdxTerm:
        return IdxTerm(self._last_index, self._last_term)

    def last_written(self) -> IdxTerm:
        return self._last_written

    def first_index(self) -> int:
        return self._first_index

    def next_index(self) -> int:
        return self._last_index + 1

    def note_applied(self, idx: int) -> None:
        """The server's apply watermark: nothing to release in memory."""

    # -- writes -------------------------------------------------------------

    def append(self, entry: Entry) -> None:
        """Leader-path append; index must be exactly next_index
        (ra_log:append/2 errors on integrity violation)."""
        if entry.index != self._last_index + 1:
            raise IntegrityError(
                f"append gap: {entry.index} != {self._last_index + 1}")
        self.counters["write_ops"] += 1
        self._entries[entry.index] = entry
        self._last_index = entry.index
        self._last_term = entry.term
        self._queue_written(entry.index, entry.index, entry.term)

    def append_batch(self, entries: list, payloads=None) -> None:
        """Leader-path batch append: contiguous strictly-new
        entries, ONE queued written event for the whole run (the batch
        twin of :meth:`append`; ``payloads`` — pre-encoded durable
        images — is accepted for interface parity and ignored, this
        backend keeps no bytes)."""
        if not entries:
            return
        if entries[0].index != self._last_index + 1:
            raise IntegrityError(
                f"append gap: {entries[0].index} != "
                f"{self._last_index + 1}")
        self.counters["write_ops"] += len(entries)
        for e in entries:
            self._entries[e.index] = e
        last = entries[-1]
        self._last_index = last.index
        self._last_term = last.term
        # one confirm for the run: terms are uniform by construction
        # (a leader appends in its own term), so the range event is
        # exactly what the per-entry events would have coalesced into
        self._queue_written(entries[0].index, last.index, last.term)

    def write(self, entries: list, payloads=None) -> None:
        """Follower-path write; may overwrite.  First index must be within
        [first_index, last_index+1]; everything after the batch is
        truncated.  ``payloads`` (pre-encoded durable images shipped in
        the AER) is ignored — this backend keeps no bytes."""
        if not entries:
            return
        first = entries[0].index
        if first > self._last_index + 1:
            raise IntegrityError(
                f"write gap: {first} > {self._last_index + 1}")
        self.counters["write_ops"] += len(entries)
        # an overwrite invalidates previous confirms over the rewritten
        # range: rewind last_written to the real predecessor BEFORE the
        # batch lands, so AER replies stay truthful (DurableLog._put does
        # the same; a stale (index, old-term) confirm here livelocks the
        # leader's stale-suffix repair)
        if self._last_written.index >= first:
            prev = first - 1
            self._last_written = IdxTerm(prev, self.fetch_term(prev) or 0)
        for e in entries:
            self._entries[e.index] = e
        last = entries[-1]
        # truncate any stale tail
        for idx in range(last.index + 1, self._last_index + 1):
            self._entries.pop(idx, None)
        self._last_index = last.index
        self._last_term = last.term
        self._queue_written(first, last.index, last.term)

    def set_last_index(self, idx: int) -> None:
        """Truncate back so last index == idx (ra_log:set_last_index,
        used when a valid leader shows a shorter log, ra_server.erl:1058)."""
        if idx >= self._last_index:
            return
        for i in range(idx + 1, self._last_index + 1):
            self._entries.pop(i, None)
        term = self.fetch_term(idx) or 0
        self._last_index = idx
        self._last_term = term
        if self._last_written.index > idx:
            self._last_written = IdxTerm(idx, term)

    def _queue_written(self, from_idx: int, to_idx: int, term: int) -> None:
        if self._auto_written:
            self._pending_events.append(WrittenEvent(from_idx, to_idx, term))

    # -- async written-event protocol --------------------------------------

    def take_events(self) -> list:
        evts, self._pending_events = self._pending_events, []
        return evts

    def release_written(self, from_idx: int, to_idx: int, term: int) -> None:
        """Manual mode: tests script the WAL confirm."""
        self._pending_events.append(WrittenEvent(from_idx, to_idx, term))

    def handle_written(self, evt: WrittenEvent) -> None:
        """Owner processed a written event: advance last_written if the
        entries still match (term check guards against overwrites,
        ra_log.erl:474-529)."""
        term = self.fetch_term(evt.to_index)
        if term == evt.term:
            if evt.to_index > self._last_written.index:
                self._last_written = IdxTerm(evt.to_index, evt.term)
        elif term is None and self._snapshot is not None and \
                self._snapshot[0].index >= evt.to_index:
            # entries already truncated by a snapshot: written info subsumed
            pass
        # else: stale write for an overwritten term — ignore (the real log
        # triggers resend_from; the memory log has nothing to resend)

    def reset_to_last_known_written(self) -> None:
        lw = self._last_written
        self.set_last_index(lw.index)

    # -- reads --------------------------------------------------------------

    def fetch(self, idx: int) -> Optional[Entry]:
        self.counters["read_ops"] += 1
        e = self._entries.get(idx)
        if e is not None:
            self.counters["read_cache"] += 1
        return e

    def fetch_term(self, idx: int) -> Optional[int]:
        self.counters["fetch_term"] += 1
        if self._snapshot is not None and idx == self._snapshot[0].index:
            return self._snapshot[0].term
        e = self._entries.get(idx)
        return e.term if e is not None else None

    def exists(self, idx: int, term: int) -> bool:
        return self.fetch_term(idx) == term

    def fold(self, from_idx: int, to_idx: int,
             fn: Callable[[Entry, Any], Any], acc: Any) -> Any:
        for i in range(from_idx, to_idx + 1):
            e = self._entries.get(i)
            if e is None:
                continue
            acc = fn(e, acc)
        return acc

    def read_range(self, from_idx: int, to_idx: int) -> list:
        return [self._entries[i]
                for i in range(from_idx, to_idx + 1) if i in self._entries]

    def sparse_read(self, indexes: Iterable[int]) -> list:
        return [self._entries[i] for i in indexes if i in self._entries]

    # -- meta ---------------------------------------------------------------

    def store_meta(self, sync: bool = True, **kv: Any) -> None:
        self._meta.update(kv)

    def fetch_meta(self, key: str, default: Any = None) -> Any:
        return self._meta.get(key, default)

    # -- snapshots ----------------------------------------------------------

    def snapshot_index_term(self) -> IdxTerm:
        if self._snapshot is None:
            return IdxTerm(0, 0)
        meta = self._snapshot[0]
        return IdxTerm(meta.index, meta.term)

    def snapshot_meta(self):
        """The current snapshot's metadata (in-memory; no data read)."""
        return self._snapshot[0] if self._snapshot is not None else None

    def checkpoint_index(self) -> int:
        """Newest checkpoint index, 0 if none (ra.hrl:378)."""
        return self._checkpoints[-1][0].index if self._checkpoints else 0

    def snapshot(self) -> Optional[tuple]:
        return self._snapshot

    def update_release_cursor(self, idx: int, cluster: tuple,
                              machine_version: int,
                              machine_state: Any) -> list:
        """Take a snapshot at idx if the entry exists; truncate ≤ idx.
        Memory log does this synchronously (the durable log spawns a
        writer, ra_snapshot.erl:357-398).  Returns effects (none here)."""
        term = self.fetch_term(idx)
        if term is None:
            return []
        meta = SnapshotMeta(index=idx, term=term, cluster=cluster,
                            machine_version=machine_version)
        data = self.snapshot_module.encode(machine_state)
        self._snapshot = (meta, data)
        self.counters["snapshots_written"] += 1
        self.counters["snapshot_bytes_written"] += len(data)
        self._truncate_to_snapshot(idx)
        return []

    def checkpoint(self, idx: int, cluster: tuple, machine_version: int,
                   machine_state: Any) -> list:
        term = self.fetch_term(idx)
        if term is None:
            return []
        meta = SnapshotMeta(index=idx, term=term, cluster=cluster,
                            machine_version=machine_version)
        data = self.snapshot_module.encode(machine_state)
        self._checkpoints.append((meta, data))
        self.counters["checkpoints_written"] += 1
        self.counters["checkpoint_bytes_written"] += len(data)
        # retention: keep at most 10 (ra.hrl:234)
        self._checkpoints = self._checkpoints[-10:]
        return []

    def promote_checkpoint(self, idx: int) -> bool:
        best = None
        for meta, st in self._checkpoints:
            if meta.index <= idx and (best is None or meta.index > best[0].index):
                best = (meta, st)
        if best is None:
            return False
        self._snapshot = best
        self.counters["checkpoints_promoted"] += 1
        self._checkpoints = [c for c in self._checkpoints
                             if c[0].index > best[0].index]
        self._truncate_to_snapshot(best[0].index)
        return True

    # -- chunk-incremental accept (same contract as DurableLog) -------------

    def begin_accept(self, meta: SnapshotMeta) -> None:
        self._accept = (meta, [])

    def accept_chunk(self, data: bytes, chunk_number: int,
                     chunk_crc: int = -1) -> bool:
        a = getattr(self, "_accept", None)
        if a is None:
            return False
        if chunk_number == 1 and a[1]:
            # transfer restarted from the top: drop the partial stream
            a = (a[0], [])
            self._accept = a
        if chunk_crc >= 0:
            import zlib
            if zlib.crc32(data) != chunk_crc:
                self._accept = None
                return False
        a[1].append(data)
        return True

    def complete_accept(self) -> bool:
        a = getattr(self, "_accept", None)
        if a is None:
            return False
        self._accept = None
        self.install_snapshot(a[0], b"".join(a[1]))
        return True

    def abort_accept(self) -> None:
        self._accept = None

    def install_snapshot(self, meta: SnapshotMeta, data: bytes) -> None:
        """Follower side: accept a complete streamed snapshot; truncates the
        whole log below/at the snapshot index (ra_log:install_snapshot)."""
        self.counters["snapshot_installed"] += 1
        self._snapshot = (meta, data)
        self._entries = {i: e for i, e in self._entries.items()
                         if i > meta.index}
        self._first_index = meta.index + 1
        if self._last_index < meta.index:
            self._last_index = meta.index
            self._last_term = meta.term
        self._last_written = IdxTerm(max(self._last_written.index, meta.index),
                                     meta.term if
                                     self._last_written.index <= meta.index
                                     else self._last_written.term)

    def recover_snapshot_state(self) -> Optional[tuple]:
        """Returns (SnapshotMeta, machine_state) or None."""
        if self._snapshot is None:
            return None
        meta, data = self._snapshot
        if not self.snapshot_module.validate(data):
            raise ValueError(
                "snapshot rejected by snapshot module "
                f"{self.snapshot_module.name!r} (format mismatch?)")
        return meta, self.snapshot_module.decode(data)

    # the mock log keeps no checkpoints: the snapshot is the only
    # machine-state base (uniform log interface for server recovery)
    recover_machine_base = recover_snapshot_state

    def snapshot_data(self) -> bytes:
        assert self._snapshot is not None
        return self._snapshot[1]

    def _truncate_to_snapshot(self, idx: int) -> None:
        for i in list(self._entries):
            if i <= idx:
                del self._entries[i]
        self._first_index = idx + 1

    # -- misc ---------------------------------------------------------------

    def tick(self, now_ms: float) -> list:
        return []

    def close(self) -> None:
        pass

    def overview(self) -> dict:
        return {
            "type": "memory",
            "last_index": self._last_index,
            "last_term": self._last_term,
            "first_index": self._first_index,
            "last_written_index_term": tuple(self._last_written),
            "num_entries": len(self._entries),
            "snapshot_index_term": tuple(self.snapshot_index_term()),
        }
