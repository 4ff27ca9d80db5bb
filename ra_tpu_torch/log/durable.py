"""DurableLog — the per-server log facade over WAL + segments + snapshots.

Same contract as ra_tpu_torch.log.memory.MemoryLog (the interface the pure core
consumes), with real durability.  Mirrors ra_log.erl's division:

* recent entries live in the in-process memtable and are readable
  immediately; durability is observed through written events delivered by
  the WAL after batch fsync (:474-529) — take_events() surfaces them to
  the shell exactly like the memory log
* the leader's own confirm participates in commit quorum; gap/resend and
  stale-term confirms are handled in handle_written (:521-529, :641-644)
* on WAL rollover the segment writer drains the memtable to this server's
  segment files (flush_mem_to_segments) and prunes it (:534-574)
* snapshots truncate segments and the memtable (:575-640); checkpoints
  don't truncate; promote_checkpoint renames one into the snapshot slot
  (ra_snapshot.erl:399-448); chunked accept for streamed installs
* recovery: meta file + latest valid snapshot + segment ranges + WAL
  recovered tables (:170-277 and §3.4 of SURVEY.md)

Layout under <data_dir>/<uid>/:
  meta                 pickled dict (current_term, voted_for, last_applied)
  NNNNNNNN.segment     segment files
  snapshot/snap_<idx>_<term>.rtsn
  checkpoints/cp_<idx>_<term>.rtsn
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Callable, Iterable, Optional

from ..convert import loads as _classic_loads
from ..core.types import (Entry, IdxTerm, SnapshotMeta, WalUpEvent,
                          WrittenEvent)
from ..metrics import LOG_FIELDS
from ..utils.flru import Flru
from .faults import IO, note as _fault_note
from .segment import DEFAULT_MAX_COUNT, SegmentFile
from .snapshot import DEFAULT_SNAPSHOT_MODULE

#: open segment fds per server (ra_flru's open_segments cap,
#: ra_log_reader.erl:45-49)
MAX_OPEN_SEGMENTS = 5

SNAP_MAGIC = b"RTSN"
_SNAP_HDR = struct.Struct("<4sII")  # magic, version, crc(meta+state)

#: sentinel for "not answerable from memtable/snapshot alone" — the
#: under-_lock half of a term lookup returns it instead of falling
#: through to a segment read (_io_lock), see _mem_term_locked (RA11)
_MISS = object()

MAX_CHECKPOINTS = 10  # ra.hrl:234

#: the durable command image is owned by ra_tpu_torch.codec —
#: one schema'd layout from socket to segment, with the pre-codec 0x01
#: fast-tuple frame and raw-pickle images kept as decode-only legacy
#: branches so r06-era WAL/segment dirs still recover.  Re-exported here
#: because every log-plane consumer (and lint rule RA10's encoder-name
#: resolution) imports the pair from this module.
from ..codec import decode_command, encode_command  # noqa: E402  (re-export)


def _has_handle(entry: Entry) -> bool:
    """Whether an entry's command carries a process-local reply or
    notification handle (a future or a callable), which its durable image
    drops (``codec._handle``)."""
    cmd = entry.command
    return any(h is not None and not isinstance(h, (str, int, tuple))
               for h in (getattr(cmd, "from_", None),
                         getattr(cmd, "notify_to", None)))


def _write_snapshot_file(path: str, meta: SnapshotMeta, data: bytes) -> None:
    """Pending-dir discipline: the container is written+fsynced to a
    ``.partial`` sibling and only then renamed into the slot, so a torn
    write can NEVER shadow a good snapshot — on any I/O error the
    OSError propagates before the rename and the old container stays
    authoritative.  Writes ride the storage I/O shim (fault-injectable,
    log/faults.py)."""
    meta_b = pickle.dumps(meta)
    body = struct.pack("<I", len(meta_b)) + meta_b + data
    crc = IO.crc32(body)
    tmp = path + ".partial"
    fd = IO.random_open(tmp, truncate=True)
    try:
        IO.pwrite(fd, _SNAP_HDR.pack(SNAP_MAGIC, 1, crc) + body, 0)
        IO.sync(fd, 2)
    finally:
        IO.close(fd)
    os.replace(tmp, path)


def _drop_partial(path: str) -> None:
    """Remove the ``.partial`` leftover of a failed container write."""
    try:
        os.unlink(path + ".partial")
    except OSError:
        # safe to swallow: a stranded .partial can never shadow a real
        # container (recovery only reads fully-renamed files) — it only
        # leaks bytes until the next write truncates it
        _fault_note("swallowed_oserrors")


def _parse_snapshot_bytes(raw: bytes) -> Optional[tuple]:
    try:
        magic, _version, crc = _SNAP_HDR.unpack_from(raw, 0)
        body = raw[_SNAP_HDR.size:]
        if magic != SNAP_MAGIC or IO.crc32(body) != crc:
            return None
        (mlen,) = struct.unpack_from("<I", body, 0)
        meta = _classic_loads(body[4:4 + mlen])
        return meta, body[4 + mlen:]
    except Exception:
        return None


def _read_snapshot_file(path: str) -> Optional[tuple]:
    """Returns (meta, data) or None when invalid (validate,
    ra_log_snapshot.erl:112+).  A crc failure is retried ONCE with a
    fresh read: transient read-side corruption must not discard a good
    container (the fallback would silently rewind machine state to an
    older image)."""
    try:
        got = _parse_snapshot_bytes(IO.read_file(path))
        if got is None:
            got = _parse_snapshot_bytes(IO.read_file(path))
            if got is not None:
                # the fresh read validated: transient read-side
                # corruption caught by the container crc — a container
                # that fails BOTH reads is genuinely invalid (torn
                # write) and is not fault telemetry
                _fault_note("crc_catches")
        return got
    except Exception:
        return None


class LogReader:
    """External-reader handle over a DurableLog's segment-flushed entries
    (the registered-reader role, ra_log.erl:983-1008).  Reads resolve
    per-call under the log's io lock; while the reader is open, snapshot
    truncation pins (rather than deletes) covered segment files, so a
    slow reader never loses entries it could already see.  Entries still
    in the memtable (not yet segment-flushed) are NOT visible — the
    reference's external readers consume flushed segrefs only."""

    def __init__(self, log: "DurableLog", name: str) -> None:
        self._log = log
        self.name = name
        self._closed = False

    def fetch(self, idx: int) -> Optional[Entry]:
        got = self._log._reader_read(idx)
        if got is None:
            return None
        term, payload = got
        return Entry(idx, term, decode_command(payload))

    def sparse_read(self, indexes: Iterable[int]) -> list:
        out = []
        for i in indexes:
            e = self.fetch(i)
            if e is not None:
                out.append(e)
        return out

    def fold(self, from_idx: int, to_idx: int, fn: Callable,
             acc: Any) -> Any:
        for i in range(from_idx, to_idx + 1):
            e = self.fetch(i)
            if e is not None:
                acc = fn(e, acc)
        return acc

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._log.close_reader(self.name)

    def __enter__(self) -> "LogReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class DurableLog:
    #: pluggable state serializer (Machine.snapshot_module override,
    #: ra_machine.erl:435-437); container format is module-agnostic
    #: True when term/voted_for/entries survive a process restart —
    #: gates supervised auto-restart (amnesia double-vote hazard)
    durable = True

    snapshot_module = DEFAULT_SNAPSHOT_MODULE

    def __init__(self, uid: str, data_dir: str, wal, *,
                 segment_max_count: int = DEFAULT_MAX_COUNT) -> None:
        self.uid = uid
        self.dir = os.path.join(data_dir, uid)
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(os.path.join(self.dir, "snapshot"), exist_ok=True)
        os.makedirs(os.path.join(self.dir, "checkpoints"), exist_ok=True)
        self.wal = wal
        self.segment_max_count = segment_max_count
        self._lock = threading.RLock()
        # serializes segment-file I/O (flush vs snapshot truncation vs
        # reads); ordering discipline: _io_lock before _lock, never inverse
        self._io_lock = threading.Lock()
        self._events: list = []            # pending events for the shell
        # idx -> Entry: reads hand back the stored object, so the apply
        # fold and AER build pay ZERO per-entry construction (the
        # Entry-per-read rebuild was ~5 namedtuple ctors per command on
        # the classic plane)
        self._memtable: dict[int, Entry] = {}
        self._mem_bytes: dict[int, bytes] = {}  # idx -> payload (for flush)
        #: the server's apply watermark (note_applied), and the memtable
        #: entries a segment flush kept because the apply has yet to read
        #: their process-local reply handle (idx -> the kept Entry)
        self._applied = 0
        self._kept: dict[int, Entry] = {}
        # creation order, newest LAST — load-bearing: _segment_read scans
        # reversed so a newer segment's entries supersede older ones where
        # they overlap, and _current_segment appends to [-1]
        self._segments: list[SegmentFile] = []
        # caps open descriptors: indexes stay in memory, evicted segments
        # reopen transparently on the next read (guarded by _io_lock)
        self._open_segments = Flru(
            MAX_OPEN_SEGMENTS, on_evict=lambda _path, seg: seg.close_fd())
        self._seg_seq = 0
        self._last_index = 0
        self._last_term = 0
        self._last_written = IdxTerm(0, 0)
        self._first_index = 1
        self._meta: dict = {"current_term": 0, "voted_for": None,
                            "last_applied": 0}
        self._snapshot: Optional[tuple] = None  # (meta, path)
        self._checkpoints: list[tuple] = []     # [(meta, path)] sorted asc
        self._truncate_next = False
        #: registered external readers (ra_log.erl:983-1008) and segments
        #: kept alive for them past a snapshot truncation.  name -> count:
        #: two consumers may register under the same name; the pins hold
        #: until the LAST registration closes
        self._readers: dict = {}
        self._pinned_segments: list = []
        #: log-subsystem counters (RA_LOG_COUNTER_FIELDS, ra.hrl:236-268);
        #: GIL-atomic dict increments, merged into key_metrics
        self.counters: dict[str, int] = {f: 0 for f in LOG_FIELDS}
        #: in-flight chunked snapshot accept stream (begin_accept)
        self._accept: Optional[dict] = None
        #: WAL incarnation this log has resent its unconfirmed tail to
        #: (the new-wal-pid check of ra_log.erl:778-793, kept per-put so
        #: no append can race the supervisor's resend hook)
        self._wal_generation = wal.generation
        self._recover_state()
        wal.register(uid, self._wal_notify)

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------

    def _recover_state(self) -> None:
        meta_path = os.path.join(self.dir, "meta")
        if os.path.exists(meta_path):
            try:
                with open(meta_path, "rb") as f:
                    self._meta.update(_classic_loads(f.read()))
            except Exception:
                pass
        # newest valid snapshot wins; fall back to older ones
        # (ra_snapshot.erl:183-222)
        snapdir = os.path.join(self.dir, "snapshot")
        # a stale accept stream from an interrupted install is garbage:
        # the leader restarts the transfer from chunk 1
        stale_accept = os.path.join(snapdir, "accept.partial")
        if os.path.exists(stale_accept):
            os.unlink(stale_accept)
        cands = sorted(os.listdir(snapdir), reverse=True)
        for fname in cands:
            got = _read_snapshot_file(os.path.join(snapdir, fname))
            if got is not None:
                self._snapshot = (got[0], os.path.join(snapdir, fname))
                break
        cpdir = os.path.join(self.dir, "checkpoints")
        for fname in sorted(os.listdir(cpdir)):
            got = _read_snapshot_file(os.path.join(cpdir, fname))
            if got is not None:
                self._checkpoints.append((got[0],
                                          os.path.join(cpdir, fname)))
        snap_idx = self._snapshot[0].index if self._snapshot else 0
        # segments in creation order, newest last: a newer segment's
        # entries supersede older ones wherever they overlap
        # (ra_log_reader:update_segments compaction, :93-108), and the
        # NEWEST segment defines the durable tail — an older segment
        # holding higher indexes is a stale tail from before an overwrite
        found = []
        for fname in sorted(os.listdir(self.dir)):
            if fname.endswith(".trunc"):
                # leftover of a truncate_from interrupted between writing
                # the fresh copy and the atomic rename — always safe to
                # delete (the original segment was only ever replaced
                # atomically, so it is still intact)
                try:
                    os.unlink(os.path.join(self.dir, fname))
                except FileNotFoundError:
                    pass
                continue
            if not fname.endswith(".segment"):
                continue
            seq = int(fname.split(".")[0])
            self._seg_seq = max(self._seg_seq, seq)
            try:
                seg = SegmentFile(os.path.join(self.dir, fname))
            except (ValueError, struct.error):
                continue  # corrupt header/index: skip the file
            # NB: OSError deliberately propagates — EMFILE/EIO here is an
            # environment fault; swallowing it would drop committed
            # entries and report a short log as healthy
            r = seg.range()
            if r is None or r[1] <= snap_idx:
                # empty, or wholly covered by the snapshot: a pinned
                # segment left behind by a shutdown with an open reader —
                # dead weight below first_index, reclaim it now
                seg.close()
                os.unlink(os.path.join(self.dir, fname))
                continue
            found.append((seq, seg))
            # enforce the fd cap DURING the scan: a long log would
            # otherwise hold every fd open until the post-scan eviction
            self._open_segments.touch(seg.path, seg)
        found.sort(key=lambda p: p[0])
        self._segments = [seg for _seq, seg in found]
        last, last_term = 0, 0
        if self._segments:
            lo, hi = self._segments[-1].range()
            last = hi
            last_term = self._segments[-1].read(hi)[0]
        # WAL recovered entries (newer than segments).  If a WAL entry
        # CONFLICTS with segment content at the same index (different
        # term), that write overwrote the log from there: segment entries
        # above the WAL table's own tail are stale and must not define
        # last_index (the ra_log init equivalent: the memtable range wins
        # over overlapping segment refs, ra_log.erl:199-277).  The term
        # comparison matters: a retained stale WAL file (kept because
        # another uid on the node was unresolved at flush time) overlaps
        # already-flushed segments with *agreeing* terms, and rewinding on
        # mere overlap would lose acknowledged entries above it.  Checked
        # against the RAW table — the snapshot floor is applied after,
        # else a snapshot covering the overwrite record hides the
        # truncation and resurrects the stale segment tail.
        wal_items = sorted(self.wal.recovered_table(self.uid).items())
        for idx, (term, _payload) in wal_items:
            if idx > last:
                break
            got = self._segment_read(idx)
            if got is not None and got[0] != term:
                last = wal_items[-1][0]
                last_term = wal_items[-1][1][0]
                break
        for idx, (term, payload) in wal_items:
            if idx <= snap_idx:
                continue
            cmd = decode_command(payload)
            self._memtable[idx] = Entry(idx, term, cmd)
            self._mem_bytes[idx] = payload
            if idx >= last:
                last, last_term = idx, term
        # contiguity clamp: a Raft log can never have holes.  A crash
        # that lost an unconfirmed torn batch while later entries
        # reached a newer WAL file would otherwise recover a
        # committed-LOOKING tail over a missing middle — a log whose
        # last_index could win elections it must lose.  Those covered
        # indexes were never acknowledged by this node (confirmation is
        # contiguous by construction), so dropping everything above the
        # first gap presents an honest, strictly-shorter log that the
        # current leader simply back-fills.
        covered = set(self._memtable)
        for seg in self._segments:
            covered.update(seg.index)
        probe = snap_idx
        while probe + 1 in covered:
            probe += 1
        if probe < last:
            import logging
            logging.getLogger("ra_tpu_torch").warning(
                "%s: recovery found a log hole above %d (tail was %d); "
                "truncating to the contiguous prefix", self.uid, probe,
                last)
            for k in [k for k in self._memtable if k > probe]:
                self._memtable.pop(k, None)
                self._mem_bytes.pop(k, None)
            last = probe
            if probe == snap_idx and self._snapshot is not None:
                last_term = self._snapshot[0].term
            elif probe in self._memtable:
                last_term = self._memtable[probe].term
            else:
                got = self._segment_read(probe) if probe else None
                last_term = got[0] if got else 0
        if snap_idx > last:
            last, last_term = snap_idx, self._snapshot[0].term
        self._last_index, self._last_term = last, last_term
        self._last_written = IdxTerm(last, last_term)
        self._first_index = snap_idx + 1

    # ------------------------------------------------------------------
    # WAL callback (runs on the WAL thread)
    # ------------------------------------------------------------------

    def _wal_notify(self, uid: str, lo: Optional[int], hi: int,
                    term: int) -> None:
        rewind_term = 0
        if lo is None and term == -2:
            # pre-read OUTSIDE the log lock (rule RA11, the
            # _put/_put_batch overwrite-rewind idiom): fetch_term can
            # fall through to a segment read (_io_lock), and
            # _io_lock-inside-_lock inverts the documented io-then-log
            # order against flush_mem_to_segments — the ABBA class once
            # fixed on the append path survived here until the RA11
            # analyzer flagged it.  Safe unlocked: the guard
            # below re-checks last_written under _lock before applying,
            # and an overwrite racing this read either starts <= hi
            # (rewinding last_written below hi, so the guard fails) or
            # starts above hi (leaving the term at hi untouched).  A
            # concurrent snapshot INSTALL is the remaining race (it
            # prunes <= meta.index and would leave this pre-read
            # stale), so the rewind branch re-resolves via
            # _mem_term_locked and only falls back to this value for a
            # segment-resident hi — segment terms are immutable.
            rewind_term = self.fetch_term(hi) or 0
        with self._lock:
            if lo is None:
                # resend_from: re-submit memtable entries above hi
                # (ra_log.erl:1125+).  Floor-clamped to last_written:
                # entries at/below it are durable in an EARLIER file or
                # segment and must not be re-written — a duplicate of a
                # durable entry in a LATER wal file trips the recovery
                # overwrite-dedup ("a lower index invalidates higher
                # ones") and, if that later file tears, wipes durable
                # entries from the recovered table (found by the
                # poison/rollover chaos).
                if term == -2 and self._last_written.index > hi:
                    # unsynced-confirm rewind (the sync_after_notify
                    # poison path): confirms above ``hi`` rode a
                    # durability syscall that then FAILED, so they are
                    # not durable anywhere but the poisoned file — pull
                    # last_written back so the floor clamp below
                    # re-writes that suffix into the fresh file instead
                    # of trusting the poisoned one (the entries are
                    # still memtable-resident: pruning only happens at
                    # segment flush, which is gated on last_written)
                    got = self._mem_term_locked(hi)
                    if got is None and self._snapshot is not None and \
                            self._snapshot[0].index >= hi:
                        # a snapshot install landed between the
                        # pre-read and this lock and pruned <= hi.
                        # Entries up to the snapshot are durable via
                        # the snapshot — but the poisoned confirms may
                        # cover memtable entries ABOVE it, so clamp
                        # last_written to the snapshot (never below:
                        # that would stamp a stale term under durable
                        # state) and let the floor clamp below resend
                        # exactly the (snapshot, last_index] suffix
                        snap = self._snapshot[0]
                        if self._last_written.index > snap.index:
                            self._last_written = IdxTerm(snap.index,
                                                         snap.term)
                    else:
                        if got is not None and got is not _MISS:
                            rewind_term = got  # fresher than pre-read
                        self._last_written = IdxTerm(hi, rewind_term)
                start = max(hi, self._last_written.index) + 1
                for idx in range(start, self._last_index + 1):
                    ent = self._memtable.get(idx)
                    raw = self._mem_bytes.get(idx)
                    if ent is not None and raw is not None:
                        self.counters["write_resends"] += 1
                        self.wal.write(self.uid, idx, ent.term, raw)
                return
            self._events.append(WrittenEvent(lo, hi, term))

    def wal_restarted(self) -> None:
        """Supervisor hook after Wal.restart(): resend every memtable
        entry above last_written to the new WAL incarnation, then surface
        a WalUpEvent so a core parked in await_condition(wal_down)
        resumes.  This is the writer half of the reference's new-wal-pid
        resend (ra_log.erl:778-793): everything confirmed durable stays
        put; everything submitted-but-unconfirmed goes again.

        The whole collect+resend runs under the log lock — _put submits
        under the same lock, so no live append can reach the new queue
        ahead of these resends and advance last_written over a hole."""
        with self._lock:
            if not self._resend_unconfirmed_locked():
                return  # died again mid-resend; the supervisor retries
            self._events.append(WalUpEvent(self.wal.generation))

    def _resend_unconfirmed_locked(self) -> bool:
        """Resend every memtable entry above last_written to the current
        WAL incarnation and record its generation as synced-with.  MUST
        run under self._lock.  Returns False when the WAL died again
        mid-resend (the generation stays unsynced, so the next caller
        retries)."""
        from .wal import WalDown
        self._wal_generation = self.wal.generation
        lw = self._last_written.index
        items = [(i, self._memtable[i].term, self._mem_bytes[i])
                 for i in sorted(self._mem_bytes)
                 if lw < i <= self._last_index]
        try:
            for idx, term, raw in items:
                self.counters["write_resends"] += 1
                self.wal.write(self.uid, idx, term, raw)  # ra10-ok: crash-recovery resend, not the steady-state path
        except WalDown:
            self._wal_generation = -1  # resend incomplete: retry later
            return False
        return True

    # ------------------------------------------------------------------
    # log contract (same as MemoryLog)
    # ------------------------------------------------------------------

    def wal_is_up(self) -> bool:
        """Health probe for the core's wal_down await_condition: True when
        the fan-in batch thread is accepting writes."""
        return self.wal.alive

    def log_metrics(self) -> dict:
        """Counter snapshot for key_metrics (ra.erl:1229-1257);
        open_segments is sampled live (a gauge, ra.hrl:258)."""
        out = dict(self.counters)
        out["open_segments"] = len(self._open_segments)
        return out

    def last_index_term(self) -> IdxTerm:
        return IdxTerm(self._last_index, self._last_term)

    def last_written(self) -> IdxTerm:
        return self._last_written

    def first_index(self) -> int:
        return self._first_index

    def next_index(self) -> int:
        return self._last_index + 1

    def append(self, entry: Entry) -> None:
        if entry.index != self._last_index + 1:
            from .memory import IntegrityError
            raise IntegrityError(
                f"append gap: {entry.index} != {self._last_index + 1}")
        self._put(entry)

    def append_batch(self, entries: list,
                     payloads: Optional[list] = None) -> None:
        """Leader-path batch append: strictly-appending
        contiguous entries, one lock acquisition and ONE WAL fan-in
        submit for the whole run — the per-entry ``append`` path costs
        a lock cycle plus a WAL queue hand-off per entry, which at
        group-commit rates dominates the event-loop thread."""
        if not entries:
            return
        if entries[0].index != self._last_index + 1:
            from .memory import IntegrityError
            raise IntegrityError(
                f"append gap: {entries[0].index} != "
                f"{self._last_index + 1}")
        self._put_batch(entries, payloads)

    def write(self, entries: list,
              payloads: Optional[list] = None) -> None:
        """Follower-path batch write (may overwrite).  ``payloads`` —
        encoded durable images parallel to ``entries`` shipped inside
        the AppendEntries frame (the leader already paid the encode for
        its own WAL) — lets the whole batch reach the WAL without one
        pickle per entry (rule RA10)."""
        if not entries:
            return
        first = entries[0].index
        if first > self._last_index + 1:
            from .memory import IntegrityError
            raise IntegrityError(
                f"write gap: {first} > {self._last_index + 1}")
        self._put_batch(entries, payloads)

    def _put_batch(self, entries: list,
                   payloads: Optional[list] = None) -> None:
        """Shared batch insert: encode what wasn't shipped, handle the
        overwrite rewind ONCE for the run, bulk-load the memtable, and
        hand the WAL one contiguous fan-in submit."""
        if payloads is None or len(payloads) != len(entries):
            # local/fallback encode — the leader's own append, or a
            # catch-up resend whose source bytes were segment-flushed.
            # This is the classic plane's encode phase stamp:
            # wire-shipped batches skip this branch entirely, so a
            # falling encode_share_pct is the encode-once proof.
            ph = self.wal.phases
            t0 = time.monotonic() if ph is not None else 0.0
            payloads = [encode_command(e.command)  # ra10-ok: fallback when no shipped payloads ride the frame
                        for e in entries]
            if ph is not None:
                ph.note("encode", time.monotonic() - t0)
        self.counters["write_ops"] += len(entries)
        first = entries[0].index
        last_e = entries[-1]
        # resolve the overwrite-rewind predecessor term BEFORE taking
        # the log lock: fetch_term can fall through to a segment read
        # (_io_lock), and _io_lock-inside-_lock inverts the documented
        # lock order against flush_mem_to_segments (ABBA).  Safe to
        # pre-read: entry terms are immutable and only this (event
        # loop) thread writes/truncates the log.
        rewind_term = 0
        if first <= self._last_index and first > 1:
            rewind_term = self.fetch_term(first - 1) or 0
        with self._lock:
            if first <= self._last_index:
                # overwrite: invalidate the stale tail above the batch
                # head; rewind last_written so AER replies stay truthful
                # (the same discipline as _put, once per run)
                for k in range(last_e.index + 1, self._last_index + 1):
                    self._memtable.pop(k, None)
                    self._mem_bytes.pop(k, None)
                if self._last_written.index >= first:
                    self._last_written = IdxTerm(first - 1, rewind_term)
            memtable = self._memtable
            mem_bytes = self._mem_bytes
            items = []
            truncate = self._truncate_next
            self._truncate_next = False
            for e, payload in zip(entries, payloads):
                memtable[e.index] = e
                mem_bytes[e.index] = payload
                items.append((e.index, e.term, payload, truncate))
                truncate = False
            self._last_index = last_e.index
            self._last_term = last_e.term
            # submit under the log lock (queue.put only — no blocking);
            # same resend-before-submit generation discipline as _put
            if getattr(self, "_wal_generation", None) != \
                    self.wal.generation:
                self._resend_unconfirmed_locked()
            self.wal.write_many(self.uid, items)

    def _put(self, entry: Entry) -> None:
        # live reply handles are process-local: stripped from the durable
        # image (the memtable keeps the full command for leader replies)
        payload = encode_command(entry.command)
        self.counters["write_ops"] += 1
        # pre-read like _put_batch: a fetch_term miss under _lock would
        # take _io_lock and invert the lock order (ABBA vs segment flush)
        rewind_term = 0
        if entry.index <= self._last_index and entry.index > 1:
            rewind_term = self.fetch_term(entry.index - 1) or 0
        with self._lock:
            if entry.index <= self._last_index:
                # overwrite: invalidate the stale tail; rewind last_written
                # to the real predecessor term so AER replies stay truthful
                for k in range(entry.index + 1, self._last_index + 1):
                    self._memtable.pop(k, None)
                    self._mem_bytes.pop(k, None)
                if self._last_written.index >= entry.index:
                    self._last_written = IdxTerm(entry.index - 1,
                                                 rewind_term)
            self._memtable[entry.index] = entry
            self._mem_bytes[entry.index] = payload
            self._last_index = entry.index
            self._last_term = entry.term
            truncate = self._truncate_next
            self._truncate_next = False
            # submit under the log lock (queue.put only — no blocking):
            # wal_restarted() holds the same lock across its resend batch,
            # so a live append can never slip into the restarted WAL's
            # queue AHEAD of the resends of a durability hole below it.
            # Generation guard: a restarted WAL resets the per-writer
            # sequence check, so a first write racing the SUPERVISOR'S
            # resend hook would be accepted ABOVE a durability hole — if
            # the WAL then dies again before the resend lands, the
            # on-disk log has a committed-looking tail over a missing
            # middle (a log that could win elections it must lose).
            # Resend-before-submit closes the window; the supervisor's
            # later call is an idempotent no-op for covered entries.
            if getattr(self, "_wal_generation", None) != \
                    self.wal.generation:
                self._resend_unconfirmed_locked()
            self.wal.write(self.uid, entry.index, entry.term, payload,
                           truncate=truncate)

    def set_last_index(self, idx: int) -> None:
        if idx >= self._last_index:
            return
        # pre-read OUTSIDE the log lock (rule RA11, the _put/_put_batch
        # idiom): a fetch_term miss under _lock would take _io_lock and
        # invert the documented io-then-log order.  Race-free: terms
        # are immutable at a given index until overwritten, and only
        # the event-loop thread that calls this truncates/overwrites.
        term = self.fetch_term(idx) or 0
        with self._lock:
            if idx >= self._last_index:
                return
            for i in range(idx + 1, self._last_index + 1):
                self._memtable.pop(i, None)
                self._mem_bytes.pop(i, None)
            self._last_index, self._last_term = idx, term
            if self._last_written.index > idx:
                self._last_written = IdxTerm(idx, term)

    def reset_to_last_known_written(self) -> None:
        self.set_last_index(self._last_written.index)

    # -- events -------------------------------------------------------------

    def take_events(self) -> list:
        with self._lock:
            evts, self._events = self._events, []
        return evts

    def handle_written(self, evt: WrittenEvent,
                       _seg: tuple = (None, None)) -> None:
        with self._lock:
            if evt.from_index > self._last_written.index + 1 and \
                    evt.from_index <= self._last_index:
                # contiguity guard: a confirm above a durability hole
                # (e.g. an append that raced a post-crash resend) must not
                # advance last_written past entries no WAL file holds.
                # An index in (last_written, from_index) that has LEFT the
                # memtable is already durable — the only exits are a
                # segment flush or a snapshot truncation — so only
                # memtable-resident hole entries need a resend; if there
                # are none, the confirm is safe to accept as-is.
                first_resident = next(
                    (i for i in range(self._last_written.index + 1,
                                      evt.from_index)
                     if i in self._mem_bytes), None)
                if first_resident is not None:
                    # drop the confirm and resend the resident span up to
                    # to_index so confirms re-arrive contiguously
                    # (ra_log's written-event ordering invariant,
                    # ra_log.erl:474-529)
                    for idx in range(first_resident, evt.to_index + 1):
                        ent = self._memtable.get(idx)
                        raw = self._mem_bytes.get(idx)
                        if ent is not None and raw is not None:
                            self.counters["write_resends"] += 1
                            self.wal.write(self.uid, idx, ent.term, raw)
                    return
            if evt.from_index > self._last_index:
                # reverted below the whole range (explicit reset or
                # snapshot install raced the WAL): stale, drop
                # (ra_log.erl:474-481)
                return
            # clamp the confirm to the current tail BEFORE the term
            # check (ra_log.erl:495 ToIdx = min(ToIdx0, LastIdx)): a
            # coalesced batch confirm can cover an overwritten suffix
            # while its surviving prefix is genuinely durable
            to = min(evt.to_index, self._last_index)
            if to <= self._last_written.index:
                # duplicate/stale confirm: every branch below is a
                # no-op for an index already at/under last_written
                return
            term = self._mem_term_locked(to)
            if term is _MISS and _seg[0] == to:
                # resolved by the out-of-lock segment read below
                term = _seg[1]
            if term is not _MISS:
                if term == evt.term:
                    # to > last_written is guaranteed by the early
                    # return above (the lock is held throughout)
                    self._last_written = IdxTerm(to, term)
                elif term is None and self._snapshot is not None and \
                        self._snapshot[0].index >= to:
                    pass  # truncated by snapshot: subsumed
                # else: stale confirm for an overwritten term — ignored;
                # the rewrite is already queued to the WAL
                return
        # Memtable miss ABOVE last_written: the entry was flushed +
        # pruned to a segment before this confirm was processed — the
        # segment writer flushes up to the WAL FILE's range, which can
        # run ahead of the log's processed confirm watermark, so this
        # is a valid confirm for an already-segment-durable entry and
        # must still advance last_written.  Resolve the term WITHOUT
        # holding _lock (a segment read takes _io_lock; io-then-log is
        # the documented order, rule RA11) and re-enter: ``to`` is
        # stable across the round trip — evt is ours and _last_index
        # only moves on this event-loop thread — so the second pass
        # hits the ``_seg[0] == to`` branch and terminates.
        got = self._segment_read(to)
        self.handle_written(evt, _seg=(to, got[0] if got else None))

    # -- reads --------------------------------------------------------------

    def fetch(self, idx: int) -> Optional[Entry]:
        self.counters["read_ops"] += 1
        with self._lock:
            # entries at/below the snapshot index are truncated even when a
            # partially-covered segment still holds bytes for them
            if idx < self._first_index or idx > self._last_index:
                return None
            ent = self._memtable.get(idx)
            if ent is not None:
                self.counters["read_cache"] += 1
                return ent
        got = self._segment_read(idx)
        if got is None:
            return None
        term, payload = got
        return Entry(idx, term, decode_command(payload))

    def _segment_read(self, idx: int) -> Optional[tuple]:
        with self._io_lock:
            for seg in reversed(self._segments):
                r = seg.range()
                if r and r[0] <= idx <= r[1]:
                    self._open_segments.touch(seg.path, seg)
                    got = seg.read(idx)
                    if got is not None:
                        self.counters["read_segment"] += 1
                        return got
        return None

    def _mem_term_locked(self, idx: int):
        """Memtable/snapshot half of a term lookup; MUST run under
        self._lock.  Returns ``_MISS`` when only a segment read can
        answer — callers holding _lock must NOT fall through to
        ``_segment_read`` (it takes _io_lock; io-then-log is the
        documented order, rule RA11)."""
        if self._snapshot is not None and \
                idx == self._snapshot[0].index:
            return self._snapshot[0].term
        if idx < self._first_index or idx > self._last_index:
            return None
        ent = self._memtable.get(idx)
        if ent is not None:
            return ent.term
        return _MISS

    def fetch_term(self, idx: int) -> Optional[int]:
        self.counters["fetch_term"] += 1
        with self._lock:
            got = self._mem_term_locked(idx)
        if got is not _MISS:
            return got
        got = self._segment_read(idx)
        return got[0] if got else None

    def exists(self, idx: int, term: int) -> bool:
        return self.fetch_term(idx) == term

    def fold(self, from_idx: int, to_idx: int, fn: Callable,
             acc: Any) -> Any:
        for e in self.read_range(from_idx, to_idx):
            acc = fn(e, acc)
        return acc

    def read_range(self, from_idx: int, to_idx: int) -> list:
        """Batched range read: ONE lock cycle for the memtable pass
        (the hot case — AER building and the apply fold read recent
        entries), with per-index segment fallback for anything older
        (the per-index ``fetch`` path paid a lock per
        entry)."""
        out: list = []
        misses = 0
        with self._lock:
            lo = max(from_idx, self._first_index)
            hi = min(to_idx, self._last_index)
            if hi < lo:
                return out
            n = hi - lo + 1
            self.counters["read_ops"] += n
            mt = self._memtable
            for i in range(lo, hi + 1):
                ent = mt.get(i)
                if ent is not None:
                    out.append(ent)    # the stored Entry, no rebuild
                else:
                    out.append(i)  # placeholder: resolve via segments
                    misses += 1
            self.counters["read_cache"] += n - misses
        if misses:
            for k, v in enumerate(out):
                if type(v) is int:
                    got = self._segment_read(v)
                    out[k] = Entry(v, got[0], decode_command(got[1])) \
                        if got is not None else None
            out = [e for e in out if e is not None]
        return out

    def read_range_with_payloads(self, from_idx: int, to_idx: int,
                                 max_bytes: int = 0) -> Optional[tuple]:
        """(entries, payloads) for the memtable-resident contiguous
        prefix of [from_idx, to_idx] — the leader's AER build reads
        entries AND their already-encoded durable images in one lock
        cycle, so followers can feed their WAL without re-encoding
        (AppendEntriesRpc.payloads).  ``max_bytes`` > 0 caps
        the prefix at the frame byte budget.  None when the range head
        has left the memtable (segment-flushed catch-up) — the caller
        falls back to ``read_range`` with no payloads."""
        entries: list = []
        payloads: list = []
        total = 0
        with self._lock:
            if from_idx < self._first_index or \
                    to_idx > self._last_index or to_idx < from_idx:
                return None
            mt = self._memtable
            mb = self._mem_bytes
            for i in range(from_idx, to_idx + 1):
                ent = mt.get(i)
                raw = mb.get(i)
                if ent is None or raw is None:
                    break
                entries.append(ent)
                payloads.append(raw)
                total += len(raw)
                if max_bytes and total >= max_bytes:
                    break
            n = len(entries)
            self.counters["read_ops"] += n
            self.counters["read_cache"] += n
        if not entries:
            return None
        return entries, payloads

    def sparse_read(self, indexes: Iterable[int]) -> list:
        out = []
        for i in indexes:
            e = self.fetch(i)
            if e is not None:
                out.append(e)
        return out

    # -- meta ---------------------------------------------------------------

    def store_meta(self, sync: bool = True, **kv: Any) -> None:
        """Durable meta store.  term/voted_for fsync before the call
        returns (MUST hit disk before vote replies; stricter than the
        reference's batched ra_log_meta — votes are rare).  The lazy
        last_applied watermark passes sync=False: atomic replace without
        fsync, since losing it only costs effect-dedup precision."""
        with self._lock:
            self._meta.update(kv)
            data = pickle.dumps(self._meta)
        tmp = os.path.join(self.dir, "meta.partial")
        with open(tmp, "wb") as f:
            f.write(data)
            if sync:
                # rides the storage shim ("meta" fault class); an EIO
                # here MUST propagate — a vote reply over an unsynced
                # term/voted_for is the double-vote hazard
                f.flush()
                IO.sync(f.fileno(), 2, path_class="meta")
        os.replace(tmp, os.path.join(self.dir, "meta"))

    def fetch_meta(self, key: str, default: Any = None) -> Any:
        return self._meta.get(key, default)

    # -- segment flush (called by the SegmentWriter thread) -----------------

    def flush_mem_to_segments(self, up_to: int) -> tuple:
        """Drain the memtable to segment files; returns
        ``(entries, bytes, segments_created)`` for the segment writer's
        counters (ra_log_segment_writer.erl:37-52)."""
        with self._io_lock:
            with self._lock:
                snap_idx = self._snapshot[0].index if self._snapshot else 0
                items = sorted((i, self._mem_bytes[i],
                                self._memtable[i].term)
                               for i in self._mem_bytes
                               if i <= up_to and i > snap_idx
                               and i <= self._last_index)
                seq_before = self._seg_seq
            # skip entries already segment-durable with an AGREEING term
            # (e.g. recovered duplicates from a retained stale WAL file):
            # re-appending one at a lower index would trip the segment's
            # overwrite-invalidation (append ≤ existing wipes everything
            # above) and destroy durable entries the memtable no longer
            # holds.  A term MISMATCH is a genuine overwrite and must
            # still go through — invalidating the stale tail is then the
            # point.  (Inline segment scan: _io_lock is already held.)
            write_items = items
            if items:
                def _seg_term(idx: int):
                    for seg in reversed(self._segments):
                        r = seg.range()
                        if r and r[0] <= idx <= r[1]:
                            got = seg.read(idx)
                            if got is not None:
                                return got[0]
                    return None
                seg_hi = max((seg.range()[1] for seg in self._segments
                              if seg.range() is not None), default=0)
                write_items = [(i, p, t) for i, p, t in items
                               if i > seg_hi or _seg_term(i) != t]
            nbytes = 0
            if write_items:
                seg = self._current_segment()
                self._open_segments.touch(seg.path, seg)
                for idx, payload, term in write_items:
                    if not seg.append(idx, term, payload):
                        seg.flush()
                        seg = self._new_segment()
                        self._open_segments.touch(seg.path, seg)
                        seg.append(idx, term, payload)
                    nbytes += len(payload)
                seg.flush()
            with self._lock:
                # ra swaps memtable for segment refs (:534-574): drop both
                # copies; reads now resolve via the segment files.  The
                # skipped duplicates prune too — they are ALREADY durable
                # in a segment, which is what the prune asserts.  An entry
                # above the apply watermark that carries a reply handle
                # stays until note_applied passes it: the segment's codec
                # image drops the handle, and an apply reading it back
                # there would never answer the command (a departure from
                # the reference, which prunes it and loses the reply)
                for idx, _, _ in items:
                    ent = self._memtable.get(idx)
                    if idx > self._applied and ent is not None and \
                            _has_handle(ent):
                        self._kept[idx] = ent
                        continue
                    self._mem_bytes.pop(idx, None)
                    self._memtable.pop(idx, None)
                return (len(write_items), nbytes,
                        self._seg_seq - seq_before)

    def note_applied(self, idx: int) -> None:
        """The server applied through ``idx``: prune what a segment flush
        kept for the apply (entries still the kept object; an overwrite
        or truncation since has replaced or dropped the rest)."""
        self._applied = idx     # a flush racing this keeps more, never less
        if not self._kept:
            return
        with self._lock:
            for i in [i for i in self._kept if i <= idx]:
                ent = self._kept.pop(i)
                if self._memtable.get(i) is ent:
                    self._memtable.pop(i)
                    self._mem_bytes.pop(i, None)

    def _current_segment(self) -> SegmentFile:
        with self._lock:
            if self._segments and not self._segments[-1].full:
                return self._segments[-1]
            return self._new_segment()

    def _new_segment(self) -> SegmentFile:
        with self._lock:
            self._seg_seq += 1
            path = os.path.join(self.dir, f"{self._seg_seq:08d}.segment")
            seg = SegmentFile(path, self.segment_max_count, create=True)
            self._segments.append(seg)
            self._open_segments.touch(seg.path, seg)
            return seg

    # -- snapshots ----------------------------------------------------------

    def snapshot_index_term(self) -> IdxTerm:
        if self._snapshot is None:
            return IdxTerm(0, 0)
        m = self._snapshot[0]
        return IdxTerm(m.index, m.term)

    def snapshot_meta(self):
        """The current snapshot's metadata (in-memory; no data read)."""
        with self._lock:
            return self._snapshot[0] if self._snapshot is not None \
                else None

    def checkpoint_index(self) -> int:
        """Newest checkpoint index, 0 if none (the checkpoint_index
        gauge, ra.hrl:378)."""
        with self._lock:
            return self._checkpoints[-1][0].index if self._checkpoints \
                else 0

    def snapshot(self) -> Optional[tuple]:
        """(meta, data_bytes) of the current snapshot, for chunked send."""
        if self._snapshot is None:
            return None
        meta, path = self._snapshot
        got = _read_snapshot_file(path)
        if got is None:
            return None
        return meta, got[1]

    def update_release_cursor(self, idx: int, cluster: tuple,
                              machine_version: int,
                              machine_state: Any) -> list:
        term = self.fetch_term(idx)
        if term is None:
            return []
        meta = SnapshotMeta(index=idx, term=term, cluster=cluster,
                            machine_version=machine_version)
        path = os.path.join(self.dir, "snapshot",
                            f"snap_{idx:016d}_{term:010d}.rtsn")
        data = self.snapshot_module.encode(machine_state)
        try:
            _write_snapshot_file(path, meta, data)
        except OSError:
            # degradation: the release cursor simply does not advance —
            # the old snapshot and the full log stay intact (pending-dir
            # discipline), and a later release point retries
            _fault_note("snapshot_write_failures")
            _drop_partial(path)
            return []
        self.counters["snapshots_written"] += 1
        self.counters["snapshot_bytes_written"] += len(data)
        old = self._snapshot
        with self._lock:
            self._snapshot = (meta, path)
        self._truncate_to(idx)
        if old is not None and old[1] != path:
            try:
                os.unlink(old[1])
            except FileNotFoundError:
                pass
        self._drop_stale_checkpoints(idx)
        return []

    def checkpoint(self, idx: int, cluster: tuple, machine_version: int,
                   machine_state: Any) -> list:
        term = self.fetch_term(idx)
        if term is None:
            return []
        meta = SnapshotMeta(index=idx, term=term, cluster=cluster,
                            machine_version=machine_version)
        path = os.path.join(self.dir, "checkpoints",
                            f"cp_{idx:016d}_{term:010d}.rtsn")
        data = self.snapshot_module.encode(machine_state)
        try:
            _write_snapshot_file(path, meta, data)
        except OSError:
            # a checkpoint is purely a replay shortcut: skipping a
            # failed one loses nothing (the log is untouched)
            _fault_note("snapshot_write_failures")
            _drop_partial(path)
            return []
        self.counters["checkpoints_written"] += 1
        self.counters["checkpoint_bytes_written"] += len(data)
        with self._lock:
            self._checkpoints.append((meta, path))
            # retention (ra.hrl:234 + take_older_checkpoints)
            while len(self._checkpoints) > MAX_CHECKPOINTS:
                _, old_path = self._checkpoints.pop(0)
                try:
                    os.unlink(old_path)
                except FileNotFoundError:
                    pass
        return []

    def promote_checkpoint(self, idx: int) -> bool:
        """Rename the newest checkpoint <= idx into the snapshot slot
        (ra_snapshot.erl:399-448)."""
        with self._lock:
            best = None
            for meta, path in self._checkpoints:
                if meta.index <= idx and \
                        (best is None or meta.index > best[0].index):
                    best = (meta, path)
            if best is None:
                return False
            self._checkpoints = [c for c in self._checkpoints
                                 if c[0].index > best[0].index]
        meta, cp_path = best
        snap_path = os.path.join(
            self.dir, "snapshot",
            f"snap_{meta.index:016d}_{meta.term:010d}.rtsn")
        self.counters["checkpoints_promoted"] += 1
        os.replace(cp_path, snap_path)
        old = self._snapshot
        with self._lock:
            self._snapshot = (meta, snap_path)
        self._truncate_to(meta.index)
        if old is not None:
            try:
                os.unlink(old[1])
            except FileNotFoundError:
                pass
        return True

    def install_snapshot(self, meta: SnapshotMeta, data: bytes) -> None:
        path = os.path.join(self.dir, "snapshot",
                            f"snap_{meta.index:016d}_{meta.term:010d}.rtsn")
        try:
            _write_snapshot_file(path, meta, data)
        except OSError:
            # the install must FAIL loudly (the leader retries the
            # transfer); the torn .partial never reached the slot
            _fault_note("snapshot_write_failures")
            _drop_partial(path)
            raise
        self._post_install(meta, path)

    def _post_install(self, meta: SnapshotMeta, path: str) -> None:
        """Swap in a freshly written snapshot file and truncate the log
        below it (shared by whole-buffer and streamed installs)."""
        self.counters["snapshot_installed"] += 1
        old = self._snapshot
        with self._lock:
            self._snapshot = (meta, path)
            if self._last_index < meta.index:
                self._last_index = meta.index
                self._last_term = meta.term
            if self._last_written.index <= meta.index:
                self._last_written = IdxTerm(meta.index, meta.term)
            # the next follower write after an install truncates the WAL
            # stream (wal_truncate_write, ra_log.erl:303,1033)
            self._truncate_next = True
        self._truncate_to(meta.index)
        if old is not None and old[1] != path:
            try:
                os.unlink(old[1])
            except FileNotFoundError:
                pass

    # -- chunk-incremental snapshot accept (ra_snapshot.erl:465-508,
    # ra_log_snapshot.erl:73-111): chunks stream to a .partial file with
    # per-chunk crc validation and O(chunk) memory; the assembled body
    # crc is patched into the header on the last chunk and the file
    # swapped in atomically --------------------------------------------

    def begin_accept(self, meta: SnapshotMeta) -> None:
        """Open a fresh accept stream (chunk 1 of an install).  A
        restarted install simply begins again — the .partial truncates."""
        self.abort_accept()
        path = os.path.join(self.dir, "snapshot", "accept.partial")
        f = open(path, "wb")
        meta_b = pickle.dumps(meta)
        prefix = struct.pack("<I", len(meta_b)) + meta_b
        # crc slot written as 0 now, patched in complete_accept
        f.write(_SNAP_HDR.pack(SNAP_MAGIC, 1, 0) + prefix)
        self._accept = {"meta": meta, "path": path, "f": f,
                        "crc": IO.crc32(prefix), "chunks": 0}

    def accept_chunk(self, data: bytes, chunk_number: int,
                     chunk_crc: int = -1) -> bool:
        """Append one chunk; False = validation failure (caller aborts
        the install and the leader restarts it)."""
        a = getattr(self, "_accept", None)
        if a is None:
            return False
        if chunk_number == 1 and a["chunks"] > 0:
            # same-snapshot transfer restarted from the top (sender
            # retry): truncate the stream rather than double-append
            self.begin_accept(a["meta"])
            a = self._accept
        if chunk_crc >= 0 and IO.crc32(data) != chunk_crc:
            self.abort_accept()
            return False
        a["f"].write(data)
        a["crc"] = zlib.crc32(data, a["crc"])
        a["chunks"] += 1
        return True

    def complete_accept(self) -> bool:
        """Finalize the stream: patch the body crc into the header, fsync,
        atomically rename into the snapshot slot, truncate the log."""
        a = getattr(self, "_accept", None)
        if a is None:
            return False
        self._accept = None
        f, meta = a["f"], a["meta"]
        try:
            f.seek(8)  # crc field of _SNAP_HDR (<4sII)
            f.write(struct.pack("<I", a["crc"]))
            f.flush()
            IO.sync(f.fileno(), 2, path_class="snapshot")
        except OSError:
            # the stream never reached the snapshot slot: drop the
            # .partial and report failure — the leader restarts the
            # transfer from chunk 1
            _fault_note("snapshot_write_failures")
            self._accept = a
            self.abort_accept()
            return False
        f.close()
        path = os.path.join(self.dir, "snapshot",
                            f"snap_{meta.index:016d}_{meta.term:010d}.rtsn")
        os.replace(a["path"], path)
        self._post_install(meta, path)
        return True

    def abort_accept(self) -> None:
        """Drop an in-flight accept stream (leader change / timeout /
        corrupt chunk)."""
        a = getattr(self, "_accept", None)
        self._accept = None
        if a is not None:
            try:
                a["f"].close()
            except OSError:
                # safe to swallow: the stream is being abandoned — its
                # bytes are garbage by definition (the leader restarts
                # the transfer), so a failed close loses nothing
                _fault_note("swallowed_oserrors")
            try:
                os.unlink(a["path"])
            except OSError:
                # safe to swallow: a stranded accept.partial can never
                # shadow a real snapshot (recovery unlinks it at boot,
                # _recover_state) — it only leaks bytes until then
                _fault_note("swallowed_oserrors")

    def recover_snapshot_state(self) -> Optional[tuple]:
        if self._snapshot is None:
            return None
        meta, path = self._snapshot
        got = _read_snapshot_file(path)
        if got is None:
            return None  # torn/corrupt container: fall back to older
        if not self.snapshot_module.validate(got[1]):
            # a crc-valid container the selected module rejects is a
            # FORMAT mismatch (e.g. module changed without migration):
            # re-initializing machine state over a truncated log would
            # be silent divergence — fail loudly instead
            raise ValueError(
                f"snapshot {path} rejected by snapshot module "
                f"{self.snapshot_module.name!r} (format mismatch?)")
        return meta, self.snapshot_module.decode(got[1])

    def recover_machine_base(self) -> Optional[tuple]:
        """Newest valid machine-state base among the snapshot and the
        retained checkpoints (ra_snapshot:init picks the latest valid
        image, ra_snapshot.erl:183-222; the recover_from_checkpoint_*
        cases of ra_checkpoint_SUITE).  Checkpoints do not truncate the
        log, so recovering from one is purely a replay shortcut; corrupt
        or undecodable checkpoints fall back to the next older image."""
        with self._lock:
            cps = list(self._checkpoints)
            snap_idx = self._snapshot[0].index if self._snapshot else -1
        for meta, path in reversed(cps):        # newest first
            if meta.index <= snap_idx:
                break  # snapshot is newer: no need to read checkpoints
            got = _read_snapshot_file(path)
            if got is None or not self.snapshot_module.validate(got[1]):
                continue  # torn/corrupt container: try the next older
            try:
                state = self.snapshot_module.decode(got[1])
            except Exception:
                continue
            return meta, state
        # no usable checkpoint above the snapshot: decode the snapshot
        # (deferred until here — a superseding checkpoint must not pay a
        # full snapshot read+decode)
        return self.recover_snapshot_state()

    def snapshot_data(self) -> bytes:
        got = self.snapshot()
        assert got is not None
        return got[1]

    def _truncate_to(self, idx: int) -> None:
        """Drop memtable entries and whole segments covered by a snapshot
        (delete_segments, ra_log.erl:1010).  Takes the io lock so an
        in-flight segment flush never races the close/unlink."""
        with self._io_lock:
            with self._lock:
                for i in [i for i in self._memtable if i <= idx]:
                    self._memtable.pop(i, None)
                    self._mem_bytes.pop(i, None)
                self._first_index = idx + 1
                keep = []
                victims = []
                for seg in self._segments:
                    r = seg.range()
                    if r is not None and r[1] <= idx:
                        victims.append(seg)
                    else:
                        keep.append(seg)
                self._segments = keep
                # a kept segment holding slots above last_index is a stale
                # overwritten tail; once the snapshot swallows the WAL's
                # truncation record this segment would be the only durable
                # "evidence" for those indexes — truncate it physically
                for seg in keep:
                    r = seg.range()
                    if r is not None and r[1] > self._last_index:
                        seg.truncate_from(self._last_index + 1)
            for seg in victims:
                self._open_segments.pop(seg.path)
                if self._readers:
                    # external readers hold the pre-truncation view: move
                    # the segment to the pinned list instead of deleting
                    # (the reference defers its memtable/segment deletion
                    # while registered readers exist, ra_log.erl:534-574)
                    self._pinned_segments.append(seg)
                else:
                    seg.close()
                    try:
                        os.unlink(seg.path)
                    except FileNotFoundError:
                        pass

    def _drop_stale_checkpoints(self, idx: int) -> None:
        with self._lock:
            stale = [c for c in self._checkpoints if c[0].index <= idx]
            self._checkpoints = [c for c in self._checkpoints
                                 if c[0].index > idx]
        for _, path in stale:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    # -- external readers (ra_log.erl:983-1008) -----------------------------

    def register_reader(self, name: str) -> "LogReader":
        """Register an external reader over the segment-flushed portion of
        the log.  While any reader is registered, snapshot truncation
        defers segment deletion (the files move to a pinned list the
        readers can still resolve) — the role the reference fills with
        deferred ETS/segment deletion for registered readers.

        Registration takes _io_lock so it serialises against an in-flight
        _truncate_to: without it a truncation could re-read self._readers
        mid-victims-loop and unlink segments a reader registered between
        iterations could already see."""
        with self._io_lock:
            with self._lock:
                self._readers[name] = self._readers.get(name, 0) + 1
        return LogReader(self, name)

    def close_reader(self, name: str) -> None:
        with self._io_lock:
            with self._lock:
                n = self._readers.get(name, 0) - 1
                if n > 0:
                    self._readers[name] = n
                else:
                    self._readers.pop(name, None)
                if self._readers:
                    return
                victims, self._pinned_segments = self._pinned_segments, []
            for seg in victims:
                self._open_segments.pop(seg.path)
                seg.close()
                try:
                    os.unlink(seg.path)
                except FileNotFoundError:
                    pass

    def _reader_read(self, idx: int) -> Optional[tuple]:
        """Resolve an index for an external reader: live segments first,
        then segments pinned past a truncation."""
        with self._io_lock:
            # newest wins: live segments (newer) before pinned (older,
            # pre-truncation) — so the concat is pinned first, reversed
            for seg in reversed(self._pinned_segments + self._segments):
                r = seg.range()
                if r and r[0] <= idx <= r[1]:
                    # reader reads respect the fd cap too: an untracked
                    # reopen would defeat MAX_OPEN_SEGMENTS over a long
                    # fold (pinned segments share the same cache)
                    self._open_segments.touch(seg.path, seg)
                    got = seg.read(idx)
                    if got is not None:
                        return got
        return None

    # -- misc ---------------------------------------------------------------

    def tick(self, now_ms: float) -> list:
        return []

    def close(self) -> None:
        # _io_lock first: a SegmentWriter flush in flight must finish
        # before fds close, or its pwrites could land on a recycled fd
        # number belonging to an unrelated file
        with self._io_lock:
            with self._lock:
                self._open_segments.evict_all()
                for seg in self._segments + self._pinned_segments:
                    seg.close()

    def overview(self) -> dict:
        return {
            "type": "durable",
            "uid": self.uid,
            "last_index": self._last_index,
            "last_term": self._last_term,
            "first_index": self._first_index,
            "last_written_index_term": tuple(self._last_written),
            "num_mem_entries": len(self._memtable),
            "num_segments": len(self._segments),
            "snapshot_index_term": tuple(self.snapshot_index_term()),
            "num_checkpoints": len(self._checkpoints),
        }
