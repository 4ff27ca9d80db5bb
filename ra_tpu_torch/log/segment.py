"""Per-server segment files + the node-wide segment writer.

Segment format follows the shape of the reference's (ra_log_segment.erl:
30-43: magic, version, preallocated fixed-capacity index region, data
region; entries carry crc32) with our own layout:

  header:  magic "RTSG"(4) | version:u32 | max_count:u32 | reserved:u32
  index:   max_count slots of (idx:u64 term:u64 offset:u64 len:u32 crc:u32)
  data:    payloads

Appends buffer in memory and reach disk in one pwrite-per-region + fsync
flush (append/sync, ra_log_segment.erl:175-266).  A slot with idx 0 is
empty (real indexes are >= 1).

The SegmentWriter is the node-wide drain: the WAL hands it per-server
ranges on rollover; it flushes each server's memtable to that server's
segment files, notifies the server's log, and deletes the WAL file once
every server's flush is done (ra_log_segment_writer.erl:129-201,
accept_mem_tables/truncate_segments roles).
"""
from __future__ import annotations

import os
import struct
import threading
import time
import queue
from typing import Callable, Optional

from .faults import IO, note as _fault_note

MAGIC = b"RTSG"
_HDR = struct.Struct("<4sIII")
_SLOT = struct.Struct("<QQQII")
DEFAULT_MAX_COUNT = 4096  # entries per segment (ra.hrl:202)


class SegmentFile:
    """One append-optimized segment file."""

    def __init__(self, path: str, max_count: int = DEFAULT_MAX_COUNT,
                 create: bool = False) -> None:
        self.path = path
        self.max_count = max_count
        self.index: dict[int, tuple] = {}  # idx -> (term, offset, len, crc)
        self._pending: list = []           # [(idx, term, payload)]
        self._count = 0
        self._max_idx = 0  # highest live-or-pending index (0 = empty)
        if create:
            self.fd = IO.random_open(path, truncate=True)
            hdr = _HDR.pack(MAGIC, 1, max_count, 0)
            IO.pwrite(self.fd, hdr + b"\x00" * (_SLOT.size * max_count), 0)
            self._data_off = _HDR.size + _SLOT.size * max_count
            self._next_off = self._data_off
        else:
            self.fd = IO.random_open(path)
            self._load()

    def _ensure_open(self) -> int:
        """Reopen the fd after a close_fd() eviction; the in-memory index
        is kept, so reopening is just an open(2)."""
        if self.fd is None:
            self.fd = IO.random_open(self.path)
        return self.fd

    def close_fd(self) -> None:
        """Close only the descriptor (LRU eviction by the log's open-
        segment cache, the ra_flru role); the index stays loaded and any
        read/flush transparently reopens."""
        if self.fd is not None:
            IO.close(self.fd)
            self.fd = None

    def _load(self) -> None:
        hdr = IO.pread(self.fd, _HDR.size, 0)
        magic, version, max_count, _ = _HDR.unpack(hdr)
        if magic != MAGIC:
            raise ValueError(f"bad segment magic in {self.path}")
        self.max_count = max_count
        self._data_off = _HDR.size + _SLOT.size * max_count
        raw = IO.pread(self.fd, _SLOT.size * max_count, _HDR.size)
        self._next_off = self._data_off
        for i in range(max_count):
            idx, term, off, ln, crc = _SLOT.unpack_from(raw, i * _SLOT.size)
            if idx == 0:
                break
            # slots are strictly append-ordered, so a slot that rewrites a
            # lower index is an overwrite: it invalidates every entry above
            # it written earlier (same dedup as WAL recovery — a stale
            # tail must not survive a reload)
            self._invalidate_from(idx)
            self.index[idx] = (term, off, ln, crc)
            self._max_idx = max(self._max_idx, idx)
            self._count += 1
            self._next_off = max(self._next_off, off + ln)

    # -- write side ---------------------------------------------------------

    def _invalidate_from(self, idx: int) -> None:
        """Drop every live/pending entry at/above ``idx`` — the single
        slot-order dedup shared by live appends and reload (_load), so
        the live index can never disagree with what a reload would
        reconstruct.  Fast path: a strictly-ascending append (the flush
        hot path) skips the sweep entirely via the max-index watermark."""
        if idx > self._max_idx:
            return
        for k in [k for k in self.index if k >= idx]:
            del self.index[k]
        self._pending = [p for p in self._pending if p[0] < idx]
        self._max_idx = max(max(self.index, default=0),
                            max((p[0] for p in self._pending), default=0))

    def append(self, idx: int, term: int, payload: bytes) -> bool:
        """Buffer an entry; False when the segment is full
        ({error, full} in the reference).  Appending at-or-below an
        existing index is an overwrite: it invalidates every LIVE entry
        at/above it immediately (see _invalidate_from)."""
        # capacity already in the FILE is append-only: refuse before
        # touching any state, so a refused append never makes the live
        # index disagree with what a reload reconstructs
        if self._count >= self.max_count:
            return False
        # invalidate BEFORE the pending-capacity check: an overwrite
        # landing in a segment whose capacity is consumed by PENDING
        # entries frees the superseded tail and fits in place instead of
        # forcing a roll.  A refusal below cannot follow a mutation: it
        # requires no pending ≥ idx (freeing even one slot admits this
        # append), and live flushed entries ≥ idx with all pending < idx
        # cannot coexist (the lower-idx pending append already swept
        # that flushed tail) — so on the refusal path the invalidation
        # was the _max_idx fast-path no-op.
        self._invalidate_from(idx)
        if self._count + len(self._pending) >= self.max_count:
            return False
        self._pending.append((idx, term, payload))
        self._max_idx = max(self._max_idx, idx)
        return True

    def flush(self) -> None:
        """Write pending data + index slots, then fsync (sync/flush,
        ra_log_segment.erl:222-266)."""
        if not self._pending:
            return
        self._ensure_open()
        data = bytearray()
        slots = bytearray()
        off = self._next_off
        base_slot = self._count
        staged = []
        for idx, term, payload in self._pending:
            crc = IO.crc32(payload)
            staged.append((idx, (term, off, len(payload), crc)))
            slots += _SLOT.pack(idx, term, off, len(payload), crc)
            data += payload
            off += len(payload)
        # NB: on an I/O error below, NO in-memory bookkeeping changes —
        # index/_count/_next_off/_pending stay exactly retry-shaped, so
        # a retried flush re-issues the SAME pwrites at the same offsets
        # (idempotent) and re-dirties the pages a failed fsync may have
        # dropped — which is why retrying the fsync here, unlike on a
        # WAL fd, is safe.  The index commits only AFTER the fsync:
        # readers (and the flush-side already-durable filter) must never
        # see written-but-unsynced slots as durable entries.
        IO.pwrite(self.fd, bytes(data), self._next_off)
        IO.pwrite(self.fd, bytes(slots),
                  _HDR.size + base_slot * _SLOT.size)
        IO.sync(self.fd, 2)
        for idx, ent in staged:
            self.index[idx] = ent
        self._count += len(self._pending)
        self._next_off = off
        self._pending.clear()

    def truncate_from(self, idx: int) -> None:
        """Durably drop every entry >= idx.  Used when a snapshot makes an
        overwritten segment tail the only remaining durable record of
        those indexes — it must not resurrect on reload.  The surviving
        entries are rewritten to a fresh file swapped in with an atomic
        rename: an in-place slot-region rewrite would break the
        append-only crash discipline (a torn rewrite could interleave new
        and old slot layouts, resurrecting — or corrupting — the tail).
        Rare (snapshot-covering-an-overwrite only), so the copy is
        acceptable."""
        self._pending = [p for p in self._pending if p[0] < idx]
        stale = [k for k in self.index if k >= idx]
        if not stale:
            return
        survivors = [(k, self.index[k][0], self.read(k)[1])
                     for k in sorted(self.index) if k < idx]
        tmp_path = self.path + ".trunc"
        fresh = SegmentFile(tmp_path, self.max_count, create=True)
        for k, term, payload in survivors:
            fresh.append(k, term, payload)
        fresh.flush()
        IO.sync(fresh.fd, 2)  # flush() early-returns when there are no
        fresh.close()         # survivors; the header must still be durable
        self.close_fd()
        os.replace(tmp_path, self.path)
        self.fd = IO.random_open(self.path)
        self.index = {}
        self._pending = []
        self._count = 0
        self._max_idx = 0
        self._load()

    # -- read side ----------------------------------------------------------

    def read(self, idx: int) -> Optional[tuple]:
        """Returns (term, payload) with crc verification
        (ra_log_segment.erl:268-335).  A crc mismatch is retried ONCE
        with a fresh pread — transient read-side corruption (bit rot in
        flight, an injected fault) must not take down a reader when the
        on-disk bytes are fine; a second mismatch is real damage and
        raises."""
        ent = self.index.get(idx)
        if ent is None:
            return None
        term, off, ln, crc = ent
        payload = IO.pread(self._ensure_open(), ln, off)
        if IO.crc32(payload) != crc:
            _fault_note("crc_catches")
            payload = IO.pread(self._ensure_open(), ln, off)
            if IO.crc32(payload) != crc:
                raise ValueError(
                    f"segment crc mismatch at {idx} in {self.path}")
        return term, payload

    def range(self) -> Optional[tuple]:
        if not self.index:
            return None
        return min(self.index), max(self.index)

    @property
    def full(self) -> bool:
        return self._count + len(self._pending) >= self.max_count

    def close(self) -> None:
        if self.fd is not None:
            IO.close(self.fd)
            self.fd = None


class _DaemonFuture:
    __slots__ = ("_done", "_result", "_exc")

    def __init__(self) -> None:
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("flush worker stalled")
        if self._exc is not None:
            raise self._exc
        return self._result


class _DaemonPool:
    """Minimal daemon-thread worker pool (submit -> future)."""

    def __init__(self, workers: int, name: str) -> None:
        self._queue: "queue.Queue" = queue.Queue()
        self._workers = workers
        for i in range(workers):
            t = threading.Thread(target=self._work, daemon=True,
                                 name=f"{name}-{i}")
            t.start()

    def stop(self) -> None:
        for _ in range(self._workers):
            self._queue.put(None)

    def _work(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, args, fut = item
            try:
                fut._result = fn(*args)
            except BaseException as exc:  # noqa: BLE001 — carried to result()
                fut._exc = exc
            fut._done.set()

    def submit(self, fn, *args) -> _DaemonFuture:
        fut = _DaemonFuture()
        self._queue.put((fn, args, fut))
        return fut


class SegmentWriter:
    """Node-wide background flusher: WAL rollover ranges -> segment files.

    Flushes within one job run on a small worker pool — the
    ``partition_parallel`` over schedulers of the reference
    (ra_log_segment_writer.erl:129-147): per-uid flushes touch disjoint
    DurableLogs and segment files, so at the co-hosted-thousands design
    point one Python thread would serialize the node's entire flush
    bandwidth.  Jobs themselves stay ordered (two jobs may carry the
    same uid); the WAL-file deletion barrier is preserved — a file is
    unlinked only after every uid's flush in its job completed."""

    #: per-uid flush attempts before escalation (first try + retries)
    FLUSH_ATTEMPTS = 3
    #: base backoff between flush retries (doubles per attempt)
    FLUSH_BACKOFF_S = 0.05

    def __init__(self, resolve: Optional[Callable] = None,
                 flush_workers: int = 4,
                 on_escalate: Optional[Callable] = None) -> None:
        #: resolve(uid) -> DurableLog | None (set by the node/log registry)
        self.resolve = resolve or (lambda uid: None)
        #: escalation hook: called as on_escalate(uid, exc) when a uid's
        #: flush exhausted its retry budget — the "server exit +
        #: supervisor restart" rung of the degradation ladder (the WAL
        #: file is kept either way, so the entries stay recoverable)
        self.on_escalate = on_escalate
        #: node-wide counters (ra_log_segment_writer.erl:37-52 names)
        from ..metrics import SEGMENT_WRITER_FIELDS
        self.counters: dict[str, int] = {f: 0
                                         for f in SEGMENT_WRITER_FIELDS}
        # force-deleted uids: an unresolvable uid in this set means "skip
        # its entries", not "keep the WAL file for a future restart"
        self._deleted: set = set()
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = False
        # daemon worker pool (NOT concurrent.futures: its atexit hook
        # joins workers, so a flush stuck in fsync on a dying disk would
        # hang process exit — the writer thread itself is daemon for the
        # same reason)
        self._pool = _DaemonPool(max(1, flush_workers),
                                 "ra-segment-flush")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ra-segment-writer")
        self._thread.start()

    def mark_deleted(self, uid: str) -> None:
        """Called on force-delete so flush jobs already queued (or queued
        later) for this uid do not pin their WAL files forever."""
        self._deleted.add(uid)

    def accept_ranges(self, ranges: dict, wal_path: str) -> None:
        """Called by the WAL on rollover (accept_mem_tables/3)."""
        self._queue.put(("__job__", ranges, wal_path))

    def retire(self, uids: list, wal_files: list) -> None:
        """Flush each uid's memtable up to its confirmed tail, then delete
        the recovered WAL files they came from."""
        self._queue.put(("__retire__", uids, wal_files))

    def await_idle(self, timeout: float = 10.0) -> None:
        """Barrier used by tests and log init (await/1 :87-100)."""
        done = threading.Event()
        self._queue.put(("__barrier__", done))
        if not done.wait(timeout):
            raise TimeoutError("segment writer barrier timed out")

    def _run(self) -> None:
        while not self._stop:
            try:
                job = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if job[0] == "__barrier__":
                job[1].set()
                continue
            try:
                if job[0] == "__retire__":
                    self._retire_job(job[1], job[2])
                elif job[0] == "__retire_retry__":
                    self._retire_job(job[1], job[2], job[3])
                else:
                    self._flush_job(job[1], job[2])
            except Exception:  # pragma: no cover
                import logging
                logging.getLogger("ra_tpu_torch").exception(
                    "segment writer job failed: %r", job[:1])

    def _flush_job(self, ranges: dict, wal_path: str) -> None:
        unresolved = False
        jobs = []
        for uid, (lo, hi) in ranges.items():
            log = self.resolve(uid)
            if log is None:
                # a STOPPED server's entries live only in this WAL file:
                # keep it so restart recovery can replay them.  A DELETED
                # server's entries are garbage — they must not pin the
                # file (purge may race a job already queued at rollover)
                if uid not in self._deleted:
                    unresolved = True
                continue
            jobs.append((uid, log, hi))
        # fan the per-uid flushes over the pool (partition_parallel role)
        futures = [(uid, log, hi,
                    self._pool.submit(log.flush_mem_to_segments, hi))
                   for uid, log, hi in jobs]
        for uid, log, hi, fut in futures:
            try:
                self._count_flush(fut.result())
            except Exception as exc:
                if not self._retry_flush(uid, log, hi, exc):
                    unresolved = True  # keep WAL file: still recoverable
        if not unresolved:
            # all servers flushed: the WAL file is redundant (:206-214)
            try:
                os.unlink(wal_path)
            except FileNotFoundError:
                pass

    def _retry_flush(self, uid: str, log, hi, exc: Exception) -> bool:
        """Retry-with-backoff rung of the flush degradation ladder
        (retry -> escalate).  flush() leaves its bookkeeping
        retry-shaped (same pwrites, re-dirtied pages), so re-running the
        whole memtable drain is idempotent.  Returns True when a retry
        succeeded; on exhaustion fires the escalation hook and returns
        False — the caller keeps the WAL file, so the entries remain
        recoverable from disk whatever the escalation does."""
        import logging
        log_ = logging.getLogger("ra_tpu_torch")
        log_.warning("segment flush failed for %s (%s); retrying",
                     uid, exc)
        _fault_note("faults_hit")
        for attempt in range(1, self.FLUSH_ATTEMPTS):
            time.sleep(self.FLUSH_BACKOFF_S * (2 ** (attempt - 1)))
            _fault_note("flush_retries")
            try:
                self._count_flush(log.flush_mem_to_segments(hi))
                return True
            except Exception as retry_exc:  # noqa: BLE001 — ladder rung
                exc = retry_exc
        _fault_note("flush_escalations")
        log_.error("segment flush for %s exhausted %d attempts (%s); "
                   "escalating", uid, self.FLUSH_ATTEMPTS, exc)
        if self.on_escalate is not None:
            try:
                self.on_escalate(uid, exc)
            except Exception:  # noqa: BLE001 — hook must not kill writer
                log_.exception("flush escalation hook failed for %s", uid)
        return False

    def _retire_job(self, uids: list, wal_files: list,
                    attempt: int = 0) -> None:
        for uid in uids:
            log = self.resolve(uid)
            if log is None:
                # registration raced the registry insert: retry briefly,
                # then keep the files (recovery will re-read them — safe)
                if attempt < 20:
                    t = threading.Timer(
                        0.05, lambda: self._queue.put(
                            ("__retire_retry__", uids, wal_files,
                             attempt + 1)))
                    t.daemon = True
                    t.start()
                return
        futures = []
        for uid in uids:
            log = self.resolve(uid)
            if log is not None:
                futures.append((uid, log, self._pool.submit(
                    lambda lg=log: lg.flush_mem_to_segments(
                        lg.last_written().index))))
        failed = False
        for uid, log, fut in futures:
            try:
                self._count_flush(fut.result())
            except Exception as exc:  # noqa: BLE001 — enters retry ladder
                if not self._retry_flush(uid, log,
                                         log.last_written().index, exc):
                    failed = True
        if failed:
            return  # keep the recovered files: entries still needed
        for path in wal_files:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def _count_flush(self, stats: Optional[tuple]) -> None:
        # counting stays on the single writer thread (futures are
        # resolved there), so no lock is needed
        if not stats:
            return
        entries, nbytes, segs = stats
        self.counters["mem_tables"] += 1
        self.counters["entries"] += entries
        self.counters["bytes_written"] += nbytes
        self.counters["segments"] += segs

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=5)
        self._pool.stop()
