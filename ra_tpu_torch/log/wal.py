"""Fan-in write-ahead log: the port's own copy of ``ra_tpu/log/wal.py``.

Its file format is the reference's byte for byte, so a WAL directory
written by either package recovers through the other.  Mirrors the
layering of the reference WAL (ra_log_wal.erl):
* single fan-in writer batching the writes of ALL co-hosted servers,
  amortizing one durability syscall across the batch (:193-214, :753-800)
* per-record framing with writer id, idx/term, payload crc (:404-453)
* out-of-sequence writer detection -> resend_from signal (:457-481)
* rollover at max size: the closed file's per-writer ranges go to the
  segment writer, which flushes each server's memtable to its segment
  files and then deletes the WAL file (:593-620, 690-739,
  ra_log_segment_writer.erl:129-201)
* recovery re-reads surviving *.wal files in order into per-uid tables,
  deduping overwrites; the writer's owner consumes them (:334-390,
  :871-955)

Division of labour (simplified vs the reference, same guarantees): the
writer's owner keeps its entries (a shard of the durable engine keeps
its unconfirmed blocks) until they are covered elsewhere; the WAL is
purely the durability+ordering fan-in, and a closed WAL file is only
deleted once its owner's ``segment_writer`` retires it (the durable
engine's retirer does so when a checkpoint covers the file).

Hot path (encode+write+sync) goes through ra_tpu_torch.native with the
GIL released.

File format "RTW3": magic(4B) then records:
  type:u8
    1 = writer registration: wid:u32 uid_len:u16 uid
    2 = entry: wid:u32 idx:u64 term:u64 len:u32 crc:u32 payload
    3 = batch run: wid:u32 count:u32 body_len:u32 crc:u32
        body = count x (idx:u64 term:u64 slot:u32) triplets
        (body_len == count*20 exactly).  ``slot`` indexes the file's
        CUMULATIVE payload table (type 4): payload images are interned
        once per file, so the three co-hosted members of a cluster
        writing the same entry burst into the shared WAL cost one
        payload image plus three 20-byte triplet runs — the payload
        fan-out was the dominant share of WAL bytes (and of the crc +
        write(2) time under them) once group commit amortized the
        fsync.  One writer's contiguous burst is ONE
        record with ONE streaming crc over header+body.
    4 = payload-table append: n:u32 body_len:u32 crc:u32
        body = n x len:u32, then the n payload images concatenated.
        Appends n images to the file-scope payload table consumed by
        every later type-3 record; the writer emits one per batch run
        that carries images not already interned in this file.
        Payloads are relayed byte-for-byte from whoever encoded them
        first.
RTW2 (same layout, no types 3/4, per-entry header crc) and RTW1
(payload-only entry crc) files remain readable — the format version
rides the file magic, so pre-codec data dirs recover unchanged.
"""
from __future__ import annotations

import collections
import os
import queue
import struct
import threading
import time
from typing import Callable, Optional

from .. import trace
from ..blackbox import RECORDER, record
from .faults import IO, note as _fault_note

MAGIC = b"RTW3"
MAGIC_V2 = b"RTW2"   # no batch-run records (read-compatible)
MAGIC_V1 = b"RTW1"   # payload-only entry crc (read-compatible)
_REG = struct.Struct("<BIH")        # type, wid, uid_len
_ENT = struct.Struct("<BIQQII")     # type, wid, idx, term, len, crc
_ENT_HDR = struct.Struct("<BIQQI")  # the crc-covered prefix of _ENT
_RUN_HDR = struct.Struct("<BIII")   # type, wid, count, body_len
_RUN_ENT = struct.Struct("<QQI")    # idx, term, slot (run-table triplet)
_PAY_HDR = struct.Struct("<BII")    # type, n, body_len (payload table)
_CRC = struct.Struct("<I")


def _entry_crc(header: bytes, payload: bytes) -> int:
    """RTW2 record crc covers the HEADER FIELDS as well as the payload:
    a flipped wid/idx/term must fail the check and stop recovery at the
    damage point, not silently skip or mis-file the entry (the tail
    discipline of ra_log_wal.erl:871-955).  RTW1 files (payload-only
    crc) remain readable — the format version rides the file magic.
    One streaming-equivalent crc call (crc32(h+p) == crc32(p, crc32(h)))
    — the two-call form paid a second shim+FFI round trip per record
    on the batch thread's hot loop."""
    return IO.crc32(header + payload)

#: ra.hrl:191's wal_max_size_bytes.  Matching the reference matters
#: beyond parity: rollover triggers the segment flush, and a larger
#: file lets release cursors truncate most of the memtable BEFORE the
#: flush sees it — at 64MB the classic bench segment-flushed ~1.3
#: entries per applied command, at 256MB ~0.2
DEFAULT_MAX_SIZE = 256 * 1024 * 1024
DEFAULT_MAX_BATCH = 8192              # ra.hrl:192

#: consecutive faulted batches before the poison/rollover ladder gives
#: up and escalates to thread death (supervisor restart + intensity
#: window) — a persistent fault (dead disk, full volume) must not
#: hot-loop file rollovers
MAX_POISON_STREAK = 3

#: notify(uid, lo, hi, term) — lo None => resend_from(hi)
NotifyFn = Callable[[str, Optional[int], int, int], None]


class WalDown(RuntimeError):
    """The WAL batch thread is dead: writes cannot become durable.  The
    reference surfaces the same condition as the ``wal_down`` error a
    server gets calling a crashed ra_log_wal process
    (ra_server.erl:538-554); cores react by entering await_condition
    until the supervisor restarts the WAL."""


def _parse_wal_bytes(data: bytes) -> tuple:
    """Parse raw WAL bytes -> (records, err): the prefix of records up
    to the first damage point, and the ValueError describing it (None
    when the file parses clean).  Records are ("reg", wid, uid) and
    ("ent", wid, idx, term, payload) — pure parsing, no table mutation,
    so a corrupt read can be retried without double-applying."""
    records: list = []
    if data[:4] not in (MAGIC, MAGIC_V2, MAGIC_V1):
        return records, None
    header_crc = data[:4] != MAGIC_V1
    payloads: list = []   # file-scope table type-4 appends / type-3 reads
    pos = 4
    while pos + 1 <= len(data):
        rtype = data[pos]
        if rtype == 1:
            if pos + _REG.size > len(data):
                return records, ValueError("torn registration")
            _, wid, ulen = _REG.unpack_from(data, pos)
            pos += _REG.size
            try:
                uid = data[pos:pos + ulen].decode()
            except UnicodeDecodeError:
                return records, ValueError("corrupt registration uid")
            pos += ulen
            records.append(("reg", wid, uid))
        elif rtype == 2:
            if pos + _ENT.size > len(data):
                return records, ValueError("torn entry header")
            _, wid, idx, term, plen, crc = _ENT.unpack_from(data, pos)
            pos += _ENT.size
            payload = data[pos:pos + plen]
            pos += plen
            want = _entry_crc(_ENT_HDR.pack(2, wid, idx, term, plen),
                              payload) if header_crc else IO.crc32(payload)
            if len(payload) < plen or want != crc:
                return records, ValueError("crc mismatch")  # torn tail
            records.append(("ent", wid, idx, term, payload))
        elif rtype == 3:
            # batch run: validate the WHOLE run (one streaming crc, then
            # the triplet table against body_len) before appending any
            # of its entries — a run lands atomically or not at all,
            # which is exactly the confirm contract (nothing in a batch
            # is confirmed before its full write + sync)
            if pos + _RUN_HDR.size + _CRC.size > len(data):
                return records, ValueError("torn run header")
            _, wid, count, body_len = _RUN_HDR.unpack_from(data, pos)
            (crc,) = _CRC.unpack_from(data, pos + _RUN_HDR.size)
            body_start = pos + _RUN_HDR.size + _CRC.size
            body = data[body_start:body_start + body_len]
            if len(body) < body_len or IO.crc32(
                    body, IO.crc32(data[pos:pos + _RUN_HDR.size])) != crc:
                return records, ValueError("crc mismatch")  # torn tail
            if body_len != count * _RUN_ENT.size:
                return records, ValueError("run table size mismatch")
            navail = len(payloads)
            for i in range(count):
                idx, term, slot = _RUN_ENT.unpack_from(
                    body, i * _RUN_ENT.size)
                if slot >= navail:
                    return records, ValueError("run slot out of range")
                records.append(("ent", wid, idx, term, payloads[slot]))
            pos = body_start + body_len
        elif rtype == 4:
            # payload-table append: crc-validate the whole record, then
            # extend the file-scope table — later type-3 runs reference
            # these images by slot
            if pos + _PAY_HDR.size + _CRC.size > len(data):
                return records, ValueError("torn payload-table header")
            _, n, body_len = _PAY_HDR.unpack_from(data, pos)
            (crc,) = _CRC.unpack_from(data, pos + _PAY_HDR.size)
            body_start = pos + _PAY_HDR.size + _CRC.size
            body = data[body_start:body_start + body_len]
            if len(body) < body_len or IO.crc32(
                    body, IO.crc32(data[pos:pos + _PAY_HDR.size])) != crc:
                return records, ValueError("crc mismatch")  # torn tail
            lens_len = n * 4
            if lens_len > body_len:
                return records, ValueError("payload lens overrun body")
            lens = struct.unpack_from("<%dI" % n, body)
            if lens_len + sum(lens) != body_len:
                return records, ValueError("payload blobs overrun body")
            off = lens_len
            for ln in lens:
                payloads.append(body[off:off + ln])
                off += ln
            pos = body_start + body_len
        else:
            break
    return records, None


def scan_wal_file(path: str, tables: dict) -> None:
    """Parse one WAL file into per-uid tables (idx -> (term, payload)),
    deduping overwrites; raises on a torn/corrupt tail (callers keep the
    prefix parsed so far).  A parse failure is retried ONCE with a fresh
    read — the crc caught the damage either way (counted as a
    crc_catch), but transient read-side corruption (a flipped bit in
    flight, not on the platter) must not truncate recovery when a
    second read comes back clean.  Shared by live recovery and offline
    replay (ra_dbg)."""
    records, err = _parse_wal_bytes(IO.read_file(path))
    if err is not None:
        retry, retry_err = _parse_wal_bytes(IO.read_file(path))
        if retry_err is None or len(retry) > len(records):
            # the fresh read parsed further: the damage was transient
            # read-side corruption (a bit flipped in flight), not a
            # torn tail on the platter — only THIS case is a crc catch;
            # an identical re-parse is an ordinary torn tail (every
            # kill-9 recovery) and is not fault telemetry
            _fault_note("crc_catches")
            records, err = retry, retry_err
    wid_to_uid: dict[int, str] = {}
    #: uid -> the highest index in its table, so the overwrite test is
    #: one comparison a record (a scan of the table a record made
    #: recovery quadratic in the entries a file holds)
    tops: dict = {}
    for rec in records:
        if rec[0] == "reg":
            wid_to_uid[rec[1]] = rec[2]
            continue
        _kind, wid, idx, term, payload = rec
        uid = wid_to_uid.get(wid)
        if uid is None:
            continue
        tbl = tables.setdefault(uid, {})
        top = tops[uid] if uid in tops else max(tbl, default=None)
        if top is not None and top >= idx:
            # overwrite invalidates higher indexes (dedup,
            # ra_log_wal recovery semantics :871-955)
            for k in [k for k in tbl if k > idx]:
                del tbl[k]
        tbl[idx] = (term, payload)
        tops[uid] = idx
    if err is not None:
        raise err


class _Writer:
    __slots__ = ("uid", "wid", "notify", "last_idx")

    def __init__(self, uid: str, wid: int, notify: NotifyFn) -> None:
        self.uid = uid
        self.wid = wid
        self.notify = notify
        self.last_idx: Optional[int] = None


class Wal:
    """Node-wide fan-in WAL with a background batch thread."""

    def __init__(self, data_dir: str, *, sync_mode: int = 1,
                 write_strategy: str = "default",
                 max_size: int = DEFAULT_MAX_SIZE,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 max_entries: int = 0,
                 max_batch_bytes: int = 0,
                 max_batch_interval_ms: float = 0.0,
                 segment_writer=None,
                 blackbox_dir: Optional[str] = None,
                 phase_stats=None) -> None:
        """write_strategy (ra_log_wal.erl:66-96):

        * ``default`` — one write(2) for the batch, then the sync_mode
          syscall, then notify (durability before confirmation)
        * ``o_sync`` — the file is opened O_SYNC so the write itself is
          durable; no separate sync syscall (trades batch-write speed
          for no sync latency)
        * ``sync_after_notify`` — write, notify, THEN sync: lowest
          confirm latency, with the documented weaker window (a crash
          between notify and sync can lose confirmed-but-unsynced
          entries of that batch — same contract as the reference)

        Group-commit policy: a batch closes when the mailbox drains, when
        it holds ``max_batch`` records (or, with ``max_entries``, the
        rest of the file's record budget), when its payload bytes
        reach ``max_batch_bytes`` (0: no byte cap), or when
        ``max_batch_interval_ms`` has elapsed since the group opened —
        whichever comes first.  With the interval at 0 (default) the
        writer never waits for more traffic; a nonzero interval lets
        bursty writers amortize one fdatasync over the whole burst (the
        fan-in batching axis of ra_log_wal.erl:193-214, extended with an
        explicit wait budget).  The interval is read once per group, so a
        live change lands at the next group.  A flush barrier or rollover
        marker closes the group immediately — flush latency never pays
        the wait budget.  A file rolls over at ``max_size`` bytes, or at
        ``max_entries`` records when that is nonzero.
        """
        if write_strategy not in ("default", "o_sync",
                                  "sync_after_notify"):
            raise ValueError(f"unknown write_strategy {write_strategy!r}")
        self.dir = os.path.join(data_dir, "wal")
        os.makedirs(self.dir, exist_ok=True)
        #: where post-mortem bundles land (<dir>/blackbox): a sharded
        #: plane points every shard at ONE home so an incident's
        #: bundles sit together, not one per shard subdir
        self._bb_dir = blackbox_dir or data_dir
        self.sync_mode = sync_mode
        self.write_strategy = write_strategy
        self.max_size = max_size
        #: optional telemetry.PhaseStats — the engine durability bridge
        #: passes its accumulator so the WAL's fsync_wait and
        #: confirm_publish edges join the phase attribution;
        #: None (the classic plane default) costs nothing
        self._phases = phase_stats
        self.max_batch_bytes = max_batch_bytes
        #: group-commit wait budget (ms); the autotuner retargets it live
        self.max_batch_interval_ms = max_batch_interval_ms
        #: optional per-file record cap (wal_max_entries; the reference
        #: rolls on either limit, ra_log_wal.erl:593-620) — 0 disables
        self.max_entries = max_entries
        self._file_entries = 0
        self.max_batch = max_batch
        #: bounded reservoir of recent durability-syscall latencies (s)
        self._sync_lats: collections.deque = collections.deque(maxlen=512)
        self.segment_writer = segment_writer
        self._writers: dict[str, _Writer] = {}
        self._wid_seq = 0
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._fd: Optional[int] = None
        self._file_seq = 0
        self._file_size = 0
        self._file_path = ""
        self._file_ranges: dict[str, list] = {}  # uid -> [lo, hi] this file
        self._registered_in_file: set = set()
        self._stop = False
        #: consecutive batches that hit an I/O fault (reset on the first
        #: clean batch) — drives the poison -> rollover -> escalate ladder
        self._poison_streak = 0
        #: bumped by restart(); lets observers detect "new WAL incarnation"
        #: (the reference's new-wal-pid check, ra_log.erl:778-793)
        self.generation = 0
        #: node-wide WAL counters (ra_log_wal.erl:32-43 field names)
        from ..metrics import WAL_FIELDS
        self.counters: dict[str, int] = {f: 0 for f in WAL_FIELDS}
        self._recovered: dict[str, dict] = {}
        self._recover()
        self._open_new_file()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ra-wal")
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stop

    @property
    def phases(self):
        """The phase accumulator this WAL stamps (None when the owner
        didn't wire one) — DurableLog adds its encode stamps to the
        same accumulator so one overview covers the whole plane."""
        return self._phases

    # -- registration -------------------------------------------------------

    def register(self, uid: str, notify: NotifyFn) -> None:
        retire = None
        with self._lock:
            w = self._writers.get(uid)
            if w is None:
                self._wid_seq += 1
                self._writers[uid] = _Writer(uid, self._wid_seq, notify)
            else:
                w.notify = notify
                w.last_idx = None  # restarted writer: fresh sequence check
            # once every uid found in recovered WAL files has re-registered,
            # their entries (now in DurableLog memtables) can be flushed to
            # segments and the old files retired (the reference deletes WAL
            # files once their tables are flushed, :206-214)
            if self._recovered_files and \
                    set(self._recovered).issubset(self._writers):
                retire = (list(self._recovered), list(self._recovered_files))
                self._recovered_files = []
        if retire is not None and self.segment_writer is not None:
            uids, files = retire
            self.segment_writer.retire(uids, files)

    def purge(self, uid: str) -> None:
        """Forget a deleted server: drop its writer registration, its
        range in the current file, and its recovered table.  Without this
        a force-deleted uid pins WAL files forever — rollover keeps any
        file whose ranges contain an unresolvable uid, and the recovery
        retirement gate (register) waits for a registration that will
        never come.  Its already-written bytes in shared files remain
        until those files rotate out, as in the reference's shared WAL."""
        retire = None
        with self._lock:
            self._writers.pop(uid, None)
            self._file_ranges.pop(uid, None)
            self._recovered.pop(uid, None)
            if self._recovered_files and \
                    set(self._recovered).issubset(self._writers):
                retire = (list(self._recovered),
                          list(self._recovered_files))
                self._recovered_files = []
        if self.segment_writer is not None:
            # flush jobs already queued for this uid must skip it rather
            # than keep their WAL file waiting for a server that will
            # never come back
            self.segment_writer.mark_deleted(uid)
            if retire is not None:
                self.segment_writer.retire(*retire)

    # -- write path ---------------------------------------------------------

    def write(self, uid: str, index: int, term: int, payload: bytes,
              truncate: bool = False) -> None:
        """Async append; confirmation arrives via notify after the batch
        reaches disk.  truncate marks a post-snapshot-install write
        (wal_truncate_write, ra_log.erl:1033).  Raises WalDown when the
        batch thread is dead (the failed gen-call to a crashed
        ra_log_wal)."""
        if not self.alive:
            raise WalDown("wal batch thread is down")
        self._queue.put((uid, index, term, payload, truncate))

    def write_many(self, uid: str, items: list) -> None:
        """Group-commit fan-in submit: hand a CONTIGUOUS
        run of entries for one writer to the batch thread as ONE queue
        item — the per-entry ``write`` path costs one lock/notify
        hand-off per entry, which at batch-append rates dominates the
        submitting (event-loop) thread.  ``items`` is
        ``[(index, term, payload, truncate), ...]`` with ascending
        consecutive indexes; the batch thread applies the same
        gap-check/confirm bookkeeping once per run instead of once per
        entry, and the run lands under the same fsync group as every
        other co-hosted writer's burst."""
        if not items:
            return
        if not self.alive:
            raise WalDown("wal batch thread is down")
        self._queue.put(("__many__", uid, items, b"", None))

    def flush(self, timeout: float = 5.0) -> None:
        """Barrier: wait until everything queued so far is durable."""
        if not self.alive:
            raise WalDown("wal batch thread is down")
        done = threading.Event()
        self._queue.put(("__flush__", 0, 0, b"", done))
        if not done.wait(timeout):
            if not self.alive:
                raise WalDown("wal died during flush")
            raise TimeoutError("wal flush timed out")

    def rollover(self) -> None:
        """Force a rollover (tests + snapshot truncation)."""
        self._queue.put(("__roll__", 0, 0, b"", None))

    # -- batch thread -------------------------------------------------------

    def _run(self) -> None:
        while not self._stop:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if first[0] == "__crash__":
                # test hook: die like a real batch-thread crash (no
                # cleanup, fd left open, queued writes abandoned).
                # A kill-9 of the WAL is a flight-recorder trigger:
                # dump the post-mortem bundle before dying (the
                # nemesis wal_kill / soak --blackbox path)
                self._crash_dump()
                raise RuntimeError("wal killed")
            batch = [first]
            # cap the batch at the remaining per-file entry budget so a
            # file never exceeds max_entries (the reference evaluates
            # its roll condition per write, ra_log_wal.erl:426-441 —
            # batch-granularity enforcement alone could overshoot by a
            # whole max_batch under bursty load)
            cap = self.max_batch
            if self.max_entries:
                cap = min(cap, max(1, self.max_entries -
                                   self._file_entries))
            # group-commit collection: greedy drain up to ``cap``
            # records (a __many__ fan-in item counts its whole run and
            # is never split), optionally holding the
            # group open up to max_batch_interval_ms / until
            # max_batch_bytes, so one fdatasync covers the whole burst.
            # Flush/roll markers close the group immediately.
            urgent = first[0] in ("__flush__", "__roll__")
            group_count, group_bytes = (0, 0) if urgent else \
                self._item_weight(first)
            interval_ms = self.max_batch_interval_ms  # once per group
            deadline = time.monotonic() + interval_ms / 1000.0 \
                if interval_ms > 0 else None
            while group_count < cap and not urgent:
                if self.max_batch_bytes and \
                        group_bytes >= self.max_batch_bytes:
                    break
                try:
                    if deadline is None:
                        item = self._queue.get_nowait()
                    else:
                        wait = deadline - time.monotonic()
                        item = self._queue.get_nowait() if wait <= 0 \
                            else self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if item[0] == "__crash__":
                    # the crash hook must fire even when collected into
                    # an open group (interval mode)
                    self._crash_dump()
                    raise RuntimeError("wal killed")
                batch.append(item)
                if item[0] in ("__flush__", "__roll__"):
                    urgent = True
                else:
                    n, b = self._item_weight(item)
                    group_count += n
                    group_bytes += b
            # a hard batch failure (disk error) kills the thread — the
            # supervisor restarts the WAL and writers resend, the same
            # let-it-crash shape as the reference's ra_log_wal under
            # ra_log_wal_sup (ra_log_sup.erl:26-51)
            with trace.span("wal.batch", "wal", n=len(batch)):
                self._write_batch(batch)

    @staticmethod
    def _item_weight(item) -> tuple:
        """(entry count, payload bytes) of one queue item — a plain
        write weighs 1, a __many__ fan-in run weighs its whole batch."""
        if item[0] == "__many__":
            return len(item[2]), sum(len(p) for _i, _t, p, _tr in item[2])
        return 1, len(item[3])

    def kill(self) -> None:
        """Simulate a WAL crash (tests / fault injection)."""
        self._queue.put(("__crash__", 0, 0, b"", None))
        self._thread.join(timeout=5)

    def _crash_dump(self) -> None:
        """Flight-recorder trigger for an injected WAL kill: record the
        event and write the post-mortem bundle next to the data dir."""
        record("wal.kill", file=self._file_path,
               queue_depth=self._queue.qsize())
        RECORDER.dump("wal_kill", what="injected WAL batch-thread kill",
                      where=self._file_path, data_dir=self._bb_dir)

    def restart(self) -> None:
        """Supervisor hook: revive a crashed WAL.

        The half-written current file keeps everything that was confirmed
        (notify only follows durability), so its per-writer ranges are
        handed to the segment writer exactly like a rollover.  Queued but
        unwritten entries are dropped — they were never confirmed, and
        writers resend everything above last_written after a restart
        (DurableLog.wal_restarted, mirroring ra_log.erl:778-793)."""
        if self.alive or self._stop:
            return
        with self._lock:
            self._queue = queue.Queue()  # crash loses the mailbox
            for w in self._writers.values():
                w.last_idx = None  # writers resend; fresh sequence check
        self._retire_current_file()
        self._poison_streak = 0  # fresh incarnation, fresh ladder
        self.generation += 1
        record("wal.restart", generation=self.generation)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ra-wal")
        self._thread.start()

    def _write_batch(self, batch: list) -> None:
        buf = bytearray()
        flushes = []
        roll = False
        confirms: dict[str, list] = {}  # uid -> [lo, hi, term]
        pending_last: dict[str, int] = {}  # provisional last_idx this batch
        new_regs: set = set()
        n_entries = 0
        pack_hdr = _ENT_HDR.pack
        pack_crc = _CRC.pack
        with self._lock:
            for item in batch:
                uid = item[0]
                if uid == "__flush__":
                    flushes.append(item[4])
                    continue
                if uid == "__roll__":
                    roll = True
                    continue
                if uid == "__many__":
                    # fan-in run: one writer's contiguous batch — the
                    # gap check, registration, and confirm-range update
                    # happen ONCE per run; only pack/crc/append remain
                    # per entry (the irreducible record-format work)
                    _tag, muid, items = item[0], item[1], item[2]
                    w = self._writers.get(muid)
                    if w is None:
                        continue
                    first_idx = items[0][0]
                    last = pending_last.get(muid, w.last_idx)
                    if last is not None and first_idx > last + 1 and \
                            not items[0][3]:
                        record("wal.resend", uid=muid, frm=last,
                               gap_at=first_idx)
                        w.notify(muid, None, last, -1)
                        continue
                    if w.wid not in self._registered_in_file and \
                            w.wid not in new_regs:
                        ub = w.uid.encode()
                        buf += _REG.pack(1, w.wid, len(ub))
                        buf += ub
                        new_regs.add(w.wid)
                    # the run lands as ONE type-3 record: a bulk-packed
                    # triplet table, one streaming crc — no per-entry
                    # pack/crc/append on the batch thread.  Payload
                    # images intern into the file-scope table (type 4):
                    # co-hosted members writing the same replicated
                    # burst pay the image bytes once, not once per
                    # member — the fan-out was most of the WAL's crc +
                    # write(2) volume
                    intern = self._intern
                    nslot = self._intern_n
                    new_lens: list = []
                    new_blobs: list = []
                    flat: list = []
                    grow = flat.append
                    for index, term, payload, _trunc in items:
                        slot = intern.get(payload)
                        if slot is None:
                            slot = intern[payload] = nslot
                            nslot += 1
                            new_lens.append(len(payload))
                            new_blobs.append(payload)
                        grow(index)
                        grow(term)
                        grow(slot)
                    if new_blobs:
                        lens = struct.pack("<%dI" % len(new_lens),
                                           *new_lens)
                        cat = b"".join(new_blobs)
                        phdr = _PAY_HDR.pack(4, len(new_blobs),
                                             len(lens) + len(cat))
                        pcrc = IO.crc32(cat, IO.crc32(lens,
                                                      IO.crc32(phdr)))
                        buf += phdr
                        buf += pack_crc(pcrc)
                        buf += lens
                        buf += cat
                        self._intern_n = nslot
                    tab = struct.pack("<" + "QQI" * len(items), *flat)
                    hdr = _RUN_HDR.pack(3, w.wid, len(items), len(tab))
                    crc = IO.crc32(tab, IO.crc32(hdr))
                    buf += hdr
                    buf += pack_crc(crc)
                    buf += tab
                    n_entries += len(items)
                    last_item = items[-1]
                    pending_last[muid] = last_item[0]
                    c = confirms.setdefault(
                        muid, [first_idx, last_item[0], last_item[1]])
                    c[0] = min(c[0], first_idx)
                    c[1] = max(c[1], last_item[0])
                    c[2] = last_item[1]
                    continue
                _uid, index, term, payload, extra = item
                w = self._writers.get(uid)
                if w is None:
                    continue
                truncate = bool(extra)
                last = pending_last.get(uid, w.last_idx)
                if last is not None and index > last + 1 and not truncate:
                    # gap: out-of-sequence write — tell the writer to
                    # resend from its last accepted index (:457-481)
                    record("wal.resend", uid=uid, frm=last, gap_at=index)
                    w.notify(uid, None, last, -1)
                    continue
                if w.wid not in self._registered_in_file and \
                        w.wid not in new_regs:
                    ub = w.uid.encode()
                    buf += _REG.pack(1, w.wid, len(ub))
                    buf += ub
                    new_regs.add(w.wid)
                hdr = pack_hdr(2, w.wid, index, term, len(payload))
                buf += hdr
                buf += pack_crc(_entry_crc(hdr, payload))
                buf += payload
                n_entries += 1
                pending_last[uid] = index
                c = confirms.setdefault(uid, [index, index, term])
                c[0] = min(c[0], index)
                c[1] = max(c[1], index)
                c[2] = term
        deferred_sync = False
        if buf:
            # IO first, bookkeeping after: if the write throws, last_idx
            # and _file_ranges still describe only bytes the file really
            # holds — rollover/restart hand _file_ranges to the segment
            # writer, which flushes and then DELETES the file, so
            # overstating the ranges would silently drop acknowledged
            # entries
            try:
                if self.write_strategy == "o_sync":
                    # O_SYNC fd: the write IS the durability point
                    n = IO.write_batch(self._fd, bytes(buf), 0)
                elif self.write_strategy == "sync_after_notify":
                    n = IO.write_batch(self._fd, bytes(buf), 0)
                    deferred_sync = self.sync_mode != 0
                else:
                    n = IO.write_batch(self._fd, bytes(buf), 0)
                    if self.sync_mode:
                        self._timed_sync()
            except OSError as exc:
                # nothing was confirmed: bookkeeping and notify are
                # skipped, the batch's entries stay memtable-resident,
                # and the degradation ladder (poison -> rollover ->
                # resend, escalate after a streak) takes over
                self._on_batch_io_error(exc, flushes)
                return
            self._poison_streak = 0
            self._file_size += n
            self._file_entries += n_entries
            self.counters["batches"] += 1
            self.counters["writes"] += n_entries
            self.counters["bytes_written"] += n
            # flight-recorder hop: the batch's per-uid index ranges are
            # the (uid, idx) join key ra_trace resolves traced commands'
            # WAL-write time through
            record("wal.write", file=os.path.basename(self._file_path),
                   n=n_entries, bytes=n,
                   ranges={u: [c[0], c[1]] for u, c in confirms.items()})
            with self._lock:
                self._registered_in_file |= new_regs
                for uid, last in pending_last.items():
                    w = self._writers.get(uid)
                    if w is None:
                        continue  # purged mid-write: no range resurrection
                    w.last_idx = last
                    lo = confirms[uid][0]
                    r = self._file_ranges.setdefault(uid, [lo, last])
                    r[0] = min(r[0], lo)
                    r[1] = max(r[1], last)
        # notify AFTER durability (complete_batch, :753-800)
        with self._lock:
            notifiers = [(self._writers[uid].notify, uid, c)
                         for uid, c in confirms.items()
                         if uid in self._writers]
        t_pub = time.monotonic() if notifiers else 0.0
        for notify, uid, (lo, hi, term) in notifiers:
            record("wal.confirm", uid=uid, lo=lo, hi=hi)
            notify(uid, lo, hi, term)
        if notifiers and self._phases is not None:
            # confirm_publish phase stamp: durability -> every writer's
            # confirm callback returned (the fan-out the commit quorum
            # waits behind)
            self._phases.note("confirm_publish",
                              time.monotonic() - t_pub)
        if deferred_sync:
            # sync_after_notify: durability syscall AFTER the confirms
            # (complete_batch with post-notify sync, ra_log_wal.erl:66-96)
            try:
                self._timed_sync()
            except OSError as exc:
                # the documented weaker window of this strategy: the
                # batch was already confirmed but may not be durable.
                # Poison + rollover; passing the batch's confirm window
                # makes the resend reach BELOW last_idx and re-write the
                # confirmed-but-unsynced suffix into the fresh file,
                # closing the window going forward.
                self._on_batch_io_error(exc, flushes, confirmed=confirms)
                return
        if roll or self._file_size >= self.max_size or \
                (self.max_entries and
                 self._file_entries >= self.max_entries):
            self._rollover()
        # flush barriers release only after any requested rollover has been
        # handed to the segment writer (callers chain await_idle after)
        for done in flushes:
            done.set()

    def _on_batch_io_error(self, exc: OSError, flushes: list,
                           confirmed: Optional[dict] = None) -> None:
        """Degradation policy for a failed batch write or durability
        syscall — the fsyncgate discipline made supervision-shaped:

        * the current file is POISONED: its fd is never fsynced again
          (after a failed fsync the kernel may have dropped the dirty
          pages, so a retried fsync can report success over lost data).
          The file is retired exactly like a rollover — its confirmed
          ranges go to the segment writer, which flushes them from the
          MEMTABLES, so nothing acknowledged depends on the bad file.
        * every registered writer gets a resend_from signal at its last
          accepted index: unconfirmed entries re-enter the queue and
          land in the fresh file (writers re-register on first write).
        * flush barriers are RE-QUEUED, not released — a durability
          barrier may only trip once the resends are really on disk.
        * MAX_POISON_STREAK consecutive faulted batches escalate to
          thread death: the supervisor restarts the WAL under its
          intensity window instead of this thread hot-looping rollovers
          against a dead disk.
        """
        import logging
        logging.getLogger("ra_tpu_torch").warning(
            "wal batch I/O error (%s): poisoning %s",
            exc, self._file_path)
        _fault_note("faults_hit")
        _fault_note("poisoned_files")
        self._poison_streak += 1
        record("wal.poison", file=os.path.basename(self._file_path),
               error=repr(exc)[:200], streak=self._poison_streak)
        if self._poison_streak >= MAX_POISON_STREAK:
            _fault_note("wal_escalations")
            record("wal.escalate", streak=self._poison_streak,
                   error=repr(exc)[:200])
            # black-box trigger: the ladder is giving up this thread —
            # capture the rings + fault-plan state before dying
            RECORDER.dump("wal_escalation",
                          what=f"poison streak {self._poison_streak} "
                               "-> thread death",
                          where=self._file_path, data_dir=self._bb_dir)
            raise exc
        _fault_note("fault_rollovers")
        self._retire_current_file()
        with self._lock:
            # last_idx None (a writer that never confirmed through this
            # incarnation, e.g. right after a supervised restart) means
            # "resend everything memtable-resident": hi=0 — duplicates
            # are harmless (overwrite dedup + stale-confirm clamping).
            # ``confirmed`` (the sync_after_notify failure path) pulls
            # the resend floor below entries that were confirmed ahead
            # of the durability syscall that then failed; those resends
            # carry term=-2 ("unsynced-confirm rewind") so a writer that
            # floor-clamps its resends to its own confirm watermark
            # (DurableLog does) knows to pull that watermark back first
            # instead of trusting the poisoned file for the suffix.
            resends = []
            for w in self._writers.values():
                last = w.last_idx if w.last_idx is not None else 0
                term = -1
                if confirmed and w.uid in confirmed:
                    last = min(last, confirmed[w.uid][0] - 1)
                    term = -2
                resends.append((w.notify, w.uid, max(0, last), term))
        for notify, uid, last, term in resends:
            notify(uid, None, last, term)
        for done in flushes:
            self._queue.put(("__flush__", 0, 0, b"", done))

    def _timed_sync(self) -> None:
        """Durability syscall with latency accounting (the reference
        exposes the same number as wal_sync_time via seshat)."""
        t0 = time.monotonic()
        IO.sync(self._fd, self.sync_mode)
        dt = time.monotonic() - t0
        self.counters["syncs"] += 1
        self.counters["sync_time_us"] += int(dt * 1e6)
        record("wal.fsync", ms=round(dt * 1000, 3),
               file=os.path.basename(self._file_path))
        if self._phases is not None:
            # fsync_wait phase stamp (the durability-syscall edge of
            # the per-window budget attribution)
            self._phases.note("fsync_wait", dt)
        with self._lock:
            # stats() iterates the reservoir from other threads; an
            # unguarded append would intermittently crash that read
            # with "deque mutated during iteration"
            self._sync_lats.append(dt)

    def stats(self) -> dict:
        """Counters plus derived group-commit health: fsync latency
        p50/p99 (from a bounded reservoir of recent syncs) and mean
        records per fsync — the amortization factor group commit buys."""
        d = dict(self.counters)
        with self._lock:
            lats = sorted(self._sync_lats)
        if lats:
            d["fsync_p50_ms"] = round(1000 * lats[len(lats) // 2], 3)
            d["fsync_p99_ms"] = round(
                1000 * lats[min(len(lats) - 1, int(len(lats) * 0.99))], 3)
        else:
            d["fsync_p50_ms"] = d["fsync_p99_ms"] = -1.0
        # -1 sentinel when no durability syscall ever ran (sync_mode=0,
        # o_sync) — matching the fsync percentile sentinels; the raw
        # write count would read as extreme amortization otherwise
        d["records_per_fsync"] = round(
            d["writes"] / d["syncs"], 2) if d["syncs"] else -1.0
        # live write-queue backlog: the group-commit pipeline depth
        # gauge the Observatory/ra_top surface next to fsync latency —
        # a climbing depth with flat p50 means the writer is starved,
        # a climbing depth with climbing p99 means the disk is
        d["queue_depth"] = self._queue.qsize()
        return d

    # -- files / rollover / recovery ---------------------------------------

    def _open_new_file(self) -> None:
        """Open the next file and write its magic.  A magic write that
        fails (torn or refused) unlinks that file, which holds no
        record, and opens the next one, up to ``MAX_POISON_STREAK``
        files; the reference raises at the first, out of ``__init__``,
        ``restart`` or a fault rollover."""
        for tries in range(MAX_POISON_STREAK, 0, -1):
            self.counters["wal_files"] += 1
            self._file_seq += 1
            self._file_path = os.path.join(self.dir,
                                           f"{self._file_seq:08d}.wal")
            self._fd = IO.wal_open(self._file_path, truncate=True,
                                   o_sync=self.write_strategy == "o_sync")
            try:
                IO.write_batch(self._fd, MAGIC, 0)
                break
            except OSError as exc:
                if tries == 1:
                    raise
                _fault_note("faults_hit")
                _fault_note("poisoned_files")
                record("wal.poison", file=os.path.basename(self._file_path),
                       error=repr(exc)[:200], streak=self._poison_streak)
                try:
                    IO.close(self._fd)
                    os.unlink(self._file_path)
                except OSError:
                    # safe to swallow: the file holds no record; a
                    # leftover is read back as a torn file and skipped
                    _fault_note("swallowed_oserrors")
        self._file_size = len(MAGIC)
        self._file_entries = 0
        self._registered_in_file = set()
        self._file_ranges = {}
        # payload interning is file-scope: type-3 slots index the table
        # accumulated by THIS file's type-4 records, so the dict resets
        # with the file (also on the fault-rollover path — a poisoned
        # file's slots must not leak into the fresh one)
        self._intern: dict = {}
        self._intern_n = 0

    def _rollover(self) -> None:
        self._retire_current_file()

    def _retire_current_file(self) -> None:
        """Close the current file, open a fresh one, and hand the closed
        file's per-writer ranges to the segment writer (an empty file is
        unlinked).  Shared by rollover and crash restart — both retire
        the file the same way."""
        old_fd, old_path = self._fd, self._file_path
        with self._lock:
            ranges = {uid: tuple(r) for uid, r in self._file_ranges.items()}
        try:
            IO.close(old_fd)
        except OSError:
            # safe to swallow: the fd is retiring and is never read or
            # synced again — its confirmed entries are covered by the
            # memtable + segment-flush barrier, and a poisoned fd may
            # legitimately surface its deferred EIO here
            _fault_note("swallowed_oserrors")
        self._open_new_file()
        if ranges and self.segment_writer is not None:
            self.segment_writer.accept_ranges(ranges, old_path)
        elif not ranges:
            try:
                os.unlink(old_path)
            except OSError:
                # safe to swallow: an empty (magic-only) file that fails
                # to unlink leaks bytes, not data — recovery re-reads it
                # as a no-op
                _fault_note("swallowed_oserrors")

    def _recover(self) -> None:
        files = sorted(f for f in os.listdir(self.dir)
                       if f.endswith(".wal"))
        for fname in files:
            path = os.path.join(self.dir, fname)
            try:
                self._recover_file(path)
            except Exception:
                import logging
                logging.getLogger("ra_tpu_torch").warning(
                    "wal recovery: truncated/corrupt tail in %s", fname)
            seq = int(fname.split(".")[0])
            self._file_seq = max(self._file_seq, seq)
        self._recovered_files = [os.path.join(self.dir, f) for f in files]

    def _recover_file(self, path: str) -> None:
        scan_wal_file(path, self._recovered)

    def recovered_table(self, uid: str) -> dict:
        """Entries for uid recovered from surviving WAL files
        (idx -> (term, payload)); consumed by DurableLog init."""
        return self._recovered.get(uid, {})

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=5)
        if self._fd is not None:
            IO.close(self._fd)
            self._fd = None
