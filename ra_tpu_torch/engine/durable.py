"""Durability bridge between the lockstep lane engine and the WAL plane.

The port of ``ra_tpu/engine/durable.py``.  In durable mode a step's
accepted entries are compacted ON THE DEVICE into a dense row buffer
(``lockstep._compact_accepted``: the readback carries only bytes that
will hit disk), pulled off the device by per-shard encode workers,
encoded as one WAL record per step per shard, and fed through S
independent :class:`ra_tpu_torch.log.wal.Wal` shards, each with its own
file, writer thread and fsync and the adaptive group commit (one
fdatasync a group).  Every shard's fsync confirm comes back as a slice
of the ``confirm_upto`` input of a later dispatch, so ``last_written``,
and with it the commit quorum, advances only over entries that are
really on disk: an entry counts toward the commit quorum only after
write(2)+fsync (ra_log_wal.erl:753-800), with the single fan-in writer
multiplied across cores.

The readback from a CUDA engine.  The dispatch thread never waits on the
device: for each dispatch it starts one asynchronous
:class:`ra_tpu_torch.readback.Readback` of the four ``int32[N]`` header
leaves a block needs (``appended_hi``, ``n_app``, ``n_acc``,
``row_csum``; ``[K, N]`` for a superstep) and queues the step's
``flat_rows`` tensor.  A shard's worker waits on that readback's event,
computes its lane slice's row range ``[r0, r1)`` from ``row_csum``, and
copies exactly ``flat_rows[r0:r1]`` into the shard's own pinned buffer
(reused from step to step, grown only when a step needs more), on the
shard's own CUDA stream after an event recorded behind the dispatch.
The job holds the source tensor until that copy has landed.  That copy
and its event are the only device work a worker issues; a CPU engine's
workers read the tensors directly.  Byte counts (``readback_bytes``,
``readback_bytes_full``, ``encoded_*``) are the reference's for the same
schedule.

Record format (one WAL payload per step per shard, uid ``__engine__``),
byte-identical with the reference's, so either package recovers the
other's directories:

  RTB1:  magic(4) | n_lanes:u32 | C:u32 | dtype:8s | n_flat:u32
  RTB2:  magic(4) | n_lanes:u32 | C:u32 | dtype:8s | n_flat:u32 | lane_lo:u32
  hi:    i32[N]   leader tail after the step (per lane of the slice)
  n_app: i32[N]   entries appended this step (accepted cmds + noop)
  n_acc: i32[N]   how many of those came from the host batch
  flat:  [n_flat, C] the accepted host rows, lane-major

RTB1 is the lane_lo=0 form, which ``wal_shards=1`` emits; shards at a
nonzero lane offset emit RTB2, so blocks describe their own lane slice
and recovery merges any mix of shard layouts found on disk (a change of
shard count needs no migration).

``hi - n_app`` is the step's append base; a base below the running tail
records an election truncation (a deposed leader's unconfirmed suffix),
the overwrite-invalidates-higher-indexes rule of WAL recovery
(ra_log_wal.erl:871-955) at step granularity.  Entries between
``n_acc`` and ``n_app`` are the term-opening noop (all-zero payload).

Recovery (:func:`open_engine`) restores the latest checkpoint, scans
every surviving WAL shard (and leftovers of another layout), stitches
the per-slice pieces into full-lane step blocks, resolves truncations,
and replays them through the engine's step on its device (the commit
phase kernel once a block on the card).  A crash (kill -9) loses
nothing that was ever reported committed.

Checkpointing (:meth:`EngineDurability.checkpoint`) quiesces all shards,
snapshots the full lane state via ``engine.save`` (atomic .npz), and
prunes WAL files the checkpoint covers.

A sharded engine (``parallel.mesh.shard_engine_state``) hands over its
aux as ``LaneParts``, one piece a lane shard.  Where the WAL shards
split the lanes as the mesh does (``per_device_wal_shards``), WAL shard
``i`` reads only lane shard ``i``'s piece, from that shard's device, and
writes RTB2 blocks at its ``lane_lo``.  Any other layout materialises a
dispatch's aux on the host once (:class:`_HostAux`): the dispatch thread
starts every piece's copy, and the encode workers only wait for the
copies and slice numpy; they launch no device work.  ``open_engine``
reopens a directory written under any mesh shape, or none.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import struct
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import devicewatch, trace
from ..blackbox import RECORDER, record, stamp_recovery
from ..core.tree import tree_map
from ..log import faults
from ..log.wal import Wal, WalDown, scan_wal_file
from ..metrics import ENGINE_WAL_FIELDS
from ..readback import Readback
from ..telemetry import PhaseStats
from .shards import LaneParts

UID = "__engine__"

#: shard-WAL supervisor restart intensity: (max restarts, window s) —
#: the engine twin of system.WAL_RESTART_INTENSITY; beyond it the
#: supervisor backs off for the window instead of hot-looping against a
#: dead disk
SHARD_RESTART_INTENSITY = (10, 5.0)
#: the default byte cap of a shard's group commit (the reference's
#: ``wal_batch_bytes``)
WAL_BATCH_BYTES = 4 * 1024 * 1024
#: recovery settle steps before ``open_engine`` gives up
SETTLE_LIMIT = 10_000
MAGIC = b"RTB1"
MAGIC2 = b"RTB2"          # RTB1 + lane_lo:u32 (sharded lane slice)
_BLK = struct.Struct("<4sII8sI")
_BLK2 = struct.Struct("<4sII8sII")


def encode_block_flat(hi: np.ndarray, n_app: np.ndarray, n_acc: np.ndarray,
                      flat: np.ndarray, lane_lo: int = 0) -> bytes:
    """Encode one step's append outcome for a lane slice from the
    already-compacted accepted rows (lane-major).  ``lane_lo == 0``
    emits the legacy RTB1 bytes; a sharded slice carries its offset."""
    n = hi.shape[0]
    flat = np.ascontiguousarray(flat)
    if flat.ndim != 2:
        flat = flat.reshape(flat.shape[0], -1)
    c = flat.shape[1]
    dt = np.dtype(flat.dtype).str.encode().ljust(8, b"\x00")
    if lane_lo:
        head = _BLK2.pack(MAGIC2, n, c, dt, flat.shape[0], lane_lo)
    else:
        head = _BLK.pack(MAGIC, n, c, dt, flat.shape[0])
    return b"".join((head,
                     np.ascontiguousarray(hi, "<i4").tobytes(),
                     np.ascontiguousarray(n_app, "<i4").tobytes(),
                     np.ascontiguousarray(n_acc, "<i4").tobytes(),
                     flat.tobytes()))


def encode_block(hi: np.ndarray, n_app: np.ndarray, n_acc: np.ndarray,
                 payload_host: np.ndarray) -> bytes:
    """Legacy host-side path: mask the accepted rows out of the full
    [N, K, C] batch, then encode.  Byte-identical to what the device
    compaction path produces — kept for tests and offline tooling."""
    _N, K, _C = payload_host.shape
    mask = np.arange(K)[None, :] < n_acc[:, None]
    return encode_block_flat(hi, n_app, n_acc, payload_host[mask])


def decode_block(data: bytes):
    """Inverse of the encoders -> (lane_lo, hi, n_app, n_acc, rows)
    where rows is [N, Kmax, C] for the block's lane slice with noop
    rows already zero-filled."""
    magic = data[:4]
    if magic == MAGIC2:
        _m, n, c, dt, n_flat, lane_lo = _BLK2.unpack_from(data, 0)
        off = _BLK2.size
    elif magic == MAGIC:
        _m, n, c, dt, n_flat = _BLK.unpack_from(data, 0)
        lane_lo = 0
        off = _BLK.size
    else:
        raise ValueError("bad engine block magic")
    dtype = np.dtype(dt.rstrip(b"\x00").decode())
    hi = np.frombuffer(data, "<i4", n, off).astype(np.int32)
    off += 4 * n
    n_app = np.frombuffer(data, "<i4", n, off).astype(np.int32)
    off += 4 * n
    n_acc = np.frombuffer(data, "<i4", n, off).astype(np.int32)
    off += 4 * n
    flat = np.frombuffer(data, dtype, n_flat * c, off).reshape(n_flat, c)
    kmax = int(n_app.max()) if n else 0
    rows = np.zeros((n, kmax, c), dtype)
    if kmax:
        mask = np.arange(kmax)[None, :] < n_acc[:, None]
        rows[mask] = flat
    return lane_lo, hi, n_app, n_acc, rows


class _HostAux:
    """One dispatch's aux of a sharded engine on the host, for WAL shards
    that split the lanes otherwise than the mesh.  The copies of every
    piece start on the dispatch thread (one ``Readback``); the first
    encode worker to need a step waits for them and joins the pieces into
    the aux of an unsharded engine (``row_csum`` running over every lane,
    the accepted rows back to back), the others reuse it.  No device
    work on a worker thread."""

    def __init__(self, aux: dict, bounds: list, keys: tuple) -> None:
        self._rb = Readback({(key, i): aux[key].parts[i] for key in keys
                             for i in range(len(bounds))})
        self._n = len(bounds)
        self._lock = threading.Lock()
        self._steps: dict = {}

    def step(self, j: Optional[int]) -> dict:
        with self._lock:
            got = self._steps.get(j)
            if got is None:
                got = self._steps[j] = self._join(j)
            return got

    def _join(self, j: Optional[int]) -> dict:
        host = self._rb.result()

        def piece(key, i):
            x = host[(key, i)]
            return x if j is None else x[j]

        out = {key: np.concatenate([piece(key, i) for i in range(self._n)])
               for key in ("appended_hi", "n_app", "n_acc")}
        csums, rows, base = [], [], 0
        for i in range(self._n):
            c = piece("row_csum", i).astype(np.int64)
            total = int(c[-1]) if len(c) else 0
            rows.append(piece("flat_rows", i)[:total])
            csums.append(c + base)
            base += total
        out["row_csum"] = np.concatenate(csums).astype(np.int32)
        out["flat_rows"] = np.concatenate(rows)
        return out


class _WalFileRetirer:
    """Duck-typed segment_writer for an engine WAL shard: instead of
    flushing per-server memtables to segments, rolled WAL files are kept
    until a checkpoint covers their step range, then unlinked — the
    engine's .npz checkpoint plays the segment role (the WAL-file
    deletion barrier of ra_log_segment_writer.erl:129-201)."""

    def __init__(self) -> None:
        self._files: list = []  # (hi_step, path)
        self._lock = threading.Lock()

    def accept_ranges(self, ranges: dict, wal_path: str) -> None:
        hi = max(r[1] for r in ranges.values())
        with self._lock:
            self._files.append((hi, wal_path))

    def retire(self, uids: list, wal_files: list) -> None:
        # recovered files: every record in them predates any future
        # checkpoint, so hi=0 (pruned by the first checkpoint taken)
        with self._lock:
            for path in wal_files:
                self._files.append((0, path))

    def mark_deleted(self, uid: str) -> None:  # pragma: no cover
        pass

    def prune(self, ckpt_step: int) -> None:
        with self._lock:
            keep = []
            for hi, path in self._files:
                if hi <= ckpt_step:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                else:
                    keep.append((hi, path))
            self._files = keep


class _WalShard:
    """One WAL shard: a contiguous lane slice [lo, hi) with its own
    file, writer thread and fsync, plus an encode worker that pulls the
    device-compacted aux of queued steps to the host, encodes the WAL
    block (CRC included) off the engine dispatch thread, and hands it to
    this shard's fan-in Wal — so dispatch N+1 overlaps step N's
    encode+write+fsync end to end."""

    def __init__(self, bridge, idx: int, lo: int, hi: int,
                 shard_dir: str, wal_kwargs: dict) -> None:
        self.idx = idx
        self.lo = lo
        self.hi = hi
        self.bridge = bridge  # ra-type: EngineDurability
        self.error: Optional[BaseException] = None
        self.retirer = _WalFileRetirer()
        self.wal = Wal(shard_dir, segment_writer=self.retirer,
                       **wal_kwargs)
        self.confirmed_step = 0
        self.confirm_upto = np.zeros((hi - lo,), np.int32)
        self._appended: dict = {}   # step -> hi np[N_s] (until confirmed)
        self._blocks: dict = {}     # step -> bytes      (until confirmed)
        self._bases: dict = {}      # step -> base np[N_s]
        self._jobs: collections.deque = collections.deque()
        self.unprocessed = 0
        self._resend_above: Optional[int] = None
        #: CUDA engines: this shard's copy stream, the pinned rows buffer
        #: reused from step to step, and the event of its last copy
        self._stream = None
        self._pinned: Optional[torch.Tensor] = None
        self._copied = None
        self._generation = self.wal.generation
        self._stop = False
        self.wal.register(UID, self._notify)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"ra-engine-wal-s{idx}")
        self._thread.start()

    # -- WAL confirm path (called from this shard's WAL batch thread) ------

    def _notify(self, uid: str, lo: Optional[int], hi: int,
                term: int) -> None:
        cond = self.bridge._cond
        with cond:
            if lo is None:
                # out-of-sequence signal: resend everything above hi on
                # the encode worker (ra_log_wal.erl:457-481)
                self._resend_above = hi
                cond.notify_all()
                return
            if hi <= self.confirmed_step:
                return
            self.confirmed_step = hi
            # (lane, submit_index)-keyed durable hop: the shard's step
            # horizon advanced — ra_trace joins this against
            # engine.submit by step range (docs/INTERNALS.md §10)
            record("engine.confirm", shard=self.idx, step=hi)
            # commit_e2e phase stamp: a step is end-to-end durable when
            # EVERY shard's horizon covers it (the merged confirm rule
            # the commit quorum gates on) — pop matured submit stamps
            # at the moment the laggiest shard advances
            self.bridge._note_confirmed_steps()
            arr = self._appended.get(hi)
            if arr is not None:
                # exact durable tail as of step hi — then re-apply the
                # bases of still-unconfirmed steps: an unconfirmed
                # truncation means indexes above its base are occupied
                # by entries not yet on disk
                confirm = arr.copy()
                for s, base in self._bases.items():
                    if s > hi:
                        confirm = np.minimum(confirm, base)
                self.confirm_upto = confirm
            for s in [s for s in self._appended if s <= hi]:
                del self._appended[s]
                self._blocks.pop(s, None)
                self._bases.pop(s, None)
            cond.notify_all()

    # -- encode worker ------------------------------------------------------

    def _run(self) -> None:
        cond = self.bridge._cond
        while True:
            with cond:
                cond.wait_for(
                    lambda: self._stop or self._jobs
                    or self._resend_above is not None,
                    timeout=0.25)
                if self._stop:
                    return
                job = self._jobs.popleft() if self._jobs else None
            self._maybe_resend()
            if job is None:
                continue
            step, work, t_enq = job
            # queue_wait phase stamp: how long the submitted step sat
            # in this shard's encode queue before a worker picked it up
            self.bridge.phases.note("queue_wait",
                                    time.monotonic() - t_enq)
            try:
                self._process(step, work)
            except Exception as exc:  # noqa: BLE001 — surfaced to callers
                record("engine.crash", shard=self.idx,
                       error=repr(exc)[:200])
                RECORDER.dump("engine_shard_error",
                              what=repr(exc)[:200],
                              where=f"shard{self.idx}",
                              data_dir=self.bridge.dir)
                with cond:
                    self.error = exc
            finally:
                with cond:
                    self.unprocessed -= 1
                    cond.notify_all()

    def _process(self, step: int, job: dict) -> None:
        lo, hi_l = self.lo, self.hi
        t_enc = time.monotonic()
        with trace.span("wal.encode", "wal", shard=self.idx, step=step):
            if "host" in job:
                # another layout than the mesh's: numpy slices of the
                # dispatch's aux, materialised on the host once
                blk = job["host"].step(job["j"])
                off = 0
            else:
                # the header leaves of the whole dispatch (or of this
                # shard's lane shard), in flight since the dispatch
                # thread queued it: wait for the copy to land
                blk = job["hdr"].result()
                if job["j"] is not None:
                    blk = {key: x[job["j"]] for key, x in blk.items()}
                off = job["lo"]
            a, b = lo - off, hi_l - off
            hi = blk["appended_hi"][a:b]
            n_app = blk["n_app"][a:b]
            n_acc = blk["n_acc"][a:b]
            # only this slice's row-offset boundary values are counted
            csum = blk["row_csum"][max(0, a - 1):b]
            r0 = int(csum[0]) if a else 0
            r1 = int(csum[-1])
            csum_bytes = 4 * (b - a + (1 if lo else 0))
            flat = blk["flat_rows"][r0:r1] if "host" in job \
                else self._pull_rows(job, r0, r1)
            t_blk = time.monotonic()
            blk = encode_block_flat(hi, n_app, n_acc, flat, lane_lo=lo)
            # encode phase stamp: just the block encode+CRC,
            # the lane plane's contribution to encode_share_pct (the
            # classic plane's half lands in DurableLog._put_batch)
            self.bridge.phases.note("encode", time.monotonic() - t_blk)
        # wal_encode phase stamp: readback pull + encode + CRC for one
        # step's block on this shard (runs off the dispatch thread)
        self.bridge.phases.note("wal_encode", time.monotonic() - t_enc)
        n_s = hi_l - lo
        k = job["kc"]
        item = flat.dtype.itemsize * (flat.shape[-1] if flat.ndim > 1
                                      else 1)
        base = hi - n_app
        cond = self.bridge._cond
        with cond:
            ctr = self.bridge.counters
            ctr["readback_bytes"] += (hi.nbytes + n_app.nbytes +
                                      n_acc.nbytes + csum_bytes +
                                      flat.nbytes)
            # what the pre-compaction full-ring readback moved for the
            # same step slice: the whole [N_s, K, C] host batch
            ctr["readback_bytes_full"] += (hi.nbytes + n_app.nbytes +
                                           n_acc.nbytes + n_s * k * item)
            ctr["encoded_blocks"] += 1
            ctr["encoded_bytes"] += len(blk)
            # transfer-ledger mirror: the WAL encode pull is the third
            # device-to-host line of a durable dispatch loop, the same
            # bytes as readback_bytes (host int increments only)
            devicewatch.record_d2h(
                "wal_readback",
                hi.nbytes + n_app.nbytes + n_acc.nbytes +
                csum_bytes + flat.nbytes)
            self._appended[step] = hi
            self._blocks[step] = blk
            self._bases[step] = base
            # an election truncation reuses indexes: the durable horizon
            # drops to the step's base until this block itself confirms
            self.confirm_upto = np.minimum(self.confirm_upto, base)
        # sync with any new WAL incarnation BEFORE submitting: a fresh
        # writer accepts any first step, so writing this block ahead of
        # the unconfirmed backlog would leave a step gap in the new file
        # if the WAL dies again before the backlog resends (recovery
        # also guards against the remaining race — _assemble_blocks
        # drops gapped pieces)
        self._maybe_resend()
        try:
            self.wal.write(UID, step, 1, blk)
        except WalDown:
            # block is recorded; the resend path replays it once the
            # supervisor restarts this shard's WAL
            pass

    def _pull_rows(self, job: dict, r0: int, r1: int) -> np.ndarray:
        """Rows ``[r0, r1)`` of the step's compacted ``flat_rows`` on the
        host.  From a CUDA tensor: one copy of exactly those rows into
        this shard's pinned buffer, on this shard's stream after the
        event the header readback recorded behind the dispatch; the job
        holds the source until the copy has landed.  The returned array
        is a view of the pinned buffer, valid until the next pull."""
        flat = job["flat"]
        if flat.device.type != "cuda":
            return flat[r0:r1].numpy()
        n = r1 - r0
        if self._stream is None:
            self._stream = torch.cuda.Stream(flat.device)
            self._copied = torch.cuda.Event()
        if self._pinned is None or self._pinned.shape[0] < n \
                or self._pinned.shape[1:] != flat.shape[1:] \
                or self._pinned.dtype != flat.dtype:
            # sized for the shard's whole slice of a full step at once:
            # later steps of this geometry never allocate again
            rows = max(n, (self.hi - self.lo) * job["kc"])
            self._pinned = torch.empty((rows,) + tuple(flat.shape[1:]),
                                       dtype=flat.dtype, pin_memory=True)
        out = self._pinned[:n]
        if n:
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(job["hdr"].event)
                out.copy_(flat[r0:r1], non_blocking=True)
                self._copied.record(self._stream)
            self._copied.synchronize()
        return out.numpy()

    def _maybe_resend(self) -> None:
        """After a WAL crash+restart (or an out-of-sequence signal),
        resend every unconfirmed block above the shard's durable horizon
        (the resend_from protocol, ra_log.erl:778-793)."""
        cond = self.bridge._cond
        resend_from = None
        with cond:
            if self._resend_above is not None:
                resend_from = self._resend_above
                self._resend_above = None
        if self.wal.generation != self._generation and self.wal.alive:
            self._generation = self.wal.generation
            with cond:
                resend_from = self.confirmed_step if resend_from is None \
                    else min(resend_from, self.confirmed_step)
        if resend_from is None:
            return
        with cond:
            pending = sorted((s, b) for s, b in self._blocks.items()
                             if s > resend_from)
        for s, b in pending:
            try:
                self.wal.write(UID, s, 1, b)
            except WalDown:
                return

    def stop(self) -> None:
        with self.bridge._cond:
            self._stop = True
            self.bridge._cond.notify_all()
        self._thread.join(timeout=5)


class EngineDurability:
    """Host-side bridge: owns the engine's sharded WAL plane (S lane
    shards, each with its own file/writer/fsync and encode worker) and
    the merged confirm feedback arrays."""

    def __init__(self, data_dir: str, n_lanes: int, *, sync_mode: int = 1,
                 write_strategy: str = "default",
                 max_pending: int = 8, wal_shards: int = 1,
                 wal_batch_bytes: int = WAL_BATCH_BYTES,
                 wal_batch_interval_ms: Optional[float] = None,
                 wal_supervise: bool = True) -> None:
        os.makedirs(data_dir, exist_ok=True)
        if not 1 <= wal_shards <= n_lanes:
            raise ValueError(
                f"wal_shards must be in [1, n_lanes]; got {wal_shards}")
        self.dir = data_dir
        self.n_lanes = n_lanes
        self.max_pending = max_pending
        self.wal_shards = wal_shards
        if wal_batch_interval_ms is None:
            # default: no wait.  Group commit still emerges under load
            # (the greedy drain batches every record queued behind the
            # backpressure window); an explicit interval only pays off
            # when records arrive faster than fsyncs complete
            wal_batch_interval_ms = 0.0
        self._cond = threading.Condition()
        self.counters: dict = {f: 0 for f in ENGINE_WAL_FIELDS}
        self.step_seq = 0
        # phase-resolved latency attribution: one accumulator for the
        # whole durable plane — the engine adopts it on attach, every
        # WAL shard feeds its fsync/confirm stamps into it, and the
        # bridge stamps queue/encode/e2e edges itself
        self.phases = PhaseStats()
        #: step -> monotonic submit stamp; popped when the MERGED
        #: confirm horizon covers the step (the commit_e2e phase)
        self._submit_ts: dict = {}
        wal_kwargs = dict(sync_mode=sync_mode,
                          write_strategy=write_strategy,
                          max_batch_bytes=wal_batch_bytes,
                          max_batch_interval_ms=wal_batch_interval_ms,
                          phase_stats=self.phases,
                          # every shard's post-mortem bundles land at
                          # the BRIDGE's data dir, not one per shard
                          blackbox_dir=data_dir)
        bounds = [round(i * n_lanes / wal_shards)
                  for i in range(wal_shards + 1)]
        self._shards: list = []
        own_dirs = set()
        for i in range(wal_shards):
            sdir = data_dir if wal_shards == 1 else \
                os.path.join(data_dir, f"shard{i:02d}")
            own_dirs.add(os.path.abspath(os.path.join(sdir, "wal")))
            self._shards.append(
                _WalShard(self, i, bounds[i], bounds[i + 1], sdir,
                          wal_kwargs))
        # foreign-layout recovery: wal dirs left by a run with a
        # different shard count are scanned read-only here and their
        # files retired at the first checkpoint — blocks self-describe
        # their lane slice, so a shard-count change needs no migration.
        # One table PER DIRECTORY: different shards reuse the same step
        # index for different lane slices, so merging them into one
        # idx-keyed table would trip the overwrite-dedup rule across
        # slices and silently drop whole shards.
        self._legacy_tables: list = []
        self._legacy_files: list = []
        for wdir in self._discover_wal_dirs(data_dir):
            if os.path.abspath(wdir) in own_dirs:
                continue
            tables: dict = {}
            for fname in sorted(os.listdir(wdir)):
                if not fname.endswith(".wal"):
                    continue
                path = os.path.join(wdir, fname)
                try:
                    scan_wal_file(path, tables)
                except Exception:
                    logging.getLogger("ra_tpu_torch").warning(
                        "wal recovery: truncated/corrupt tail in %s",
                        path)
                self._legacy_files.append(path)
            self._legacy_tables.append(tables)
        # per-shard WAL supervisor (the ra_log_wal_sup role for the
        # sharded plane): a dead shard batch thread is restarted under
        # an intensity window, the shard worker detects the generation
        # bump and resends its unconfirmed blocks — the merged confirm
        # vector never advanced past them, so nothing reported committed
        # depends on the crashed incarnation (disabled by tests that
        # assert raw WalDown freeze behaviour)
        # post-mortem bundle sources: per-shard durable watermarks +
        # the durability config (last engine wins the shared names; a
        # closed bridge unhooks its own, see close())
        self._bb_config = {
            "data_dir": data_dir, "n_lanes": n_lanes,
            "wal_shards": wal_shards, "sync_mode": sync_mode,
            "write_strategy": write_strategy,
            "max_pending": max_pending,
            "wal_batch_bytes": wal_batch_bytes,
            "wal_batch_interval_ms": wal_batch_interval_ms,
            "wal_supervise": wal_supervise,
        }
        self._bb_watermarks = self._watermark_source
        self._bb_config_src = lambda: self._bb_config
        RECORDER.add_source("engine_wal_watermarks", self._bb_watermarks)
        RECORDER.add_source("engine_wal_config", self._bb_config_src)
        self._sup_stop = threading.Event()
        self._shard_restarts: collections.deque = collections.deque()
        self._sup_thread: Optional[threading.Thread] = None
        if wal_supervise:
            self._sup_thread = threading.Thread(
                target=self._supervise_shards, daemon=True,
                name="ra-engine-wal-sup")
            self._sup_thread.start()

    def _supervise_shards(self) -> None:
        max_r, period = SHARD_RESTART_INTENSITY
        log = logging.getLogger("ra_tpu_torch")
        while not self._sup_stop.wait(0.02):
            for sh in self._shards:
                wal = sh.wal
                if wal._stop or wal.alive:
                    continue
                now = time.monotonic()
                while self._shard_restarts and \
                        now - self._shard_restarts[0] > period:
                    self._shard_restarts.popleft()
                if len(self._shard_restarts) >= max_r:
                    log.error("engine wal supervisor: restart intensity "
                              "exceeded (%d in %.0fs); backing off",
                              max_r, period)
                    record("sup.giveup", plane="engine_wal",
                           shard=sh.idx)
                    RECORDER.dump(
                        "engine_wal_supervisor_giveup",
                        what=f"shard restart intensity exceeded "
                             f"({max_r} in {period:.0f}s)",
                        where=f"shard{sh.idx}", data_dir=self.dir)
                    if self._sup_stop.wait(period):
                        return
                    continue
                self._shard_restarts.append(now)
                log.warning("engine wal supervisor: restarting dead "
                            "WAL shard %d", sh.idx)
                try:
                    wal.restart()
                    record("sup.restart", plane="engine_wal",
                           shard=sh.idx)
                except Exception:
                    log.exception("engine wal supervisor: restart of "
                                  "shard %d failed; will retry", sh.idx)
                    continue
                with self._cond:
                    # wake the shard worker: _maybe_resend sees the
                    # generation bump and replays unconfirmed blocks
                    self._cond.notify_all()

    @staticmethod
    def _discover_wal_dirs(data_dir: str) -> list:
        dirs = []
        top = os.path.join(data_dir, "wal")
        if os.path.isdir(top):
            dirs.append(top)
        try:
            names = sorted(os.listdir(data_dir))
        except OSError:
            names = []
        for name in names:
            w = os.path.join(data_dir, name, "wal")
            if name.startswith("shard") and os.path.isdir(w):
                dirs.append(w)
        return dirs

    # -- compat surface -----------------------------------------------------

    @property
    def wal(self) -> Wal:
        """The first shard's WAL — the whole plane when ``wal_shards=1``
        (the surface the single-shard tests drive kill/restart/flush
        through)."""
        return self._shards[0].wal

    @property
    def wals(self) -> list:
        return [sh.wal for sh in self._shards]

    @property
    def confirm_upto(self) -> np.ndarray:
        """Merged per-lane durable horizon across shards."""
        if len(self._shards) == 1:
            return self._shards[0].confirm_upto
        with self._cond:
            return np.concatenate(
                [sh.confirm_upto for sh in self._shards])

    @property
    def confirmed_step(self) -> int:
        return min(sh.confirmed_step for sh in self._shards)

    def seed(self, prev_hi: np.ndarray, step_seq: int) -> None:
        """Set the post-recovery baseline: everything up to ``prev_hi``
        is durable and recorded through ``step_seq``."""
        prev = prev_hi.astype(np.int32)
        with self._cond:
            self.step_seq = step_seq
            self._submit_ts.clear()  # replay steps are not e2e samples
            for sh in self._shards:
                sh.confirm_upto = prev[sh.lo:sh.hi].copy()
                sh.confirmed_step = step_seq

    # -- phase attribution / live tunables ---------------------------------

    def _note_confirmed_steps(self) -> None:
        """Pop submit stamps the MERGED confirm horizon now covers and
        record their commit_e2e samples (called from a shard's WAL
        notify path with the bridge cond held — it is an RLock)."""
        with self._cond:
            m = min(sh.confirmed_step for sh in self._shards)
            if not self._submit_ts:
                return
            now = time.monotonic()
            for s in [s for s in self._submit_ts if s <= m]:
                self.phases.note("commit_e2e",
                                 now - self._submit_ts.pop(s))
            # a dead shard freezes the merged horizon: stamps would
            # otherwise pile up for the rest of the process — bound the
            # table; dropped stamps just lose samples, never accounting
            while len(self._submit_ts) > 4096:
                self._submit_ts.pop(min(self._submit_ts))

    # -- submit path (engine dispatch thread — must never host-sync) --------

    #: aux leaves a WAL record needs per inner step: the header leaves
    #: (read back whole, once a dispatch) and the compacted rows
    _HDR_KEYS = ("appended_hi", "n_app", "n_acc", "row_csum")
    _BLOCK_KEYS = _HDR_KEYS + ("flat_rows",)

    def _works(self, aux: dict, k: Optional[int], lo: int, n: int) -> list:
        """The encode jobs of one dispatch's aux for lanes ``[lo, lo +
        n)``: the header readback started here, and the row tensors as
        views taken on this (the dispatch) thread."""
        hdr = Readback({key: aux[key] for key in self._HDR_KEYS})
        flat = aux["flat_rows"]
        kc = flat.shape[-2] // max(1, n)
        if k is None:
            return [{"hdr": hdr, "j": None, "flat": flat, "lo": lo,
                     "kc": kc}]
        return [{"hdr": hdr, "j": j, "flat": flat[j], "lo": lo, "kc": kc}
                for j in range(k)]

    def _enqueue(self, aux: dict, k: Optional[int]) -> None:
        """Start the header readback of one dispatch and queue its
        ``k`` inner steps (None: one single step) on every shard.  No
        host sync: the readback's copies and events are asynchronous.
        A sharded engine's aux (``LaneParts``) goes to each WAL shard as
        its own lane shard's piece where the layouts match, else through
        one host copy of the whole aux."""
        parts = aux["appended_hi"]
        if not isinstance(parts, LaneParts):
            works = [self._works(aux, k, 0, self.n_lanes)] * \
                len(self._shards)
        else:
            bounds = parts.bounds()
            if bounds[-1][1] != self.n_lanes:
                raise ValueError(f"a sharded aux of {bounds[-1][1]} lanes "
                                 f"for a WAL of {self.n_lanes} lanes")
            if bounds == [(sh.lo, sh.hi) for sh in self._shards]:
                works = [self._works(
                    {key: aux[key].parts[i] for key in self._BLOCK_KEYS},
                    k, lo, hi - lo) for i, (lo, hi) in enumerate(bounds)]
            else:
                host = _HostAux(aux, bounds, self._BLOCK_KEYS)
                kc = aux["flat_rows"].parts[0].shape[-2] // \
                    max(1, bounds[0][1] - bounds[0][0])
                works = [[{"host": host, "j": j, "kc": kc}
                          for j in ([None] if k is None else range(k))]] * \
                    len(self._shards)
        t_sub = time.monotonic()
        with self._cond:
            step_lo = self.step_seq + 1
            for j in range(len(works[0])):
                self.step_seq += 1
                step = self.step_seq
                self._submit_ts[step] = t_sub
                for sh, shard_works in zip(self._shards, works):
                    sh._jobs.append((step, shard_works[j], t_sub))
                    sh.unprocessed += 1
            step_hi = self.step_seq
            self._cond.notify_all()
        # host-side boundary event only (step counters — no device
        # value is touched on this thread): commands are joined post
        # hoc by (lane, submit_index) against the on-device step stamps
        record("engine.submit", step_lo=step_lo, step_hi=step_hi,
               k=1 if k is None else k)

    def submit(self, aux: dict) -> None:
        """Queue one step's device aux for off-thread encode + WAL write
        on every shard.  No host sync happens here: the shard workers
        pull the compacted readback when the device values are ready."""
        self._enqueue(aux, None)

    def submit_block(self, aux: dict, k: int) -> None:
        """Queue one superstep dispatch's STACKED aux (a leading [K]
        axis on every leaf) as ``k`` consecutive per-inner-step encode
        jobs on every shard: one RTB block per inner step per shard, and
        confirms advance per inner step as each block fsyncs."""
        self._enqueue(aux, k)

    def flush_all(self, timeout: float = 5.0) -> None:
        """Durability barrier on every shard: drains the encode workers
        first so steps still queued there are written, then flushes
        each shard's WAL."""
        self.drain_all(timeout)
        for sh in self._shards:
            sh.wal.flush(timeout)

    def _raise_shard_error(self) -> None:
        err = next((sh.error for sh in self._shards if sh.error), None)
        if err is not None:
            raise err

    def drain_all(self, timeout: float = 30.0) -> None:
        """Barrier: every submitted step is encoded and handed to its
        shard WAL (not necessarily fsynced — flush the shards for that).
        After this returns, every election truncation's base clamp is
        reflected in ``confirm_upto``."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: any(sh.error for sh in self._shards)
                or all(sh.unprocessed == 0 for sh in self._shards),
                timeout)
        self._raise_shard_error()
        if not ok:
            raise TimeoutError("WAL encode workers stalled")

    def pending_steps(self) -> int:
        """Dispatched but unconfirmed steps on the laggiest shard: the
        durability half of the ingress plane's backlog (its queue depth
        plus this is the node's uncommitted total)."""
        return self.step_seq - self.confirmed_step

    def shard_layout(self) -> list:
        """``[[lo, hi], ...]``: the lane slice of each WAL shard."""
        return [[sh.lo, sh.hi] for sh in self._shards]

    def batch_interval_ms(self) -> float:
        """The live WAL group-commit wait budget (uniform across shards;
        the engine's pipeline overview stamps it)."""
        return float(self._shards[0].wal.max_batch_interval_ms)

    def set_batch_interval_ms(self, ms: float) -> None:
        """Autotuner hook: retarget every shard's group-commit wait
        budget.  The WAL batch threads read the interval once per group,
        so the change lands at the next group: no restart, no flush."""
        ms = max(0.0, float(ms))
        for sh in self._shards:
            sh.wal.max_batch_interval_ms = ms
        self._bb_config["wal_batch_interval_ms"] = ms

    def backpressure(self, timeout: float = 30.0) -> None:
        """Bound the unconfirmed window: wait for WAL confirms when more
        than ``max_pending`` steps are in flight on the laggiest shard
        (the flow control a gen_batch_server gets from its bounded
        mailbox).  A shard WAL that dies while the shard supervisor runs
        is waited out: the supervisor restarts it and wakes the cond,
        and the shard worker resends its unconfirmed blocks.  Unlike the
        reference, which raises as soon as it sees the dead shard and so
        races the restart, WalDown is raised only with no supervisor, or
        at the deadline with the shard still down."""
        supervised = self._sup_thread is not None

        def lag() -> int:
            return self.step_seq - min(sh.confirmed_step
                                       for sh in self._shards)

        def down() -> list:
            return [sh.idx for sh in self._shards if not sh.wal.alive]

        deadline = time.monotonic() + timeout
        while True:
            with self._cond:
                # sliced wait: WAL thread death never notifies the cond
                self._cond.wait_for(
                    lambda: lag() < self.max_pending
                    or any(sh.error for sh in self._shards)
                    or (not supervised and bool(down())),
                    min(0.5, max(0.0, deadline - time.monotonic())))
                under = lag() < self.max_pending
            self._raise_shard_error()
            if under:
                return
            late = time.monotonic() > deadline
            if down() and (late or not supervised):
                raise WalDown(
                    f"engine WAL shards {down()} died under "
                    "backpressure; call wal.restart() to resume")
            if late:
                raise TimeoutError("WAL confirms stalled")

    # -- observability ------------------------------------------------------

    def _watermark_source(self) -> dict:
        """Per-shard durable watermarks for post-mortem bundles: host
        ints/np arrays only (``confirm_upto`` lives on the host side of
        the confirm protocol — no device sync here)."""
        with self._cond:
            return {
                "step_seq": self.step_seq,
                "shards": [{
                    "shard": sh.idx,
                    "lanes": [sh.lo, sh.hi],
                    "confirmed_step": sh.confirmed_step,
                    "jobs_pending": len(sh._jobs),
                    "wal_alive": sh.wal.alive,
                    "confirm_upto_min": int(sh.confirm_upto.min())
                    if sh.confirm_upto.size else 0,
                    "confirm_upto_max": int(sh.confirm_upto.max())
                    if sh.confirm_upto.size else 0,
                } for sh in self._shards],
            }

    def wal_overview(self) -> dict:
        """ENGINE_WAL_FIELDS plus per-shard WAL stats (batch bytes,
        records per fsync, fsync latency p50/p99, confirm lag) — the
        key_metrics merge mirroring the RPC_FIELDS pattern."""
        with self._cond:
            eng = dict(self.counters)
            eng["confirm_lag_steps"] = self.step_seq - min(
                sh.confirmed_step for sh in self._shards)
            shards = []
            for sh in self._shards:
                st = sh.wal.stats()
                st["shard"] = sh.idx
                st["lanes"] = [sh.lo, sh.hi]
                st["confirm_lag_steps"] = \
                    self.step_seq - sh.confirmed_step
                # encode-queue backlog: steps dispatched but not yet
                # picked up by this shard's encode worker — with
                # Wal.stats' queue_depth this completes the per-shard
                # pipeline-depth picture the Observatory/ra_top render
                st["jobs_pending"] = len(sh._jobs)
                shards.append(st)
        return {"engine": eng, "shards": shards,
                "disk_faults": faults.disk_fault_counters()}

    # -- checkpoint / recovery ----------------------------------------------

    def checkpoint(self, engine, timeout: float = 30.0) -> str:
        deadline = time.monotonic() + timeout
        self.drain_all(timeout)
        while True:
            with self._cond:
                done = all(sh.confirmed_step >= self.step_seq
                           for sh in self._shards)
            if done:
                break
            for sh in self._shards:
                if not sh.wal.alive:
                    raise WalDown("checkpoint: WAL shard died; "
                                  "wal.restart() and retry")
                try:
                    sh.wal.flush(min(5.0, max(
                        0.1, deadline - time.monotonic())))
                except TimeoutError:
                    pass
            with self._cond:
                self._cond.wait_for(
                    lambda: all(sh.confirmed_step >= self.step_seq
                                for sh in self._shards),
                    min(0.5, max(0.0, deadline - time.monotonic())))
            self._raise_shard_error()
            if time.monotonic() > deadline:
                raise TimeoutError("checkpoint: WAL confirms stalled")
        path = os.path.join(self.dir, "ckpt.npz")
        engine.save(path)
        # the pytree schema rides the meta for post-mortem diagnostics:
        # a reopen under a different engine version can say WHICH field
        # set the archive carries before restore() decides (the archive
        # itself is schema-named and is authoritative)
        from .lockstep import LaneState
        meta = {"step": self.step_seq, "wal_shards": self.wal_shards,
                "schema": list(LaneState._fields)}
        tmp = path + ".meta.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, "ckpt.meta.json"))
        # roll every shard's current file so its (now-covered) records
        # become prunable, then drop every covered file
        for sh in self._shards:
            sh.wal.rollover()
            sh.wal.flush()
            sh.retirer.prune(self.step_seq)
        self._prune_legacy()
        return path

    def _prune_legacy(self) -> None:
        files, self._legacy_files = self._legacy_files, []
        dirs = set()
        for path in files:
            try:
                os.unlink(path)
            except OSError:
                pass
            dirs.add(os.path.dirname(path))
        for d in dirs:
            parent = os.path.dirname(d)
            try:
                os.rmdir(d)
                if os.path.basename(parent).startswith("shard"):
                    os.rmdir(parent)
            except OSError:
                pass
        self._legacy_tables = []

    def recovered_pieces(self, base_step: int) -> dict:
        """step -> [(lane_lo, hi, n_app, n_acc, rows)] merged from every
        shard's recovered WAL tables plus foreign-layout leftovers."""
        pieces: dict = {}
        tabs = [sh.wal.recovered_table(UID) for sh in self._shards]
        tabs += [t.get(UID, {}) for t in self._legacy_tables]
        for tbl in tabs:
            for s, (_t, blk) in tbl.items():
                if s <= base_step:
                    continue
                pieces.setdefault(s, []).append(decode_block(blk))
        return pieces

    def close(self) -> None:
        RECORDER.remove_source("engine_wal_watermarks",
                               self._bb_watermarks)
        RECORDER.remove_source("engine_wal_config", self._bb_config_src)
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=5)
        try:
            self.drain_all(timeout=10.0)
        except Exception:  # noqa: BLE001 — a dead WAL must not block cleanup
            pass
        for sh in self._shards:
            try:
                sh.wal.flush()
            except (WalDown, TimeoutError):
                pass
        for sh in self._shards:
            sh.stop()
            sh.wal.close()


def _assemble_blocks(pieces: dict, n_lanes: int, ckpt_tail: np.ndarray):
    """Stitch per-slice step pieces into full-lane step blocks.

    Lanes with no piece at a step (their shard crashed before recording
    it, or a foreign layout covered other slices) carry their tail
    forward with ``n_app=0`` — nothing was durably recorded for them at
    that step, and the merged per-lane confirm rule guarantees nothing
    beyond their last record was ever reported committed.

    Contiguity guard (the engine twin of the classic log's recovery
    clamp): a piece whose append BASE exceeds a lane's carried tail
    records appends above a step gap — a post-restart write that beat
    the unconfirmed-backlog resend into the new WAL file before a
    second crash.  Those appends were never confirmable (the shard's
    confirm slice froze below the gap), so the lane skips the piece
    and carries its tail forward instead of replaying a holed log the
    engine could never converge on."""
    blocks = []
    cur_hi = ckpt_tail.astype(np.int32).copy()
    for s in sorted(pieces):
        ps = pieces[s]
        kmax = max(p[4].shape[1] for p in ps)
        c = ps[0][4].shape[2]
        hi = cur_hi.copy()
        n_app = np.zeros((n_lanes,), np.int32)
        n_acc = np.zeros((n_lanes,), np.int32)
        rows = np.zeros((n_lanes, kmax, c), ps[0][4].dtype)
        for lane_lo, phi, papp, pacc, prows in ps:
            sl = slice(lane_lo, lane_lo + phi.shape[0])
            ok = (phi - papp) <= cur_hi[sl]
            if not ok.all():
                logging.getLogger("ra_tpu_torch").warning(
                    "engine recovery: step %d piece at lanes [%d,%d) "
                    "appends above a gap on %d lane(s); skipped",
                    s, lane_lo, lane_lo + phi.shape[0],
                    int((~ok).sum()))
            hi[sl] = np.where(ok, phi, hi[sl])
            n_app[sl] = np.where(ok, papp, n_app[sl])
            n_acc[sl] = np.where(ok, pacc, n_acc[sl])
            if prows.shape[1]:
                dst = rows[sl]
                dst[ok, :prows.shape[1]] = prows[ok]
        blocks.append((s, hi, n_app, n_acc, rows))
        cur_hi = hi
    return blocks


def _final_logs(blocks: list, ckpt_tail: np.ndarray):
    """Resolve election truncations across recovered step blocks into the
    surviving per-step entry counts.

    blocks: [(step, hi, n_app, n_acc, rows)] in step order.  Returns
    (surv_counts per block [N], trimmed_tail np[N], final_hi np[N]):
    ``surv_counts[b][i]`` entries of block b survive for lane i (always a
    prefix — truncation removes a suffix of earlier appends), and
    ``trimmed_tail`` is where the checkpoint state itself must be cut
    (a truncation can reach below the checkpoint when unconfirmed
    leader tail existed at checkpoint time)."""
    n = ckpt_tail.shape[0]
    if not blocks:
        return [], ckpt_tail.copy(), ckpt_tail.copy()
    bases = np.stack([hi - n_app for _s, hi, n_app, _a, _r in blocks])
    his = np.stack([hi for _s, hi, _n, _a, _r in blocks])
    # suffix-min of bases strictly after each block: entries above it die
    suffix = np.full((len(blocks) + 1, n), np.iinfo(np.int32).max,
                     np.int32)
    for b in range(len(blocks) - 1, -1, -1):
        suffix[b] = np.minimum(suffix[b + 1], bases[b])
    surv = []
    for b, (_s, hi, n_app, _n_acc, _rows) in enumerate(blocks):
        end = np.minimum(his[b], suffix[b + 1])
        surv.append(np.clip(end - bases[b], 0, n_app).astype(np.int32))
    trimmed_tail = np.minimum(ckpt_tail, suffix[0])
    final_hi = his[-1]
    return surv, trimmed_tail, final_hi


def open_engine(machine, data_dir: str, n_lanes: int, n_members: int = 3,
                *, sync_mode: int = 1, write_strategy: str = "default",
                max_pending: int = 8, wal_shards: int = 1,
                wal_batch_bytes: int = WAL_BATCH_BYTES,
                wal_batch_interval_ms: Optional[float] = None,
                wal_supervise: bool = True, **engine_kwargs):
    """Create-or-recover a durable LockstepEngine at ``data_dir``.

    Fresh directory: a new engine wired to ``wal_shards`` new WAL
    shards.  Existing data: restore the checkpoint, merge the surviving
    shard records (any layout), replay them through the engine's step
    on its device (recomputing machine state with the same apply fold),
    and resume in durable mode: recovery = checkpoint + WAL re-read,
    deduped by the overwrite rule, applied with effects suppressed.
    ``wal_batch_bytes`` and ``wal_batch_interval_ms`` (None: 0.0, no
    wait) set every shard's group commit, ``write_strategy`` (``default``,
    ``o_sync`` or ``sync_after_notify``) every shard's durability order.  ``engine_kwargs`` go to
    :class:`LockstepEngine`, ``device`` among them: None is the CUDA
    card, ``"cpu"`` the CPU by name only."""

    from .lockstep import LockstepEngine, _take

    os.makedirs(data_dir, exist_ok=True)
    ckpt = os.path.join(data_dir, "ckpt.npz")
    meta_path = os.path.join(data_dir, "ckpt.meta.json")
    base_step = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            base_step = json.load(f).get("step", 0)

    # the bridge's shard Wals scan surviving files once on construction
    # (scan_wal_file dedups per-index overwrites); the merged piece
    # tables are the step-block source for replay.  No engine writes
    # happen until attach, so constructing it up front is safe.
    dur = EngineDurability(data_dir, n_lanes, sync_mode=sync_mode,
                           write_strategy=write_strategy,
                           max_pending=max_pending, wal_shards=wal_shards,
                           wal_batch_bytes=wal_batch_bytes,
                           wal_batch_interval_ms=wal_batch_interval_ms,
                           wal_supervise=wal_supervise)
    pieces = dur.recovered_pieces(base_step)

    kmax = max((p[4].shape[1] for ps in pieces.values() for p in ps),
               default=0)
    if kmax:
        # the replay apply window must cover the widest recovered block,
        # or ring backpressure would silently clip replayed entries
        engine_kwargs = dict(engine_kwargs)
        engine_kwargs["apply_window"] = max(
            engine_kwargs.get("apply_window") or 0, kmax + 2)
        ring = engine_kwargs.get("ring_capacity", 1024)
        if ring < kmax + 2:
            # the ring-write dummy slot must stay clear of the widest
            # replayed block; reopening with a smaller geometry than
            # the writer would otherwise silently corrupt the replay
            raise ValueError(
                f"ring_capacity {ring} too small to replay recovered "
                f"blocks of width {kmax}; use >= {kmax + 2} (the "
                "engine that wrote this WAL had larger max_step_cmds)")

    eng = LockstepEngine(machine, n_lanes, n_members, **engine_kwargs)
    if os.path.exists(ckpt):
        eng.restore(ckpt)
        # transient failure masks do not survive a node restart: every
        # non-removed member recovers with the node (removed members
        # have voter=False too and stay out).  Revival is by SNAPSHOT
        # INSTALL from the lane leader, vectorized over all revived
        # members — a bare active-flag flip would leave a frozen
        # applied cursor that drags the lane-uniform apply window onto
        # recycled ring slots (silent divergence).
        st = eng.state
        revive = st.voter & ~st.active
        # a recovery-time host read (not the hot path)
        if bool(revive.any()):
            snap = _take(st.applied, st.leader_slot)[:, None]   # [N,1]

            def from_leader(x):
                lx = _take(x, st.leader_slot)[:, None]
                rv = revive.reshape(revive.shape + (1,) * (x.dim() - 2))
                return torch.where(rv, lx, x)

            st = st._replace(
                mac=tree_map(from_leader, st.mac),
                applied=torch.where(revive, snap, st.applied),
                commit=torch.where(revive, snap, st.commit),
                last_index=torch.where(revive, snap, st.last_index),
                last_written=torch.where(revive, snap, st.last_written),
                match=torch.where(revive, 0, st.match),
                next_index=torch.where(revive, snap + 1, st.next_index))
        eng.state = st._replace(active=st.active | st.voter)

    lane = np.arange(n_lanes)
    st = eng.state
    leader = st.leader_slot.cpu().numpy()
    ckpt_tail = st.last_index.cpu().numpy()[lane, leader].astype(np.int32)

    blocks = _assemble_blocks(pieces, n_lanes, ckpt_tail)
    surv, trimmed_tail, final_hi = _final_logs(blocks, ckpt_tail)

    if (trimmed_tail < ckpt_tail).any():
        # a post-checkpoint election truncated into the checkpoint's
        # unconfirmed tail: cut the restored cursors (commit/applied are
        # always below the cut — commit never truncates)
        st = eng.state
        t = torch.as_tensor(trimmed_tail).to(st.last_index.device)[:, None]
        eng.state = st._replace(
            last_index=torch.minimum(st.last_index, t),
            last_written=torch.minimum(st.last_written, t),
            match=torch.minimum(st.match, t),
            next_index=torch.minimum(st.next_index, t + 1))

    if blocks:
        kmax = kmax or 1
        C = eng.payload_width
        np_dtype = torch.empty(0, dtype=eng.payload_dtype).numpy().dtype
        for (s, hi, n_app, n_acc, rows), keep in zip(blocks, surv):
            pad = np.zeros((n_lanes, kmax, C), rows.dtype)
            if rows.shape[1]:
                pad[:, :rows.shape[1]] = rows
            eng.step(keep, pad)
        # settle: drain the apply/commit pipeline until every lane's
        # recovered log is fully committed and applied on every live
        # member (recovery commits the whole surviving log: it is on
        # disk, i.e. replicated on every co-hosted member by definition)
        zero_n = np.zeros((n_lanes,), np.int32)
        zero_p = np.zeros((n_lanes, 1, C), np_dtype)
        for _ in range(SETTLE_LIMIT):
            # a host readback every settle step: recovery, not the hot path
            stn = eng.state
            com = stn.commit.cpu().numpy()[lane,
                                           stn.leader_slot.cpu().numpy()]
            active = stn.active.cpu().numpy()
            app = np.where(active, stn.applied.cpu().numpy(),
                           np.iinfo(np.int32).max).min(axis=1)
            if (com >= final_hi).all() and (app >= com).all():
                break
            eng.step(zero_n, zero_p)
        else:
            raise RuntimeError("recovery settle did not converge")

    st = eng.state
    leader = st.leader_slot.cpu().numpy()
    tail = st.last_index.cpu().numpy()[lane, leader].astype(np.int32)
    last_step = max(pieces) if pieces else base_step
    dur.seed(tail, last_step)
    eng.attach_durability(dur)
    if pieces or os.path.exists(ckpt):
        # an actual recovery happened (checkpoint restore and/or WAL
        # replay): stamp the join-able report next to any post-mortem
        # bundle the crash left (crash + recovery are one
        # incident)
        stamp_recovery(
            {"plane": "engine", "base_step": base_step,
             "replayed_steps": len(pieces),
             "resumed_at_step": last_step,
             "wal_shards": wal_shards,
             "tail_min": int(tail.min()) if tail.size else 0,
             "tail_max": int(tail.max()) if tail.size else 0},
            data_dir=data_dir)
    return eng
