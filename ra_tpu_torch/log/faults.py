"""Deterministic storage-plane fault injection: the port's own copy of
``ra_tpu/log/faults.py``.

Everything in ``ra_tpu_torch.log`` does its file I/O through the :data:`IO`
shim below instead of the raw native facade.  With no plan installed
the shim is a plain passthrough (one attribute check per call).  With a
:class:`DiskFaultPlan` installed, every (path-class, op) stream owns a
private RNG seeded from the plan seed + the stream key, so one
stream's draws never perturb another's and a schedule replays
identically whatever the thread interleaving — the same determinism
contract as the wire plan.

Fault taxonomy (the storage failure modes the degradation policy in
``log/wal.py`` and ``engine/durable.py`` must answer):

* ``fsync_eio``    — the durability syscall fails (EIO).  fsyncgate
  discipline: after a failed fsync the kernel may have dropped the
  dirty pages, so re-issuing fsync on the same fd and treating success
  as durability is a silent-loss bug.  The shim tracks failed fds and
  counts any fsync re-issued with NO intervening write to that fd as
  ``fsync_retries_after_failure`` (must stay 0).  NB the oracle is
  deliberately write-granular, not range-granular: any write clears
  the poison mark, because the one legitimate re-sync path — the
  segment-flush retry — re-issues the FULL pending batch (identical
  pwrites, pages re-dirtied).  A policy that appended fresh data to a
  poisoned fd and re-synced would evade this counter; the WAL policy
  makes that structurally impossible by retiring a poisoned file
  before any further write.
* ``enospc``       — write fails up front, nothing lands.
* ``short_write``  — a torn write: a PREFIX of the buffer really
  reaches the file, then the call errors.  Recovery must stop at the
  damage point via crc, not mis-file the tail.
* ``corrupt_read`` — read-side bit rot: one bit of the returned bytes
  is flipped.  Every read path carries a crc; the checks must catch it
  (counted as ``crc_catches`` by the catching layer).
* ``slow``         — the op sleeps ``slow_ms`` first (latency chaos).

Path classes: ``wal`` (\\*.wal), ``segment`` (\\*.segment / \\*.trunc),
``snapshot`` (\\*.rtsn / accept.partial / snapshot+checkpoints dirs),
``meta`` (meta / meta.partial), ``other``.  Ops: ``write``, ``fsync``,
``read``.

Node-wide observability rides :data:`DISK_COUNTERS`
(metrics.DISK_FAULT_FIELDS), merged into the durable engine's WAL
overview.  The plan, the counters and :data:`IO` are the port's own: a
plan installed into ``ra_tpu.log.faults`` does not reach the port.
"""
from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..blackbox import RECORDER, record
from ..metrics import DISK_FAULT_FIELDS
from ..native import IO as _NATIVE

#: node-wide disk-fault counters (GIL-atomic increments, like the
#: per-component counter dicts elsewhere)
DISK_COUNTERS: dict = {f: 0 for f in DISK_FAULT_FIELDS}


def note(field: str, n: int = 1) -> None:
    DISK_COUNTERS[field] = DISK_COUNTERS.get(field, 0) + n


def disk_fault_counters() -> dict:
    return dict(DISK_COUNTERS)


def reset_disk_fault_counters() -> None:
    for f in list(DISK_COUNTERS):
        DISK_COUNTERS[f] = 0


def classify_path(path: str) -> str:
    """Path class of a storage file (the fault-plan routing key)."""
    name = os.path.basename(path)
    if name.endswith(".wal"):
        return "wal"
    if name.endswith(".segment") or name.endswith(".trunc"):
        return "segment"
    parent = os.path.basename(os.path.dirname(path))
    if name.endswith(".rtsn") or name.endswith(".rtsn.partial") or \
            name == "accept.partial" or parent in ("snapshot",
                                                   "checkpoints"):
        return "snapshot"
    if name in ("meta", "meta.partial"):
        return "meta"
    return "other"


@dataclass(frozen=True)
class DiskFaultSpec:
    """Per-stream fault probabilities.  ``limit`` bounds the TOTAL
    faults this spec may inject on one stream (0 = unbounded) — a limit
    of 2 with ``fsync_eio=1.0`` means 'fail exactly the first two
    fsyncs', which is how tests script deterministic scenarios.
    ``path_match`` narrows a rule to paths containing the substring
    (e.g. ``shard03`` to target one WAL shard)."""

    fsync_eio: float = 0.0
    enospc: float = 0.0
    short_write: float = 0.0
    corrupt_read: float = 0.0
    slow: float = 0.0
    slow_ms: tuple = (1.0, 5.0)
    limit: int = 0
    path_match: str = ""

    @property
    def quiet(self) -> bool:
        return (self.fsync_eio == self.enospc == self.short_write ==
                self.corrupt_read == self.slow == 0)


#: which fault kinds apply to which op (spec field -> injected kind)
_OP_KINDS = {
    "fsync": (("fsync_eio", "fsync_eio"), ("slow", "slow")),
    "write": (("enospc", "enospc"), ("short_write", "short_write"),
              ("slow", "slow")),
    "read": (("corrupt_read", "corrupt_read"), ("slow", "slow")),
}


class DiskFaultPlan:
    """Seeded fault schedule consulted by the storage I/O shim.

    Rules resolve most-specific-first: the first entry of ``rules``
    whose path-class matches (``*`` = any) and whose ``path_match``
    substring appears in the path, then ``by_class[path_class]``, then
    the default.  Every (rule, path_class, op) stream owns a private
    RNG seeded from the plan seed + the key.
    """

    def __init__(self, seed: int = 0,
                 default: Optional[DiskFaultSpec] = None,
                 by_class: Optional[dict] = None,
                 rules: Optional[list] = None) -> None:
        self.seed = seed
        self.default = default or DiskFaultSpec()
        self.by_class = dict(by_class or {})
        #: [(path_class_or_star, DiskFaultSpec)] — checked in order
        self.rules = list(rules or [])
        self._rngs: dict = {}
        self._spent: dict = {}
        self._lock = threading.Lock()
        #: injected-fault counters by kind
        self.counters: dict = {}

    def _spec_for(self, path_class: str, path: str):
        for i, (cls, spec) in enumerate(self.rules):
            if cls in ("*", path_class) and spec.path_match in path:
                return ("rule", i), spec
        spec = self.by_class.get(path_class)
        if spec is not None:
            return ("class", path_class), spec
        return ("default",), self.default

    def decide(self, path_class: str, op: str, path: str = "") -> tuple:
        """-> (kind, param): kind in {"ok", "fsync_eio", "enospc",
        "short_write", "corrupt_read", "slow"}; param is the sleep
        seconds for "slow", else 0."""
        rid, spec = self._spec_for(path_class, path)
        if spec.quiet:
            return ("ok", 0)
        key = (rid, path_class, op)
        with self._lock:
            rng = self._rngs.get(key)
            if rng is None:
                rng = self._rngs[key] = random.Random(
                    f"{self.seed}:{rid}:{path_class}:{op}")
            if spec.limit and self._spent.get(key, 0) >= spec.limit:
                return ("ok", 0)
            roll = rng.random()
            edge = 0.0
            for field, kind in _OP_KINDS.get(op, ()):
                prob = getattr(spec, field)
                edge += prob
                if roll >= edge:
                    continue
                self._spent[key] = self._spent.get(key, 0) + 1
                self.counters[kind] = self.counters.get(kind, 0) + 1
                note("faults_injected")
                # every injected storage fault names itself in the
                # flight recorder: a post-mortem bundle can point at
                # the exact faulted op, not just a counter
                record("disk.fault", kind=kind, path_class=path_class,
                       op=op, path=os.path.basename(path) if path
                       else "")
                if kind == "slow":
                    lo, hi = spec.slow_ms
                    return ("slow", rng.uniform(lo, hi) / 1000.0)
                if kind == "corrupt_read":
                    # deterministic damage: bit position drawn from the
                    # stream RNG, applied by the shim to the read bytes
                    return ("corrupt_read", rng.random())
                return (kind, 0)
        return ("ok", 0)

    def overview(self) -> dict:
        """Plan state for post-mortem bundles: seed, targeting rules
        and per-kind injection counts — a bundle must NAME the chaos
        that was active when the system died."""
        def _spec(s: DiskFaultSpec) -> dict:
            d = {f: getattr(s, f) for f in
                 ("fsync_eio", "enospc", "short_write", "corrupt_read",
                  "slow") if getattr(s, f)}
            if s.limit:
                d["limit"] = s.limit
            if s.path_match:
                d["path_match"] = s.path_match
            return d

        return {"seed": self.seed,
                "default": _spec(self.default),
                "by_class": {c: _spec(s)
                             for c, s in self.by_class.items()},
                "rules": [[c, _spec(s)] for c, s in self.rules],
                "injected": dict(self.counters)}


class FaultyIO:
    """Thin shim over the native I/O facade, consulted by everything in
    ``ra_tpu_torch.log``.  Tracks fd -> (path_class, path) so positioned I/O
    on an fd resolves its fault stream, and enforces the fsyncgate
    bookkeeping (failed-fsync fds are remembered until their data is
    rewritten)."""

    def __init__(self, base) -> None:
        self._base = base
        self.plan: Optional[DiskFaultPlan] = None
        self._fd_info: dict = {}
        self._failed_sync_fds: set = set()
        self._lock = threading.Lock()

    # -- plan lifecycle -----------------------------------------------------

    def install(self, plan: Optional[DiskFaultPlan]) -> None:
        self.plan = plan

    def uninstall(self) -> None:
        self.plan = None
        with self._lock:
            self._failed_sync_fds.clear()

    # -- passthroughs -------------------------------------------------------

    @property
    def native(self) -> bool:
        return self._base.native

    def stats(self) -> dict:
        return self._base.stats()

    def crc32(self, data: bytes, seed: int = 0) -> int:
        return self._base.crc32(data, seed)

    # -- opens (register the fd's fault stream) -----------------------------

    def wal_open(self, path: str, truncate: bool = False,
                 o_sync: bool = False) -> int:
        fd = self._base.wal_open(path, truncate=truncate, o_sync=o_sync)
        with self._lock:
            self._fd_info[fd] = (classify_path(path), path)
            self._failed_sync_fds.discard(fd)
        return fd

    def random_open(self, path: str, truncate: bool = False) -> int:
        fd = self._base.random_open(path, truncate=truncate)
        with self._lock:
            self._fd_info[fd] = (classify_path(path), path)
            self._failed_sync_fds.discard(fd)
        return fd

    def close(self, fd: int) -> None:
        with self._lock:
            self._fd_info.pop(fd, None)
            self._failed_sync_fds.discard(fd)
        self._base.close(fd)

    def _info(self, fd: int) -> tuple:
        return self._fd_info.get(fd, ("other", ""))

    def _decide(self, fd: int, op: str,
                path_class: Optional[str] = None) -> tuple:
        plan = self.plan
        if plan is None:
            return ("ok", 0)
        cls, path = self._info(fd)
        if path_class is not None:
            cls = path_class
        kind, param = plan.decide(cls, op, path)
        if kind == "slow":
            time.sleep(param)
            return ("ok", 0)
        return (kind, param)

    # -- faultable ops ------------------------------------------------------

    def write_batch(self, fd: int, buf: bytes, sync_mode: int = 1) -> int:
        kind, _ = self._decide(fd, "write")
        if kind == "enospc":
            raise OSError(errno.ENOSPC, "injected: no space left on "
                          "device (DiskFaultPlan)")
        if kind == "short_write":
            # a torn write: half the buffer really lands, then the call
            # errors — the crc discipline must stop recovery here
            torn = buf[:max(1, len(buf) // 2)]
            self._base.write_batch(fd, torn, 0)
            raise OSError(errno.EIO, "injected: short/torn write "
                          "(DiskFaultPlan)")
        n = self._base.write_batch(fd, buf, sync_mode)
        with self._lock:
            self._failed_sync_fds.discard(fd)  # data rewritten/extended
        return n

    def pwrite(self, fd: int, buf: bytes, off: int) -> int:
        kind, _ = self._decide(fd, "write")
        if kind == "enospc":
            raise OSError(errno.ENOSPC, "injected: no space left on "
                          "device (DiskFaultPlan)")
        if kind == "short_write":
            torn = buf[:max(1, len(buf) // 2)]
            self._base.pwrite(fd, torn, off)
            raise OSError(errno.EIO, "injected: short/torn pwrite "
                          "(DiskFaultPlan)")
        n = self._base.pwrite(fd, buf, off)
        with self._lock:
            self._failed_sync_fds.discard(fd)
        return n

    def pread(self, fd: int, length: int, off: int) -> bytes:
        data = self._base.pread(fd, length, off)
        kind, param = self._decide(fd, "read")
        if kind == "corrupt_read" and data:
            data = self._flip_bit(data, param)
        return data

    def sync(self, fd: int, mode: int = 1,
             path_class: Optional[str] = None) -> None:
        if mode == 0:
            return
        # fsyncgate bookkeeping applies only to fds OPENED through the
        # shim: an unregistered fd (the path_class-override one-shot
        # handles of store_meta/complete_accept) is closed by plain
        # f.close(), so its number recycles and a stale entry in the
        # failed set would count false fsync_retries_after_failure hits
        # against whatever unrelated file lands on that number next.
        # Those call sites discard the whole file on failure anyway —
        # there is no fd to wrongly re-sync.
        with self._lock:
            tracked = fd in self._fd_info
            if tracked and fd in self._failed_sync_fds:
                # fsyncgate: an fsync re-issued on a failed fd without
                # an intervening rewrite can report success over dropped
                # pages — the degradation policy must never do this
                note("fsync_retries_after_failure")
        kind, _ = self._decide(fd, "fsync", path_class=path_class)
        if kind == "fsync_eio":
            if tracked:
                with self._lock:
                    self._failed_sync_fds.add(fd)
            raise OSError(errno.EIO, "injected: fsync failed "
                          "(DiskFaultPlan)")
        self._base.sync(fd, mode)

    def fsync_failed(self, fd: int) -> bool:
        """True when a durability syscall on this fd has failed and its
        data has not been rewritten since (the fd is poisoned)."""
        with self._lock:
            return fd in self._failed_sync_fds

    def read_file(self, path: str) -> bytes:
        """Whole-file read with read-side fault injection (the recovery
        scan path of WAL files and snapshot containers, which bypasses
        positioned fd I/O)."""
        with open(path, "rb") as f:
            data = f.read()
        plan = self.plan
        if plan is None or not data:
            return data
        kind, param = plan.decide(classify_path(path), "read", path)
        if kind == "slow":
            time.sleep(param)
        elif kind == "corrupt_read":
            data = self._flip_bit(data, param)
        return data

    @staticmethod
    def _flip_bit(data: bytes, roll: float) -> bytes:
        pos = min(len(data) - 1, int(roll * len(data)))
        b = bytearray(data)
        b[pos] ^= 1 << (pos % 8)
        return bytes(b)


#: the storage-plane I/O facade — ra_tpu_torch.log modules import THIS
IO = FaultyIO(_NATIVE)

#: post-mortem bundles embed the ACTIVE DiskFaultPlan (None = no chaos
#: installed) plus the node-wide fault counters
RECORDER.add_source(
    "disk_fault_plan",
    lambda: {"plan": (IO.plan.overview() if IO.plan is not None
                      else None),
             "counters": disk_fault_counters()})


def install_plan(plan: Optional[DiskFaultPlan]) -> None:
    """Install a node-wide disk fault plan (None clears it)."""
    if plan is None:
        IO.uninstall()
    else:
        IO.install(plan)


def clear_plan() -> None:
    IO.uninstall()


def current_plan() -> Optional[DiskFaultPlan]:
    return IO.plan
