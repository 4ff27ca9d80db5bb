"""RaSystem — a named instance of the full durable-log stack.

The reference's 'system' (ra_system.erl) is one isolated set of log
infrastructure: WAL + segment writer + registries, hosting many servers.
Multiple systems can coexist with separate data dirs/tunables
(ra_system.erl:18-63).  This is exactly that, minus supervision trees:
component threads are owned by this object and restarted by it.
"""
from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from collections import deque
from typing import Optional

from .blackbox import RECORDER, record, stamp_recovery
from .core.types import (Membership, SNAPSHOT_TUNABLE_KEYS,
                         ServerConfig, ServerId)
from .directory import Directory
from .log.durable import DurableLog
from .log.segment import SegmentWriter
from .log.wal import DEFAULT_MAX_BATCH, DEFAULT_MAX_SIZE, Wal


def _config_snapshot(cfg: ServerConfig) -> dict:
    """The reconstructable (picklable) parts of a server config, persisted
    in the directory for recover_servers — the ra_server_sup_sup
    recover_config role (:80-103).  The machine is resolved at recovery
    time."""
    from .machines import spec_of
    return {
        "server_id": tuple(cfg.server_id),
        "uid": cfg.uid,
        "cluster_name": cfg.cluster_name,
        "initial_members": tuple(tuple(m) for m in cfg.initial_members),
        "election_timeout_ms": cfg.election_timeout_ms,
        "tick_interval_ms": cfg.tick_interval_ms,
        "broadcast_time_ms": cfg.broadcast_time_ms,
        # the remaining tunables round-trip too — a restart-applied
        # mutable-config change (RaNode.MUTABLE_CONFIG_KEYS) must
        # survive node/system recovery, not silently revert
        **{k: getattr(cfg, k) for k in SNAPSHOT_TUNABLE_KEYS},
        "membership": cfg.membership.value,
        "system_name": cfg.system_name,
        # spec-built machines persist their recipe so a restart (local
        # boot recovery OR the cross-node control plane) can rebuild
        # them from disk alone; None for machines passed as live objects
        "machine_spec": spec_of(cfg.machine),
    }


#: System-level lane-engine dispatch-pipeline tunables.
#: ``superstep_k`` is how many engine rounds fuse into one dispatch
#: (the superstep, ra_tpu_torch/engine/lockstep.py) and
#: ``dispatch_ahead`` how many dispatches the host may keep in flight
#: before ``DispatchAheadDriver`` waits on a commit watermark.  These are
#: deployment knobs, not per-engine constants: a node co-hosting the
#: classic plane and the lane engine sizes them against the SAME host
#: budget that sizes wal shards/batching, which is why they live here
#: with the other system tunables.  Resolution order: explicit RaSystem
#: kwarg > RA_TPU_SUPERSTEP_K / RA_TPU_DISPATCH_AHEAD env > defaults.
ENGINE_SUPERSTEP_K = 8
ENGINE_DISPATCH_AHEAD = 2


def engine_pipeline_defaults() -> dict:
    """The system-level superstep/dispatch-ahead defaults after env
    overrides — what bench.py's ``--superstep auto`` and embedding
    nodes resolve against."""
    return {
        "superstep_k": int(os.environ.get("RA_TPU_SUPERSTEP_K",
                                          ENGINE_SUPERSTEP_K)),
        "dispatch_ahead": int(os.environ.get("RA_TPU_DISPATCH_AHEAD",
                                             ENGINE_DISPATCH_AHEAD)),
    }


#: WAL supervisor restart intensity: (max restarts, window seconds).
#: Beyond it the supervisor backs off for the window instead of
#: hot-looping (OTP's intensity/period shape, ra_log_sup.erl:26-51 — but
#: where OTP escalates and kills the subtree, a whole-process teardown
#: here would lose every co-hosted cluster member, so we throttle and
#: keep trying: a transient fault like a full disk stays recoverable).
WAL_RESTART_INTENSITY = (10, 5.0)


class RaSystem:
    def __init__(self, data_dir: str, *, name: str = "default",
                 wal_sync_mode: int = 1,
                 wal_max_size: int = DEFAULT_MAX_SIZE,
                 wal_max_batch: int = DEFAULT_MAX_BATCH,
                 wal_max_entries: int = 0,
                 wal_max_batch_bytes: int = 0,
                 wal_max_batch_interval_ms: float = 0.0,
                 segment_max_count: int = 4096,
                 wal_supervise: bool = True,
                 superstep_k: Optional[int] = None,
                 dispatch_ahead: Optional[int] = None) -> None:
        self.name = name
        self.data_dir = data_dir
        # lane-engine pipeline tunables carried by the system so an
        # embedding node configures both planes in one place (surfaced
        # in overview(); the engine/bench read them via
        # engine_pipeline_defaults when not set explicitly)
        defaults = engine_pipeline_defaults()
        self.superstep_k = defaults["superstep_k"] \
            if superstep_k is None else superstep_k
        self.dispatch_ahead = defaults["dispatch_ahead"] \
            if dispatch_ahead is None else dispatch_ahead
        #: the WAL group-commit wait budget this system was configured
        #: with — an autotuner-tunable knob, so it is stamped in the
        #: engine_pipeline overview next to superstep_k (rule RA07)
        self.wal_max_batch_interval_ms = wal_max_batch_interval_ms
        os.makedirs(data_dir, exist_ok=True)
        self.segment_max_count = segment_max_count
        self._logs: dict[str, DurableLog] = {}
        self._lock = threading.Lock()
        self.directory = Directory(data_dir)
        #: flush-escalation handler: called as fn(uid, exc) when a
        #: server's segment flush exhausted its retry budget (the
        #: server-restart rung of the degradation ladder — a node that
        #: hosts the server can install a kill+restart hook here;
        #: the default just records the event, which is safe: the WAL
        #: file is kept, so the entries stay recoverable)
        self.on_flush_escalation = None
        self.segment_writer = SegmentWriter(resolve=self._resolve,
                                            on_escalate=self._escalate)
        #: classic-plane phase attribution: one accumulator
        #: for every co-hosted server — the WAL stamps fsync_wait /
        #: confirm_publish, the DurableLogs stamp encode — surfaced via
        #: node.classic_stats() as encode_share_pct in bench tails
        from .telemetry import PhaseStats
        self.phase_stats = PhaseStats()
        # group-commit tunables ride through to the node-wide WAL (flush
        # on bytes OR interval; 0/0 keeps the drain-the-mailbox policy)
        self.wal = Wal(data_dir, sync_mode=wal_sync_mode,
                       max_size=wal_max_size, max_batch=wal_max_batch,
                       max_entries=wal_max_entries,
                       max_batch_bytes=wal_max_batch_bytes,
                       max_batch_interval_ms=wal_max_batch_interval_ms,
                       segment_writer=self.segment_writer,
                       phase_stats=self.phase_stats)
        # Recovered WAL entries are purged at boot ONLY for uids with an
        # explicit force-delete tombstone.  Absence from the registry is
        # not proof of deletion (the directory file may predate the
        # record, or may have failed to load), so unknown uids keep their
        # fsync-acknowledged data conservatively — their recovered files
        # stay pinned until the server re-registers, matching the
        # reference's keep-unresolvable-WAL behaviour.
        if self.wal._recovered_files:
            # this boot re-read surviving WAL files: stamp a recovery
            # report joining any post-mortem bundle the crash left
            # (crash + recovery read as one incident)
            stamp_recovery(
                {"plane": "classic_wal", "system": name,
                 "files": len(self.wal._recovered_files),
                 "uids": sorted(self.wal._recovered)},
                data_dir=data_dir)
        if not self.directory.load_failed:
            spent = set()
            for uid in self.directory.tombstones():
                if self.directory.is_registered_uid(uid):
                    # the uid was re-registered after the force-delete:
                    # the tombstone's authorisation is superseded by the
                    # live server — prune it, or it lingers forever
                    spent.add(uid)
                    continue
                # wal.purge only drops in-memory tables — the uid's bytes
                # stay in shared WAL files and may be re-recovered at the
                # next boot, when the tombstone must still authorise
                # purging them again; capture that BEFORE purging
                had_wal = uid in self.wal._recovered
                if had_wal:
                    self.wal.purge(uid)
                # a crash between wal.purge and rmtree in force_delete can
                # leave the uid's data dir behind: finish the job here, or
                # the orphan leaks forever once the tombstone is pruned
                tomb_dir = os.path.join(data_dir, uid)
                if os.path.isdir(tomb_dir):
                    shutil.rmtree(tomb_dir, ignore_errors=True)
                # spent only when neither WAL data nor an on-disk dir
                # remains to authorise cleaning at the next boot
                if not had_wal and not os.path.isdir(tomb_dir):
                    spent.add(uid)
            self.directory.prune_tombstones(spent)
        # WAL supervisor: restart a dead batch thread and run the writers'
        # resend hooks (the ra_log_sup/ra_log_wal_sup role; disabled in
        # tests that assert raw WalDown behaviour)
        self._sup_stop = threading.Event()
        self._wal_restarts: deque = deque()
        self._sup_thread: Optional[threading.Thread] = None
        if wal_supervise:
            self._sup_thread = threading.Thread(
                target=self._supervise_wal, daemon=True,
                name=f"ra-wal-sup-{name}")
            self._sup_thread.start()

    def _supervise_wal(self) -> None:
        max_r, period = WAL_RESTART_INTENSITY
        log = logging.getLogger("ra_tpu_torch")
        while not self._sup_stop.wait(0.02):
            wal = self.wal
            if wal._stop or wal.alive:
                continue
            now = time.monotonic()
            while self._wal_restarts and \
                    now - self._wal_restarts[0] > period:
                self._wal_restarts.popleft()
            if len(self._wal_restarts) >= max_r:
                log.error("wal supervisor (%s): restart intensity "
                          "exceeded (%d in %.0fs); backing off %.0fs",
                          self.name, max_r, period, period)
                record("sup.giveup", plane="wal", system=self.name)
                RECORDER.dump(
                    "wal_supervisor_giveup",
                    what=f"WAL restart intensity exceeded ({max_r} in "
                         f"{period:.0f}s)",
                    where=self.name, data_dir=self.data_dir)
                if self._sup_stop.wait(period):
                    return
                continue
            self._wal_restarts.append(now)
            log.warning("wal supervisor (%s): restarting dead WAL",
                        self.name)
            # a failing restart (e.g. ENOSPC opening the fresh file) must
            # not kill the supervisor itself — it already counted against
            # the intensity window, so the loop retries with backoff once
            # the window fills
            try:
                wal.restart()
                record("sup.restart", plane="wal", system=self.name)
                with self._lock:
                    logs = list(self._logs.values())
                for dlog in logs:
                    dlog.wal_restarted()
            except Exception:
                log.exception("wal supervisor (%s): restart attempt "
                              "failed; will retry", self.name)

    def _resolve(self, uid: str) -> Optional[DurableLog]:
        with self._lock:
            return self._logs.get(uid)

    def _escalate(self, uid: str, exc: BaseException) -> None:
        """Segment-flush escalation (retry budget exhausted).  With no
        installed handler this only logs: the flush job kept the WAL
        file, so every entry remains recoverable from disk — the
        degraded state is 'WAL files accumulate', not data loss.  A
        node-level handler (on_flush_escalation) may stop+restart the
        owning server so it re-recovers from memtable + segments, the
        reference's supervisor semantics."""
        handler = self.on_flush_escalation
        if handler is not None:
            handler(uid, exc)
        else:
            logging.getLogger("ra_tpu_torch").error(
                "segment flush escalation for %s (%s): WAL file kept, "
                "no restart handler installed", uid, exc)

    @staticmethod
    def validate_uid(uid: str) -> bool:
        """UIDs name on-disk directories and WAL records: restrict to
        base64url-safe characters, non-empty (ra_lib:validate_base64uri,
        ra_lib.erl:254-268; start_server refuses invalid UIDs the same
        way, ra_2_SUITE:start_server_uid_validation)."""
        import re
        return bool(uid) and re.fullmatch(r"[A-Za-z0-9_\-=]+", uid) \
            is not None

    def log_factory(self, cfg: ServerConfig) -> DurableLog:
        """Factory handed to RaNode: per-server durable log over the shared
        WAL/segment-writer.  The log is the server's *storage identity* and
        survives server crashes within a running system — a restarted
        server reuses it (the ra_log_ets role: memtables outlive the
        processes that fill them)."""
        if not self.validate_uid(cfg.uid):
            raise ValueError(
                f"invalid uid {cfg.uid!r}: must be non-empty base64url "
                "(it names a data directory)")
        # every uid that owns a log MUST be in the durable directory — the
        # boot purge treats absence as "force-deleted".  Log-only configs
        # (no server_id; tests/tools) register under their uid with an
        # empty config snapshot, which recover_servers skips.
        if cfg.server_id is not None:
            self.directory.register(cfg.uid, cfg.server_id.name,
                                    cfg.cluster_name, _config_snapshot(cfg))
        else:
            self.directory.register(cfg.uid, cfg.uid, cfg.cluster_name, {})
        with self._lock:
            log = self._logs.get(cfg.uid)
            if log is not None:
                log.take_events()  # drop confirms addressed to the old shell
                self.wal.register(cfg.uid, log._wal_notify)
                return log
            # create under the lock: two concurrent starts for one uid must
            # not build two logs over one directory
            log = DurableLog(cfg.uid, self.data_dir, self.wal,
                             segment_max_count=self.segment_max_count)
            self._logs[cfg.uid] = log
            return log

    # -- recovery / deletion (ra_system_recover + force_delete) ------------

    def recover_servers(self, node, machine_for=None) -> list:
        """Restart every registered server on ``node`` — the boot-time
        `server_recovery_strategy: registered` (ra_system_recover.erl:
        34-68).  ``machine_for(cluster_name, server_name) -> Machine``
        resolves the user machine (the durable equivalent of the module
        reference the reference persists); when it is None or returns
        None, a persisted machine_spec in the config snapshot resolves
        through the machine registry instead.  Servers with neither are
        skipped; already-running servers are left alone."""
        from .machines import resolve_machine, spec_of
        started = []
        for uid in self.directory.uids():
            snap = self.directory.config_of(uid)
            if not snap:
                continue
            name = self.directory.name_of(uid)
            if name is None or name in node.shells:
                continue
            machine = machine_for(snap["cluster_name"], name) \
                if machine_for is not None else None
            spec = snap.get("machine_spec")
            if machine is None and spec is not None:
                machine = resolve_machine(spec)
            if machine is None:
                continue
            if spec is not None and spec_of(machine) is None:
                # carry the persisted spec onto a machine_for-supplied
                # machine: the re-register below snapshots spec_of(), and
                # erasing it would break later disk-based control-plane
                # restarts of this member
                machine._machine_spec = spec
            cfg = ServerConfig(
                server_id=ServerId(*snap["server_id"]),
                uid=uid,
                cluster_name=snap["cluster_name"],
                initial_members=tuple(ServerId(*m)
                                      for m in snap["initial_members"]),
                machine=machine,
                election_timeout_ms=snap["election_timeout_ms"],
                tick_interval_ms=snap["tick_interval_ms"],
                broadcast_time_ms=snap["broadcast_time_ms"],
                membership=Membership(snap["membership"]),
                system_name=snap.get("system_name", "default"),
                **{k: snap[k] for k in SNAPSHOT_TUNABLE_KEYS
                   if k in snap},
            )
            started.append(node.start_server(cfg))
        return started

    def delete_server_data(self, uid: str) -> None:
        """Wipe a server's durable footprint (the data-dir half of
        ra:force_delete_server).  The caller stops the process first.
        Includes the member's uid-scoped machine_ets side tables — the
        system owns them like the reference's ra_machine_ets service
        under ra_sup (ra_sup.erl:33-35)."""
        from . import machine_ets
        machine_ets.drop_scope(uid)
        with self._lock:
            log = self._logs.pop(uid, None)
        if log is not None:
            log.close()
        self.wal.purge(uid)
        # tombstone: authorises a later boot to purge any WAL remnants of
        # this uid that a crash resurrects (see __init__)
        self.directory.unregister(uid, tombstone=True)
        target = os.path.join(self.data_dir, uid)
        if os.path.isdir(target):
            shutil.rmtree(target, ignore_errors=True)

    def registered_uids(self) -> list:
        with self._lock:
            return list(self._logs)

    def close(self) -> None:
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=5)
        self.wal.close()
        self.segment_writer.close()
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs.clear()

    def counters(self) -> dict:
        """Node-wide infra counters: the WAL's (ra_log_wal.erl:32-43,
        plus derived fsync latency p50/p99 and records-per-fsync from
        Wal.stats), the segment writer's
        (ra_log_segment_writer.erl:37-52), and the storage-plane fault
        counters (metrics.DISK_FAULT_FIELDS)."""
        from .log import faults
        return {"wal": self.wal.stats(),
                "segment_writer": dict(self.segment_writer.counters),
                "disk_faults": faults.disk_fault_counters()}

    def observatory(self, *, counters=None, router=None,
                    ring_capacity: int = 256):
        """The unified host-side observability surface for this system
        (ra_tpu_torch.telemetry.Observatory): one merged snapshot of WAL/
        segment-writer/disk-fault counters + the pipeline tunables,
        optionally a node's Counters registry and a TcpRouter (whose
        reliable-RPC counters then reach the exposition/ring);
        Prometheus exposition and the bounded per-window time-series
        ring ride on it."""
        from .telemetry import Observatory
        return Observatory.for_system(self, counters=counters,
                                      router=router,
                                      ring_capacity=ring_capacity)

    def overview(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "data_dir": self.data_dir,
                "servers": {uid: log.overview()
                            for uid, log in self._logs.items()},
                "directory": self.directory.overview(),
                "counters": self.counters(),
                "engine_pipeline": {
                    "superstep_k": self.superstep_k,
                    "dispatch_ahead": self.dispatch_ahead,
                    "wal_max_batch_interval_ms":
                        self.wal_max_batch_interval_ms,
                },
            }
