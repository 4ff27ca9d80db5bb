"""Counter-field registries, counters and the leaderboard of the port.

Own copies of every field tuple of ``ra_tpu.metrics`` (the port imports
nothing of ``ra_tpu``), with the classic plane's ``Counters`` registry
and ``Leaderboard``; the equality of every tuple with the reference is
pinned by ``tests/test_torch_engine.py``, ``tests/test_torch_wal.py``,
``tests/test_torch_ingress.py`` and ``tests/test_torch_classic_core.py``.
``PLACEMENT_FIELDS`` are the counters of the placement tier's
``EngineSupervisor`` (``placement/supervisor.py``) and the wire
listener's ``rehome_hints``.
"""
from __future__ import annotations

import threading
from typing import Optional

#: per-server LOG subsystem counter fields (RA_LOG_COUNTER_FIELDS,
#: ra.hrl:236-268 — same names).  Owned by the log facade (DurableLog /
#: MemoryLog keep a plain dict) and merged into key_metrics.
#: Deliberate N/A vs the reference: ``reserved_1`` (a placeholder), and
#: ``read_open_mem_tbl``/``read_closed_mem_tbl`` — the reference's
#: open/closed WAL ETS tables are merged into the DurableLog memtable
#: here (wal.py:15-21), so those reads all count as ``read_cache``.
LOG_FIELDS = (
    "write_ops", "write_resends", "read_ops", "read_cache",
    "read_segment", "fetch_term", "snapshots_written",
    "snapshot_installed", "snapshot_bytes_written", "open_segments",
    "checkpoints_written", "checkpoint_bytes_written",
    "checkpoints_promoted",
)

#: per-server raft/process counter fields (RA_SRV_COUNTER_FIELDS,
#: ra.hrl:311-357 — same names).  ``reserved_2`` omitted (placeholder);
#: ``invalid_reply_mode_commands`` stays 0 by construction — reply modes
#: are a typed enum here, so an invalid one cannot be submitted.
#: ``msgs_processed`` is ours (no reference equivalent): total events
#: through the shell, useful for busy-loop diagnostics.
SERVER_FIELDS = (
    "aer_received_follower", "aer_replies_success", "aer_replies_fail",
    "commands", "command_flushes", "aux_commands", "consistent_queries",
    "rpcs_sent", "msgs_sent", "dropped_sends", "send_msg_effects_sent",
    "pre_vote_elections", "elections", "forced_gcs", "snapshots_sent",
    "release_cursors", "aer_received_follower_empty",
    "term_and_voted_for_updates", "local_queries",
    "invalid_reply_mode_commands", "checkpoints", "msgs_processed",
)

#: per-server gauge fields (RA_SRV_METRICS_COUNTER_FIELDS,
#: ra.hrl:359-383): sampled live from server state at key_metrics time
#: rather than double-written into counters on every event.
METRIC_FIELDS = (
    "last_applied", "commit_index", "snapshot_index", "last_index",
    "last_written_index", "commit_latency", "term", "checkpoint_index",
    "effective_machine_version",
)

#: router-level reliable-RPC counter fields (transport/rpc.py): the
#: control plane's at-most-once observability.  Sender side: calls,
#: retries and the typed failure triad; receiver side: executions,
#: dedup hits (a retry mapped onto an already-seen request id — the
#: proof no lifecycle verb ran twice), responses re-sent from the
#: cache, and requests that arrived past their propagated deadline.
#: No reference equivalent: rpc:call rides Erlang distribution there.
RPC_FIELDS = (
    "rpc_calls", "rpc_retries", "rpc_timeouts", "rpc_unreachable",
    "rpc_remote_errors", "rpc_dedup_hits", "rpc_requests_executed",
    "rpc_responses_resent", "rpc_expired",
)

#: node-wide segment-writer counter fields (ra_log_segment_writer.erl:
#: 37-52 — same names)
SEGMENT_WRITER_FIELDS = ("mem_tables", "segments", "entries",
                         "bytes_written")

#: classic replication-batching health: the shape of
#: ``RaNode.classic_stats()`` — stamped into bench_classic's JSON tail
#: (both phases) and wired into the leader system's Observatory as the
#: ``classic`` source.  ``aer_batches_sent`` counts multi-entry
#: AppendEntries frames built by leaders hosted on the node and
#: ``aer_batch_entries`` the entries they carried (their ratio is the
#: realized AER batching factor); ``entries_per_batch_p50``/
#: ``entries_per_batch_p99``/``entries_per_batch_mean`` come from the
#: cores' bounded batch-size reservoirs; ``records_per_fsync`` — the
#: group-commit fan-in half of the pair — is Wal.stats()'s
#: amortization factor, stamped next to the AER numbers by the
#: embedding bench so one doc answers "how batched was replication,
#: end to end".
CLASSIC_FIELDS = (
    "aer_batches_sent", "aer_batch_entries", "entries_per_batch_p50",
    "entries_per_batch_p99", "entries_per_batch_mean",
    "records_per_fsync",
)

#: placement failover control plane (the reference's ``placement/``):
#: the EngineSupervisor's counter group.  Detector tier:
#: ``heartbeats`` probe responses heard (delayed arrivals count when
#: they land), ``suspects``/``downs`` verdict escalations (a suspect
#: that recovers inside the hysteresis window never becomes a down —
#: the slow-fsync guard), ``recoveries`` suspect→up de-escalations.
#: Re-placement tier: ``migrations`` lane-range re-placements
#: committed through the placement table, ``migrate_retries`` extra
#: attempts the bounded commit loop needed beyond the first,
#: ``giveups`` bounded loops that exhausted their deadline (each also
#: emits ``placement.giveup``), ``adopts`` victim engines restored
#: into a survivor's lane space, ``rehomed_sessions`` sessions
#: re-bound to a new home (epoch bump + slot claim).  Cross-host tier
#:: ``stale_probe_drops`` probe replies discarded because
#: the slot was re-provisioned to a newer generation while the probe
#: was in flight (each also emits ``placement.stale_probe``), and
#: ``rehome_hints`` frames refused by a serving listener with a typed
#: REHOME hint because the lane's home moved (each refusal batch also
#: emits ``placement.rehome_hint``).
PLACEMENT_FIELDS = (
    "heartbeats", "suspects", "downs", "recoveries", "migrations",
    "migrate_retries", "giveups", "adopts", "rehomed_sessions",
    "stale_probe_drops", "rehome_hints",
)


#: host-side dispatch-pipeline counters of ``LockstepEngine``:
#: ``dispatches`` device programs launched by the host, ``inner_steps``
#: engine rounds (a superstep of K adds K), ``superstep_dispatches`` the
#: fused subset, ``blocks_staged`` host->device staging transfers of the
#: dispatch-ahead driver, ``window_syncs`` its in-flight-cap pops that
#: had to wait for the device.
ENGINE_PIPELINE_FIELDS = ("dispatches", "inner_steps",
                          "superstep_dispatches", "blocks_staged",
                          "window_syncs")

#: device-resident per-lane telemetry accumulators (``LaneTelemetry``):
#: counters ``elections_requested``, ``elections_won``, ``leader_changes``,
#: ``steps``; gauges ``leader_age`` (steps since the leader last moved),
#: ``commit_lag`` (leader tail - leader commit), ``apply_lag`` (leader
#: commit - lane apply frontier), ``stall_steps`` (consecutive rounds with
#: a commit backlog and no commit progress).
TELEMETRY_FIELDS = (
    "elections_requested", "elections_won", "leader_changes",
    "leader_age", "commit_lag", "apply_lag", "stall_steps", "steps",
)

#: the on-device aggregation of TELEMETRY_FIELDS that
#: ``TelemetrySampler`` reads back: scalar rollups, the log2-bucket
#: ``commit_lag_hist``, the ``top_lanes`` offenders by (stall, lag) score
#: with their ``top_*`` gauges, and cumulative float32 totals.
TELEMETRY_SUMMARY_FIELDS = (
    "steps", "elections_requested", "elections_won", "leader_changes",
    "stalled_lanes", "commit_lag_max", "commit_lag_mean",
    "apply_lag_max", "apply_lag_mean", "leader_age_min",
    "commit_lag_hist", "top_lanes", "top_commit_lag", "top_apply_lag",
    "top_stall_steps", "committed_total",
    "read_served_total", "read_shed_total", "read_stale_total",
    "read_leased_total",
)

#: host-side latency phases of ``telemetry.PhaseStats``, stamped at the
#: dispatch path's edges: ``host_staging`` the driver's host copy of a
#: block into pinned memory plus the start of its host-to-device copy,
#: ``device_dispatch`` submit to the dispatch's committed watermark
#: observed on the host, ``read_e2e`` read-block submit to its serve
#: outcome observed.  The WAL phases are stamped by the durable engine
#: (``engine/durable.py``) and its WAL shards (``log/wal.py``):
#: ``queue_wait`` a submitted step's wait for its shard's worker,
#: ``wal_encode`` readback plus encode, ``encode`` the block encode
#: alone, ``fsync_wait`` and ``confirm_publish`` the WAL's group commit,
#: ``commit_e2e`` submit to the step covered by every shard's horizon.
PHASE_FIELDS = (
    "host_staging", "device_dispatch", "queue_wait", "wal_encode",
    "fsync_wait", "confirm_publish", "commit_e2e", "encode",
    "read_e2e",
)

#: WAL counter fields, one dict per WAL (each shard of the durable
#: engine owns one): ``wal_files`` files opened, ``batches`` group
#: commits, ``writes`` records, ``bytes_written``, ``syncs`` durability
#: syscalls and ``sync_time_us`` their cumulative wall time.
#: ``Wal.stats()`` adds fsync p50/p99 and records per fsync.
WAL_FIELDS = ("wal_files", "batches", "writes", "bytes_written", "syncs",
              "sync_time_us")

#: durable-engine bridge counters (``engine/durable.py``):
#: ``readback_bytes`` what the compacted device-to-host readback moved
#: for WAL encode, ``readback_bytes_full`` what a readback of the whole
#: [N, K, C] batch would have moved on the same steps, and the encoded
#: WAL blocks and their bytes.  The overview adds ``confirm_lag_steps``
#: (dispatched but unconfirmed steps on the laggiest shard) as a gauge.
ENGINE_WAL_FIELDS = ("readback_bytes", "readback_bytes_full",
                     "encoded_blocks", "encoded_bytes")

#: storage-plane fault counters (``log/faults.py``), one process-wide
#: dict: ``faults_injected`` plan decisions that injected a fault;
#: ``faults_hit`` I/O errors the log layer handled; ``crc_catches``
#: corruption caught by a CRC check; ``poisoned_files`` WAL files
#: poisoned by a failed durability syscall (never fsynced again);
#: ``fault_rollovers`` rollovers that poison forced;
#: ``wal_escalations`` poison-cap overflows escalated to thread death;
#: ``flush_retries``/``flush_escalations`` the segment-flush backoff;
#: ``snapshot_write_failures`` failed snapshot writes;
#: ``swallowed_oserrors`` the audited swallow sites; and
#: ``fsync_retries_after_failure`` fsyncs re-issued on a failed fd with
#: no rewrite in between, which must stay 0.
DISK_FAULT_FIELDS = (
    "faults_injected", "faults_hit", "crc_catches", "poisoned_files",
    "fault_rollovers", "wal_escalations", "flush_retries",
    "flush_escalations", "snapshot_write_failures",
    "swallowed_oserrors", "fsync_retries_after_failure",
)

#: ingress-plane counters (``ingress/``), one dict an ``IngressPlane``:
#: ``submitted`` every row offered to ``submit``; ``accepted`` the rows
#: placed into the coalescer (these alone advance the at-most-once seqno
#: watermark); ``dup_dropped`` resends of an already placed (session,
#: seqno); ``slow_signals`` admissions past the soft credit;
#: ``deferred`` rows parked by tenant-fairness admission at ladder level
#: >= 2; ``rejected`` rows refused at the hard credit; ``shed_rows`` rows
#: dropped by coalescer ring overflow (bounded queues shed, they never
#: grow); ``blocks_built`` superstep blocks dispatched and ``block_rows``
#: the rows they carried; ``reconnects`` session epoch bumps;
#: ``credits_released`` per-row credit returns at block-commit
#: granularity.
INGRESS_FIELDS = (
    "submitted", "accepted", "dup_dropped", "slow_signals", "deferred",
    "rejected", "shed_rows", "blocks_built", "block_rows", "reconnects",
    "credits_released",
)

#: wire-plane counters (``wire/``), one dict a ``WireListener``.
#: Connections: ``conns_opened``/``conns_closed`` slots bound and
#: released (socket accepts and loopback bulk connects),
#: ``hello_reconnects`` re-binds of a known connection key.  Data:
#: ``bytes_recv`` raw bytes landed in the rings, ``sweeps`` sweep passes,
#: ``swept_rows`` DATA records decoded and submitted, ``protocol_errors``
#: malformed frames or records (each closes its connection).  Feedback:
#: ``credit_rows``/``ack_rows`` verdict and watermark records sent back;
#: ``credit_ok`` .. ``credit_shed`` the verdicts by status.  Reads:
#: ``read_rows`` READ records decoded and submitted, ``read_reply_rows``
#: READ_REPLY records sent back with their certified watermark.
WIRE_FIELDS = (
    "conns_opened", "conns_closed", "hello_reconnects", "bytes_recv",
    "sweeps", "swept_rows", "protocol_errors", "credit_rows",
    "ack_rows", "credit_ok", "credit_slow", "credit_defer",
    "credit_reject", "credit_dup", "credit_shed",
    "read_rows", "read_reply_rows",
)

#: the ingress plane's read-lane counters, one dict an ``IngressPlane``:
#: ``submitted`` read rows offered, ``accepted`` those placed into the
#: read coalescer, ``shed`` rows shed by overload (any ladder level above
#: green sheds reads before writes are delayed), ``rejected`` rows
#: refused by ring overflow; ``blocks_built``/``block_rows`` read blocks
#: dispatched and their rows; ``served`` reads answered at a certified
#: watermark, ``stale_refused`` reads the device refused rather than
#: serve stale, ``lease_served`` the served-under-lease subset,
#: ``replies_sent`` READ_REPLY rows sent back to clients.
READ_FIELDS = (
    "submitted", "accepted", "shed", "rejected", "blocks_built",
    "block_rows", "served", "stale_refused", "lease_served",
    "replies_sent",
)

#: the device plane (``devicewatch.WATCH.counters``).  Capture sentinel:
#: ``compiles`` CUDA graph captures (the port's compiles: a new graph key
#: captures once), ``recompiles`` the captures of a key an engine had
#: captured before (evicted) or of a new shape at a site (one variant of
#: an engine's graph cache) that had one (steady state MUST stay 0),
#: ``compile_ms`` their cumulative wall time.
#: Transfer ledger: ``h2d_events``/``h2d_bytes`` host->device copies,
#: ``d2h_events``/``d2h_bytes`` device->host readbacks.  Memory
#: watermarks, sampled on the TelemetrySampler's harvest tick from the
#: caching allocator's host-side statistics: ``live_buffers``/
#: ``live_bytes`` allocations and bytes held at the last sample,
#: ``peak_live_bytes`` the high-water mark, ``buffers_freed`` the frees
#: the allocator counted between samples, ``watermark_samples`` samples.
DEVICE_FIELDS = (
    "compiles", "recompiles", "compile_ms", "h2d_events", "h2d_bytes",
    "d2h_events", "d2h_bytes", "live_buffers", "live_bytes",
    "peak_live_bytes", "buffers_freed", "watermark_samples",
)

#: every counter-field group of the port, by the reference's group names
FIELD_REGISTRY = {
    "log": LOG_FIELDS,
    "server": SERVER_FIELDS,
    "metric": METRIC_FIELDS,
    "rpc": RPC_FIELDS,
    "segment_writer": SEGMENT_WRITER_FIELDS,
    "classic": CLASSIC_FIELDS,
    "placement": PLACEMENT_FIELDS,
    "wal": WAL_FIELDS,
    "engine_wal": ENGINE_WAL_FIELDS,
    "engine_pipeline": ENGINE_PIPELINE_FIELDS,
    "telemetry": TELEMETRY_FIELDS,
    "telemetry_summary": TELEMETRY_SUMMARY_FIELDS,
    "phase": PHASE_FIELDS,
    "disk_faults": DISK_FAULT_FIELDS,
    "ingress": INGRESS_FIELDS,
    "read": READ_FIELDS,
    "wire": WIRE_FIELDS,
    "device": DEVICE_FIELDS,
}


class Counters:
    """Named counter groups (the seshat role)."""

    def __init__(self) -> None:
        self._groups: dict[str, dict] = {}
        self._lock = threading.Lock()
        #: increments addressed to an unknown group or field.  The old
        #: behaviour silently dropped them — a typo'd field name lost
        #: its events with no trace; now every drop is itself counted
        #: (the seshat-style self-metric; asserted 0 under the normal
        #: workloads in tests).
        self.dropped = 0

    def new(self, name: str, fields=SERVER_FIELDS) -> dict:
        with self._lock:
            g = self._groups.get(name)
            if g is None:
                g = {f: 0 for f in fields}
                self._groups[name] = g
            return g

    def incr(self, name: str, field: str, n: int = 1) -> None:
        g = self._groups.get(name)
        if g is None or field not in g:
            self.dropped += 1
            return
        g[field] += n

    def self_metrics(self) -> dict:
        """The registry's own health: ``telemetry_dropped`` counts
        increments lost to unknown group/field names (MUST stay 0 — a
        nonzero value means an instrumentation site and the field
        registry disagree)."""
        return {"telemetry_dropped": self.dropped}

    def fetch(self, name: str) -> Optional[dict]:
        g = self._groups.get(name)
        return dict(g) if g is not None else None

    def delete(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)

    def overview(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._groups.items()}


class Leaderboard:
    """cluster name -> (leader, members); written on leader change, read
    lock-free by clients (ra_leaderboard.erl:23-34)."""

    def __init__(self) -> None:
        self._tab: dict[str, tuple] = {}

    def record(self, cluster_name: str, leader, members) -> None:
        self._tab[cluster_name] = (leader, tuple(members))

    def lookup_leader(self, cluster_name: str):
        got = self._tab.get(cluster_name)
        return got[0] if got else None

    def lookup_members(self, cluster_name: str):
        got = self._tab.get(cluster_name)
        return got[1] if got else None

    def overview(self) -> dict:
        return dict(self._tab)
