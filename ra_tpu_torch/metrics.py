"""Counter-field registries the port's engine uses.

Own copies of ``ra_tpu.metrics.ENGINE_PIPELINE_FIELDS``,
``TELEMETRY_FIELDS``, ``TELEMETRY_SUMMARY_FIELDS`` and ``PHASE_FIELDS``
(the port imports nothing of ``ra_tpu``); the equality of every tuple
with the reference is pinned by ``tests/test_torch_engine.py``.
"""

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
#: outcome observed.  The WAL phases (``queue_wait`` to ``encode``) are
#: stamped by the durable engine, which is not ported yet.
PHASE_FIELDS = (
    "host_staging", "device_dispatch", "queue_wait", "wal_encode",
    "fsync_wait", "confirm_publish", "commit_e2e", "encode",
    "read_e2e",
)

#: every counter-field group of the port, by the reference's group names
FIELD_REGISTRY = {
    "engine_pipeline": ENGINE_PIPELINE_FIELDS,
    "telemetry": TELEMETRY_FIELDS,
    "telemetry_summary": TELEMETRY_SUMMARY_FIELDS,
    "phase": PHASE_FIELDS,
}
