"""Counter-field registries the port's engine uses.

Own copies of ``ra_tpu.metrics.ENGINE_PIPELINE_FIELDS`` and
``TELEMETRY_FIELDS`` (the port imports nothing of ``ra_tpu``); the
equality of both tuples with the reference is pinned by
``tests/test_torch_engine.py``.
"""

#: host-side dispatch-pipeline counters of ``LockstepEngine``:
#: ``dispatches`` device programs launched by the host, ``inner_steps``
#: engine rounds (a superstep of K adds K), ``superstep_dispatches`` the
#: fused subset, ``blocks_staged`` host->device staging transfers of the
#: dispatch-ahead driver, ``window_syncs`` its in-flight-cap waits.  The
#: port has no superstep or driver yet, so the last three stay 0.
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

#: every counter-field group of the port, by the reference's group names
FIELD_REGISTRY = {
    "engine_pipeline": ENGINE_PIPELINE_FIELDS,
    "telemetry": TELEMETRY_FIELDS,
}
