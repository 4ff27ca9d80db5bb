"""Latency phases, the asynchronous telemetry sampler of the engine, and
the unified Observatory.

The port's own copy of ``ra_tpu/telemetry.py``:

* :class:`PhaseStats` -- per phase of ``metrics.PHASE_FIELDS``, a
  bounded latency reservoir (p50/p99/max), a log2-ms histogram, a count
  and a monotone ``total_ms``, fed with host-clock stamps taken at the
  edges of the dispatch path (never a device sync).
* :class:`TelemetrySampler` -- every ``cadence_steps`` engine rounds it
  aggregates the engine's per-lane ``LaneTelemetry`` on the device
  (``engine.lockstep.telemetry_summary_fn``) and starts an asynchronous
  copy of the few-hundred-byte result (a ``readback.Readback``); ready
  copies are harvested on later ticks.  On a sharded engine each lane
  shard's summary runs on its own device, all copied in one readback,
  and the harvest merges them (``merge_telemetry_summaries``: global
  lane ids, ties to the lower lane id).  The dispatch loop never blocks
  on it.  A harvest also takes the device-memory census
  (``devicewatch.sample_watermarks``, throttled) and feeds the installed
  tracer a ``lane_health`` counter track.
* :class:`Observatory` -- the host-side unification: one merged snapshot
  of engine telemetry, dispatch-pipeline counters and knobs, phase
  attribution, WAL plane, the ingress and read planes (a wire listener
  attaches itself), the device plane and the flight recorder, with (a)
  Prometheus text exposition (metric prefix ``ra_tpu_``, the name
  ``tools/ra_top.py`` and dashboards read), (b) a bounded time-series
  ring yielding per-window rates and percentiles (what the SLO engine and
  the autotuner read), and (c) JSONL-ring export for
  ``tools/ra_top.py``.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from . import devicewatch, trace
from .metrics import PHASE_FIELDS
from .readback import Readback

logger = logging.getLogger("ra_tpu_torch.telemetry")

#: default sampling cadence in engine rounds (inner steps, not dispatches)
DEFAULT_CADENCE_STEPS = 64

#: a lane is STALLED once it has sat this many consecutive rounds with a
#: commit backlog and no commit progress
DEFAULT_STALL_THRESHOLD = 8

#: minimum seconds between device-memory censuses on the harvest tick; a
#: sampler's first harvest censuses at once
CENSUS_MIN_INTERVAL_S = 0.25

#: log2 millisecond buckets of the phase histograms: bucket 0 = <1 ms,
#: bucket b = < 2^b ms, the last one takes the tail
PHASE_HIST_BUCKETS = 16


class PhaseStats:
    """Phase-resolved latency attribution: where a window's latency went
    (host staging, device dispatch, read service, and on a durable
    engine the WAL phases, stamped by its bridge and WAL shards).  One
    accumulator per engine; a sample is a pair of ``time.monotonic()``
    stamps taken on the host."""

    def __init__(self, *, reservoir: int = 512) -> None:
        self._fields = PHASE_FIELDS
        self._lock = threading.Lock()
        self._res = {p: collections.deque(maxlen=reservoir)
                     for p in PHASE_FIELDS}
        self._hist = {p: [0] * PHASE_HIST_BUCKETS for p in PHASE_FIELDS}
        self._count = {p: 0 for p in PHASE_FIELDS}
        self._total_ms = {p: 0.0 for p in PHASE_FIELDS}
        #: samples addressed to an unknown phase
        self.dropped = 0

    def note(self, phase: str, dt_s: float) -> None:
        """Record one sample of ``dt_s`` seconds for ``phase``."""
        if phase not in self._count:
            self.dropped += 1
            return
        ms = dt_s * 1000.0
        b = min(PHASE_HIST_BUCKETS - 1, max(0, int(ms).bit_length()))
        with self._lock:
            self._res[phase].append(ms)
            self._hist[phase][b] += 1
            self._count[phase] += 1
            self._total_ms[phase] += ms

    def overview(self) -> dict:
        """Per phase ``{count, total_ms, p50_ms, p99_ms, max_ms, hist}``
        (-1.0 for the percentiles of a phase with no sample), plus
        ``dropped``."""
        out: dict = {}
        with self._lock:
            for p in self._fields:
                lats = sorted(self._res[p])
                n = len(lats)
                out[p] = {
                    "count": self._count[p],
                    "total_ms": round(self._total_ms[p], 3),
                    "p50_ms": round(lats[n // 2], 3) if n else -1.0,
                    "p99_ms": round(lats[min(n - 1, int(n * 0.99))], 3)
                    if n else -1.0,
                    "max_ms": round(lats[-1], 3) if n else -1.0,
                    "hist": list(self._hist[p]),
                }
        out["dropped"] = self.dropped
        return out

    def reset_reservoirs(self) -> None:
        """Clear the percentile reservoirs and keep count, total_ms and
        hist monotone: a boundary between warm-up and a measured window."""
        with self._lock:
            for p in self._fields:
                self._res[p].clear()


def _host_value(arr: np.ndarray) -> Any:
    """A harvested numpy value as a python scalar (floats rounded to 4
    places, as the reference does) or a list."""
    if arr.ndim == 0:
        v = arr.item()  # ra04-ok: host numpy of a readback that has landed
        return round(v, 4) if isinstance(v, float) else v
    return arr.tolist()


class TelemetrySampler:
    """Asynchronous drain of a ``LockstepEngine``'s telemetry.

    Constructing one attaches it; the engine calls :meth:`tick` after
    every dispatch.  Every ``cadence_steps`` rounds it runs the summary
    over the current state and starts its copy to the host; ready copies
    are harvested on later ticks, and with more than ``max_pending``
    samples in flight the oldest is dropped (``samples_dropped``).
    ``last`` holds the newest harvested snapshot as host data."""

    def __init__(self, engine, *, cadence_steps: int = DEFAULT_CADENCE_STEPS,
                 top_k: int = 8, hist_buckets: int = 16,
                 stall_threshold: int = DEFAULT_STALL_THRESHOLD,
                 max_pending: int = 4) -> None:
        from .engine.lockstep import telemetry_summary_fn
        self.engine = engine
        self.cadence_steps = max(1, int(cadence_steps))
        self.top_k = min(int(top_k), engine.n_lanes)
        self.hist_buckets = int(hist_buckets)
        self.stall_threshold = int(stall_threshold)
        self.max_pending = max(1, int(max_pending))
        self._fn = telemetry_summary_fn(self.top_k, self.hist_buckets,
                                        self.stall_threshold)
        self._pending: collections.deque = collections.deque()
        self._steps_since = 0
        #: the first harvest censuses device memory at once
        self._censused = False
        #: newest harvested snapshot (plain dict), or None
        self.last: Optional[dict] = None
        #: ``samples_started`` summaries dispatched, ``samples_harvested``
        #: landed, ``samples_dropped`` evicted in flight,
        #: ``blocking_waits`` forced waits (only :meth:`drain` makes
        #: them), ``observer_errors`` observers that raised
        self.counters = {"samples_started": 0, "samples_harvested": 0,
                         "samples_dropped": 0, "blocking_waits": 0,
                         "observer_errors": 0}
        self._observers: list = []
        engine._telemetry = self

    # -- dispatch-loop path (called by the engine; never blocks) -----------

    def tick(self, k: int = 1) -> None:
        """Advance the cadence by ``k`` rounds (1 a step, K a superstep)
        and harvest the samples that are ready."""
        self._steps_since += k
        if self._steps_since >= self.cadence_steps:
            # keep the overshoot: a K that does not divide the cadence
            # must not stretch the sampling window
            self._steps_since %= self.cadence_steps
            self._start_sample()
        self._harvest(block=False)

    def _start_sample(self) -> None:
        from .engine.lockstep import telemetry_summary_fn
        shards = self.engine.lane_shard_states()
        out = {}
        for j, (_lo, n, st) in enumerate(shards):
            fn = self._fn if len(shards) == 1 else telemetry_summary_fn(
                min(self.top_k, n), self.hist_buckets, self.stall_threshold)
            got = fn(st.telem, st.total_committed,
                     (st.read_served, st.read_shed, st.read_stale,
                      st.read_leased))
            out.update(got if len(shards) == 1
                       else {(j, k): v for k, v in got.items()})
        h = Readback(out)
        # the transfer ledger counts the copies when they start
        devicewatch.record_d2h("sampler_harvest", h.nbytes,
                               events=len(out))
        self.counters["samples_started"] += 1
        self._pending.append(
            (time.time(), self.engine.pipeline_counters["inner_steps"], h,
             [(lo, n) for lo, n, _st in shards]))
        while len(self._pending) > self.max_pending:
            # never wait on a slow copy: drop the oldest sample instead
            self._pending.popleft()
            self.counters["samples_dropped"] += 1

    def _harvest(self, block: bool) -> None:
        while self._pending:
            ts, steps, h, shards = self._pending[0]
            if not h.is_ready():
                if not block:
                    return
                self.counters["blocking_waits"] += 1
            self._pending.popleft()
            res = h.result()
            if len(shards) > 1:
                from .engine.lockstep import merge_telemetry_summaries
                res = merge_telemetry_summaries(
                    [(lo, n, {k: v for (j, k), v in res.items() if j == i})
                     for i, (lo, n) in enumerate(shards)], self.top_k)
            snap = {k: _host_value(v) for k, v in res.items()}
            snap["ts"] = ts
            snap["inner_steps_at_sample"] = steps
            snap["stall_threshold"] = self.stall_threshold
            self.last = snap
            self.counters["samples_harvested"] += 1
            # the device-memory census rides this tick: host-side
            # allocator counters, no new sync; at once on the first
            # harvest, then throttled
            if devicewatch.sample_watermarks(
                    CENSUS_MIN_INTERVAL_S if self._censused else 0.0):
                self._censused = True
            self._feed_tracer(snap)
            for fn in self._observers:
                # an observer that fails must not stop the dispatch loop
                # the harvest rides: counted and logged, never raised
                try:
                    fn(snap)
                except Exception:  # noqa: BLE001 — observer fault isolation
                    self.counters["observer_errors"] += 1
                    logger.exception("telemetry observer failed")

    # -- out-of-loop API ---------------------------------------------------

    def add_observer(self, fn: Callable[[dict], None]) -> None:
        """Call ``fn(snapshot)`` for every harvested sample, synchronously
        on the harvest path: keep it cheap."""
        self._observers.append(fn)

    def drain(self) -> Optional[dict]:
        """Sample the current state and block until it and every older
        sample in flight have landed; returns the newest snapshot.  A
        run-end operation, never for the dispatch loop."""
        self._steps_since = 0
        self._start_sample()
        self._harvest(block=True)
        return self.last

    def _feed_tracer(self, snap: dict) -> None:
        """Feed the installed tracer a ``lane_health`` counter track, so
        Chrome traces carry lane health beside the spans (no tracer
        installed: no cost)."""
        t = trace.get_tracer()
        if t is None:
            return
        t.counter("lane_health",
                  stalled_lanes=snap.get("stalled_lanes", 0),
                  commit_lag_max=snap.get("commit_lag_max", 0),
                  apply_lag_max=snap.get("apply_lag_max", 0),
                  leader_changes=snap.get("leader_changes", 0))


# ---------------------------------------------------------------------------
# Observatory: the merged host-side surface
# ---------------------------------------------------------------------------

class Observatory:
    """One merged snapshot of everything observable, plus derived
    per-window series.

    Sources are named zero-arg callables returning plain dicts of HOST
    data (no device syncs — the engine source reads the sampler's last
    harvested snapshot and host-side counter dicts only, so periodic
    snapshots are safe next to a running dispatch loop).  Snapshots
    land in a bounded ring; :meth:`window_rates` differentiates
    monotone counters into per-second rates between the last two ring
    entries and :meth:`percentile` reads a distribution over the ring
    — what the SLO engine and the autotuner read."""

    def __init__(self, *, ring_capacity: int = 256) -> None:
        self._sources: dict[str, Callable[[], dict]] = {}
        self._ring: collections.deque = collections.deque(
            maxlen=max(2, ring_capacity))
        self._seq = 0
        # post-mortem bundles embed a fresh Observatory snapshot (the
        # flight recorder fault-isolates a failing source, so a
        # half-closed engine degrades to an ``error`` entry, not a
        # failed dump); newest-constructed Observatory wins the name,
        # and close() unhooks it — the stored bound-method ref is what
        # makes the identity-guarded removal work (a fresh
        # ``self.snapshot`` access is a NEW object every time)
        from .blackbox import RECORDER
        self._bb_src = self.snapshot
        RECORDER.add_source("observatory", self._bb_src)

    # -- wiring ------------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], dict]) -> "Observatory":
        self._sources[name] = fn
        return self

    def close(self) -> None:
        """Unhook this Observatory's flight-recorder bundle source (the
        mirror of EngineDurability.close's source removal).  Call when
        the observed engine/system is being torn down in a long-lived
        process — otherwise the source closure pins the closed engine
        (and its device buffers) for the rest of the process and every
        later bundle embeds an ``error`` entry instead of live state."""
        from .blackbox import RECORDER
        RECORDER.remove_source("observatory", self._bb_src)

    @classmethod
    def for_engine(cls, engine, *, sampler: Optional[TelemetrySampler] = None,
                   system=None, counters=None, router=None,
                   ring_capacity: int = 256) -> "Observatory":
        """The standard wiring: engine telemetry + pipeline + WAL plane,
        the attached ingress plane, the device plane and the flight
        recorder; optionally a system's node-wide counters, a counters
        registry and a router carrying reliable-RPC counters (duck-typed,
        as in the reference: the port has no host planes yet)."""
        obs = cls(ring_capacity=ring_capacity)
        sampler = sampler or getattr(engine, "_telemetry", None)

        def engine_src() -> dict:
            out: dict = {"lanes": engine.n_lanes,
                         "members": engine.n_members}
            # the autotuner-tunable knobs are stamped NEXT TO the rates
            # they move (rule RA07: no silent knob turns — every knob
            # the controller may touch is in this overview, so a ring
            # window always shows knob value + its effect together)
            dur = engine._dur
            out["pipeline"] = {
                "superstep_k": engine._superstep_k_last,
                "cmds_per_step": engine.max_step_cmds,
                "mesh_shape": engine.mesh_shape(),
                "wal_max_batch_interval_ms": (
                    dur.batch_interval_ms() if dur is not None else -1.0),
                "dispatches_in_flight": (engine._driver.in_flight()
                                         if engine._driver is not None
                                         else 0),
                **engine.pipeline_counters,
            }
            phases = getattr(engine, "phases", None)
            if phases is not None:
                out["phases"] = phases.overview()
            s = sampler or getattr(engine, "_telemetry", None)
            if s is not None:
                out["sampler"] = dict(s.counters)
                if s.last is not None:
                    out["telemetry"] = s.last
            if dur is not None:
                out["wal"] = dur.wal_overview()
            return out

        obs.add_source("engine", engine_src)
        ing = getattr(engine, "_ingress", None)
        if ing is not None:
            # the session tier: INGRESS_FIELDS counters +
            # flow gauges as their own source, so ring keys read
            # ``ingress_<field>`` (the SLO/bench_diff namespace)
            obs.add_source("ingress", ing.overview)
            if getattr(ing, "reads_enabled", False):
                # the read lane: READ_FIELDS counters +
                # lease coverage as ring keys ``read_<field>`` (the
                # ra_top read panel's namespace)
                obs.add_source("read", ing.read_overview)
        # the device plane: capture sentinel + transfer ledger + memory
        # watermarks as their own source — ring keys read
        # ``device_<field>`` (DEVICE_FIELDS; the namespace the
        # ``steady_state_recompiles`` SLO objective resolves against).
        # Process-wide on purpose: captures and allocations are process
        # facts, not per-engine ones.
        obs.add_source("device", devicewatch.WATCH.overview)
        cls._wire_host_sources(obs, system, counters, router)
        return obs

    @classmethod
    def for_system(cls, system, *, counters=None, router=None,
                   ring_capacity: int = 256) -> "Observatory":
        """Classic-plane wiring (no lane engine): system counters +
        an optional node Counters registry and reliable-RPC router."""
        obs = cls(ring_capacity=ring_capacity)
        cls._wire_host_sources(obs, system, counters, router)
        return obs

    @staticmethod
    def _wire_host_sources(obs: "Observatory", system, counters,
                           router=None) -> None:
        """The system/counters source wiring shared by both factories —
        one definition keeps the engine-path and classic-path snapshots
        field-for-field comparable."""
        if system is not None:
            obs.add_source("system", lambda: {
                "counters": system.counters(),
                "engine_pipeline": {
                    "superstep_k": system.superstep_k,
                    "dispatch_ahead": system.dispatch_ahead,
                    "wal_max_batch_interval_ms": getattr(
                        system, "wal_max_batch_interval_ms", -1.0),
                },
            })
        if counters is not None:
            obs.add_source("counters", lambda: {
                **counters.overview(), "self": counters.self_metrics()})
        if router is not None and \
                getattr(router, "rpc_counters", None) is not None:
            # the reliable control plane's RPC_FIELDS (retry/dedup/
            # unreachable...) flow through _flatten_numeric into the
            # Prometheus exposition and the time-series ring exactly
            # like the per-shard WAL stats
            obs.add_source("rpc", lambda: dict(router.rpc_counters))
        from .blackbox import RECORDER
        # the flight recorder's health + last incident ride every
        # snapshot so a stalled soak is explainable from the live view
        # (ra_top's incident footer reads this)
        obs.add_source("blackbox", RECORDER.overview)

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Merge every source into one dict, append the numeric
        flattening to the time-series ring, and return the snapshot.
        A failing source contributes an ``error`` entry instead of
        killing the export (observability must not crash the plane it
        observes)."""
        self._seq += 1
        snap: dict = {"seq": self._seq, "ts": time.time()}
        for name, fn in self._sources.items():
            try:
                snap[name] = fn()
            except Exception as exc:  # noqa: BLE001 — degrade, don't die
                snap[name] = {"error": repr(exc)[:200]}
        self._ring.append((snap["ts"], _flatten_numeric(snap)))
        return snap

    def ring(self) -> list:
        """The (ts, flat-numeric-dict) time series, oldest first."""
        return list(self._ring)

    #: flat-key patterns whose values are MONOTONE counters: a negative
    #: window delta on one of these is a counter reset (engine restart,
    #: a fresh bridge adopting the Observatory's source names) and must
    #: yield an OMITTED rate, never a negative one — a burn-rate
    #: evaluator fed a huge negative "rate" across a restart window
    #: would mis-verdict every objective that reads it.  Suffix-
    #: anchored where a looser match would swallow a gauge: plain
    #: substring "dispatches" also matches the dispatches_in_flight
    #: DEPTH gauge, whose negative drift (pipeline draining) is real
    #: signal a consumer must keep seeing.
    _MONOTONE_SUFFIXES = (
        "committed_total", "dispatches", "inner_steps", "_writes",
        "batches", "_syncs", "events", "_count", "total_ms",
        "blocks_staged", "seq", "telemetry_steps", "wal_files",
        "window_syncs", "leader_changes", "bytes_written",
        # ingress plane counters — suffix-anchored so the
        # ingress_queue_rows / ingress_level DEPTH gauges keep their
        # negative drift (the dispatches_in_flight lesson)
        "submitted", "_accepted", "dup_dropped", "slow_signals",
        "_deferred", "_rejected", "shed_rows", "blocks_built",
        "block_rows", "reconnects", "credits_released",
        # device plane — "compiles" also anchors
        # device_recompiles (the steady_state_recompiles SLO rate).
        # device_live_buffers stays an un-hinted gauge; live_bytes is
        # swallowed by the "bytes" infix, which only omits its
        # negative drift from rates — the gauge VALUE in snapshots is
        # untouched (rates of a census gauge are not a signal anyway)
        "compiles", "compile_ms", "_freed", "_samples",
    )
    _MONOTONE_INFIXES = (
        "bytes", "samples_", "encoded_", "readback_", "rpc_",
        "faults_", "elections_",
    )

    @classmethod
    def _is_monotone_key(cls, key: str) -> bool:
        return any(key.endswith(s) for s in cls._MONOTONE_SUFFIXES) \
            or any(h in key for h in cls._MONOTONE_INFIXES)

    def window_rates(self, span: int = 1, end: int = -1,
                     keys=None) -> dict:
        """Per-second deltas of every numeric key between ring entries
        ``span`` windows apart (default: the last two snapshots).
        Monotone counters (committed_total, dispatches, wal writes...)
        read as true rates; gauges read as drift — callers pick their
        keys from the field registry (``metrics.FIELD_REGISTRY``).

        ``span`` > 1 rates over a wider window (``ring[end-span]`` ->
        ``ring[end]``) — the SLO engine's multi-window burn-rate input;
        ``end`` indexes the newer entry (negative from the newest).

        Counter-reset guard: a key the monotone-hint list recognises
        whose delta went NEGATIVE (an engine restart zeroed its
        counters mid-ring) is omitted — absent beats a bogus negative
        rate, same contract as the stale-sample omission below.

        ``engine_telemetry_*`` keys rate over the SAMPLER's own sample
        window (the embedded sample's ``ts``): snapshots taken faster
        than the harvest cadence re-embed the same sample, and the
        snapshot-ts delta would read a running engine as 0 cmds/s.
        With no fresh sample between the two snapshots those keys are
        omitted entirely — absent beats misleadingly zero.

        ``keys`` restricts the computation to an iterable of flat keys
        — the SLO engine's per-objective evaluation sweeps many ring
        windows per verdict, and differentiating every key of every
        window would put O(windows x keys) dict work on the snapshot
        path for the handful it reads."""
        span = max(1, int(span))
        n = len(self._ring)
        if end < 0:
            end = n + end
        lo = end - span
        if lo < 0 or end >= n or n < 2:
            return {}
        (t0, a), (t1, b) = self._ring[lo], self._ring[end]
        dt = max(t1 - t0, 1e-9)
        ts_key = "engine_telemetry_ts"
        tdt = (b[ts_key] - a[ts_key]
               if ts_key in a and ts_key in b else 0.0)
        out: dict = {}
        for k in (b if keys is None else keys):
            if k not in a or k not in b:
                continue
            delta = b[k] - a[k]
            if delta < 0 and self._is_monotone_key(k):
                continue  # counter reset across an engine restart
            if k.startswith("engine_telemetry_"):
                if tdt > 1e-9 and k != ts_key:
                    out[k] = round(delta / tdt, 4)
                continue
            out[k] = round(delta / dt, 4)
        return out

    def series(self, key: str) -> list:
        return [v[key] for _t, v in self._ring if key in v]

    def percentile(self, key: str, q: float) -> Optional[float]:
        """q in [0,1] percentile of ``key`` over the ring window."""
        s = sorted(self.series(key))
        if not s:
            return None
        return s[min(len(s) - 1, int(len(s) * q))]

    # -- exports -----------------------------------------------------------

    def prometheus(self, snap: Optional[dict] = None) -> str:
        """Prometheus text exposition of a snapshot (fresh one by
        default): scalars flatten to ``ra_tpu_<path>``, the commit-lag
        histogram becomes a cumulative ``_bucket{le=...}`` family, and
        the top-K offender arrays become lane-labelled gauges.
        Round-trip pinned by tests/test_torch_observatory.py via
        :func:`parse_prometheus`."""
        snap = snap if snap is not None else self.snapshot()
        lines = ["# ra-tpu Observatory exposition",
                 f"# seq {snap.get('seq', 0)}"]
        flat = _flatten_numeric(snap)
        for key in sorted(flat):
            lines.append(f"ra_tpu_{key} {_fmt_num(flat[key])}")
        tel = snap.get("engine", {}).get("telemetry")
        if tel:
            hist = tel.get("commit_lag_hist")
            if hist:
                # log2 buckets: bucket 0 = lag 0, bucket b = lag <
                # 2^b; cumulative counts per the exposition format
                cum = 0
                for b, count in enumerate(hist):
                    cum += count
                    le = "0" if b == 0 else (
                        "+Inf" if b == len(hist) - 1 else str(2 ** b - 1))
                    lines.append(
                        'ra_tpu_engine_commit_lag_bucket{le="%s"} %d'
                        % (le, cum))
                lines.append(f"ra_tpu_engine_commit_lag_count {cum}")
            lanes = tel.get("top_lanes") or []
            for rank, lane in enumerate(lanes):
                for field in ("top_commit_lag", "top_apply_lag",
                              "top_stall_steps"):
                    vals = tel.get(field) or []
                    if rank < len(vals):
                        lines.append(
                            'ra_tpu_engine_%s{lane="%d",rank="%d"} %s'
                            % (field, lane, rank, _fmt_num(vals[rank])))
        phases = snap.get("engine", {}).get("phases") or {}
        for pname in sorted(phases):
            ph = phases[pname]
            if not isinstance(ph, dict):
                continue
            hist = ph.get("hist")
            if not hist:
                continue
            # log2-ms buckets: bucket 0 = <1ms, bucket b = <2^b ms
            cum = 0
            for b, count in enumerate(hist):
                cum += count
                le = "+Inf" if b == len(hist) - 1 else str(2 ** b)
                lines.append(
                    'ra_tpu_engine_phase_ms_bucket{phase="%s",le="%s"}'
                    ' %d' % (pname, le, cum))
        return "\n".join(lines) + "\n"

    def to_jsonl(self, path: str, *, max_lines: int = 512) -> dict:
        """Append a fresh snapshot to a bounded JSONL ring at ``path``
        (compacted back to ``max_lines`` once it doubles) — what
        ``tools/ra_top.py`` follows."""
        snap = self.snapshot()
        append_jsonl_ring(path, snap, max_lines=max_lines)
        return snap


# ---------------------------------------------------------------------------
# helpers: flattening, exposition formatting, parsing, JSONL ring
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _flatten_numeric(obj: Any, prefix: str = "") -> dict:
    """Nested dicts -> {'a_b_c': float} for scalar numeric leaves.
    Lists of dicts flatten with their index (``wal_shards_0_...`` —
    the per-shard fsync stats must reach the exposition and the ring);
    lists of scalars and strings are skipped (histograms and top-K
    arrays get their own labelled exposition families)."""
    out: dict = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = _NAME_RE.sub("_", str(k))
            out.update(_flatten_numeric(v, f"{prefix}{key}_"))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            if isinstance(v, dict):
                out.update(_flatten_numeric(v, f"{prefix}{i}_"))
    elif isinstance(obj, bool):
        out[prefix[:-1]] = float(obj)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix[:-1]] = float(obj)
    return out


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


#: exposition line: name{labels} value — the value token is validated
#: by float() below, which accepts every form the format allows
#: (negative exponents like 5e-05, +Inf, NaN) without a lookalike
#: character-class regex drifting out of sync with it
_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text exposition into {(name, labels): float}.
    Raises ValueError on any malformed non-comment line — the
    round-trip test runs every Observatory export through this."""
    out: dict = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(f"unparsable exposition line: {raw!r}")
        name, labels, val = m.group(1), m.group(2) or "", m.group(3)
        try:
            out[(name, labels)] = float(val)
        except ValueError:
            raise ValueError(
                f"unparsable exposition value: {raw!r}") from None
    return out


#: per-path line-count cache so the steady-state append is ONE
#: buffered write — re-reading the whole ring per append would put
#: O(file) disk reads on the harvest path that observers (and through
#: them the dispatch loop) ride
_RING_LINES: dict = {}


def append_jsonl_ring(path: str, obj: dict, *, max_lines: int = 512) -> None:
    """Append one JSON line; once the file exceeds ``2*max_lines``
    lines, atomically compact it down to the newest ``max_lines`` (a
    bounded ring that tail-followers can read mid-compaction).  The
    line count is tracked in memory per path: the common call is one
    buffered append (no fsync, no re-read); the file is only read back
    at first touch of an existing ring and at compaction."""
    line = json.dumps(obj, separators=(",", ":"))
    count = _RING_LINES.get(path)
    if count is None:
        try:
            with open(path) as f:
                count = sum(1 for _ in f)
        except OSError:
            count = 0
    with open(path, "a") as f:
        f.write(line + "\n")
    count += 1
    if count > 2 * max_lines:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            _RING_LINES[path] = count
            return
        tmp = path + ".compact"
        with open(tmp, "w") as f:
            f.writelines(lines[-max_lines:])
        os.replace(tmp, path)
        count = min(len(lines), max_lines)
    _RING_LINES[path] = count


def read_jsonl_tail(path: str, n: int = 1) -> list:
    """Newest ``n`` parsable snapshots from a JSONL ring (oldest first
    within the result); tolerant of a torn last line mid-append."""
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return []
    out = []
    for raw in lines[-(n + 1):]:
        try:
            out.append(json.loads(raw))
        except ValueError:
            continue
    return out[-n:]
