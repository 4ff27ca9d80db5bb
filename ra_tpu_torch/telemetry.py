"""Latency phases and the asynchronous telemetry sampler of the engine.

The port's own copies of ``ra_tpu/telemetry.py``'s ``PhaseStats`` and
``TelemetrySampler``:

* :class:`PhaseStats` -- per phase of ``metrics.PHASE_FIELDS``, a
  bounded latency reservoir (p50/p99/max), a log2-ms histogram, a count
  and a monotone ``total_ms``, fed with host-clock stamps taken at the
  edges of the dispatch path (never a device sync).
* :class:`TelemetrySampler` -- every ``cadence_steps`` engine rounds it
  aggregates the engine's per-lane ``LaneTelemetry`` on the device
  (``engine.lockstep.telemetry_summary_fn``) and starts an asynchronous
  copy of the few-hundred-byte result (a ``readback.Readback``); ready
  copies are harvested on later ticks.  The dispatch loop never blocks
  on it.

The reference sampler also feeds a trace counter track and takes a
device-memory census on its harvest tick; the port has the tracer
(``trace.py``) but neither feed yet: they wait for the rest of
``devicewatch`` (ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from . import devicewatch
from .metrics import PHASE_FIELDS
from .readback import Readback

logger = logging.getLogger("ra_tpu_torch.telemetry")

#: default sampling cadence in engine rounds (inner steps, not dispatches)
DEFAULT_CADENCE_STEPS = 64

#: a lane is STALLED once it has sat this many consecutive rounds with a
#: commit backlog and no commit progress
DEFAULT_STALL_THRESHOLD = 8

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
        st = self.engine.state
        out = self._fn(st.telem, st.total_committed,
                       (st.read_served, st.read_shed, st.read_stale,
                        st.read_leased))
        h = Readback(out)
        # the transfer ledger counts the copies when they start
        devicewatch.record_d2h("sampler_harvest", h.nbytes,
                               events=len(out))
        self.counters["samples_started"] += 1
        self._pending.append(
            (time.time(), self.engine.pipeline_counters["inner_steps"], h))
        while len(self._pending) > self.max_pending:
            # never wait on a slow copy: drop the oldest sample instead
            self._pending.popleft()
            self.counters["samples_dropped"] += 1

    def _harvest(self, block: bool) -> None:
        while self._pending:
            ts, steps, h = self._pending[0]
            if not h.is_ready():
                if not block:
                    return
                self.counters["blocking_waits"] += 1
            self._pending.popleft()
            snap = {k: _host_value(v) for k, v in h.result().items()}
            snap["ts"] = ts
            snap["inner_steps_at_sample"] = steps
            snap["stall_threshold"] = self.stall_threshold
            self.last = snap
            self.counters["samples_harvested"] += 1
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
