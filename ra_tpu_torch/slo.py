"""SLO engine over the Observatory time-series ring: the port's own copy
of ``ra_tpu/slo.py``.

The Observatory ring is what the SLO engine and the autotuner read
(telemetry.py); this module closes the first half of that loop:
declarative objectives — a flat ring key, a comparison, a threshold —
evaluated PER WINDOW over the ring, with multi-window burn-rate
alerting (the Google SRE workbook shape: a breach only pages when both
a fast window and a slow window are burning, so a single noisy window
neither pages nor hides a sustained regression).

Two objective kinds:

* ``value`` — the key's value in each ring entry is compared against
  the threshold (latency percentiles: ``engine_phases_commit_e2e_p99_ms``,
  per-shard ``fsync_p99_ms``...).  Negative values are the repo-wide
  "never measured" sentinel and skip the window rather than counting as
  a pass.
* ``rate`` — the key is differentiated between consecutive ring
  entries via :meth:`Observatory.window_rates` (which owns the
  stale-sample omission and the counter-reset guard), and the RATE is
  compared (minimum throughput: ``engine_telemetry_committed_total``).

Keys may carry one ``*`` wildcard (``engine_wal_shards_*_fsync_p99_ms``)
aggregated by ``agg`` (max for latencies, sum for rates) — a 4-shard
WAL plane is one objective, not four.

Verdicts land in the Observatory snapshot (the engine registers itself
as a ``slo`` source), the Prometheus exposition and time-series ring
(``slo_objectives_<name>_ok`` flattens like any numeric), ra_top's SLO
panel, and a bench row's tail.  The autotuner
(:mod:`ra_tpu_torch.autotune`) reads the same verdict dict.
"""
from __future__ import annotations

from typing import Optional

#: default burn-rate windows: the fast window catches "breaching right
#: now", the slow window proves "and it has been for a while" — both
#: must burn past their fraction for the ``alert`` verdict
DEFAULT_FAST_WINDOWS = 5
DEFAULT_SLOW_WINDOWS = 30
DEFAULT_BURN_FAST = 0.6
DEFAULT_BURN_SLOW = 0.3


class Objective:
    """One declarative objective: ``key op threshold`` per window.

    ``name`` is the registry handle (ra_top column, verdict dict key);
    ``key`` a flat ring key, optionally with one ``*`` wildcard;
    ``op`` is ``"<="`` (latency ceilings) or ``">="`` (rate floors);
    ``kind`` ``"value"`` or ``"rate"``; ``agg`` resolves wildcard
    matches (``max``/``sum``/``min``)."""

    __slots__ = ("name", "key", "op", "threshold", "kind", "agg")

    def __init__(self, name: str, key: str, op: str, threshold: float,
                 *, kind: str = "value", agg: str = "max") -> None:
        if op not in ("<=", ">="):
            raise ValueError(f"objective op must be <= or >=; got {op!r}")
        if kind not in ("value", "rate"):
            raise ValueError(f"objective kind {kind!r}")
        self.name = name
        self.key = key
        self.op = op
        self.threshold = float(threshold)
        self.kind = kind
        self.agg = agg

    def describe(self) -> dict:
        return {"name": self.name, "key": self.key, "op": self.op,
                "threshold": self.threshold, "kind": self.kind,
                "agg": self.agg}


def default_objectives(*, commit_p99_ms: float = 25.0,
                       fsync_p99_ms: float = 50.0,
                       min_cmds_per_s: float = 1000.0,
                       read_p99_ms: float = 10.0) -> tuple:
    """The standard lane-engine objective set: commit latency from the
    always-on phase attribution, fsync latency from the per-shard WAL
    stats, a throughput floor rated from the device telemetry's
    committed counter, and the device-plane capture-stability pin: a
    warm dispatch loop must not re-capture a graph, so the capture
    sentinel's recompile counter's rate over any window must stay 0.
    Absent devicewatch wiring the key never appears and the objective
    reads ``no_data`` (which is ok).

    ``read_p99_ms`` ceilings the read plane's submit→serve latency from
    the ``read_e2e`` phase (stamped only for dispatches that served
    reads); on a write-only engine the key never appears and the
    objective reads ``no_data``.  Its verdict is the read half of the
    ladder bias: ingress sheds reads outright at any tightened level,
    so a read_p99 breach never delays the write plane."""
    return (
        Objective("commit_p99_ms",
                  "engine_phases_commit_e2e_p99_ms", "<=", commit_p99_ms),
        Objective("fsync_p99_ms",
                  "engine_wal_shards_*_fsync_p99_ms", "<=", fsync_p99_ms),
        Objective("cmds_per_s",
                  "engine_telemetry_committed_total", ">=",
                  min_cmds_per_s, kind="rate", agg="sum"),
        Objective("steady_state_recompiles",
                  "device_recompiles", "<=", 0.0, kind="rate"),
        Objective("read_p99_ms",
                  "engine_phases_read_e2e_p99_ms", "<=", read_p99_ms),
    )


def _match_keys(flat: dict, pattern: str) -> list:
    if "*" not in pattern:
        return [pattern] if pattern in flat else []
    pre, _star, suf = pattern.partition("*")
    return [k for k in flat
            if k.startswith(pre) and k.endswith(suf)
            and len(k) >= len(pre) + len(suf)]


def _aggregate(vals: list, agg: str) -> Optional[float]:
    if not vals:
        return None
    if agg == "sum":
        return float(sum(vals))
    if agg == "min":
        return float(min(vals))
    return float(max(vals))


class SloEngine:
    """Evaluate a set of objectives per window over an Observatory's
    ring, with multi-window burn-rate verdicts.

    Construction registers the engine as the Observatory's ``slo``
    source, so every snapshot embeds the verdicts computed over the
    ring as of the PREVIOUS snapshots — the verdict always describes
    completed windows, never the half-built one."""

    def __init__(self, observatory, objectives=None, *,
                 fast_windows: int = DEFAULT_FAST_WINDOWS,
                 slow_windows: int = DEFAULT_SLOW_WINDOWS,
                 burn_fast: float = DEFAULT_BURN_FAST,
                 burn_slow: float = DEFAULT_BURN_SLOW) -> None:
        self.obs = observatory
        self.objectives = tuple(objectives if objectives is not None
                                else default_objectives())
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.fast_windows = max(1, int(fast_windows))
        self.slow_windows = max(self.fast_windows, int(slow_windows))
        self.burn_fast = float(burn_fast)
        self.burn_slow = float(burn_slow)
        #: evaluate() memo for an unchanged ring: the Observatory's
        #: slo source and the autotuner's tick both evaluate at every
        #: window boundary — the second call must not pay the full
        #: multi-window sweep again (the <3% plane-overhead pin)
        self._cache: tuple = (None, None)
        observatory.add_source("slo", self.evaluate)

    # -- per-window evaluation --------------------------------------------

    def _window_value(self, obj: Objective, i: int, ring: list,
                      wanted: list) -> Optional[float]:
        """Objective value at ring window ``i`` (the pair ``i-1 -> i``
        for rates, the entry ``i`` for values), or None when the
        window carries no signal for it (missing key, -1 sentinel,
        stale sample / counter reset omission).  ``wanted`` is the
        objective's matched key list, resolved ONCE per evaluate
        against the newest entry — re-globbing every key of every
        window would put O(windows x keys) string work on the
        snapshot path (a window lacking a matched key simply
        contributes fewer values)."""
        if obj.kind == "rate":
            rates = self.obs.window_rates(end=i, keys=wanted)
            vals = [rates[k] for k in wanted if k in rates]
        else:
            flat = ring[i][1]
            # the repo-wide "never measured" sentinel (-1 fsync p50 on
            # a sync_mode=0 WAL, -1 phase p99 before the first sample)
            # is absence of signal, not a zero-latency pass
            vals = [flat[k] for k in wanted
                    if k in flat and flat[k] >= 0]
        return _aggregate(vals, obj.agg)

    def _breaches(self, obj: Objective, val: float) -> bool:
        return not (val <= obj.threshold if obj.op == "<="
                    else val >= obj.threshold)

    def evaluate(self) -> dict:
        """Verdict per objective over the ring: the newest window's
        value, breach burn fractions over the fast and slow windows,
        and the verdict — ``ok`` / ``breach`` (newest window breaches
        and the fast window burns) / ``alert`` (fast AND slow windows
        both burn: sustained, page-worthy).  Windows with no signal
        are skipped, never counted as passes."""
        ring = self.obs.ring()
        n = len(ring)
        # keyed by the Observatory's snapshot seq: a ring that has not
        # grown yields the memoized verdicts (an id()-based key could
        # alias a recycled dict; seq never repeats)
        cache_key = (n, getattr(self.obs, "_seq", 0))
        if self._cache[0] == cache_key:
            return self._cache[1]
        out: dict = {"objectives": {}, "windows": max(0, n - 1)}
        breaches = 0
        alerts = 0
        for obj in self.objectives:
            wanted = _match_keys(ring[-1][1], obj.key) if n else []
            # a value objective reads single entries (the first snapshot
            # is already a window); a rate objective needs a pair
            lo = max(0 if obj.kind == "value" else 1,
                     n - self.slow_windows)
            fast_hits = fast_seen = slow_hits = slow_seen = 0
            newest_val = None
            newest_breach = newest_live = False
            for i in range(lo, n):
                val = self._window_value(obj, i, ring, wanted)
                if val is None:
                    continue
                bad = self._breaches(obj, val)
                slow_seen += 1
                slow_hits += int(bad)
                if i >= n - self.fast_windows:
                    fast_seen += 1
                    fast_hits += int(bad)
                newest_val, newest_breach = val, bad
                newest_live = i == n - 1
            burn_f = fast_hits / fast_seen if fast_seen else 0.0
            burn_s = slow_hits / slow_seen if slow_seen else 0.0
            if not newest_live:
                # the NEWEST window carries no signal (sentinel,
                # stale sample, counter reset): the verdict must say
                # so rather than re-issue a stale ok/breach — the
                # omission guards' discipline carried into verdicts
                verdict = "no_data"
            elif newest_breach and burn_f >= self.burn_fast \
                    and burn_s >= self.burn_slow:
                verdict = "alert"
            elif newest_breach and burn_f >= self.burn_fast:
                verdict = "breach"
            else:
                verdict = "ok"
            breaches += int(verdict in ("breach", "alert"))
            alerts += int(verdict == "alert")
            out["objectives"][obj.name] = {
                **obj.describe(),
                "value": round(newest_val, 4)
                if newest_val is not None else None,
                "ok": verdict in ("ok", "no_data"),
                "verdict": verdict,
                "burn_fast": round(burn_f, 4),
                "burn_slow": round(burn_s, 4),
                "windows_seen": slow_seen,
            }
        out["breaches"] = breaches
        out["alerts"] = alerts
        out["ok"] = breaches == 0
        self._cache = (cache_key, out)
        return out

    def verdict(self, name: str) -> str:
        """One objective's current verdict string (``ok`` / ``breach``
        / ``alert`` / ``no_data``), or ``no_data`` for an unknown name
        — the accessor the ingress backpressure ladder polls (memoized
        with evaluate(), so a per-wave poll costs one dict lookup)."""
        obj = self.evaluate()["objectives"].get(name)
        return obj["verdict"] if obj else "no_data"
