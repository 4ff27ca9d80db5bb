"""The engine supervisor: the classic control plane watching lane
engines.  The port's copy of ``ra_tpu/placement/supervisor.py``.

:class:`EngineSupervisor` heartbeats every watched engine and escalates
silence up → suspect → down with a **hysteresis window**: down needs the
engine silent beyond ``down_after`` AND suspect for ``hysteresis``
seconds, so a latency spike (a slow fsync, a delay a FaultPlan injects)
rides the window out while a kill-9 stays silent and escalates.  On a
confirmed death it commits the re-placement through the placement table,
never a local mutation: the table's generation gate makes retried
migrations idempotent, and a supervisor that dies mid-failover leaves a
table a successor finishes from.  Every commit loop is deadline-bounded
and records ``placement.giveup`` when it gives up.  It is tick-driven
(:meth:`tick` from the serving loop), with no thread of its own.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

from ..blackbox import record
from ..metrics import PLACEMENT_FIELDS
from .table import owned_ranges

_INF = float("inf")


class PlacementError(RuntimeError):
    """A bounded placement commit loop gave up (deadline exhausted)."""


class EngineSupervisor:
    """Monitors lane engines; commits re-placements on confirmed death.

    ``table_sid``/``router`` name a member of the placement-table cluster.
    ``probes`` maps engine id → zero-arg callable, truthy while the
    engine lives; a probe returning **None** is asynchronous, its reply
    landing through :meth:`probe_reply` (the cross-host probe of
    ``fabric.py``).  ``fault_plan`` is consulted per heartbeat on the
    ``ping`` frame class: a dropped probe is silence, a delayed one
    arrives late, so delay shows as age."""

    def __init__(self, table_sid, router, *,
                 probes: Optional[dict] = None,
                 suspect_after: float = 1.0, down_after: float = 2.0,
                 hysteresis: float = 0.5, fault_plan=None,
                 on_migrate: Optional[Callable] = None,
                 commit_timeout: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.table_sid = table_sid
        self.router = router
        self.suspect_after = float(suspect_after)
        self.down_after = float(down_after)
        self.hysteresis = float(hysteresis)
        self.fault_plan = fault_plan
        self.on_migrate = on_migrate
        self.commit_timeout = float(commit_timeout)
        self._clock = clock
        self.counters = {f: 0 for f in PLACEMENT_FIELDS}
        self._probe: dict[str, Callable] = {}
        self._gen: dict[str, int] = {}         # watched slot generation
        self._last_heard: dict[str, float] = {}
        self._arrive: dict[str, float] = {}    # in-flight probe reply
        self._verdict: dict[str, str] = {}
        self._suspect_since: dict[str, float] = {}
        self._migrated: set = set()
        for eid, probe in (probes or {}).items():
            self.watch(eid, probe)

    def watch(self, eid: str, probe: Callable[[], Any],
              generation: int = 1) -> None:
        """(Re)register an engine slot.  A higher generation is a
        re-provision: the detector resets, and in-flight replies of the
        old incumbent become stale (:meth:`probe_reply`)."""
        now = self._clock()
        self._probe[eid] = probe
        self._gen[eid] = int(generation)
        self._last_heard[eid] = now
        self._arrive[eid] = _INF
        self._verdict[eid] = "up"
        self._suspect_since.pop(eid, None)

    def generation(self, eid: str) -> int:
        """The watched slot's generation (an async probe captures it)."""
        return self._gen.get(eid, 0)

    def verdict(self, eid: str) -> str:
        return self._verdict.get(eid, "unknown")

    def last_heard_age(self, eid: str,
                       now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        return now - self._last_heard.get(eid, now)

    def probe_reply(self, eid: str, *, heard_at: Optional[float] = None,
                    generation: Optional[int] = None) -> bool:
        """Complete a probe whose reply arrived outside the tick.
        ``heard_at`` is the probe's issue time (a round trip proves the
        engine alive when it left, so RTT reads as age); a reply from a
        superseded ``generation`` is discarded, or it would vouch for the
        slot's new incumbent.  True when the reply counted."""
        if eid not in self._probe:
            return False
        if generation is not None and generation != self._gen.get(eid):
            self.counters["stale_probe_drops"] += 1
            record("placement.stale_probe", peer=eid,
                   reply_generation=generation,
                   generation=self._gen.get(eid, 0))
            return False
        heard = self._clock() if heard_at is None else heard_at
        if heard > self._last_heard.get(eid, -_INF):
            self._last_heard[eid] = heard
            self.counters["heartbeats"] += 1
        return True

    def tick(self, now: Optional[float] = None) -> list:
        """One heartbeat round over every watched engine; returns the
        engine ids newly confirmed down."""
        now = self._clock() if now is None else now
        newly_down: list = []
        for eid, probe in self._probe.items():
            if self._verdict[eid] == "down":
                continue
            # a delayed reply landing now counts at its arrival time
            if self._arrive[eid] <= now:
                self._last_heard[eid] = self._arrive[eid]
                self._arrive[eid] = _INF
                self.counters["heartbeats"] += 1
            try:
                res = probe()
            except Exception:  # noqa: BLE001 — a failing probe is silence
                res = False
            if res:         # None: asynchronous, judged by what was heard
                deliver, delay_s = True, 0.0
                if self.fault_plan is not None:
                    d = self.fault_plan.decide(eid, "ping", "send")
                    deliver, delay_s = d.action != "drop", d.delay_s
                if deliver and delay_s <= 0.0:
                    self._last_heard[eid] = now
                    self.counters["heartbeats"] += 1
                elif deliver:
                    self._arrive[eid] = min(self._arrive[eid],
                                            now + delay_s)
            silent = now - self._last_heard[eid]
            verdict = self._verdict[eid]
            if silent <= self.suspect_after:
                if verdict == "suspect":
                    self._verdict[eid] = "up"
                    self._suspect_since.pop(eid, None)
                    self.counters["recoveries"] += 1
                continue
            if verdict == "up":
                self._verdict[eid] = "suspect"
                self._suspect_since[eid] = now
                self.counters["suspects"] += 1
                record("detector.suspect", peer=eid, age=silent)
                continue
            if silent > self.down_after and \
                    now - self._suspect_since.get(eid, now) >= \
                    self.hysteresis:
                self._verdict[eid] = "down"
                self.counters["downs"] += 1
                record("detector.down", peer=eid, age=silent)
                newly_down.append(eid)
        return newly_down

    def table_state(self) -> dict:
        """A committed read of the placement table."""
        from ..api import consistent_query
        return self._commit(lambda: consistent_query(
            self.table_sid, lambda s: s, router=self.router,
            timeout=self.commit_timeout), what="table_read").reply

    def failover(self, victim: str, survivor: str,
                 trace_ctx: Optional[str] = None) -> list:
        """Commit the victim's death and one migrate per owned range
        through the table; returns the committed ``(rid, home,
        generation)`` placements and calls ``on_migrate(victim, survivor,
        placements, trace_ctx)`` for the host tier's adoption."""
        from ..api import process_command

        def commit(cmd, what):
            return self._commit(lambda: process_command(
                self.table_sid, cmd, self.router,
                timeout=self.commit_timeout, trace_ctx=trace_ctx),
                what=what)
        state = self.table_state()
        eng = state["engines"].get(victim)
        if eng is not None and eng["status"] != "down":
            commit(("engine_down", victim, eng["generation"]),
                   "engine_down")
        placements: list = []
        for rid, ent in owned_ranges(state, victim):
            _tag, _rid, home, gen = commit(
                ("migrate", rid, victim, survivor, ent["generation"] + 1),
                f"migrate/{rid}").reply
            record("placement.migrate", trace=trace_ctx, rid=rid,
                   victim=victim, survivor=home, generation=gen)
            self.counters["migrations"] += 1
            placements.append((rid, home, gen))
        self._migrated.add(victim)
        if self.on_migrate is not None and placements:
            self.on_migrate(victim, survivor, placements, trace_ctx)
        return placements

    def _commit(self, attempt: Callable[[], Any], *, what: str) -> Any:
        """The one retry shape of this package: a deadline-bounded loop
        (a raised error or a returned ``ErrorResult`` retries) that
        records a give-up when the deadline passes."""
        from ..core.types import ErrorResult
        deadline = self._clock() + self.commit_timeout * 3
        attempts = 0
        last: Any = None
        while self._clock() < deadline:
            attempts += 1
            try:
                res = attempt()
            except (TimeoutError, RuntimeError) as exc:
                last = exc
            else:
                if not isinstance(res, ErrorResult):
                    return res
                last = res
            self.counters["migrate_retries"] += 1
        self.counters["giveups"] += 1
        record("placement.giveup", what=what, attempts=attempts)
        raise PlacementError(
            f"placement commit {what} gave up after {attempts} "
            f"attempts: {last!r}")
