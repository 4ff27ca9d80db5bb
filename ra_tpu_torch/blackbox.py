"""Black-box flight recorder and the event registry of the port.

The port's own copy of ``ra_tpu/blackbox.py`` (the port imports nothing
of ``ra_tpu``), with the registry cut to the planes the port has: the
classic plane's command lifecycle and reliable RPC, the WAL shards, the
durable engine's bridge, the storage fault plan, the supervisors, the
ingress and wire planes, the placement failover tier, the autotuner and the device plane (whose four
events keep the reference's texts).

* :class:`FlightRecorder` -- an always-on, bounded, per-subsystem ring
  of structured events.  Every plane emits typed events through
  :func:`record`: one dict lookup and one deque append, no lock, no
  device sync.  The ring is read only when something crashes.
* **Post-mortem bundles** -- on a supervisor giving up, a poisoned WAL
  rollover, a WAL thread's death or a shard worker's crash,
  :meth:`FlightRecorder.dump` writes one JSON bundle: the recent event
  rings and every registered state source (per-shard WAL watermarks,
  the active DiskFaultPlan, the durability configuration).  Recovery
  stamps a report beside the newest bundle (:func:`stamp_recovery`),
  so a crash and the recovery that answered it read as one incident.
* :data:`EVENT_REGISTRY` -- every event type the port emits, with its
  meaning; an unregistered type is still recorded but counted in
  ``counters["unregistered_events"]``, which must stay 0.

Host-side events carry a join key: ``(uid, idx)`` for the WAL plane,
``step`` for the engine plane (commands are never tagged on the device,
so the dispatch loop stays free of host syncs).
"""
from __future__ import annotations

import collections
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Optional

logger = logging.getLogger("ra_tpu_torch.blackbox")

#: every event type the port's recorder and tracer may emit, with a
#: one-line meaning.  Span names recorded through ``trace`` are events
#: too: a Chrome trace and a post-mortem bundle speak one vocabulary.
EVENT_REGISTRY = {
    # -- command lifecycle (classic path; `trace` = propagated ctx) ----
    "cmd.ingress": "client created a trace context at the API boundary",
    "cmd.submit": "traced command handed to a member (one per attempt; "
                  "redirects show as extra submits)",
    "cmd.append": "leader appended the command at (uid, idx, term)",
    "cmd.commit": "a server's commit index advanced to idx (uid-keyed)",
    "cmd.apply": "a traced command was applied on a member",
    # -- classic replication batching ----------------------------------
    "rpc.batch": "leader built one multi-entry AppendEntries batch "
                 "(entry count + payload bytes; ONE event per batch, "
                 "never per entry)",
    # -- reliable control-plane RPC (transport/rpc.py) -----------------
    "rpc.send": "reliable-RPC attempt left the sender (rid stable "
                "across retries)",
    "rpc.recv": "receiver started executing a request id",
    "rpc.dup": "receiver dedup hit — duplicate delivery of a seen rid "
               "under the same trace context",
    "rpc.expired": "request arrived past its propagated deadline",
    # -- transport fault plan ------------------------------------------
    "net.fault": "transport FaultPlan injected a fault (kind, peer, "
                 "frame class)",
    "rpc.domain_delay": "latency-domain matrix stretched a frame "
                        "crossing (src -> dst) domains",
    # -- WAL plane (per shard) -----------------------------------------
    "wal.batch": "span: one group-commit batch (write + sync + notify)",
    "wal.write": "one group-commit batch reached the file (per-uid "
                 "index ranges ride along)",
    "wal.fsync": "durability syscall latency (ms)",
    "wal.confirm": "per-writer durable range notify (uid, lo..hi)",
    "wal.resend": "out-of-sequence write gap -> resend_from signal",
    "wal.poison": "batch I/O error poisoned the current WAL file",
    "wal.escalate": "poison streak exhausted -> thread death "
                    "(supervisor restart)",
    "wal.kill": "injected WAL crash (nemesis / kill hook)",
    "wal.restart": "supervised restart of a dead WAL incarnation",
    # -- engine durability bridge (keyed by step = submit_index) -------
    "engine.step": "span: one single-step dispatch",
    "engine.superstep": "span: one fused K-round dispatch",
    "engine.backpressure": "span: dispatch thread waiting on the "
                           "unconfirmed-step window",
    "engine.wal_submit": "span: handing a dispatch's aux to the WAL "
                         "shards",
    "wal.encode": "span: shard encode worker pulled+encoded one "
                  "step's WAL block",
    "engine.submit": "dispatch queued steps [step_lo, step_hi] to "
                     "every WAL shard",
    "engine.confirm": "a shard's durable step horizon advanced",
    "engine.crash": "a shard encode worker died on an exception",
    # -- storage fault plan --------------------------------------------
    "disk.fault": "DiskFaultPlan injected a fault (kind, path class, "
                  "op, path)",
    # -- supervision ---------------------------------------------------
    "sup.restart": "a supervisor restarted a dead component",
    "sup.giveup": "restart intensity exceeded; supervisor backing off",
    "srv.crash": "a server shell crashed out of the node event loop",
    # -- ingress plane (ingress/) --------------------------------------
    "ingress.connect": "session (re)connected: epoch bump under a "
                       "stable (tenant, lane, shard) placement",
    "ingress.level": "backpressure ladder level transition "
                     "(open/tight/fair)",
    "ingress.shed": "coalescer ring overflow began shedding rows "
                    "(transition into a shed episode, not per row)",
    "read.shed": "ladder bias began shedding read waves at admission "
                 "(any tightened level refuses reads before writes are "
                 "delayed; transition, not per row)",
    "read.stale": "the device refused pending reads rather than serve "
                  "past lease/quorum cover (stale-refusal episode "
                  "transition)",
    # -- wire plane (wire/) ---------------------------------------------
    "wire.conn": "connection lifecycle: accept/close/bulk-connect/"
                 "reconnect-storm (loopback fleets emit one event, never "
                 "one per connection)",
    "wire.credit": "the credit-frame ladder level changed between "
                   "sweeps (transition only, never per row)",
    "wire.shed": "a sweep began answering shed verdicts (transition "
                 "into a wire shed episode)",
    "wire.error": "protocol error (bad hello/version/record) closed "
                  "a connection",
    # -- placement failover (placement/; `trace` = migrated-cmd ctx) ---
    "detector.suspect": "failure detector escalated a peer/engine to "
                        "suspect (silent beyond suspect_after; age = "
                        "seconds since last heard)",
    "detector.down": "failure detector confirmed a peer/engine down "
                     "(silent beyond down_after AND suspect for the "
                     "full hysteresis window; age rides along)",
    "placement.refuse": "a lane range's old home refused/was "
                        "unreachable for a session (the client-visible "
                        "start of a failover incident)",
    "placement.migrate": "control plane committed a lane-range "
                         "re-placement through the placement table "
                         "(rid, victim -> survivor, new generation)",
    "placement.adopt": "survivor restored a victim engine's durable "
                       "lane state (checkpoint + WAL-shard merge, "
                       "gated at the fsynced watermark)",
    "placement.giveup": "a bounded placement retry loop exhausted its "
                        "deadline/attempts and gave up (no silent "
                        "infinite retry in the control plane)",
    "placement.adopt_rpc": "a survivor host committed an adoption "
                           "requested over the reliable control-plane "
                           "RPC tier (host_adopt: retried, "
                           "deduplicated, deadline-bounded)",
    "placement.stale_probe": "supervisor discarded a probe reply from "
                             "a superseded engine generation (a stale "
                             "reply must not reset the new incumbent's "
                             "suspect streak)",
    "nemesis.op": "chaos schedule executed one op",
    "placement.rehome": "sessions re-bound to the new home: epoch "
                        "bump, dedup slots claimed, ack watermarks "
                        "re-seeded",
    "placement.rehome_hint": "listener refused a frame routed on a "
                             "stale placement revision with a typed "
                             "REHOME hint (engine, generation, rev)",
    # -- SLO autotuner (autotune.py) -----------------------------------
    "tune.decision": "autotuner changed a knob (knob, old->new, "
                     "triggering phase + objective) — RA07: no silent "
                     "knob turns",
    "tune.freeze": "autotuner entered a freeze (active FaultPlan/"
                   "DiskFaultPlan or a fresh incident): decisions "
                   "suspended",
    # -- device plane (devicewatch.py) ---------------------------------
    "device.recompile": "recompile sentinel caught a steady-state "
                        "retrace of a wrapped jit entry point (fn tag "
                        "+ which argument's shape/dtype/sharding "
                        "drifted + compile wall ms)",
    "profile.captured": "a jax_profile() capture finished; the profile "
                        "dir rides along so the capture shows up in "
                        "ra_trace timelines instead of being a side "
                        "file nobody finds",
    # -- recorder meta -------------------------------------------------
    "bb.dump": "post-mortem bundle written",
    "bb.recover": "recovery stamped a join-able recovery report",
}


def _json_safe(obj: Any) -> Any:
    """Best-effort conversion for bundle serialization — events may
    carry exceptions, ServerIds, numpy scalars; a bundle write must
    never fail on a field repr."""
    return repr(obj)


class FlightRecorder:
    """Bounded per-subsystem structured-event rings + bundle dumps.

    The subsystem is the event type's dotted prefix (``wal.fsync`` ->
    ring ``wal``), so one noisy plane can never evict another plane's
    history — the property that makes the recorder useful at the crash
    site (the engine's kHz dispatch events do not wash out the three
    supervisor events that explain the death)."""

    DEFAULT_RING = 4096

    def __init__(self, ring_capacity: int = DEFAULT_RING) -> None:
        self.ring_capacity = int(ring_capacity)
        self._rings: dict[str, collections.deque] = {}
        #: named zero-arg state callables merged into every bundle
        #: (WAL watermarks, fault-plan state, configuration...)
        self._sources: dict[str, Callable[[], Any]] = {}
        #: newest-first incident log (what/where/when + bundle path)
        self.incidents: collections.deque = collections.deque(maxlen=32)
        #: master switch: False turns record() into one attr read + a
        #: bool test (the A/B knob the overhead pin flips)
        self.enabled = True
        #: where dump() writes when the trigger site has no data_dir;
        #: None -> $RA_TPU_BLACKBOX_DIR -> <tmp>/ra_tpu_blackbox
        self.dump_dir: Optional[str] = None
        self.origin = f"pid{os.getpid()}"
        self.counters = {"events": 0, "unregistered_events": 0,
                         "dumps": 0, "dump_errors": 0, "recoveries": 0}
        self._dump_lock = threading.Lock()
        self._dump_seq = 0

    # -- emit path (rides dispatch loops and WAL threads: stay cheap) --

    def record(self, etype: str, **fields: Any) -> None:
        """Append one structured event to its subsystem ring.  One dict
        lookup + one deque append; never blocks, never raises, never
        touches a device tensor."""
        if not self.enabled:
            return
        sub = etype.partition(".")[0]
        ring = self._rings.get(sub)
        if ring is None:
            ring = self._rings.setdefault(
                sub, collections.deque(maxlen=self.ring_capacity))
        if etype not in EVENT_REGISTRY:
            # a typo'd event type is still recorded (evidence beats
            # purity at a crash site) but counted so tests can pin the
            # mismatch to 0
            self.counters["unregistered_events"] += 1
        ring.append((time.time(), etype, fields))
        self.counters["events"] += 1

    # -- wiring --------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a state source merged into every bundle.  Sources
        are fault-isolated at dump time (a failing one contributes an
        ``error`` entry, the dump still lands)."""
        self._sources[name] = fn

    def remove_source(self, name: str, fn: Optional[Callable] = None) -> None:
        """Drop a source; with ``fn`` given, only when it is still the
        registered one (a closed engine must not unhook its
        successor's source under the shared name)."""
        if fn is None or self._sources.get(name) is fn:
            self._sources.pop(name, None)

    def clear(self, *, sources: bool = False) -> None:
        """Drop every ring and incident (test isolation).  Sources are
        KEPT by default — module-level wiring (fault-plan registries)
        registers once per process and must survive a ring wipe."""
        self._rings.clear()
        self.incidents.clear()
        if sources:
            self._sources.clear()
        for k in self.counters:
            self.counters[k] = 0

    # -- readout -------------------------------------------------------

    def events(self, subsystem: Optional[str] = None) -> list:
        """Recorded events as [(ts, etype, fields)], oldest first —
        one subsystem's ring, or every ring merged and time-sorted."""
        rings = ([self._rings.get(subsystem, ())] if subsystem
                 else list(self._rings.values()))
        out: list = []
        for ring in rings:
            got: list = []
            for _ in range(3):
                # deque iteration can race a concurrent append
                # ("deque mutated during iteration"); retry into a
                # FRESH list so a failed attempt's partial copy never
                # duplicates events — readers are rare, appends must
                # never wait on them
                try:
                    got = list(ring)
                    break
                except RuntimeError:  # pragma: no cover — append race
                    got = []
                    continue
            out.extend(got)
        out.sort(key=lambda e: e[0])
        return out

    def last_incident(self) -> Optional[dict]:
        return self.incidents[-1] if self.incidents else None

    def overview(self) -> dict:
        """Host-side health summary."""
        return {"counters": dict(self.counters),
                "rings": {k: len(v) for k, v in self._rings.items()},
                "last_incident": self.last_incident()}

    # -- post-mortem bundles -------------------------------------------

    def _resolve_dir(self, data_dir: Optional[str]) -> str:
        if data_dir:
            return os.path.join(data_dir, "blackbox")
        if self.dump_dir:
            return self.dump_dir
        env = os.environ.get("RA_TPU_BLACKBOX_DIR")
        if env:
            return env
        return os.path.join(tempfile.gettempdir(), "ra_tpu_blackbox")

    def dump(self, reason: str, *, what: str = "", where: str = "",
             data_dir: Optional[str] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write a post-mortem bundle and log the incident.  Returns
        the bundle path, or None when the write itself failed (an
        ENOSPC'd disk must not add a crash to the crash — counted in
        ``dump_errors``).  Trigger sites pass their ``data_dir`` so
        bundles land next to the data they explain."""
        ts = time.time()
        with self._dump_lock:
            self._dump_seq += 1
            seq = self._dump_seq
        # the whole build+write is guarded: dump() is called from crash
        # handlers, so ANY escape (a ring dict resized by a concurrent
        # first-event record, a non-string dict key json refuses, a
        # full disk) must degrade to a counted dump_error — a failing
        # dump must never add a crash to the crash (doc'd contract)
        try:
            bundle = {
                "format": "ra-tpu-blackbox-1",
                "reason": reason,
                "what": what,
                "where": where,
                "ts": ts,
                "origin": self.origin,
                "pid": os.getpid(),
                "counters": dict(self.counters),
                "incidents": list(self.incidents),
                "events": {sub: self.events(sub)
                           for sub in list(self._rings)},
                "sources": {},
                "extra": extra or {},
            }
            for name, fn in list(self._sources.items()):
                try:
                    bundle["sources"][name] = fn()
                except Exception as exc:  # noqa: BLE001 — degrade
                    bundle["sources"][name] = {"error": repr(exc)[:200]}
            out_dir = self._resolve_dir(data_dir)
            path = os.path.join(
                out_dir, f"bundle-{int(ts)}-{os.getpid()}-{seq:03d}-"
                f"{reason[:40]}.json")
            os.makedirs(out_dir, exist_ok=True)
            tmp = path + ".partial"
            with open(tmp, "w") as f:
                json.dump(bundle, f, default=_json_safe,
                          separators=(",", ":"), skipkeys=True)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — never raise from a dump
            self.counters["dump_errors"] += 1
            logger.exception("flight recorder: bundle dump failed "
                             "(%s)", reason)
            return None
        incident = {"ts": ts, "reason": reason, "what": what,
                    "where": where, "path": path}
        self.incidents.append(incident)
        self.counters["dumps"] += 1
        self.record("bb.dump", reason=reason, what=what, where=where,
                    path=path)
        logger.warning("flight recorder: post-mortem bundle %s (%s)",
                       path, reason)
        return path

    def stamp_recovery(self, info: dict,
                       data_dir: Optional[str] = None) -> Optional[str]:
        """Write a recovery report that joins the newest bundle in the
        same blackbox dir (``joins`` names it, or None for a clean
        boot) — crash and recovery read as one incident."""
        ts = time.time()
        out_dir = self._resolve_dir(data_dir)
        joins = None
        try:
            names = sorted(n for n in os.listdir(out_dir)
                           if n.startswith("bundle-")
                           and n.endswith(".json"))
            joins = names[-1] if names else None
        except OSError:
            pass
        report = {"format": "ra-tpu-recovery-1", "ts": ts,
                  "origin": self.origin, "joins": joins, **info}
        path = os.path.join(out_dir,
                            f"recovery-{int(ts)}-{os.getpid()}.json")
        try:
            os.makedirs(out_dir, exist_ok=True)
            tmp = path + ".partial"
            with open(tmp, "w") as f:
                json.dump(report, f, default=_json_safe, skipkeys=True)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — recovery must not fail on this
            self.counters["dump_errors"] += 1
            logger.exception("flight recorder: recovery stamp failed")
            return None
        self.counters["recoveries"] += 1
        self.record("bb.recover", joins=joins, path=path,
                    plane=info.get("plane", "?"))
        return path


#: the process-wide recorder.  Always on (the black-box contract); the
#: rings are bounded, so "on" costs memory O(subsystems * capacity)
#: and one deque append per event.
RECORDER = FlightRecorder()


def record(etype: str, **fields: Any) -> None:
    """Emit one flight-recorder event (module-level convenience — the
    instrumented call sites all route through here)."""
    RECORDER.record(etype, **fields)


def stamp_recovery(info: dict, data_dir: Optional[str] = None):
    return RECORDER.stamp_recovery(info, data_dir=data_dir)


def load_bundle(path: str) -> dict:
    """Parse a post-mortem bundle (the ra_trace input contract)."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != "ra-tpu-blackbox-1":
        raise ValueError(f"not a ra-tpu blackbox bundle: {path}")
    return doc
