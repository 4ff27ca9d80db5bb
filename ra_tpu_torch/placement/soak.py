"""The placement failover soak: the port's copy of
``ra_tpu/placement/soak.py``, both lane-engine hosts (and the adopted
victim's recovery) on ``device`` (None: the card).

:func:`run_failover_soak`: two lane-engine hosts serve loopback wire
traffic under a three-member classic cluster holding the placement table,
an :class:`EngineSupervisor` heartbeating both.  Mid-traffic one host is
kill-9'd; the detector climbs up → suspect → down through its hysteresis
window, the supervisor commits the re-placement through the table, the
survivor adopts the victim's durable directory (``open_engine``'s
recovery), and every victim session re-homes onto the adopted listener
(epochs bumped, old dedup slots claimed, unacked ops replayed).  The run
closes on the exactly-once oracle over the union of both engines' state.
The row carries ``failover_recovery_s`` (kill → first commit on the new
home), ``failover_lost_acked`` and ``failover_double_applied`` (both 0),
the supervisor's ``placement_counters`` and ``wave_marks``: the time and
the acked op count as each wave and the drain start (before ``on_wave``).
The fault interpreter is the module's own :class:`_Nemesis` (the
reference's stand-in, with the same ops).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from ..blackbox import record
from ..trace import new_trace_ctx
from ..utils import host_envelope
from ..wire.dedup import DedupCounterMachine
from .host import LaneEngineHost
from .supervisor import EngineSupervisor
from .table import placement_spec


def run_failover_soak(seed: int, *, conns: int = 16,
                      sessions_per_conn: int = 2, lanes: int = 32,
                      waves: int = 8, wave_ops: int = 1200,
                      kill_wave: int = 3, wal_shards: int = 2,
                      data_dir: Optional[str] = None,
                      disk_faults: bool = False,
                      suspect_after: float = 0.05,
                      down_after: float = 0.12,
                      hysteresis: float = 0.05,
                      fault_plan=None,
                      recovery_bar: Optional[float] = None,
                      device=None,
                      on_wave: Optional[Callable[[int], None]] = None
                      ) -> dict:
    """One failover run; returns the tail row.  See the module docstring
    for the scenario.  ``device`` is the engines' (None: the card);
    ``on_wave(w)``, when given, is called as wave ``w`` starts and with
    ``waves`` as the drain starts, so a caller can trace a window."""
    from ..api import process_command, start_cluster
    from ..core.types import ErrorResult, ServerId
    from ..node import LocalRouter, RaNode
    from ..wire.client import LoopbackFleet
    rng = np.random.default_rng(seed)
    spc = int(sessions_per_conn)
    sessions = conns * spc
    slots = 4 * max(1, sessions // lanes) + 64
    factory = lambda: DedupCounterMachine(slots=slots)  # noqa: E731
    tmp = None
    if data_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="failover-soak-")
        data_dir = tmp.name
    dirs = {"engA": os.path.join(data_dir, "engA"),
            "engB": os.path.join(data_dir, "engB")}
    disk_plan = None
    if disk_faults:
        from ..log import faults
        disk_plan = faults.DiskFaultPlan(
            seed=seed, by_class={"wal": faults.DiskFaultSpec(
                fsync_eio=0.05, short_write=0.02, limit=4)})
    router = LocalRouter()
    nodes = [RaNode(f"pn{i}", router=router) for i in (1, 2, 3)]
    sids = [ServerId(f"pt{i}", f"pn{i}") for i in (1, 2, 3)]
    hosts: dict = {}
    fleets: dict = {}
    try:
        start_cluster("placement", placement_spec(), sids, router=router)
        for eid in ("engA", "engB"):
            hosts[eid] = LaneEngineHost(
                eid, dirs[eid], machine_factory=factory, lanes=lanes,
                wal_shards=wal_shards, max_conns=conns + 8,
                device=device)
            fleets[eid] = LoopbackFleet(
                hosts[eid].listener, conns, sessions_per_conn=spc,
                key=f"fl/{eid}", tenants=4, seed=seed,
                max_ops=waves * wave_ops + wave_ops + 1024)
            assert int(fleets[eid].slots.max()) < slots, \
                "dedup slot overflow"
        sup = EngineSupervisor(
            sids[0], router,
            probes={eid: hosts[eid].alive for eid in hosts},
            suspect_after=suspect_after, down_after=down_after,
            hysteresis=hysteresis, fault_plan=fault_plan)
        sup.on_migrate = _adopt_and_rehome(hosts, fleets, dirs, sup)
        for cmd in (("register_engine", "engA"),
                    ("register_engine", "engB"),
                    ("assign", "engA/lanes", "engA", 0, lanes),
                    ("assign", "engB/lanes", "engB", 0, lanes)):
            res = sup._commit(lambda c=cmd: process_command(
                sids[0], c, router, timeout=10.0), what="setup")
            assert not isinstance(res, ErrorResult)
        nem = _Nemesis()

        def _cycle() -> None:
            # send all, then pump every host (a survivor pumps what it
            # adopted), then harvest credits
            for eid in ("engA", "engB"):
                fleets[eid].send_queued()
            for eid in ("engA", "engB"):
                hosts[eid].cycle()
            for eid in ("engA", "engB"):
                fleets[eid].collect()

        # warm the graphs outside the measured window
        for eid in ("engA", "engB"):
            fleets[eid].new_ops(np.arange(sessions) % sessions,
                                np.zeros(sessions, np.int32))
        _cycle()
        for eid in ("engA", "engB"):
            hosts[eid].settle()
        _cycle()
        if disk_plan is not None:
            nem.run([("disk_faults", disk_plan)])

        victim, survivor = "engA", "engB"
        ctx: Optional[str] = None
        t_kill = recovery_s = -1.0
        killed = migrated = False
        t0 = time.perf_counter()
        marks: list = []

        def _mark(w: int) -> None:      # stamped before the hook runs
            marks.append((time.perf_counter() - t0, int(sum(
                int(f.acked_mask().sum()) for f in fleets.values()))))
            if on_wave is not None:
                on_wave(w)
        for w in range(waves):
            _mark(w)
            for eid in ("engA", "engB"):
                if eid == victim and killed and not migrated:
                    continue  # old home dead, new home not bound yet
                sess = rng.integers(0, sessions, wave_ops)
                fleets[eid].new_ops(sess, rng.integers(1, 8, wave_ops)
                                    .astype(np.int32))
            for _ in range(3):
                _cycle()
            sup.tick()
            if w and w != kill_wave:
                # settle at wave boundaries so ack watermarks stay live;
                # not in the kill wave, whose kill lands mid-window
                for eid in ("engA", "engB"):
                    hosts[eid].settle(timeout=60.0)
                _cycle()
            if w == kill_wave and not killed:
                # mid-traffic kill-9: the unfsynced (never acked) tail goes
                nem.run([("engine_kill", hosts[victim])])
                t_kill = time.perf_counter()
                killed = True
                det_deadline = time.monotonic() + 30.0
                while sup.verdict(victim) != "down":
                    sup.tick()
                    _cycle()
                    time.sleep(0.005)
                    if time.monotonic() > det_deadline:
                        raise TimeoutError("detector never confirmed "
                                           "the kill-9'd engine down")
                ctx = new_trace_ctx("failover")
                record("placement.refuse", trace=ctx, engine=victim,
                       unplaced=int(fleets[victim].unplaced_count()))
                nem.run([("placement_failover", sup, victim, survivor,
                          ctx)])
                migrated = True
                if disk_plan is not None:
                    nem.run([("disk_heal",)])
                # the first ack from the new home closes the recovery window
                wm = int(fleets[victim].watermark.sum())
                rec_deadline = time.monotonic() + 60.0
                while int(fleets[victim].watermark.sum()) <= wm:
                    _cycle()
                    hosts[survivor].settle(timeout=60.0)
                    _cycle()
                    if time.monotonic() > rec_deadline:
                        raise TimeoutError("no commit on the new home")
                recovery_s = time.perf_counter() - t_kill
        assert killed and migrated, "kill wave never ran"
        _mark(waves)
        # drain: at-least-once, every op retries until placed
        deadline = time.monotonic() + 120.0
        while any(fleets[eid].unplaced_count() for eid in fleets):
            _cycle()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"failover drain: "
                    f"{[fleets[e].unplaced_count() for e in fleets]} "
                    "ops unplaced")
        for eid in ("engA", "engB"):
            hosts[eid].settle(timeout=120.0)
        for _ in range(3):
            _cycle()
        elapsed = time.perf_counter() - t0
        # the exactly-once oracle over the union of both engines
        got = {eid: np.asarray(eng.consistent_read(np.arange(lanes))
                               ["value"]).astype(np.int64)
               for eid, eng in ((victim, hosts[survivor].adopted_engine(
                   victim)), (survivor, hosts[survivor].engine))}
        lost = double = 0
        for eid in ("engA", "engB"):
            expected = fleets[eid].expected_lane_sums(lanes)
            lost += int(np.maximum(expected - got[eid], 0).sum())
            double += int(np.maximum(got[eid] - expected, 0).sum())
        row = {
            "value": recovery_s,
            "failover_recovery_s": recovery_s,
            "failover_lost_acked": lost,
            "failover_double_applied": double,
            "seed": seed, "conns": 2 * conns,
            "sessions": 2 * sessions, "lanes": lanes,
            "ops": int(sum(fleets[e].n_ops for e in fleets)),
            "rehomed_sessions": int(sup.counters["rehomed_sessions"]),
            "placement_counters": dict(sup.counters),
            "migrations": int(sup.counters["migrations"]),
            "detector": {k: int(sup.counters[k]) for k in
                         ("heartbeats", "suspects", "downs",
                          "recoveries")},
            "elapsed_s": elapsed, "wal_shards": wal_shards,
            "disk_faults_injected":
                dict(disk_plan.counters) if disk_plan else {},
            "wave_marks": marks, "kill_s": t_kill - t0,
            "host": host_envelope(),
        }
        for eid in ("engA", "engB"):
            expected = fleets[eid].expected_lane_sums(lanes)
            np.testing.assert_array_equal(got[eid], expected)
            fl = fleets[eid]
            ranked = fl.op_rank[:fl.n_ops] >= 0
            acked = fl.acked_mask()
            assert acked[ranked].all(), \
                f"{eid}: {int((~acked[ranked]).sum())} ranked ops " \
                "never acked"
        assert sup.counters["downs"] == 1
        assert sup.counters["migrations"] >= 1
        if recovery_bar is not None:
            assert recovery_s <= recovery_bar, \
                f"recovery {recovery_s:.3f}s > bar {recovery_bar}s"
        return row
    finally:
        for h in hosts.values():
            h.close()
        for n in nodes:
            n.stop()
        if disk_plan is not None:
            from ..log import faults
            faults.clear_plan()
        if tmp is not None:
            tmp.cleanup()


def _adopt_and_rehome(hosts: dict, fleets: dict, dirs: dict, sup):
    """The supervisor's on_migrate hook: the survivor adopts the victim's
    directory, and the victim's fleet re-homes onto the adopted
    listener."""
    def hook(victim: str, survivor: str, placements: list,
             trace_ctx) -> None:
        lst = hosts[survivor].adopt(victim, dirs[victim],
                                    trace_ctx=trace_ctx)
        fleets[victim].rehome(lst, trace_ctx=trace_ctx)
        sup.counters["adopts"] += 1
        sup.counters["rehomed_sessions"] += fleets[victim].n_sessions
    return hook


class _Nemesis:
    """The soak's fault interpreter: each op of a schedule is recorded
    (``nemesis.op``) and run."""

    def run(self, schedule):
        for step in schedule:
            op, args = step[0], step[1:]
            record("nemesis.op", op=op,
                   args=repr(args)[:120] if args else "")
            getattr(self, f"_op_{op}")(*args)

    def _op_engine_kill(self, host):
        host.kill9()

    def _op_placement_failover(self, sup, victim, survivor,
                               trace_ctx=None):
        sup.failover(victim, survivor, trace_ctx=trace_ctx)

    def _op_disk_faults(self, plan):
        from ..log import faults
        faults.install_plan(plan)

    def _op_disk_heal(self):
        from ..log import faults
        faults.clear_plan()


def failover_main(seeds, **kw) -> list:
    """One run per seed, a summary line and the JSON tail each."""
    rows = []
    for seed in seeds:
        res = run_failover_soak(int(seed), **kw)
        print(f"failover seed={seed}: "
              f"recovery={res['failover_recovery_s'] * 1e3:.1f}ms "
              f"lost_acked={res['failover_lost_acked']} "
              f"migrations={res['migrations']}")
        print(json.dumps(res))
        rows.append(res)
    return rows
