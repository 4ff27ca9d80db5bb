"""The port's placement tier (``ra_tpu_torch/placement/``) against the
reference's, the port's engines on the CPU: a twin of each test of
``tests/test_placement.py`` (the table, the supervisor's detector and
commit loop, the re-home claims and REHOME hints, the fault plan's
latency domains, ``HostAgent``, the failover soak and its trace), each
feeding both packages the same inputs and comparing what comes out; the
fault plan's per-frame decisions frame for frame; and a reference table
directory with snapshots recovered by the port.  The soak's ``cuda``
test is in ``tests/test_torch_placement_card.py`` (no JAX there).
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest

import ra_tpu
import ra_tpu.autotune as ref_autotune
import ra_tpu.blackbox as ref_blackbox
import ra_tpu.core.machine as ref_machine
import ra_tpu.core.types as ref_types
import ra_tpu.placement as ref_pl
import ra_tpu.placement.fabric as ref_fabric
import ra_tpu.transport.rpc as ref_rpc
import ra_tpu_torch.autotune as port_autotune
import ra_tpu_torch.blackbox as port_blackbox
import ra_tpu_torch.core.machine as port_machine
import ra_tpu_torch.core.types as port_types
import ra_tpu_torch.placement as port_pl
import ra_tpu_torch.placement.fabric as port_fabric
import ra_tpu_torch.transport.rpc as port_rpc
from ra_tpu.engine import LockstepEngine as RefEngine
from ra_tpu.ingress import IngressPlane as RefPlane
from ra_tpu.system import RaSystem as RefSystem
from ra_tpu.wire import DedupCounterMachine as RefDedup
from ra_tpu.wire import LoopbackFleet as RefFleet
from ra_tpu.wire import WireClient as RefClient
from ra_tpu.wire import WireListener as RefListener
from ra_tpu_torch.engine import LockstepEngine
from ra_tpu_torch.ingress import IngressPlane
from ra_tpu_torch.wire import (DedupCounterMachine, LoopbackFleet,
                               WireClient, WireListener)

from nemesis import await_leader
from test_torch_classic_core import Twin, norm
from test_torch_classic_log import PORT as LOG_PORT, REF as LOG_REF, \
    recover_cores
from test_torch_slo_autotune import _scoped_port_plans  # noqa: F401

# the soak's kill-9 dies loudly in the victim's WAL threads by design
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

PKGS = {
    "ref": dict(pl=ref_pl, rpc=ref_rpc, types=ref_types,
                meta=ref_machine.ApplyMeta(index=1, term=1),
                autotune=ref_autotune, fabric=ref_fabric,
                engine=lambda m, n, **kw: RefEngine(m, n, 3, donate=False,
                                                    **kw),
                dedup=RefDedup, plane=RefPlane, listener=RefListener,
                fleet=RefFleet, client=RefClient),
    "port": dict(pl=port_pl, rpc=port_rpc, types=port_types,
                 meta=port_machine.ApplyMeta(index=1, term=1),
                 autotune=port_autotune, fabric=port_fabric,
                 engine=lambda m, n, **kw: LockstepEngine(m, n, 3,
                                                          device="cpu", **kw),
                 dedup=DedupCounterMachine, plane=IngressPlane,
                 listener=WireListener, fleet=LoopbackFleet,
                 client=WireClient),
}


def both(fn):
    """``fn(pkg)`` in each package; the port's result must equal the
    reference's, which is returned."""
    want = fn(PKGS["ref"])
    assert fn(PKGS["port"]) == want
    return want


# -- the table machine ----------------------------------------------------

def table(pkg, *commands):
    """Apply a command script to a fresh table: (replies, state)."""
    m = pkg["pl"].PlacementTableMachine()
    state, replies = m.init({}), []
    for cmd in commands:
        state, reply = m.apply(pkg["meta"], cmd, state)
        replies.append(reply)
    return replies, state


SETUP = (("register_engine", "engA"), ("register_engine", "engB"),
         ("assign", "r0", "engA", 0, 8))


MIG = ("migrate", "r0", "engA", "engB", 2)
#: the reference's table tests: (script, its last replies, r0's home)
TABLE_CASES = {
    "register_assign_migrate": (SETUP + (MIG,), [("placed", "r0", "engB", 2)],
                                "engB"),
    "migrate_redelivery_is_idempotent": (
        SETUP + (MIG, MIG), [("placed", "r0", "engB", 2)] * 2, "engB"),
    "migrate_stale_generation_absorbed": (
        SETUP + (MIG, ("migrate", "r0", "engA", "engC", 2)),
        [("placed", "r0", "engB", 2)], "engB"),
    "engine_down_generation_gated": (
        (("register_engine", "engA"), ("engine_down", "engA", 99),
         ("engine_down", "engA", 1), ("engine_down", "ghost", 1)),
        [("engine", "engA", "up", 1), ("engine", "engA", "down", 1),
         ("refused", "ghost", None, 0)], None),
    "assign_refuses_cross_engine_reassign": (
        SETUP + (("assign", "r0", "engB", 0, 8), ("assign", "r0", "engA", 0, 8)),
        [("refused", "r0", "engA", 1), ("placed", "r0", "engA", 1)], "engA"),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_table_scripts(case):
    """Each reference table test's script: every reply, the state and the
    owned ranges equal; a redelivered migrate leaves ``rev`` alone."""
    script, tail, home = TABLE_CASES[case]

    def run(p):
        replies, st = table(p, *script)
        return replies, st, [[r for r, _ in p["pl"].owned_ranges(st, e)]
                             for e in ("engA", "engB")]
    replies, st, owned = both(run)
    assert replies[-len(tail):] == tail
    assert owned == [["r0"] if e == home else [] for e in ("engA", "engB")]
    if "redelivery" in case:
        assert st["rev"] == 4
    if "engine_down" in case:
        assert st["engines"]["engA"]["status"] == "down"


def test_placement_cache_is_revision_monotone():
    def run(pkg):
        _r, st = table(pkg, ("register_engine", "engA"),
                       ("assign", "r0", "engA", 0, 8))
        cache = pkg["pl"].PlacementCache()
        out = [cache.refresh(st), cache.lookup("r0"), cache.lane_owner(3),
               cache.lane_owner(9),
               cache.refresh({"rev": st["rev"] - 1, "ranges": {}}),
               cache.lookup("r0"), cache.stale_against({"rev": 9}),
               cache.ranges()]
        cache.invalidate()
        return out + [cache.lookup("r0"), cache.rev]
    got = both(run)
    assert got[:7] == [True, ("engA", 1), "engA", None, False, ("engA", 1),
                       True] and got[-2:] == [None, -1]


# -- never half-moved under leader kill-9 ---------------------------------

def test_leader_kill9_mid_migration_never_half_moved(monkeypatch):
    """The reference's scenario on the ``SimCluster`` twin: every
    server's term, commit, applied index, machine state, log and effects
    equal the reference's after every delivered message."""
    tw = Twin(monkeypatch, 3, ref_pl.PlacementTableMachine,
              port_pl.PlacementTableMachine)

    def command(i, cmd):
        tw.handle(i, lambda c, t: t.CommandEvent(t.UserCommand(cmd)))

    def placed():
        return both(lambda p: [tuple(srv.machine_state["ranges"]["r0"][k]
                                     for k in ("engine", "generation"))
                               for srv in (tw.ref if p["pl"] is ref_pl
                                           else tw.port).servers.values()])
    tw.handle(0, lambda c, t: t.ElectionTimeout())
    for cmd in SETUP:
        command(0, cmd)
    tw.both(lambda c, t: c.isolate(c.ids[0]))
    command(0, ("migrate", "r0", "engA", "engB", 2))
    tw.handle(1, lambda c, t: t.ElectionTimeout())
    tw.both(lambda c, t: c.heal())
    tw.run()
    assert placed() == [("engA", 1)] * 3
    command(1, ("migrate", "r0", "engA", "engB", 2))
    assert placed() == [("engB", 2)] * 3
    rev = tw.port.servers[tw.port.ids[1]].machine_state["rev"]
    command(1, ("migrate", "r0", "engA", "engB", 2))
    assert placed() == [("engB", 2)] * 3
    assert tw.port.servers[tw.port.ids[1]].machine_state["rev"] == rev


# -- the detector: delay is not death -------------------------------------

def sup(pkg, probe, *, fault_plan=None, suspect_after=0.15, down_after=1.0,
        hysteresis=0.5, **kw):
    """A supervisor on a fake clock: (sup, clock cell)."""
    t = [0.0]
    s = pkg["pl"].EngineSupervisor(
        None, None, probes={"eng": probe} if probe else None,
        suspect_after=suspect_after, down_after=down_after,
        hysteresis=hysteresis, fault_plan=fault_plan, clock=lambda: t[0],
        **kw)
    return s, t


def ticks(s, t, n, dt=0.05):
    """n ticks: the newly-down lists and verdicts."""
    out = []
    for _ in range(n):
        t[0] += dt
        out.append((s.tick(), s.verdict("eng")))
    return out


def test_pure_delay_never_migrates():
    def run(pkg):
        plan = pkg["rpc"].FaultPlan(7, by_class={"ping": pkg["rpc"].FaultSpec(
            delay=1.0, delay_ms=(200.0, 900.0))})
        s, t = sup(pkg, lambda: True, fault_plan=plan)
        seq = ticks(s, t, 400)
        plan.unregister()
        return seq, s.counters, plan.counters
    seq, counters, injected = both(run)
    assert all(d == [] and v != "down" for d, v in seq)
    assert counters["downs"] == 0 and counters["suspects"] > 0 and \
        counters["recoveries"] > 0 and injected["delay"] == 400


def test_hysteresis_absorbs_spike_then_kill_downs():
    def run(pkg):
        alive = [True]
        s, t = sup(pkg, lambda: alive[0], suspect_after=0.1,
                   down_after=0.3, hysteresis=0.5)
        alive[0] = False
        seq = ticks(s, t, 11)
        alive[0] = True
        seq += ticks(s, t, 1)
        alive[0] = False
        seq += ticks(s, t, 29)
        return seq, s.counters
    seq, counters = both(run)
    assert all(d == [] for d, _v in seq[:11]) and seq[11][1] == "up"
    assert [d for d, _v in seq if d] == [["eng"]]
    assert counters["recoveries"] == 1 and counters["downs"] == 1


def test_drop_plan_downs():
    def run(pkg):
        plan = pkg["rpc"].FaultPlan(3, by_class={
            "ping": pkg["rpc"].FaultSpec(drop=1.0)})
        s, t = sup(pkg, lambda: True, fault_plan=plan)
        seq = ticks(s, t, 100)
        plan.unregister()
        return seq, s.counters
    seq, counters = both(run)
    assert [d for d, _v in seq if d] == [["eng"]] and counters["downs"] == 1


# -- the bounded commit loop ----------------------------------------------

def test_commit_loop_gives_up_on_deadline():
    def run(pkg):
        s, t = sup(pkg, None, commit_timeout=0.1)

        def attempt():
            t[0] += 0.05
            raise RuntimeError("leader gone")
        with pytest.raises(pkg["pl"].PlacementError) as exc:
            s._commit(attempt, what="migrate/r0")
        return str(exc.value), s.counters
    msg, counters = both(run)
    assert "gave up after 7 attempts" in msg
    assert counters["giveups"] == 1 and counters["migrate_retries"] == 7


def test_commit_loop_retries_returned_error_results():
    def run(pkg):
        s, t = sup(pkg, None, commit_timeout=0.1)
        er = pkg["types"].ErrorResult
        results = [er("not_leader"), er("timeout"), "ok"]

        def attempt():
            t[0] += 0.01
            return results.pop(0)
        return s._commit(attempt, what="migrate/r0"), s.counters
    res, counters = both(run)
    assert res == "ok" and counters["migrate_retries"] == 2 and \
        counters["giveups"] == 0


# -- the re-home claim path -----------------------------------------------

def stack(pkg, lanes, slots=64, port=None):
    eng = pkg["engine"](pkg["dedup"](slots=slots), lanes, ring_capacity=128,
                        max_step_cmds=8)
    plane = pkg["plane"](eng, superstep_k=2, window_s=0.0)
    return eng, pkg["listener"](plane, port=port)


def outcome(fn):
    """("ok", result) or (exception type name, message)."""
    try:
        return ("ok", fn())
    except (RuntimeError, ValueError) as exc:
        return (type(exc).__name__, str(exc))


def test_rehome_claims_are_validated():
    def run(pkg):
        eng, lst = stack(pkg, lanes=1)
        try:
            fleet = pkg["fleet"](lst, 2, key="k")
            zeros = np.zeros(2, np.int64)
            out = [outcome(lambda k=k, s=s: lst.loopback_rehome(
                2, key=k, slots=s, committed=zeros)) for k, s in (
                ("k", fleet.slots), ("short", np.array([7], np.int32)),
                ("dup", np.array([5, 5], np.int32)),
                ("clash", fleet.slots))]
            before = lst.plane.directory.epoch[fleet.handles].copy()
            conns = lst.loopback_rehome(2, key="fresh",
                                        slots=np.array([10, 11], np.int32),
                                        committed=zeros)
            return out + [len(conns), np.asarray(
                lst.plane.directory.epoch[fleet.handles] == before).all(),
                lst.session_slots(lst.hbase[conns]).tolist()]
        finally:
            lst.close()
            eng.close()
    got = both(run)
    for (kind, msg), want in zip(got[:4], ("known key", "one claimed slot",
                                           "duplicate", "already bound")):
        assert kind in ("RuntimeError", "ValueError") and want in msg
    assert got[4:6] == [2, True]


def test_rehome_refuses_diverged_lane_placement():
    def run(pkg):
        (ea, la), (eb, lb) = stack(pkg, lanes=2), stack(pkg, lanes=4)
        try:
            return outcome(lambda: pkg["fleet"](la, 1, key="div").rehome(lb))
        finally:
            for x in (la, ea, lb, eb):
                x.close()
    assert both(run) == ("RuntimeError",
                         "rehome: lane placement diverged between homes")


# -- end to end: the failover soak + the trace timeline -------------------

RECOVERY_BAR_S = 60.0
ROW_KEYS = ("failover_lost_acked", "failover_double_applied", "migrations",
            "rehomed_sessions", "detector", "seed", "conns", "sessions",
            "lanes", "wal_shards", "disk_faults_injected")


@pytest.fixture(scope="module")
def failover_runs(tmp_path_factory):
    """The reference test's soak in each package: (row, events)."""
    out = {}
    for name, rec, kw in (("ref", ref_blackbox.RECORDER, {}),
                          ("port", port_blackbox.RECORDER,
                           {"device": "cpu"})):
        row = PKGS[name]["pl"].run_failover_soak(
            0, conns=4, sessions_per_conn=2, lanes=8, waves=4,
            wave_ops=200, kill_wave=2,
            data_dir=str(tmp_path_factory.mktemp(f"failover_{name}")),
            recovery_bar=RECOVERY_BAR_S, **kw)
        out[name] = (row, rec.events())
    return out


def test_failover_soak_exactly_once(failover_runs):
    ref, port = (failover_runs[k][0] for k in ("ref", "port"))
    detector = ("downs", "suspects")
    assert {k: port[k] for k in ROW_KEYS if k != "detector"} == \
        {k: ref[k] for k in ROW_KEYS if k != "detector"}
    assert {k: port["detector"][k] for k in detector} == \
        {k: ref["detector"][k] for k in detector}
    assert port["failover_lost_acked"] == port["failover_double_applied"] == 0
    assert 0 < port["failover_recovery_s"] <= RECOVERY_BAR_S
    assert port["migrations"] >= 1 and port["detector"]["downs"] == 1
    assert port["rehomed_sessions"] == 8


def test_failover_trace_timeline(failover_runs):
    """One failover trace joins the cross-tier hops in causal order in
    each package, and ``ra_trace --explain`` renders it alike."""
    import tools.ra_trace as rt
    hops = ("placement.refuse", "cmd.submit", "cmd.commit",
            "placement.migrate", "placement.adopt", "placement.rehome")

    def timeline(events):
        tid = [e for e in events if e[1] == "placement.refuse"
               and e[2].get("trace")][-1][2]["trace"]
        tl = rt.index_traces([(ts, et, f, "soak")
                              for ts, et, f in events])[tid]
        first = {}
        for ts, etype, _f, _o in tl["hops"]:
            first.setdefault(etype, ts)
        text = rt.explain(tid, tl)
        assert all(h in first for h in hops), sorted(first)
        order = sorted(("placement.refuse", "cmd.submit", "cmd.commit",
                        "placement.adopt", "placement.rehome"),
                       key=lambda h: first[h])
        return order, [n in text for n in hops]
    want = timeline(failover_runs["ref"][1])
    assert timeline(failover_runs["port"][1]) == want
    assert want == (["placement.refuse", "cmd.submit", "cmd.commit",
                     "placement.adopt", "placement.rehome"], [True] * 6)


# -- stale probe generations ----------------------------------------------

def test_stale_probe_generation_discarded():
    def run(pkg):
        s, t = sup(pkg, lambda: None)
        s.tick()
        t[0] += 0.05
        out = [s.probe_reply("eng", heard_at=t[0], generation=1)]
        s.watch("eng", lambda: None, generation=2)
        t[0] += 0.2
        s.tick()
        out += [s.verdict("eng"),
                s.probe_reply("eng", heard_at=t[0], generation=1)]
        s.tick()
        out += [s.verdict("eng"),
                s.probe_reply("eng", heard_at=t[0], generation=2)]
        s.tick()
        return out + [s.verdict("eng"), s.probe_reply("ghost", generation=1),
                      s.counters]
    got = both(run)
    assert got[:-1] == [True, "suspect", False, "suspect", True, "up", False]
    assert got[-1]["stale_probe_drops"] == 1 and \
        got[-1]["heartbeats"] == 2 and got[-1]["recoveries"] == 1


# -- latency domains ------------------------------------------------------

GEO_MEMBERS = {"ctl": ["ctl"], "far": ["gf1", "gf2"], "eng": ["nA", "nB"]}
GEO_MATRIX = {("ctl", "far"): {"delay_ms": (80.0, 150.0)}}


def geo(pkg, seed=0, local="ctl", matrix=GEO_MATRIX, **kw):
    return pkg["rpc"].FaultPlan(seed, domains={
        "local": local, "members": GEO_MEMBERS, "matrix": matrix}, **kw)


def test_domain_matrix_quiet_is_vantage_local():
    def run(pkg):
        plans = [geo(pkg), geo(pkg, local="eng"),
                 geo(pkg, matrix={("ctl", "far"): {"delay_ms": 0.0}})]
        try:
            return [p.quiet() for p in plans]
        finally:
            for p in plans:
                p.unregister()
    assert both(run) == [False, True, True]


def test_freeze_guard_is_domain_aware():
    def run(pkg):
        guard = pkg["autotune"].default_freeze_guard
        base = guard()
        eng = geo(pkg, local="eng")
        try:
            out = [guard() == base]
            ctl = geo(pkg)
            try:
                out.append(guard())
            finally:
                ctl.unregister()
            return out + [guard() == base]
        finally:
            eng.unregister()
    assert both(run) == [True, "transport_fault_plan_active", True]


def decisions(plan, frames):
    return [tuple(vars(plan.decide(*f)).values()) for f in frames]


def test_domain_matrix_resolution_and_precedence():
    def run(pkg):
        plan = geo(pkg, 7, matrix={("ctl", "far"): {"delay_ms": (5.0, 5.0)}},
                   by_peer={"gf2": pkg["rpc"].FaultSpec()})
        try:
            return decisions(plan, [
                ("gf1", "append", "send"), ("gf1", "append", "recv"),
                ("stranger", "append", "send"), ("gf2", "append", "send")]) \
                + [plan.counters]
        finally:
            plan.unregister()
    got = both(run)
    assert got[0][:2] == ("deliver", pytest.approx(0.005))
    assert got[1][1] > 0.0 and got[2][1] == got[3][1] == 0.0


def test_domain_delay_streams_replay_deterministically():
    def run(pkg):
        plan = geo(pkg, 11)
        try:
            return [plan.decide("gf1", "append", "send").delay_s
                    for _ in range(8)]
        finally:
            plan.unregister()
    seq = both(run)
    assert len(set(seq)) > 1 and all(0.080 <= s <= 0.150 for s in seq)


def test_decide_streams_match_reference_frame_for_frame():
    """Mixed specs (per class, per peer with a limit, per (peer, class),
    the domain matrix and a default), a partition, and drop-only call
    sites: one seed and one seeded frame sequence give the reference's
    decisions, counters, partition answers and recv keys."""
    rng = np.random.default_rng(5)
    peers = ["ctl", "gf1", "gf2", "nA", "nB", "stranger"]
    classes = ["msg", "ping", "rpc_req", "reply", "append"]
    frames = [(peers[a], classes[b], ("send", "recv")[c])
              for a, b, c in rng.integers(0, [6, 5, 2], (600, 3))]
    honors = rng.integers(0, 2, 600)

    def run(pkg):
        spec = pkg["rpc"].FaultSpec
        plan = geo(pkg, 9, default=spec(drop=0.05, reorder=0.05),
                   by_class={"ping": spec(drop=0.2, delay=0.3,
                                          delay_ms=(1.0, 9.0),
                                          duplicate=0.1, reorder=0.1)},
                   by_peer={"nB": spec(drop=1.0, limit=3)},
                   by_peer_class={("gf2", "msg"): spec(duplicate=0.5)})
        try:
            plan.partition("nA")
            out = [tuple(vars(plan.decide(
                *f, honor=frozenset({"drop"}) if h else plan.ALL_FAULTS))
                .values()) for f, h in zip(frames, honors)]
            plan.heal("nA")
            out += decisions(plan, frames[:50])
            return out + [plan.counters, plan.is_partitioned("nA"),
                          plan.recv_peer(["x", "nB"]),
                          plan.recv_peer(["y"]), plan.recv_peer([]),
                          plan._spec_for("gf2", "msg") ==
                          spec(duplicate=0.5), plan.overview()]
        finally:
            plan.unregister()
    got = both(run)
    kinds = {d[0] for d in got[:650]}
    assert kinds == {"deliver", "drop"} and got[650]["delay"] > 0 and \
        got[650]["duplicate"] > 0 and got[650]["partition"] > 0


# -- the serving-path placement staleness gate ----------------------------

def test_stale_placement_rows_get_rehome_hint_not_submit():
    def run(pkg):
        eng, lst = stack(pkg, lanes=4)
        try:
            cache = pkg["pl"].PlacementCache()
            lst.bind_placement(cache, {"engA"}, rids={"r0"})
            fleet = pkg["fleet"](lst, 2, key="stale")
            sess, out = np.arange(2), []

            def wave(fl):
                fl.new_ops(sess, np.full(2, 3, np.int32))
                fl.send_queued()
                out.append(lst.sweep())
                fl.collect()
                out.append(fl.op_state[:fl.n_ops].tolist())
            wave(fleet)
            cache.refresh({"rev": 5, "ranges": {"r0": {
                "engine": "engB", "generation": 3, "lo": 0, "hi": 4}}})
            swept0 = lst.counters["swept_rows"]
            wave(fleet)
            out += [lst.counters["swept_rows"] - swept0,
                    int(fleet.tenant_shed.sum()), lst.rehome_hints,
                    fleet.rehome_hints, fleet.rehome_hint[1:]]
            cache.refresh({"rev": 6, "ranges": {
                "r0": {"engine": "engA", "generation": 4, "lo": 0, "hi": 4},
                "rX": {"engine": "engB", "generation": 9, "lo": 0,
                       "hi": 4}}})
            wave(pkg["fleet"](lst, 2, key="healed"))
            return out
        finally:
            lst.close()
            eng.close()
    got = both(run)
    assert got[:4] == [2, [2, 2], 0, [2, 2, 1, 1]]
    assert got[4:9] == [0, 0, 2, 2, ("engB", 3, 5)]
    assert got[9:] == [2, [2, 2]]


def pump_tcp(lsts, cli, done, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not done():
        cli.flush()
        for lst in lsts:
            lst.sweep()
            lst.plane.pump(force=True)
            lst.plane.settle()
        cli.poll()
        assert time.monotonic() < deadline


def lane_sum(eng):
    return int(np.asarray(eng.consistent_read(np.arange(4))["value"]).sum())


def test_wire_client_follows_rehome_hint_once_per_epoch():
    """Over real sockets in each package: a stale home refuses with a
    REHOME frame, the client follows it once to the pre-claimed new home,
    and the acked op stays where it landed."""
    def run(pkg):
        (ea, la), (eb, lb) = stack(pkg, 4, port=0), stack(pkg, 4, port=0)
        cli = None
        try:
            cache = pkg["pl"].PlacementCache()
            la.bind_placement(cache, {"engA"}, rids={"r0"})
            cli = pkg["client"](la.address, key="geo/c1", n_sessions=1,
                                timeout=10.0)
            cli.enqueue(5)
            cli.flush()
            pump_tcp([la], cli, lambda: cli.acked_count() >= 1)
            lb.claim_sessions("geo/c1", 1,
                              slots=np.asarray(cli.slots, np.int64),
                              committed=cli.watermark.copy())
            cli.rehome_resolver = {"engB": lb.address}.get
            cache.refresh({"rev": 2, "ranges": {"r0": {
                "engine": "engB", "generation": 2, "lo": 0, "hi": 4}}})
            cli.enqueue(7)
            cli.flush()
            pump_tcp([la, lb], cli, lambda: cli.acked_count() >= 2)
            out = [cli.rehome_follows, cli.rehome_hint,
                   cli.address == tuple(lb.address), la.rehome_hints >= 1,
                   (lane_sum(ea), lane_sum(eb))]
            follows, real = [], cli.rehome_to
            cli.rehome_to = lambda addr, durable=None: \
                follows.append(tuple(addr) == tuple(lb.address))
            hint = {"engine": "engB", "generation": 2, "rev": 2}
            cli._maybe_follow_rehome(hint)
            cli._maybe_follow_rehome(hint)
            cli.rehome_to = real
            cli.rehome_resolver = None
            cli._maybe_follow_rehome({"engine": "engC", "generation": 9,
                                      "rev": 9})
            return out + [follows, cli.rehome_follows]
        finally:
            if cli is not None:
                cli.close()
            for x in (la, lb, ea, eb):
                x.close()
    assert both(run) == [1, ("engB", 2, 2), True, True, (5, 7), [True], 2]


# -- the host agent's serving-loop bridge ---------------------------------

class FakeNode:
    def __init__(self):
        self.control_ops = {}


class FakeHost:
    engine_id = "engX"
    lanes = 4
    listener = None

    @staticmethod
    def alive():
        return True


def test_host_agent_bridges_mutating_verbs_onto_serving_loop():
    def run(pkg):
        node = FakeNode()
        agent = pkg["fabric"].HostAgent(FakeHost(), node)
        out = [sorted(node.control_ops), node.control_ops["host_status"]({}),
               agent.pump()]

        def push(rev):
            got = {}
            th = threading.Thread(target=lambda: got.update(
                node.control_ops["host_placement"](
                    {"state": {"rev": rev, "ranges": {}}})))
            th.start()
            deadline = time.monotonic() + 5.0
            while agent.pump() == 0:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            th.join(5.0)
            assert not th.is_alive()
            return got
        out += [push(3), agent.cache.rev, push(1),
                node.control_ops["host_stop"]({}), agent.stopped.is_set()]
        return out
    got = both(run)
    assert got[1:] == [{"eid": "engX", "alive": True, "generation": 1}, 0,
                       {"rev": 3, "changed": True}, 3,
                       {"rev": 3, "changed": False}, "stopping", True]


# -- a reference table directory, snapshot included, opened by the port ---

FAILOVER = SETUP + (("engine_down", "engA", 1),
                    ("migrate", "r0", "engA", "engB", 2))


def test_port_recovers_reference_table_snapshot(tmp_path):
    """Three reference nodes, each with its own ``RaSystem``, a table
    cluster started from its spec and a failover's commands, then a
    snapshot of each member's table through its log: the port recovers a
    copy of the directory to the reference's own recovery (terms,
    commits, logs, snapshots, tables)."""
    base = str(tmp_path / "ref")
    router = ra_tpu.LocalRouter()
    sids = [ref_types.ServerId(f"pt{i}", f"pn{i}") for i in (1, 2, 3)]
    systems = {s.node: RefSystem(os.path.join(base, s.node)) for s in sids}
    nodes = [ra_tpu.RaNode(s.node, router=router, system=systems[s.node])
             for s in sids]
    try:
        ra_tpu.start_cluster("placement", ref_pl.placement_spec(), sids,
                             router=router)
        leader = await_leader(router, sids)
        for cmd in FAILOVER:
            ra_tpu.process_command(leader, cmd, router=router)
        srvs = [n.shells[s.name].server for n, s in zip(nodes, sids)]
        deadline = time.monotonic() + 10.0
        while {s.last_applied for s in srvs} != {srvs[0].commit_index}:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        for n in nodes:
            n.stop()
    try:
        for srv in srvs:
            srv.log.update_release_cursor(
                srv.last_applied, srv._cluster_spec_at(srv.last_applied), 0,
                srv.machine_state)
    finally:
        for s in systems.values():
            s.close()
    shutil.copytree(base, tmp_path / "for_port")
    want = recover_cores(LOG_REF, base,
                         lambda **kw: ref_pl.PlacementTableMachine())
    got = recover_cores(LOG_PORT, str(tmp_path / "for_port"),
                        lambda **kw: port_pl.PlacementTableMachine())
    assert got == want and len(want) == 3
    table_after = norm(table(PKGS["ref"], *FAILOVER)[1])
    assert all(v["snap"][0] == v["applied"] > 0 and
               v["state"] == table_after for v in want.values())
