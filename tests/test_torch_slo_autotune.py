"""The port's SLO engine and autotuner (``ra_tpu_torch/slo.py``,
``ra_tpu_torch/autotune.py``) against the reference's.

Each scenario runs twice, once over the reference's Observatory, SLO
engine, tuner, fault plans and flight recorder, once over the port's, with
the same seeded inputs and the same injected clock (``time`` replaced in
both packages' telemetry and autotune modules): window rates, verdict
dicts, decision lists (knob, old, new, phase, objective, tick, ts) and
the tuners' overviews are held equal.  The closed-loop plants are the
synthetic engines of ``tests/test_slo_autotune.py``: an Observatory whose
engine source is a controllable dict in the real engine source's layout.
Also: phase attribution on real durable engines (the port on the CPU),
the volatile engine's -1.0 interval stamp, and the wire soak's lossy
transport plan, live and freezing the tuner during the soak, gone after
it.  No twin of the wall-clock overhead test: the card measures that.
"""
import gc
import types

import numpy as np
import pytest

import ra_tpu.autotune as ref_autotune
import ra_tpu.slo as ref_slo
import ra_tpu.telemetry as ref_telemetry
import ra_tpu_torch.autotune as port_autotune
import ra_tpu_torch.slo as port_slo
import ra_tpu_torch.telemetry as port_telemetry
from ra_tpu import blackbox as ref_blackbox
from ra_tpu.log import faults as ref_faults
from ra_tpu.transport import rpc as ref_rpc
from ra_tpu_torch import blackbox as port_blackbox
from ra_tpu_torch.log import faults as port_faults
from ra_tpu_torch.transport import rpc as port_rpc


class Clock:
    """One injected clock for ``time.time``/``monotonic``/``perf_counter``;
    ``sleep`` advances it."""

    def __init__(self, t: float = 1_000_000.0) -> None:
        self.t = t

    def time(self) -> float:
        return self.t

    monotonic = perf_counter = time

    def sleep(self, s: float) -> None:
        self.t += s


PKGS = {
    "ref": types.SimpleNamespace(
        telemetry=ref_telemetry, slo=ref_slo, autotune=ref_autotune,
        faults=ref_faults, rpc=ref_rpc, RECORDER=ref_blackbox.RECORDER,
        EVENT_REGISTRY=ref_blackbox.EVENT_REGISTRY),
    "port": types.SimpleNamespace(
        telemetry=port_telemetry, slo=port_slo, autotune=port_autotune,
        faults=port_faults, rpc=port_rpc, RECORDER=port_blackbox.RECORDER,
        EVENT_REGISTRY=port_blackbox.EVENT_REGISTRY),
}


@pytest.fixture(autouse=True)
def _scoped_port_plans():
    """The port's plan registries are process-global like the
    reference's (whose scoping the suite's conftest does): plans a test
    registers are unregistered, and the disk-plan slot restored, when it
    ends."""
    pre_net = list(port_rpc.live_fault_plans())
    pre_disk = port_faults.current_plan()
    yield
    for p in port_rpc.live_fault_plans():
        if p not in pre_net:
            p.unregister()
    if port_faults.current_plan() is not pre_disk:
        if pre_disk is None:
            port_faults.clear_plan()
        else:
            port_faults.install_plan(pre_disk)


def run_both(monkeypatch, scenario):
    """``scenario(pkg, clock)`` over each package with a fresh injected
    clock; returns ``(ref_result, port_result)``."""
    out = []
    for name in ("ref", "port"):
        pkg = PKGS[name]
        clock = Clock()
        with monkeypatch.context() as m:
            m.setattr(pkg.telemetry, "time", clock)
            m.setattr(pkg.autotune, "time", clock)
            out.append(scenario(pkg, clock))
    return out


# ---------------------------------------------------------------------------
# ring edge cases and verdicts
# ---------------------------------------------------------------------------

def sc_percentile_empty_and_missing(pkg, clock):
    obs = pkg.telemetry.Observatory()
    out = [obs.percentile("anything", 0.5)]
    obs.add_source("s", lambda: {"x": 1})
    obs.snapshot()
    out += [obs.percentile("s_x", 0.5), obs.percentile("s_missing", 0.99),
            obs.window_rates()]
    obs.close()
    return out


def sc_window_rates_span(pkg, clock):
    vals = iter(range(0, 500, 10))
    obs = pkg.telemetry.Observatory()
    obs.add_source("s", lambda: {"ctr_count": next(vals)})
    for i in range(5):
        clock.sleep(0.013 * (i + 1))
        obs.snapshot()
    out = [obs.window_rates(span=4), obs.window_rates(span=1, end=2),
           obs.window_rates(span=10), obs.ring()]
    obs.close()
    return out


def sc_depth_gauge_drift(pkg, clock):
    depth = iter([4.0, 1.0])
    disp = iter([100.0, 50.0])
    obs = pkg.telemetry.Observatory()
    obs.add_source("engine", lambda: {"pipeline": {
        "dispatches_in_flight": next(depth), "dispatches": next(disp)}})
    obs.snapshot()
    clock.sleep(0.5)
    obs.snapshot()
    out = obs.window_rates()
    obs.close()
    return out


def sc_counter_reset(pkg, clock):
    seq = iter([1000.0, 2000.0, 5.0])
    gauge = iter([10.0, 4.0, 2.0])
    obs = pkg.telemetry.Observatory()
    obs.add_source("s", lambda: {"committed_total": next(seq),
                                 "lag_depth": next(gauge)})
    out = []
    for _ in range(3):
        obs.snapshot()
        out.append(obs.window_rates())
        clock.sleep(0.25)
    obs.close()
    return out


@pytest.mark.parametrize("scenario", [
    sc_percentile_empty_and_missing, sc_window_rates_span,
    sc_depth_gauge_drift, sc_counter_reset], ids=lambda f: f.__name__)
def test_window_rates_match_reference(monkeypatch, scenario):
    ref, port = run_both(monkeypatch, scenario)
    assert port == ref


def test_window_rates_edge_cases_hold_reference_rules(monkeypatch):
    _, port = run_both(monkeypatch, sc_percentile_empty_and_missing)
    assert port == [None, 1.0, None, {}]
    _, port = run_both(monkeypatch, sc_depth_gauge_drift)
    assert port["engine_pipeline_dispatches_in_flight"] < 0
    assert "engine_pipeline_dispatches" not in port
    _, port = run_both(monkeypatch, sc_counter_reset)
    assert port[1]["s_committed_total"] > 0
    assert "s_committed_total" not in port[2] and port[2]["s_lag_depth"] < 0


def mk_obs(pkg, clock, state):
    """An Observatory whose engine source mirrors the real layout — the
    flat ring keys the production objectives read."""
    obs = pkg.telemetry.Observatory(ring_capacity=64)

    def engine_src():
        return {
            "phases": {
                "device_dispatch": {"total_ms": state["disp_total"]},
                "fsync_wait": {"total_ms": state["fsync_total"]},
                "commit_e2e": {"total_ms": state["e2e_total"],
                               "p99_ms": state["commit_p99"]},
            },
            "wal": {"shards": [{"fsync_p99_ms": state["fsync_p99"]}]},
            "telemetry": {"ts": clock.time(),
                          "committed_total": state["committed"]},
            "gauge_cmds_per_s": state["gauge_rate"],
        }

    obs.add_source("engine", engine_src)
    return obs


def base_state():
    return {"disp_total": 0.0, "fsync_total": 0.0, "e2e_total": 0.0,
            "commit_p99": 5.0, "fsync_p99": 5.0, "committed": 0.0,
            "gauge_rate": -1.0}


def sc_verdicts(pkg, clock):
    state = base_state()
    obs = mk_obs(pkg, clock, state)
    slo = pkg.slo.SloEngine(obs, pkg.slo.default_objectives(
        min_cmds_per_s=100.0), fast_windows=2, slow_windows=4,
        burn_fast=0.5, burn_slow=0.5)
    out = [slo.evaluate()]
    for p99 in (5.0, 5.0, 5.0, 90.0, 90.0, 90.0, 90.0):
        state["commit_p99"] = p99
        state["committed"] += 1000.0
        clock.sleep(0.002)
        obs.snapshot()
        out.append(slo.evaluate())
    snap = obs.snapshot()
    text = obs.prometheus(snap)
    out += [snap["slo"], text, pkg.telemetry.parse_prometheus(text),
            slo.verdict("commit_p99_ms"), slo.verdict("no-such")]
    obs.close()
    return out


def test_slo_verdicts_ok_breach_alert_no_data(monkeypatch):
    ref, port = run_both(monkeypatch, sc_verdicts)
    assert port == ref
    v = port[3]["objectives"]
    assert port[0]["objectives"]["commit_p99_ms"]["verdict"] == "no_data"
    assert v["commit_p99_ms"]["verdict"] == "ok"
    assert v["cmds_per_s"]["verdict"] == "ok" and \
        v["cmds_per_s"]["value"] > 100.0
    assert port[4]["objectives"]["commit_p99_ms"]["verdict"] in (
        "breach", "alert")
    last = port[7]["objectives"]["commit_p99_ms"]
    assert last["verdict"] == "alert" and last["burn_fast"] == 1.0
    assert port[-3][("ra_tpu_slo_objectives_commit_p99_ms_ok", "")] == 0.0
    assert port[-2] == "alert" and port[-1] == "no_data"


def sc_wildcard(pkg, clock):
    shards = [{"fsync_p99_ms": -1.0}, {"fsync_p99_ms": 70.0}]
    obs = pkg.telemetry.Observatory()
    obs.add_source("engine", lambda: {"wal": {"shards": shards}})
    slo = pkg.slo.SloEngine(obs, (pkg.slo.Objective(
        "fsync_p99_ms", "engine_wal_shards_*_fsync_p99_ms", "<=", 50.0),),
        fast_windows=1, slow_windows=2, burn_fast=0.5)
    obs.snapshot()
    out = [slo.evaluate()]
    shards[1]["fsync_p99_ms"] = -1.0
    clock.sleep(0.1)
    obs.snapshot()
    out.append(slo.evaluate())
    obs.close()
    return out


def test_slo_wildcard_aggregates_shards_and_skips_sentinels(monkeypatch):
    ref, port = run_both(monkeypatch, sc_wildcard)
    assert port == ref
    first = port[0]["objectives"]["fsync_p99_ms"]
    assert first["value"] == 70.0 and not first["ok"]
    assert port[1]["objectives"]["fsync_p99_ms"]["verdict"] == "no_data"


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_slo_duplicate_objective_names_rejected(pkg):
    p = PKGS[pkg]
    obs = p.telemetry.Observatory()
    objs = (p.slo.Objective("a", "x", "<=", 1.0),
            p.slo.Objective("a", "y", ">=", 1.0))
    with pytest.raises(ValueError, match="duplicate objective names"):
        p.slo.SloEngine(obs, objs)
    with pytest.raises(ValueError):
        p.slo.Objective("a", "x", "<", 1.0)
    obs.close()


def test_default_objectives_and_knobs_match_reference():
    assert [o.describe() for o in port_slo.default_objectives()] == \
        [o.describe() for o in ref_slo.default_objectives()]
    assert port_autotune.TUNABLE_KNOBS == ref_autotune.TUNABLE_KNOBS
    assert port_autotune.DEFAULT_BOUNDS == ref_autotune.DEFAULT_BOUNDS
    for name in ("tune.decision", "tune.freeze", "device.recompile",
                 "profile.captured"):
        assert port_blackbox.EVENT_REGISTRY[name] == \
            ref_blackbox.EVENT_REGISTRY[name], name


# ---------------------------------------------------------------------------
# the closed loop on synthetic plants
# ---------------------------------------------------------------------------

def mk_tuner(pkg, slo, obs, **kw):
    kw.setdefault("freeze_guard", lambda: None)
    kw.setdefault("incident_freeze_s", 0.0)
    kw.setdefault("cooldown_windows", 0)
    kw.setdefault("breach_windows", 2)
    return pkg.autotune.AutoTuner(slo, obs, **kw)


def drive(obs, tuner, state, plant, windows, clock):
    decisions = []
    for _ in range(windows):
        plant(tuner.knobs, state)
        clock.sleep(0.002)
        obs.snapshot()
        d = tuner.tick()
        if d is not None:
            decisions.append(d)
    return decisions


def dispatch_bound_plant(knobs, state):
    k = knobs["superstep_k"]
    state["disp_total"] += 100.0 / k
    state["fsync_total"] += 4.0
    state["e2e_total"] += 110.0 / k
    state["commit_p99"] = 100.0 / k + 5.0
    state["committed"] += 10000.0


def fsync_bound_plant(knobs, state):
    k = knobs["superstep_k"]
    interval = knobs["wal_max_batch_interval_ms"]
    state["fsync_total"] += 100.0
    state["disp_total"] += 5.0
    state["e2e_total"] += 120.0
    state["fsync_p99"] = 30.0 + 2.0 * interval + 4.0 * k
    state["commit_p99"] = state["fsync_p99"] / 2.0
    state["committed"] += 1000.0


def throughput_bound_plant(knobs, state):
    k = knobs["superstep_k"]
    c = knobs["cmds_per_step"]
    state["disp_total"] += 10.0
    state["commit_p99"] = 5.0
    state["gauge_rate"] = 100.0 * k * c
    state["e2e_total"] += 10.0


def mesh_plant(knobs, state):
    k = knobs["superstep_k"]
    interval = knobs["wal_max_batch_interval_ms"]
    if state["regime"] == "dispatch":
        dispatch_bound_plant(knobs, state)
        state["fsync_p99"] = 5.0
    else:
        fsync_bound_plant(knobs, state)
        state["fsync_p99"] = 30.0 + 2.0 * interval + 4.0 * k
        state["committed"] += 9000.0


def default_slo(pkg, obs, **kw):
    kw.setdefault("fast_windows", 3)
    kw.setdefault("slow_windows", 6)
    kw.setdefault("burn_fast", 0.5)
    kw.setdefault("burn_slow", 0.25)
    return pkg.slo.SloEngine(
        obs, pkg.slo.default_objectives(min_cmds_per_s=1.0), **kw)


def tune_events(pkg, base):
    return [(e[1], e[2]) for e in pkg.RECORDER.events("tune")[base:]]


def sc_dispatch_bound(pkg, clock):
    state = base_state()
    obs = mk_obs(pkg, clock, state)
    tuner = mk_tuner(pkg, default_slo(pkg, obs), obs,
                     knobs={"superstep_k": 1})
    base = len(pkg.RECORDER.events("tune"))
    up = drive(obs, tuner, state, dispatch_bound_plant, 16, clock)
    more = drive(obs, tuner, state, dispatch_bound_plant, 6, clock)
    snap = obs.snapshot()
    obs.close()
    return up, more, tune_events(pkg, base), snap["autotune"], \
        tuner.decisions.maxlen


def sc_fsync_bound(pkg, clock):
    state = base_state()
    obs = mk_obs(pkg, clock, state)
    tuner = mk_tuner(pkg, default_slo(pkg, obs), obs,
                     knobs={"superstep_k": 8,
                            "wal_max_batch_interval_ms": 2.0})
    down = drive(obs, tuner, state, fsync_bound_plant, 16, clock)
    more = drive(obs, tuner, state, fsync_bound_plant, 6, clock)
    obs.close()
    return down, more, tuner.overview()


def sc_throughput_bound(pkg, clock):
    state = base_state()
    obs = mk_obs(pkg, clock, state)
    slo = pkg.slo.SloEngine(obs, (
        pkg.slo.Objective("commit_p99_ms",
                          "engine_phases_commit_e2e_p99_ms", "<=", 25.0),
        pkg.slo.Objective("cmds_per_s", "engine_gauge_cmds_per_s",
                          ">=", 25_000.0)),
        fast_windows=3, slow_windows=6, burn_fast=0.5, burn_slow=0.25)
    tuner = mk_tuner(pkg, slo, obs, bounds={"superstep_k": (1, 4)},
                     knobs={"superstep_k": 1, "cmds_per_step": 32})
    up = drive(obs, tuner, state, throughput_bound_plant, 20, clock)
    more = drive(obs, tuner, state, throughput_bound_plant, 6, clock)
    obs.close()
    return up, more, tuner.overview()


def sc_mesh(pkg, clock):
    state = {**base_state(), "regime": "dispatch"}
    obs = mk_obs(pkg, clock, state)
    tuner = mk_tuner(pkg, default_slo(pkg, obs), obs,
                     knobs={"superstep_k": 1,
                            "wal_max_batch_interval_ms": 2.0})
    up = drive(obs, tuner, state, mesh_plant, 16, clock)
    quiet = drive(obs, tuner, state, mesh_plant, 4, clock)
    state["regime"] = "fsync"
    down = drive(obs, tuner, state, mesh_plant, 18, clock)
    after = drive(obs, tuner, state, mesh_plant, 6, clock)
    snap = obs.snapshot()
    obs.close()
    return up, quiet, down, after, snap["autotune"]


def sc_hysteresis(pkg, clock):
    state = base_state()
    obs = mk_obs(pkg, clock, state)
    slo = default_slo(pkg, obs, fast_windows=2, slow_windows=4,
                      burn_slow=0.3)
    tuner = mk_tuner(pkg, slo, obs, breach_windows=2,
                     knobs={"superstep_k": 1})

    def noisy_plant(knobs, st):
        dispatch_bound_plant(knobs, st)
        st["commit_p99"] = 90.0 if st["committed"] % 20000 else 5.0

    out = drive(obs, tuner, state, noisy_plant, 10, clock)
    obs.close()
    return out, tuner.overview()


def sc_cooldown(pkg, clock):
    state = base_state()
    obs = mk_obs(pkg, clock, state)
    tuner = mk_tuner(pkg, default_slo(pkg, obs), obs, cooldown_windows=3,
                     knobs={"superstep_k": 1})
    ticks = []
    for w in range(12):
        dispatch_bound_plant(tuner.knobs, state)
        state["commit_p99"] = 90.0
        clock.sleep(0.002)
        obs.snapshot()
        d = tuner.tick()
        if d is not None:
            ticks.append((w, d))
    obs.close()
    return ticks


def knobs_of(decisions):
    return [(d["knob"], d["new"]) for d in decisions]


@pytest.mark.parametrize("scenario", [
    sc_dispatch_bound, sc_fsync_bound, sc_throughput_bound, sc_mesh,
    sc_hysteresis, sc_cooldown], ids=lambda f: f.__name__)
def test_closed_loop_matches_reference(monkeypatch, scenario):
    """Decision lists (knob, old, new, phase, objective, tick, ts),
    recorder events and overviews equal under one clock."""
    ref, port = run_both(monkeypatch, scenario)
    assert port == ref


def test_closed_loop_walks_as_the_reference_pins(monkeypatch):
    _, (up, more, events, ov, maxlen) = run_both(monkeypatch,
                                                 sc_dispatch_bound)
    assert knobs_of(up) == [("superstep_k", 2), ("superstep_k", 4),
                            ("superstep_k", 8)]
    assert all(d["phase"] == "device_dispatch" and
               d["objective"] == "commit_p99_ms" for d in up)
    assert more == [] and maxlen == 256
    assert [e[0] for e in events] == ["tune.decision"] * 3
    assert all(e[0] in port_blackbox.EVENT_REGISTRY for e in events)
    assert port_blackbox.RECORDER.counters["unregistered_events"] == 0
    assert ov["knobs"]["superstep_k"] == 8 and \
        ov["last_decision"]["new"] == 8
    _, (down, more, _ov) = run_both(monkeypatch, sc_fsync_bound)
    assert knobs_of(down) == [("wal_max_batch_interval_ms", 1.0),
                              ("wal_max_batch_interval_ms", 0.0),
                              ("superstep_k", 4)]
    assert all(d["objective"] == "fsync_p99_ms" and
               d["phase"] == "fsync_wait" for d in down) and more == []
    _, (up, more, _ov) = run_both(monkeypatch, sc_throughput_bound)
    assert knobs_of(up) == [("superstep_k", 2), ("superstep_k", 4),
                            ("cmds_per_step", 64)] and more == []
    _, (up, quiet, down, after, ov) = run_both(monkeypatch, sc_mesh)
    assert knobs_of(up) == [("superstep_k", 2), ("superstep_k", 4),
                            ("superstep_k", 8)] and quiet == []
    assert knobs_of(down) == [("wal_max_batch_interval_ms", 1.0),
                              ("wal_max_batch_interval_ms", 0.0),
                              ("superstep_k", 4)] and after == []
    assert ov["knobs"]["superstep_k"] == 4
    _, (noisy, _ov) = run_both(monkeypatch, sc_hysteresis)
    assert noisy == []
    _, ticks = run_both(monkeypatch, sc_cooldown)
    assert len(ticks) >= 2
    assert all(b[0] - a[0] >= 4 for a, b in zip(ticks, ticks[1:]))


# ---------------------------------------------------------------------------
# freeze guards
# ---------------------------------------------------------------------------

def breach_forever(knobs, state):
    dispatch_bound_plant(knobs, state)
    state["commit_p99"] = 90.0


def isolated_guard(pkg):
    """``default_freeze_guard`` over plans the test itself creates (the
    registries are process-global)."""
    gc.collect()
    pre_net = {id(p) for p in pkg.rpc.live_fault_plans()}
    pre_disk = pkg.faults.current_plan()

    def guard():
        cur = pkg.faults.current_plan()
        if cur is not None and cur is not pre_disk:
            return "disk_fault_plan_active"
        if any(id(p) not in pre_net and not p.quiet()
               for p in pkg.rpc.live_fault_plans()):
            return "transport_fault_plan_active"
        return None

    return guard


def freeze_tuner(pkg, clock, **kw):
    state = base_state()
    obs = mk_obs(pkg, clock, state)
    kw.setdefault("freeze_guard", isolated_guard(pkg))
    kw.setdefault("incident_freeze_s", 0.0)
    tuner = pkg.autotune.AutoTuner(
        default_slo(pkg, obs), obs, cooldown_windows=0, breach_windows=2,
        knobs={"superstep_k": 1}, **kw)
    return obs, tuner, state


def freezes(pkg):
    return len([e for e in pkg.RECORDER.events("tune")
                if e[1] == "tune.freeze"])


def sc_disk_freeze(pkg, clock):
    obs, tuner, state = freeze_tuner(pkg, clock)
    plan = pkg.faults.DiskFaultPlan(seed=7)
    pkg.faults.install_plan(plan)
    try:
        guard = pkg.autotune.default_freeze_guard()
        f0 = freezes(pkg)
        frozen = drive(obs, tuner, state, breach_forever, 6, clock)
        ov = tuner.overview()
        n_freeze = freezes(pkg) - f0
    finally:
        pkg.faults.clear_plan()
    thawed = drive(obs, tuner, state, breach_forever, 4, clock)
    obs.close()
    return guard, frozen, ov, n_freeze, thawed, tuner.overview()


def sc_quiet_plans(pkg, clock):
    assert pkg.faults.current_plan() is None
    quiet = pkg.rpc.FaultPlan(seed=1)
    partitioned = pkg.rpc.FaultPlan(seed=2)
    partitioned.partition("nodeB")
    lossy = pkg.rpc.FaultPlan(seed=3, default=pkg.rpc.FaultSpec(drop=0.5))
    out = [quiet.quiet(), partitioned.quiet(), lossy.quiet()]
    partitioned.heal()
    out.append(partitioned.quiet())
    del lossy
    gc.collect()
    out += [all(p.quiet() for p in pkg.rpc.live_fault_plans()),
            pkg.autotune.default_freeze_guard()]
    return out


def sc_transport_freeze(pkg, clock):
    obs, tuner, state = freeze_tuner(pkg, clock)
    plan = pkg.rpc.FaultPlan(seed=3, default=pkg.rpc.FaultSpec(drop=0.25))
    try:
        live = plan in pkg.rpc.live_fault_plans() and not plan.quiet()
        guard = pkg.autotune.default_freeze_guard()
        frozen = drive(obs, tuner, state, breach_forever, 5, clock)
        reason = tuner.overview()["freeze_reason"]
    finally:
        del plan
        gc.collect()
    thawed = drive(obs, tuner, state, breach_forever, 4, clock)
    obs.close()
    return live, guard, frozen, reason, thawed


def sc_incident_freeze(pkg, clock, tmp_dir):
    obs, tuner, state = freeze_tuner(pkg, clock, freeze_guard=lambda: None,
                                     incident_freeze_s=3600.0)
    pkg.RECORDER.dump("tuner_unit_incident", what="w", data_dir=tmp_dir)
    # the recorder stamps the bundle with the real clock: one second on
    clock.t = pkg.RECORDER.last_incident()["ts"] + 1.0
    try:
        frozen = drive(obs, tuner, state, breach_forever, 5, clock)
        reason = tuner.overview()["freeze_reason"]
    finally:
        pkg.RECORDER.incidents.clear()
    thawed = drive(obs, tuner, state, breach_forever, 4, clock)
    obs.close()
    # decision stamps carry the dump's real time: compare the knobs
    return frozen, reason, knobs_of(thawed)


def test_frozen_under_active_disk_fault_plan(monkeypatch):
    ref, port = run_both(monkeypatch, sc_disk_freeze)
    assert port == ref
    guard, frozen, ov, n_freeze, thawed, ov2 = port
    assert guard == "disk_fault_plan_active" and frozen == []
    assert ov["frozen"] and ov["freeze_reason"] == "disk_fault_plan_active"
    assert n_freeze == 1                     # the transition, not per tick
    assert thawed and thawed[0]["knob"] == "superstep_k"
    assert not ov2["frozen"]


def test_quiet_or_healed_transport_plan_does_not_freeze(monkeypatch):
    ref, port = run_both(monkeypatch, sc_quiet_plans)
    assert port == ref == [True, False, False, True, True, None]


def test_frozen_under_live_transport_fault_plan(monkeypatch):
    ref, port = run_both(monkeypatch, sc_transport_freeze)
    assert port == ref
    live, guard, frozen, reason, thawed = port
    assert live and guard == "transport_fault_plan_active"
    assert frozen == [] and reason == "transport_fault_plan_active"
    assert thawed


def test_frozen_after_fresh_incident(monkeypatch, tmp_path):
    ref, port = run_both(monkeypatch, lambda pkg, clock: sc_incident_freeze(
        pkg, clock, str(tmp_path / pkg.autotune.__name__)))
    assert port == ref
    frozen, reason, thawed = port
    assert frozen == [] and reason == "recent_incident" and thawed[0]


# ---------------------------------------------------------------------------
# real engines: phases flow end to end
# ---------------------------------------------------------------------------

def durable_run(pkg_name, data_dir):
    """A durable engine (2 WAL shards) driven through the dispatch-ahead
    driver with snapshots between submits; returns the final snapshot,
    its exposition, the engine and the Observatory."""
    if pkg_name == "ref":
        from ra_tpu.engine import DispatchAheadDriver, open_engine
        from ra_tpu.models import CounterMachine
        kw = {}
    else:
        from ra_tpu_torch.engine import DispatchAheadDriver
        from ra_tpu_torch.engine.durable import open_engine
        from ra_tpu_torch.models import CounterMachine
        kw = {"device": "cpu"}
    pkg = PKGS[pkg_name]
    eng = open_engine(CounterMachine(), data_dir, 16, 3, wal_shards=2,
                      max_step_cmds=4, ring_capacity=64, **kw)
    obs = pkg.telemetry.Observatory.for_engine(eng)
    slo = pkg.slo.SloEngine(obs, pkg.slo.default_objectives(
        min_cmds_per_s=1.0))
    drv = DispatchAheadDriver(eng, max_in_flight=2)
    nb = np.full((4, 16), 4, np.int32)
    pb = np.ones((4, 16, 4, 1), np.int32)
    for i in range(10):
        drv.submit(nb, pb)
        if i % 3 == 0:
            obs.snapshot()
    drv.drain()
    eng._dur.flush_all()
    snap = obs.snapshot()
    return snap, obs.prometheus(snap), eng, obs, slo


def test_phase_attribution_on_real_durable_engine(tmp_path):
    runs = {name: durable_run(name, str(tmp_path / name))
            for name in ("ref", "port")}
    try:
        snaps = {k: v[0] for k, v in runs.items()}
        port, ref = snaps["port"], snaps["ref"]
        ph = port["engine"]["phases"]
        for p in ("host_staging", "device_dispatch", "queue_wait",
                  "wal_encode", "fsync_wait", "confirm_publish",
                  "commit_e2e"):
            assert ph[p]["count"] > 0, p
        assert ph["dropped"] == 0
        # the same phases sampled, the same knob stamps and pipeline
        # counters, the same WAL engine counters, the same objectives
        assert {p for p, v in ph.items() if isinstance(v, dict) and
                v["count"]} == {p for p, v in ref["engine"]["phases"]
                                .items() if isinstance(v, dict) and
                                v["count"]}
        assert port["engine"]["pipeline"] == ref["engine"]["pipeline"]
        assert port["engine"]["wal"]["engine"] == \
            ref["engine"]["wal"]["engine"]
        assert set(port["slo"]["objectives"]) == \
            set(ref["slo"]["objectives"])
        # every flat key of the engine and slo sources is the
        # reference's (the exposition's layout)
        flat = {k: port_telemetry._flatten_numeric(port[k])
                for k in ("engine", "slo")}
        want = {k: ref_telemetry._flatten_numeric(ref[k])
                for k in ("engine", "slo")}
        assert {k: set(v) for k, v in flat.items()} == \
            {k: set(v) for k, v in want.items()}
        text = runs["port"][1]
        port_telemetry.parse_prometheus(text)
        assert "ra_tpu_engine_phases_commit_e2e_p99_ms" in text
        assert 'ra_tpu_engine_phase_ms_bucket{phase="fsync_wait"' in text
        assert "ra_tpu_slo_objectives_fsync_p99_ms_ok" in text
        # a live interval retarget lands on every shard, both packages
        for name, (_s, _t, eng, _o, _slo) in runs.items():
            eng._dur.set_batch_interval_ms(3.5)
            assert [w.max_batch_interval_ms for w in eng._dur.wals] == \
                [3.5, 3.5], name
            assert eng._dur.batch_interval_ms() == 3.5
            assert eng.overview()["pipeline"][
                "wal_max_batch_interval_ms"] == 3.5
        assert runs["port"][2]._dur.shard_layout() == \
            runs["ref"][2]._dur.shard_layout() == [[0, 8], [8, 16]]
        assert runs["port"][2]._dur.confirmed_step == \
            runs["ref"][2]._dur.confirmed_step == 40
    finally:
        for _s, _t, eng, obs, _slo in runs.values():
            obs.close()
            eng.close()


def test_volatile_engine_has_phase_plane_too():
    from ra_tpu.engine import LockstepEngine as RefEngine
    from ra_tpu.models import CounterMachine as RefCounter
    from ra_tpu_torch.engine import LockstepEngine
    from ra_tpu_torch.models import CounterMachine
    ref = RefEngine(RefCounter(), 8, 3, ring_capacity=64, max_step_cmds=4)
    port = LockstepEngine(CounterMachine(), 8, 3, ring_capacity=64,
                          max_step_cmds=4, device="cpu")
    for _ in range(4):
        ref.uniform_step(2)
        port.uniform_step(2)
    assert port.phases.overview()["commit_e2e"]["count"] == 0
    assert port.overview()["pipeline"] == ref.overview()["pipeline"]
    assert port.overview()["pipeline"]["wal_max_batch_interval_ms"] == -1.0


# ---------------------------------------------------------------------------
# the wire soak's lossy transport plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg_name", ["ref", "port"])
def test_wire_soak_plan_freezes_the_tuner_only_during_the_soak(
        monkeypatch, pkg_name):
    """During the soak its lossy FaultPlan is live and non-quiet, so the
    default freeze guard names it and a tuner ticked then freezes; after
    the soak the plan is gone from the registry, in both packages."""
    pkg = PKGS[pkg_name]
    if pkg_name == "ref":
        import ra_tpu.wire.soak as soak
        kw = {}
    else:
        import ra_tpu_torch.wire.soak as soak
        kw = {"device": "cpu"}
    obs = pkg.telemetry.Observatory()
    tuner = pkg.autotune.AutoTuner(pkg.slo.SloEngine(obs),
                                   incident_freeze_s=0.0)
    seen = []
    cycle = soak._cycle

    def observed_cycle(*a):
        if not seen:
            lossy = [p for p in pkg.rpc.live_fault_plans()
                     if not p.quiet()]
            seen.append((len(lossy), pkg.autotune.default_freeze_guard(),
                         tuner.tick(), tuner.overview()["freeze_reason"]))
        return cycle(*a)

    monkeypatch.setattr(soak, "_cycle", observed_cycle)
    before = list(pkg.rpc.live_fault_plans())
    row = soak.run_wire_soak(0, conns=64, lanes=16, waves=2, wave_ops=256,
                             superstep_k=2, cmds=8, **kw)
    assert row["ops"] > 0
    assert seen == [(1, "transport_fault_plan_active", None,
                     "transport_fault_plan_active")]
    assert list(pkg.rpc.live_fault_plans()) == before
    assert pkg.autotune.default_freeze_guard() is None
    obs.close()


# ---------------------------------------------------------------------------
# chip_smoke.py's tune_path and reads_path loops, at CPU scale
# ---------------------------------------------------------------------------

def test_tune_loop_holds_its_invariants_on_cpu(tmp_path):
    """The autotuned durable loop the card runs at full width, at 32
    lanes: every dispatched K decided and stamped, the live interval on
    every shard, the freeze under a DiskFaultPlan, the committed total
    equal to the logs, the WAL's accepted rows and the counters, and the
    Prometheus round trip (the loop raises on any miss)."""
    from chip_smoke import tune_loop
    out = tune_loop("cpu", str(tmp_path / "wal"), n_lanes=32, cmds=8,
                    seconds=1.5, k_hi=8, shards=2)
    assert out["committed_exact"] and out["frozen_ticks"] == 2
    assert out["committed"] == out["sent_cmds"]    # the ring clips nothing
    assert [d["k"] for d in out["k_dispatched"]] == [1] + [
        d["new"] for d in out["decisions"] if d["knob"] == "superstep_k"]
    assert out["captures"] == []                   # the CPU captures none
    assert out["prometheus_round_trip"]["keys"] > 100


def test_reads_loop_oracle_on_cpu(tmp_path):
    """The read/write loop the card runs at ``bench.py --reads``'
    defaults, at 32 lanes: the replicas' KV state equals the model of
    the logs' puts, which are the accepted puts in submission order, and
    every served read equals the log at its watermark."""
    from chip_smoke import reads_loop
    out = reads_loop("cpu", str(tmp_path / "wal"), lanes=32, seconds=0.6)
    assert out["kv_state_equal_model"] and out["reads_equal_log_at_watermark"]
    assert out["oracle_reads_checked"] > 0 and out["oracle_puts"] > 0
    assert out["steady_state_recaptures"] == 0
    assert set(out["slo"]) == {o.name for o in port_slo.default_objectives()}
