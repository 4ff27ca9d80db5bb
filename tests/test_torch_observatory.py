"""The port's Observatory (``ra_tpu_torch/telemetry.py``) against the
reference's (``ra_tpu/telemetry.py``).

The same snapshot dict gives byte-equal Prometheus text in both packages,
and the text parses back to the ring's flattening; the parser refuses the
same garbage.  Engines of both packages driven with the same seeded
schedule under one injected clock (``time`` replaced in both telemetry
modules) give equal flattened rings over the engine source, equal window
rates, the same stale-sample omission, and the same lane-health counter
track on the tracer.  A failing source degrades alike; the JSONL rings
are byte-equal and ``tools/ra_top.py`` renders the port's.  The ingress
plane's SLO-verdict poll and Observatory wiring, and the wire listener's
``attach``, are held against the reference's planes.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import ra_tpu.telemetry as ref_telemetry
import ra_tpu_torch.telemetry as port_telemetry
from ra_tpu import trace as ref_trace
from ra_tpu.engine import LockstepEngine as RefEngine
from ra_tpu.models import CounterMachine as RefCounter
from ra_tpu_torch import trace as port_trace
from ra_tpu_torch.engine import LockstepEngine
from ra_tpu_torch.models import CounterMachine
from test_torch_slo_autotune import Clock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEL = {"ref": ref_telemetry, "port": port_telemetry}


def mk_engine(pkg, n=8, p=3):
    kw = dict(ring_capacity=64, max_step_cmds=4)
    if pkg == "ref":
        return RefEngine(RefCounter(), n, p, donate=False, **kw)
    return LockstepEngine(CounterMachine(), n, p, device="cpu", **kw)


@pytest.fixture
def clock(monkeypatch):
    """One injected clock for both telemetry modules."""
    c = Clock()
    for mod in TEL.values():
        monkeypatch.setattr(mod, "time", c)
    return c


def engine_keys(flat):
    return {k: v for k, v in flat.items()
            if k.startswith("engine_") or k == "seq"}


def rich_snapshot():
    """A snapshot dict with every shape the exposition handles: nested
    scalars, bools, tiny and huge floats, lists of dicts (shards), lists
    of scalars (skipped), the commit-lag histogram, top-K offenders,
    phase histograms, an error entry and names that need escaping."""
    return {
        "seq": 7, "ts": 1234.5,
        "engine": {
            "lanes": 16, "members": 3,
            "pipeline": {"superstep_k": 8, "mesh_shape": "",
                         "wal_max_batch_interval_ms": 2.5,
                         "dispatches": 10 ** 16, "tiny": 5e-05},
            "telemetry": {"committed_total": 4096, "ts": 99.25,
                          "commit_lag_hist": [3, 0, 2, 5, 1],
                          "top_lanes": [4, 1, 9],
                          "top_commit_lag": [7, 3, 0],
                          "top_apply_lag": [1, 0],
                          "top_stall_steps": [9, 8, 1.5]},
            "phases": {"fsync_wait": {"count": 3, "p99_ms": 12.125,
                                      "hist": [1, 0, 2]},
                       "commit_e2e": {"count": 0, "p99_ms": -1.0,
                                      "hist": []},
                       "dropped": 0},
            "wal": {"shards": [{"shard": 0, "fsync_p99_ms": -1.0},
                               {"shard": 1, "fsync_p99_ms": 70.0}]},
        },
        "slo": {"ok": False, "objectives": {"a-b c": {"ok": True}}},
        "boom": {"error": "ZeroDivisionError('division by zero')"},
        "flags": [True, False],
    }


def test_prometheus_text_byte_equal_and_round_trips():
    snap = rich_snapshot()
    want = ref_telemetry.Observatory().prometheus(snap)
    obs = port_telemetry.Observatory()
    got = obs.prometheus(snap)
    assert got == want
    parsed = port_telemetry.parse_prometheus(got)
    assert parsed == ref_telemetry.parse_prometheus(want)
    flat = port_telemetry._flatten_numeric(snap)
    assert flat == ref_telemetry._flatten_numeric(snap)
    assert {n[len("ra_tpu_"):]: v for (n, lbl), v in parsed.items()
            if not lbl and not n.endswith("_count")} == \
        {k: v for k, v in flat.items() if not k.endswith("_count")}
    assert parsed[("ra_tpu_engine_commit_lag_bucket", '{le="+Inf"}')] == 11
    assert parsed[("ra_tpu_engine_top_commit_lag",
                   '{lane="9",rank="2"}')] == 0.0
    assert parsed[("ra_tpu_engine_phase_ms_bucket",
                   '{phase="fsync_wait",le="+Inf"}')] == 3
    obs.close()


@pytest.mark.parametrize("text,ok", [
    ("ra_tpu_ok 1\nnot a metric line at all\n", False),
    ("ra_tpu_ok notanumber\n", False),
    ('ra_tpu_x{le="1" 2\n', False),
    ("ra_tpu_tiny 5e-05\nra_tpu_neg -1\nra_tpu_inf +Inf\n", True),
    ('# comment\n\nra_tpu_b{lane="1",rank="0"} 3\n', True),
], ids=["garbage_line", "bad_value", "open_labels", "value_forms",
        "comments_and_labels"])
def test_prometheus_parser_matches_reference(text, ok):
    if not ok:
        for mod in TEL.values():
            with pytest.raises(ValueError):
                mod.parse_prometheus(text)
        return
    got = port_telemetry.parse_prometheus(text)
    assert got == ref_telemetry.parse_prometheus(text)
    if "tiny" in text:
        assert got[("ra_tpu_tiny", "")] == 5e-05
        assert got[("ra_tpu_inf", "")] == float("inf")


def settle_reference_samples(sampler):
    """Make each of the reference sampler's readbacks land when it
    starts, as the port's do on the CPU (a copy from a CPU tensor is made
    at once).  JAX dispatches asynchronously and torch on the CPU does
    not: without this, whether the reference's ``drain()`` finds its
    samples ready, and so its ``blocking_waits``, depends on how busy
    the host is."""
    import jax

    start = sampler._start_sample

    def start_settled():
        start()
        jax.block_until_ready(sampler._pending[-1][2])

    sampler._start_sample = start_settled


def test_prometheus_round_trip_on_engines(clock):
    """Sampled engines of both packages: the same flat names and values
    in the exposition (commit-lag family included), and the port's
    offender gauges carry lane and rank labels."""
    parsed = {}
    for pkg, mod in TEL.items():
        eng = mk_engine(pkg)
        s = mod.TelemetrySampler(eng, cadence_steps=4)
        if pkg == "ref":
            settle_reference_samples(s)
        for _ in range(8):
            eng.uniform_step(2)
        s.drain()
        obs = mod.Observatory.for_engine(eng, sampler=s)
        parsed[pkg] = mod.parse_prometheus(obs.prometheus())
        obs.close()
    got, want = parsed["port"], parsed["ref"]
    eng_names = {k: v for k, v in got.items()
                 if k[0].startswith("ra_tpu_engine_") and
                 "top_" not in k[0]}
    assert eng_names == {k: v for k, v in want.items()
                         if k[0].startswith("ra_tpu_engine_") and
                         "top_" not in k[0]}
    inf = [v for (n, lbl), v in got.items()
           if n == "ra_tpu_engine_commit_lag_bucket" and "+Inf" in lbl]
    assert inf == [8.0]
    assert got[("ra_tpu_engine_commit_lag_count", "")] == 8.0
    assert any(n == "ra_tpu_engine_top_commit_lag" and "lane=" in lbl
               for n, lbl in got)
    assert ("ra_tpu_engine_sampler_samples_started", "") in got
    assert ("ra_tpu_device_compiles", "") in got


def drive_pair(clock):
    """Both packages' engines, sampled, under one clock: snapshots taken
    between schedule windows; returns each package's Observatory,
    engine and sampler."""
    out = {}
    for pkg, mod in TEL.items():
        clock.t = 1_000_000.0
        eng = mk_engine(pkg)
        s = mod.TelemetrySampler(eng, cadence_steps=4)
        if pkg == "ref":
            settle_reference_samples(s)
        obs = mod.Observatory.for_engine(eng, sampler=s)
        for window in range(3):
            for _ in range(4 + 2 * window):
                eng.uniform_step(2)
            clock.sleep(0.05 * (window + 1))
            s.drain()
            obs.snapshot()
        out[pkg] = (obs, eng, s)
    return out


def test_engine_rings_and_rates_match_reference(clock):
    runs = drive_pair(clock)
    (ref, ref_eng, _), (port, port_eng, _) = runs["ref"], runs["port"]
    try:
        want = [(t, engine_keys(f)) for t, f in ref.ring()]
        got = [(t, engine_keys(f)) for t, f in port.ring()]
        assert got == want
        rates = port.window_rates()
        assert engine_keys(rates) == engine_keys(ref.window_rates())
        key = "engine_telemetry_committed_total"
        (t0, a), (t1, b) = port.ring()[-2:]
        tdt = b["engine_telemetry_ts"] - a["engine_telemetry_ts"]
        assert rates[key] == pytest.approx(
            (b[key] - a[key]) / tdt, rel=1e-4) and rates[key] > 0
        assert rates["seq"] * (t1 - t0) == pytest.approx(1.0, rel=1e-2)
        assert port.percentile(key, 0.5) == ref.percentile(key, 0.5)
        assert port.series(key) == ref.series(key)
    finally:
        ref.close()
        port.close()


def sc_stale(mod):
    same_sample = {"ts": 1000.0, "committed_total": 512.0}
    obs = mod.Observatory()
    obs.add_source("engine", lambda: {"telemetry": dict(same_sample),
                                      "pipeline": {"dispatches": 7}})
    obs.snapshot()
    obs.snapshot()
    rates = obs.window_rates()
    obs.close()
    return rates


def test_window_rates_omit_stale_telemetry_sample(clock):
    got = sc_stale(port_telemetry)
    assert got == sc_stale(ref_telemetry)
    assert "engine_telemetry_committed_total" not in got
    assert got.get("engine_pipeline_dispatches") == 0.0


def test_failing_source_degrades_not_dies(clock):
    out = {}
    for pkg, mod in TEL.items():
        obs = mod.Observatory()
        obs.add_source("ok", lambda: {"x": 1})
        obs.add_source("boom", lambda: 1 / 0)
        snap = obs.snapshot()
        out[pkg] = (snap, obs.prometheus(snap))
        mod.parse_prometheus(out[pkg][1])
        obs.close()
    assert out["port"] == out["ref"]
    assert out["port"][0]["ok"] == {"x": 1}
    assert "error" in out["port"][0]["boom"]


def test_jsonl_ring_bounds_and_tail(tmp_path):
    paths = {}
    for pkg, mod in TEL.items():
        path = str(tmp_path / f"{pkg}.jsonl")
        for i in range(70):
            mod.append_jsonl_ring(path, {"seq": i, "v": [i, 0.5]},
                                  max_lines=16)
        paths[pkg] = path
    with open(paths["port"], "rb") as f:
        got = f.read()
    with open(paths["ref"], "rb") as f:
        assert got == f.read()
    assert got.count(b"\n") <= 32
    assert [t["seq"] for t in port_telemetry.read_jsonl_tail(
        paths["port"], 3)] == [67, 68, 69]
    with open(paths["port"], "a") as f:
        f.write('{"seq": 70, "v"')             # a torn last append
    assert port_telemetry.read_jsonl_tail(paths["port"], 2) == \
        ref_telemetry.read_jsonl_tail(paths["port"], 2)
    assert port_telemetry.read_jsonl_tail(str(tmp_path / "none")) == []


def test_ra_top_renders_the_ports_ring(tmp_path):
    eng = mk_engine("port")
    s = port_telemetry.TelemetrySampler(eng, cadence_steps=4)
    lead = int(eng.state.leader_slot[2])
    for slot in range(3):
        if slot != lead:
            eng.fail_member(2, slot)
    for _ in range(12):
        eng.uniform_step(2)
    s.drain()
    obs = port_telemetry.Observatory.for_engine(eng, sampler=s)
    path = str(tmp_path / "obs.jsonl")
    obs.to_jsonl(path)
    obs.to_jsonl(path)
    obs.close()
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "ra_top.py"),
         path, "--once"], capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "ra_top" in out and "stalled=1" in out
    assert "STALLED" in out and "#2" in out
    assert "cmds/s" in out and "pipe" in out
    assert "device  compiles=" in out


def test_for_system_wires_duck_typed_host_sources(clock):
    """``for_system`` (and ``for_engine``'s host half) wire a system's
    counters and pipeline stamps, a counters registry and a router's RPC
    counters from duck-typed objects, as the reference does: the same
    snapshot sources and exposition lines."""
    class System:
        superstep_k, dispatch_ahead = 4, 2
        wal_max_batch_interval_ms = 1.5

        def counters(self):
            return {"wal": {"syncs": 3, "fsync_p50_ms": 2.5}}

    class Registry:
        def overview(self):
            return {"srv1": {"commands": 7}}

        def self_metrics(self):
            return {"telemetry_dropped": 0}

    class Router:
        rpc_counters = {"rpc_retries": 2, "rpc_unreachable": 0}

    out = {}
    for pkg, mod in TEL.items():
        obs = mod.Observatory.for_system(System(), counters=Registry(),
                                         router=Router())
        snap = obs.snapshot()
        lines = [ln for ln in obs.prometheus(snap).splitlines()
                 if ln.startswith(("ra_tpu_system_", "ra_tpu_counters_",
                                   "ra_tpu_rpc_"))]
        out[pkg] = ({k: snap[k] for k in ("system", "counters", "rpc")},
                    sorted(snap), lines)
        obs.close()
    assert out["port"] == out["ref"]
    assert out["port"][0]["system"]["engine_pipeline"][
        "wal_max_batch_interval_ms"] == 1.5
    assert "ra_tpu_rpc_rpc_retries 2" in out["port"][2]


def test_sampler_feeds_tracer_counter_track():
    tracks = {}
    for pkg, mod, tr in (("ref", ref_telemetry, ref_trace),
                         ("port", port_telemetry, port_trace)):
        t = tr.Tracer()
        tr.set_tracer(t)
        try:
            eng = mk_engine(pkg)
            s = mod.TelemetrySampler(eng, cadence_steps=4)
            for _ in range(8):
                eng.uniform_step(2)
            s.drain()
        finally:
            tr.set_tracer(None)
        tracks[pkg] = [e["args"] for e in t.events()
                       if e["ph"] == "C" and e["name"] == "lane_health"]
    assert tracks["port"] == tracks["ref"]
    assert tracks["port"] and set(tracks["port"][-1]) == {
        "stalled_lanes", "commit_lag_max", "apply_lag_max",
        "leader_changes"}


# ---------------------------------------------------------------------------
# the ingress and wire planes' hooks
# ---------------------------------------------------------------------------

def test_slo_verdict_accessor_drives_the_ladder():
    """The pump polls ``SloEngine.verdict("commit_p99_ms")`` and feeds
    ``on_verdict``: the same levels in both packages, from a live
    verdict."""
    from ra_tpu.ingress.backpressure import CreditLadder as RefLadder
    from ra_tpu.ingress.sessions import SessionDirectory as RefDirectory
    from ra_tpu.slo import SloEngine as RefSlo
    from ra_tpu_torch.ingress.backpressure import CreditLadder
    from ra_tpu_torch.ingress.sessions import SessionDirectory
    from ra_tpu_torch.slo import SloEngine
    levels = {}
    for pkg, mod, slo_cls, lad_cls, dir_cls in (
            ("ref", ref_telemetry, RefSlo, RefLadder, RefDirectory),
            ("port", port_telemetry, SloEngine, CreditLadder,
             SessionDirectory)):
        obs = mod.Observatory()
        p99 = [5.0]
        obs.add_source("engine", lambda p=p99: {
            "phases": {"commit_e2e": {"p99_ms": p[0]}}})
        slo = slo_cls(obs, fast_windows=1, slow_windows=2)
        lad = lad_cls(dir_cls(4))
        out = [slo.verdict("commit_p99_ms"), slo.verdict("nope"),
               lad.on_verdict(slo.verdict("commit_p99_ms"))]
        for v in (5.0, 90.0, 90.0, 90.0, 5.0, 5.0, 5.0, 5.0):
            p99[0] = v
            obs.snapshot()
            verdict = slo.verdict("commit_p99_ms")
            out.append((verdict, lad.on_verdict(verdict)))
        levels[pkg] = out
        obs.close()
    assert levels["port"] == levels["ref"]
    assert levels["port"][:3] == ["no_data", "no_data", 0]
    assert {lvl for _v, lvl in levels["port"][3:]} >= {0, 1, 2}


def test_ingress_observatory_matches_reference(clock):
    """After one seeded ingress sequence on both planes, ``for_engine``
    wires the ``ingress`` and ``read`` sources: equal snapshots, ring
    keys and exposition lines, and the counters rate as monotone keys;
    a live SloEngine on the plane's ``slo=`` hook moves the ladder."""
    from test_torch_ingress import _drive, _engines, _planes
    ref_eng, port_eng = _engines()
    ref, port, replies = _planes(ref_eng, port_eng)
    _drive(ref, port, replies, np.random.default_rng(1))
    obs = {"ref": ref_telemetry.Observatory.for_engine(ref_eng),
           "port": port_telemetry.Observatory.for_engine(port_eng)}
    try:
        snaps = {k: o.snapshot() for k, o in obs.items()}
        for src in ("ingress", "read"):
            assert snaps["port"][src] == snaps["ref"][src], src
        assert snaps["port"]["ingress"]["accepted"] == \
            port.counters["accepted"] > 0
        flat = {k: o.ring()[-1][1] for k, o in obs.items()}
        pick = {k: {n: v for n, v in f.items()
                    if n.startswith(("ingress_", "read_"))}
                for k, f in flat.items()}
        assert pick["port"] == pick["ref"] and pick["port"]
        text = {k: [ln for ln in o.prometheus(snaps[k]).splitlines()
                    if ln.startswith(("ra_tpu_ingress_", "ra_tpu_read_"))]
                for k, o in obs.items()}
        assert text["port"] == text["ref"]
        clock.sleep(0.5)
        for o in obs.values():
            o.snapshot()
        rates = {k: {n: v for n, v in o.window_rates().items()
                     if n.startswith(("ingress_", "read_"))}
                 for k, o in obs.items()}
        assert rates["port"] == rates["ref"]
        assert "ingress_accepted" in rates["port"]
        # the plane's slo= hook: a live verdict moves the ladder
        from ra_tpu_torch.slo import SloEngine
        slo = SloEngine(obs["port"], fast_windows=1, slow_windows=2)
        port.slo = slo
        src = obs["port"]._sources["engine"]
        obs["port"].add_source("engine", lambda: {
            **src(), "phases": {"commit_e2e": {"p99_ms": 99.0}}})
        obs["port"].snapshot()
        port.pump(force=True)
        assert slo.verdict("commit_p99_ms") in ("breach", "alert")
        assert port.ladder.overview()["level"] > 0
    finally:
        for o in obs.values():
            o.close()


def test_wire_listener_attach_matches_reference():
    from test_torch_wire import _close, _stacks, mk_fleet
    stacks = _stacks(lanes=16, cmds=4, max_conns=32, ring_bytes=2048)
    snaps, texts = {}, {}
    for pkg, (eng, plane, lst) in stacks.items():
        fleet = mk_fleet(pkg, lst, 8, key="obs", seed=0)
        fleet.new_ops(np.arange(8), np.ones(8, np.int32))
        fleet.send_queued()
        lst.sweep()
        fleet.collect()
        plane.pump(force=True)
        plane.settle()
        obs = TEL[pkg].Observatory.for_engine(eng)
        assert lst.attach(obs) is lst
        snaps[pkg] = obs.snapshot()
        texts[pkg] = [ln for ln in obs.prometheus(snaps[pkg]).splitlines()
                      if ln.startswith("ra_tpu_wire_")]
        obs.close()
    _close(stacks)
    assert snaps["port"]["wire"] == snaps["ref"]["wire"]
    assert snaps["port"]["wire"]["swept_rows"] == 8
    assert texts["port"] == texts["ref"]
    assert "ra_tpu_wire_swept_rows 8" in texts["port"]
